from repro_torch.data.synthetic import (LMTaskConfig, lm_batches,
                                        retrieval_corpus, shard_batch)
