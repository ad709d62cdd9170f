from repro_torch.data.synthetic import retrieval_corpus
