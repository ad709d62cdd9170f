from repro_torch.core import (bitplanar, clustering, energy, quantization,
                              similarity)
from repro_torch.core.bitplanar import (BitPlanarDB, pack_bitplanes,
                                        pack_nibble_planes, reconstruct_int8,
                                        unpack_bitplanes,
                                        unpack_nibble_plane_signed,
                                        unpack_nibble_plane_unsigned)
from repro_torch.core.clustering import (ClusterCodebook, ClusterIndex,
                                         ClusterParams, block_table,
                                         cluster_grouped_order, kmeans_int8)
from repro_torch.core.engine import (ClusterPolicy, MaskedPolicy, PlainPolicy,
                                     RetrievalEngine, SchedulePlan,
                                     SlabPolicy, StagePlan, ViewPolicy,
                                     WindowedPolicy, plan)
from repro_torch.core.quantization import (QuantizedDB, build_database,
                                           dequantize, lsb_nibble,
                                           msb_nibble, quantize_int4,
                                           quantize_int8, quantize_int8_fixed,
                                           reconstruct_from_nibbles,
                                           unit_norm_scale)
from repro_torch.core.retrieval import (NO_TENANT, RetrievalConfig,
                                        RetrievalResult, batched_retrieve,
                                        batched_retrieve_masked,
                                        cluster_pruned_retrieve,
                                        exact_retrieve, int4_retrieve,
                                        two_stage_retrieve,
                                        two_stage_retrieve_masked,
                                        windowed_retrieve_masked)
from repro_torch.core.similarity import (cosine_key_f32, fraction_greater,
                                         int_dot, int_matvec,
                                         rerank_dense_comparator, topk_mips)
