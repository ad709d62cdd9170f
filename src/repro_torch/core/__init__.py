from repro_torch.core import (bitplanar, clustering, energy, quantization,
                              similarity)
from repro_torch.core.bitplanar import BitPlanarDB
from repro_torch.core.clustering import (ClusterCodebook, ClusterIndex,
                                         ClusterParams, block_table,
                                         cluster_grouped_order, kmeans_int8)
from repro_torch.core.engine import (ClusterPolicy, MaskedPolicy, PlainPolicy,
                                     RetrievalEngine, SchedulePlan,
                                     SlabPolicy, StagePlan, ViewPolicy,
                                     WindowedPolicy, plan)
from repro_torch.core.quantization import (QuantizedDB, build_database,
                                           dequantize, msb_nibble,
                                           quantize_int4, quantize_int8,
                                           reconstruct_from_nibbles,
                                           unit_norm_scale)
from repro_torch.core.retrieval import (NO_TENANT, RetrievalConfig,
                                        RetrievalResult,
                                        two_stage_retrieve_masked)
from repro_torch.core.similarity import int_dot, topk_mips
