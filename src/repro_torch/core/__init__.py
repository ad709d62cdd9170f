from repro_torch.core import (bitplanar, clustering, energy, quantization,
                              similarity)
from repro_torch.core.bitplanar import BitPlanarDB
from repro_torch.core.clustering import ClusterCodebook, ClusterParams
from repro_torch.core.engine import (ClusterPolicy, MaskedPolicy, PlainPolicy,
                                     RetrievalEngine, SchedulePlan, StagePlan,
                                     WindowedPolicy, plan)
from repro_torch.core.quantization import (QuantizedDB, build_database,
                                           msb_nibble, quantize_int8)
from repro_torch.core.retrieval import (NO_TENANT, RetrievalConfig,
                                        RetrievalResult)
