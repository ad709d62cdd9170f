"""Runtime fault tolerance: the heartbeat and straggler monitors
(`fault.py`) and the elastic checkpoint-restart trainer (`elastic.py`),
the port of `repro.runtime`."""
from repro_torch.runtime.elastic import (ElasticTrainer, FailureInjector,
                                         WorkerFailure, build_mesh_from)
from repro_torch.runtime.fault import HeartbeatMonitor, StragglerDetector

__all__ = ["ElasticTrainer", "FailureInjector", "HeartbeatMonitor",
           "StragglerDetector", "WorkerFailure", "build_mesh_from"]
