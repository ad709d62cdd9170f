"""Runtime fault tolerance: the heartbeat and straggler monitors.

Port of `repro.runtime`'s serving half (`fault.py`); the elastic trainer
(`elastic.py`) waits for the training port (ROADMAP A3).
"""
from repro_torch.runtime.fault import HeartbeatMonitor, StragglerDetector

__all__ = ["HeartbeatMonitor", "StragglerDetector"]
