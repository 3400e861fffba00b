from .checkpoint import CheckpointManager
from .logger import MetricLogger
from .timing import EpochTimer, PhaseTimer, event_times_ms, synchronize, time_fn

__all__ = ["CheckpointManager", "MetricLogger", "EpochTimer", "PhaseTimer", "event_times_ms",
           "synchronize", "time_fn"]
