from .checkpoint import CheckpointManager
from .logger import Logger, MetricLogger
from .timing import EpochTimer, PhaseTimer, event_times_ms, op_time, synchronize, time_fn

__all__ = ["CheckpointManager", "Logger", "MetricLogger", "EpochTimer", "PhaseTimer", "op_time",
           "event_times_ms", "synchronize", "time_fn"]
