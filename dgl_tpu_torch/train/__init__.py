from .timing import EpochTimer, PhaseTimer, event_times_ms, synchronize, time_fn

__all__ = ["EpochTimer", "PhaseTimer", "event_times_ms", "synchronize", "time_fn"]
