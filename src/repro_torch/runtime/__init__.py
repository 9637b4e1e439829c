from .fault_tolerance import HeartbeatMonitor  # noqa: F401
