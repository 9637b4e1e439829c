from .fault_tolerance import HeartbeatMonitor, RestartableLoop  # noqa: F401
