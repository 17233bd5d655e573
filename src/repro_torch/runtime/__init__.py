from .fault import PreemptionGuard, RestartableLoop, StragglerDetector  # noqa: F401
