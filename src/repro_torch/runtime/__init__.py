from .compile_guard import (CompileBudgetExceeded,  # noqa: F401
                            CompileGuard)
from .fault import (FaultInjector, Heartbeat, InjectedFault,  # noqa: F401
                    PreemptionGuard, RestartableLoop, StragglerDetector)
