from repro_torch.runtime.ft import FaultInjector, StepRunner, StragglerWatchdog
from repro_torch.runtime.ladder import (CompileCounter, LadderRuntime,
                                        compile_rungs)

__all__ = ["StepRunner", "StragglerWatchdog", "FaultInjector",
           "CompileCounter", "LadderRuntime", "compile_rungs"]
