from repro_torch.optim.optimizers import (
    OptState,
    apply_updates,
    apply_updates_,
    init_opt_state,
    make_schedule,
)

__all__ = ["OptState", "apply_updates", "apply_updates_",
           "init_opt_state", "make_schedule"]
