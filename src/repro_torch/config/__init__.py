from repro_torch.config.base import (
    DataConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    SyncConfig,
)
from repro_torch.config.registry import (
    get_arch,
    get_smoke,
    list_archs,
    register_arch,
)

__all__ = ["DataConfig", "ModelConfig", "MoEConfig", "SSMConfig",
           "SyncConfig", "get_arch", "get_smoke", "list_archs",
           "register_arch"]
