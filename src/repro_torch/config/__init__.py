from repro_torch.config.base import (
    CheckpointConfig,
    DataConfig,
    FaultToleranceConfig,
    MeshConfig,
    ModelConfig,
    MoEConfig,
    OptimizerConfig,
    SSMConfig,
    SyncConfig,
    TrainConfig,
    asdict,
    config_fingerprint,
    replace,
)
from repro_torch.config.registry import (
    get_arch,
    get_smoke,
    list_archs,
    register_arch,
)

__all__ = [
    "CheckpointConfig", "DataConfig", "FaultToleranceConfig", "MeshConfig",
    "ModelConfig", "MoEConfig", "OptimizerConfig", "SSMConfig", "SyncConfig",
    "TrainConfig", "asdict", "config_fingerprint", "replace",
    "get_arch", "get_smoke", "list_archs", "register_arch",
]
