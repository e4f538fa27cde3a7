from repro_torch.config.base import DataConfig, SyncConfig

__all__ = ["DataConfig", "SyncConfig"]
