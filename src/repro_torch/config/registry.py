"""Architecture registry. ``repro_torch/configs/*.py`` register themselves
here; the port registers the archs it can build."""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.config.base import ModelConfig

_ARCHS: Dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: Dict[str, Callable[[], ModelConfig]] = {}


def register_arch(arch_id: str, full: Callable[[], ModelConfig],
                  smoke: Callable[[], ModelConfig]) -> None:
    _ARCHS[arch_id] = full
    _SMOKE[arch_id] = smoke


def get_arch(arch_id: str) -> ModelConfig:
    _ensure_loaded()
    if arch_id not in _ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_ARCHS)}")
    return _ARCHS[arch_id]()


def get_smoke(arch_id: str) -> ModelConfig:
    _ensure_loaded()
    if arch_id not in _SMOKE:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_SMOKE)}")
    return _SMOKE[arch_id]()


def list_archs():
    _ensure_loaded()
    return sorted(_ARCHS)


def _ensure_loaded() -> None:
    if _ARCHS:
        return
    import repro_torch.configs  # noqa: F401  (imports register every arch)
