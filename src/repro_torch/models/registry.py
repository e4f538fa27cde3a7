"""Model registry: family → model class. The port builds the dense, ssm and
hybrid families."""
from __future__ import annotations

from typing import Union

from repro_torch.config.base import ModelConfig
from repro_torch.models.hybrid import HybridModel
from repro_torch.models.ssm import SSD_IMPLS, SSMModel
from repro_torch.models.transformer import DecoderLM

FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")

Model = Union[DecoderLM, SSMModel, HybridModel]


def build_model(cfg: ModelConfig, *, attn_impl: str = "kernel",
                ssd_impl: str = "kernel") -> Model:
    """The model of ``cfg.family``. ``attn_impl`` selects the attention of a
    full sequence (dense, hybrid) and ``ssd_impl`` the prefill's SSD scan
    (ssm, hybrid): ``"kernel"`` or ``"torch"``."""
    if cfg.family not in FAMILIES:
        raise KeyError(f"unknown family {cfg.family!r}; known "
                       f"{sorted(FAMILIES)}")
    if ssd_impl not in SSD_IMPLS:
        raise ValueError(f"unknown ssd impl {ssd_impl!r} "
                         f"({' | '.join(SSD_IMPLS)})")
    if cfg.family == "ssm":
        return SSMModel(cfg, ssd_impl=ssd_impl)
    if cfg.family == "hybrid":
        return HybridModel(cfg, attn_impl=attn_impl, ssd_impl=ssd_impl)
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  f"(ROADMAP §1 item 16)")
    return DecoderLM(cfg, attn_impl=attn_impl)
