"""Model registry: family → model class. The port builds the dense family."""
from __future__ import annotations

from repro_torch.config.base import ModelConfig
from repro_torch.models.transformer import DecoderLM

FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")


def build_model(cfg: ModelConfig, *, attn_impl: str = "kernel") -> DecoderLM:
    if cfg.family not in FAMILIES:
        raise KeyError(f"unknown family {cfg.family!r}; known "
                       f"{sorted(FAMILIES)}")
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  f"(ROADMAP §1 item 16)")
    return DecoderLM(cfg, attn_impl=attn_impl)
