"""Model registry: family → model class, plus exact analytic parameter
counts. The port builds every family of the reference: dense, moe, vlm,
ssm, hybrid and audio.

``analytic_param_count`` sums the model's own ``param_defs()`` shape
declarations, so it is exact by construction, as the reference's is.
``active_only=True`` scales the MoE expert tensors (the router and the
three expert weights, the reference's ``"experts"`` logical axis) by
top_k/E: the MODEL_FLOPS = 6·N_active·D roofline convention.
"""
from __future__ import annotations

import math
from typing import Union

from repro_torch.config.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.hybrid import HybridModel
from repro_torch.models.ssm import SSD_IMPLS, SSMModel
from repro_torch.models.transformer import DecoderLM, PrefixVLM

FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")

Model = Union[DecoderLM, PrefixVLM, SSMModel, HybridModel, EncDecModel]


def build_model(cfg: ModelConfig, *, attn_impl: str = "kernel",
                ssd_impl: str = "kernel", remat: str = "none") -> Model:
    """The model of ``cfg.family``. ``attn_impl`` selects the attention of a
    full sequence (every family but ssm) and ``ssd_impl`` the prefill's SSD
    scan (ssm, hybrid): ``"kernel"`` or ``"torch"``. ``remat`` is the
    reference's activation checkpointing of each layer where a gradient is
    taken: ``"full"`` or ``"dots"`` for dense, moe and vlm (another value
    checkpoints nothing), any value but ``"none"`` for ssm, hybrid and
    audio (a whole layer)."""
    if cfg.family not in FAMILIES:
        raise KeyError(f"unknown family {cfg.family!r}; known "
                       f"{sorted(FAMILIES)}")
    if ssd_impl not in SSD_IMPLS:
        raise ValueError(f"unknown ssd impl {ssd_impl!r} "
                         f"({' | '.join(SSD_IMPLS)})")
    if cfg.family == "ssm":
        return SSMModel(cfg, ssd_impl=ssd_impl, remat=remat)
    if cfg.family == "hybrid":
        return HybridModel(cfg, attn_impl=attn_impl, ssd_impl=ssd_impl,
                           remat=remat)
    if cfg.family == "audio":
        return EncDecModel(cfg, attn_impl=attn_impl, remat=remat)
    cls = PrefixVLM if cfg.family == "vlm" else DecoderLM
    return cls(cfg, attn_impl=attn_impl, remat=remat)


def _def_leaves(defs, path=()):
    """(path of keys, Param) of every declaration, a layer list's entries
    each counted."""
    if isinstance(defs, L.Param):
        return [(path, defs)]
    if isinstance(defs, list):
        return [leaf for d in defs for leaf in _def_leaves(d, path)]
    return [leaf for k in sorted(defs)
            for leaf in _def_leaves(defs[k], path + (k,))]


def analytic_param_count(cfg: ModelConfig, active_only: bool = False,
                         include_embeddings: bool = True) -> int:
    """The parameter count of ``cfg``'s model, summed over its declarations;
    ``active_only`` counts top_k of the E experts of each MoE tensor."""
    total = 0
    for keys, p in _def_leaves(build_model(cfg).param_defs()):
        if not include_embeddings and "embed" in keys[0]:
            continue
        n = math.prod(p.shape)
        if active_only and "moe" in keys:
            n = int(n * cfg.moe.top_k / max(1, cfg.moe.num_experts))
        total += n
    return int(total)
