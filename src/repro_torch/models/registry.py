"""Model registry: family → model class, plus exact analytic parameter
counts. The port builds the dense, ssm and hybrid families.

``analytic_param_count`` sums the model's own ``param_defs()`` shape
declarations, so it is exact by construction, as the reference's is.
"""
from __future__ import annotations

import math
from typing import Union

from repro_torch.config.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.hybrid import HybridModel
from repro_torch.models.ssm import SSD_IMPLS, SSMModel
from repro_torch.models.transformer import DecoderLM

FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")

Model = Union[DecoderLM, SSMModel, HybridModel]


def build_model(cfg: ModelConfig, *, attn_impl: str = "kernel",
                ssd_impl: str = "kernel", remat: str = "none") -> Model:
    """The model of ``cfg.family``. ``attn_impl`` selects the attention of a
    full sequence (dense, hybrid) and ``ssd_impl`` the prefill's SSD scan
    (ssm, hybrid): ``"kernel"`` or ``"torch"``. ``remat`` is the
    reference's activation checkpointing of each layer where a gradient is
    taken: ``"full"`` or ``"dots"`` for dense (another value checkpoints
    nothing), any value but ``"none"`` for ssm and hybrid."""
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
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  f"(ROADMAP §1 item 16)")
    return DecoderLM(cfg, attn_impl=attn_impl, remat=remat)


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
    """The parameter count of ``cfg``'s model, summed over its declarations
    (``active_only`` scales MoE expert tensors by top_k/E in the reference;
    the MoE family waits for ROADMAP §1 item 16 and raises here)."""
    if cfg.is_moe or cfg.family == "moe":
        raise NotImplementedError("parameter counts of the MoE family wait "
                                  "for its port (ROADMAP §1 item 16)")
    total = 0
    for keys, p in _def_leaves(build_model(cfg).param_defs()):
        if not include_embeddings and "embed" in keys[0]:
            continue
        total += math.prod(p.shape)
    return int(total)
