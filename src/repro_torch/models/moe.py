"""Mixture-of-Experts FFN: top-k routing with scatter/gather dispatch.

The port of ``repro.models.moe``'s single-device path (the reference's
``moe_ffn`` with no mesh rules; its expert-parallel ``_moe_ffn_sharded``
and one-hot ``_moe_ffn_onehot`` serve a mesh and wait for expert
parallelism across ranks, ROADMAP §1 item 21).

Tokens are scattered into a static (E, C, D) expert buffer (C = capacity
per expert), the expert products run as batched (E, C, D)×(E, D, F)
products, and the outputs gather back to token order, each slot weighted
by its renormalised gate. A token's rank in its expert's queue is the
cumsum over the (T·k, E) one-hot of the routed experts, rows ordered
``t·k + j`` as in the reference; a slot ranked at or beyond C is dropped.

Everything stays on the device, with shapes fixed by (T, k, E, C): the
drop writes into a spare row C of the buffer that is cut off, never a
boolean index, so a decode step with MoE layers captures as a CUDA graph.
Ties among the gates go to the lower expert index, as ``jax.lax.top_k``
gives them (a stable descending sort, not ``torch.topk``).

Training takes ``moe_ffn(…, return_aux=True)``: the Switch load-balance
term of the same router logits and routed experts the dispatch used. Its
gradient reaches the router through the softmax's mean gate mass; the
routed share is counted from the indices and carries none, as in the
reference. The backward of the dispatch is deterministic: a kept (expert,
rank) has one writer, and the gather's duplicate rows (a dropped slot reads
row C − 1 of its expert) carry a weight of 0, so their gradient adds zeros.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.models import layers as L

CAPACITY_FACTOR = 1.25


def moe_defs(cfg: ModelConfig) -> L.ParamDefs:
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    return {
        "router": L.Param((d, e), ("embed", "experts"), init="fan_in"),
        "w_gate": L.Param((e, d, f), ("experts", "expert_embed", "expert_mlp"), init="fan_in"),
        "w_up": L.Param((e, d, f), ("experts", "expert_embed", "expert_mlp"), init="fan_in"),
        "w_down": L.Param((e, f, d), ("experts", "expert_mlp", "expert_embed"), init="fan_in"),
    }


def top_k_routing(logits: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (T, E) → (weights (T, k) f32 renormalised, indices (T, k)):
    the f32 softmax's k largest gates, equal gates in ascending expert
    order (the reference's ``_top_k_routing``)."""
    gates = torch.softmax(logits.float(), dim=-1)
    weights, indices = torch.sort(gates, dim=-1, descending=True,
                                  stable=True)
    weights, indices = weights[:, :k], indices[:, :k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return weights, indices


def capacity(tokens: int, cfg: ModelConfig,
             capacity_factor: float = CAPACITY_FACTOR) -> int:
    """Slots per expert: ``max(8, cf·k·T/E)`` rounded up to a multiple of
    8, the reference's sublane-aligned capacity."""
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    c = int(max(8, capacity_factor * k * tokens / e))
    return -(-c // 8) * 8


def router_logits(params: L.Params, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, D) → the router's logits (B·S, E), in x's dtype."""
    return x.reshape(-1, x.shape[-1]) @ params["router"].to(x.dtype)


def routing(logits: torch.Tensor, cfg: ModelConfig,
            capacity_factor: float = CAPACITY_FACTOR):
    """The dispatch of router logits (T, E): (weights (T, k) f32, indices
    (T, k), each slot's rank in its expert's queue (T, k), the capacity
    C)."""
    t, e = logits.shape
    k = cfg.moe.top_k
    weights, indices = top_k_routing(logits, k)
    # rank of (token, slot) within its expert queue, rows t·k + j
    flat_e = indices.reshape(t * k, 1)
    onehot = torch.zeros((t * k, e), dtype=torch.int32, device=logits.device)
    onehot.scatter_(1, flat_e, 1)
    pos = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1
    pos = torch.gather(pos, 1, flat_e).reshape(t, k)
    return weights, indices, pos, capacity(t, cfg, capacity_factor)


def load_balance(logits: torch.Tensor, indices: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """The Switch-style load-balance aux term (f32) of router logits (T, E)
    and their routed experts (T, k): E × Σ_e (mean gate mass of e) × (share
    of the routed slots that went to e), the reference's ``aux``. The
    serving path does not compute it; a training loss adds it."""
    t, e = logits.shape
    gates = torch.softmax(logits.float(), dim=-1)
    routed = torch.zeros((t, e), dtype=torch.float32, device=logits.device)
    routed.scatter_add_(1, indices, torch.ones(indices.shape,
                                               dtype=torch.float32,
                                               device=logits.device))
    ce = routed.mean(dim=0) / cfg.moe.top_k
    return e * torch.sum(gates.mean(dim=0) * ce)


def moe_ffn(params: L.Params, x: torch.Tensor, cfg: ModelConfig,
            capacity_factor: float = CAPACITY_FACTOR,
            return_aux: bool = False):
    """x (B, S, D) → out (B, S, D), or with ``return_aux`` (out, aux): the
    f32 :func:`load_balance` term of the router logits and routed experts
    this dispatch used (the reference's pair). Serving takes out alone and
    computes no aux."""
    b, s, d = x.shape
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    t = b * s
    dtype = x.dtype
    xt = x.reshape(t, d)
    logits = router_logits(params, x)
    weights, indices, pos, cap = routing(logits, cfg, capacity_factor)

    # scatter per slot into (E, C + 1, D): a slot over capacity lands in
    # the spare row C, cut off below (the reference's mode="drop"). A kept
    # (expert, rank) has one writer, so the sum is the token's row.
    row = indices * (cap + 1) + torch.clamp(pos, max=cap)
    buf = torch.zeros((e * (cap + 1), d), dtype=dtype, device=x.device)
    for j in range(k):
        buf.index_add_(0, row[:, j], xt)
    buf = buf.reshape(e, cap + 1, d)[:, :cap]

    gate = torch.bmm(buf, params["w_gate"].to(dtype))
    up = torch.bmm(buf, params["w_up"].to(dtype))
    ye = torch.bmm(F.silu(gate) * up, params["w_down"].to(dtype))
    ye = ye.reshape(e * cap, d)

    # gather back per slot in slot order; dropped slots contribute 0
    out = torch.zeros((t, d), dtype=dtype, device=x.device)
    for j in range(k):
        kept = (pos[:, j] < cap).to(weights.dtype)
        yt = ye.index_select(
            0, indices[:, j] * cap + torch.clamp(pos[:, j], max=cap - 1))
        out = out + yt * (weights[:, j] * kept)[:, None].to(dtype)
    out = out.reshape(b, s, d)
    if return_aux:
        return out, load_balance(logits, indices, cfg)
    return out
