"""Mixture-of-Experts FFN: top-k routing with scatter/gather dispatch.

The port of ``repro.models.moe``. :func:`moe_ffn` dispatches as the
reference does:

* no mesh rules current: the single-device path below;
* a mesh (:func:`repro_torch.sharding.use_rules`) and T ≥ 32,768 tokens
  where the experts split over the model axis, d_model over the data axis
  and the sequence over the model axis: :func:`moe_ffn_sharded`, the
  reference's expert parallelism (an all-to-all of the dispatched tokens to
  the ranks that own their experts, the FSDP gathers of the expert tables
  over data, the return trip);
* a mesh and fewer tokens: :func:`moe_ffn_onehot`, the reference's
  decode-sized function with the expert tables left where they sit;
* a mesh, T ≥ 32,768 and those conditions failing: the tables and the
  batch gathered and the single-device body run, the function the
  reference's scatter path computes there.

On a mesh a rank holds its data shard of the batch and its shards of the
expert tables (experts→model, d_model→data) and of the router
(d_model→data, experts→model; gathered whole before the router product:
routing needs every expert's logit). Its tokens are its act_seq chunk of
the sequence where a prefill or a training sequence splits it (``seq``,
:func:`repro_torch.models.layers.act_shards`:
the token shard the all-to-all path takes as it is), else the whole
sequence, replicated over the model axis; it gets back the output of the
tokens it was given.

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
On a mesh the sharded path's gradient goes through the collectives'
transposes (:mod:`repro_torch.core.collectives`): each rank's loss is its
share of the whole, a replicated leaf's gradient (the router's) this rank's
part of it.
"""
from __future__ import annotations

from collections import Counter
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.core import collectives as CL
from repro_torch.models import layers as L
from repro_torch.sharding import current_rules

CAPACITY_FACTOR = 1.25
# tokens from which a mesh takes the all-to-all path (the reference's)
SHARDED_MIN_TOKENS = 32768
# calls of each mesh path in this process: "sharded" (all-to-all),
# "onehot", "gathered" (the tables and the batch gathered)
PATHS: Counter = Counter()


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
    me, ce = _load_terms(logits, indices, cfg)
    return logits.shape[1] * torch.sum(me * ce)


def _load_terms(logits: torch.Tensor, indices: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the mean gate mass of each expert, its share of the routed slots)."""
    t, e = logits.shape
    gates = torch.softmax(logits.float(), dim=-1)
    routed = torch.zeros((t, e), dtype=torch.float32, device=logits.device)
    routed.scatter_add_(1, indices, torch.ones(indices.shape,
                                               dtype=torch.float32,
                                               device=logits.device))
    return gates.mean(dim=0), routed.mean(dim=0) / cfg.moe.top_k


def _dispatch(xt: torch.Tensor, indices: torch.Tensor, pos: torch.Tensor,
              cap: int, e: int) -> torch.Tensor:
    """Scatter per slot into (E, C + 1, D): a slot over capacity lands in
    the spare row C, cut off here (the reference's mode="drop"). A kept
    (expert, rank) has one writer, so the sum is the token's row."""
    row = indices * (cap + 1) + torch.clamp(pos, max=cap)
    buf = torch.zeros((e * (cap + 1), xt.shape[1]), dtype=xt.dtype,
                      device=xt.device)
    for j in range(indices.shape[1]):
        buf.index_add_(0, row[:, j], xt)
    return buf.reshape(e, cap + 1, xt.shape[1])[:, :cap]


def _experts(buf: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """The expert products of (E, C, D) slots: SwiGLU, (E, C, D) out."""
    dtype = buf.dtype
    gate = torch.bmm(buf, w_gate.to(dtype))
    up = torch.bmm(buf, w_up.to(dtype))
    return torch.bmm(F.silu(gate) * up, w_down.to(dtype))


def _combine(ye: torch.Tensor, indices: torch.Tensor, pos: torch.Tensor,
             weights: torch.Tensor, cap: int) -> torch.Tensor:
    """Gather back per slot in slot order from (E·C, D); dropped slots (and
    slots of weight 0) contribute 0."""
    t, d = indices.shape[0], ye.shape[1]
    out = torch.zeros((t, d), dtype=ye.dtype, device=ye.device)
    for j in range(indices.shape[1]):
        kept = (pos[:, j] < cap).to(weights.dtype)
        yt = ye.index_select(
            0, indices[:, j] * cap + torch.clamp(pos[:, j], max=cap - 1))
        out = out + yt * (weights[:, j] * kept)[:, None].to(ye.dtype)
    return out


def moe_ffn(params: L.Params, x: torch.Tensor, cfg: ModelConfig,
            capacity_factor: float = CAPACITY_FACTOR,
            return_aux: bool = False, seq=None):
    """x (B, S, D) → out (B, S, D), or with ``return_aux`` (out, aux): the
    f32 :func:`load_balance` term of the router logits and routed experts
    this dispatch used (the reference's pair). Serving takes out alone and
    computes no aux. Under mesh rules x is this rank's rows of the batch
    (with ``seq``, the model group of an act_seq split, its chunk of their
    sequence) and ``params`` holds its shards of the tables (the module
    docstring); aux is then the whole batch's."""
    rules = current_rules()
    if rules is not None and rules.mesh is not None:
        return _moe_ffn_mesh(params, x, cfg, capacity_factor, return_aux,
                             rules, seq)
    return _moe_ffn_local(params, x, cfg, capacity_factor, return_aux)


def _moe_ffn_local(params, x, cfg, capacity_factor, return_aux):
    """The single-device path."""
    b, s, d = x.shape
    e = cfg.moe.num_experts
    xt = x.reshape(b * s, d)
    logits = router_logits(params, x)
    weights, indices, pos, cap = routing(logits, cfg, capacity_factor)
    buf = _dispatch(xt, indices, pos, cap, e)
    ye = _experts(buf, params["w_gate"], params["w_up"], params["w_down"])
    out = _combine(ye.reshape(e * cap, d), indices, pos, weights, cap)
    out = out.reshape(b, s, d)
    if return_aux:
        return out, load_balance(logits, indices, cfg)
    return out


# ---------------------------------------------------------------------------
# on a mesh
# ---------------------------------------------------------------------------

def _whole_router(router: torch.Tensor, d: int, e: int, model
                  ) -> torch.Tensor:
    """The (D, E) router from what the rank holds: whole (a training
    rank's), or its (D/Dn, E/M) shard gathered over data and model
    (exact)."""
    router = L.fsdp(router, 0, d)
    if router.shape[1] == e:
        return router
    if router.shape[1] * model.k != e:
        raise ValueError(f"a router of {tuple(router.shape)} is neither the "
                         f"whole {e} experts nor its share of the model axis")
    return model.gather_dim(router, 1)


def _moe_ffn_mesh(params, x, cfg, capacity_factor, return_aux, rules, seq):
    data, model = CL.mesh_groups(rules)
    # how the rank holds its tables: the rules' axes of their dims
    split = (bool(rules.mesh_axes_for("experts")),
             bool(rules.mesh_axes_for("expert_embed")))
    b_loc, s_loc, d = x.shape
    s = s_loc * (seq.k if seq is not None else 1)
    e = cfg.moe.num_experts
    tables = {name: params[name] for name in ("w_gate", "w_up", "w_down")}
    tables["router"] = _whole_router(params["router"], d, e, model)
    if b_loc * data.k * s < SHARDED_MIN_TOKENS:
        PATHS["onehot"] += 1
        out, aux = moe_ffn_onehot(tables, L.seq_gather(x, seq), cfg, data,
                                  model, split, capacity_factor, return_aux)
        out = L.seq_chunk(out, seq)
    elif all(split) and e % model.k == 0 and d % data.k == 0 \
            and s % model.k == 0:
        PATHS["sharded"] += 1
        if seq is not None:
            # the rank's act_seq chunk is the token shard it dispatches
            out, aux = moe_ffn_sharded(tables, x, cfg, data, model,
                                       capacity_factor, return_aux)
        else:
            # the act_seq slice of this rank's rows, and the outputs of
            # every slice gathered back along seq over the model axis
            s_loc = s // model.k
            out, aux = moe_ffn_sharded(
                tables, x.narrow(1, model.index * s_loc, s_loc), cfg, data,
                model, capacity_factor, return_aux)
            out = model.gather_dim(out, 1)
    else:
        PATHS["gathered"] += 1
        for name, d_dim in (("w_gate", 1), ("w_up", 1), ("w_down", 2)):
            if split[0]:
                tables[name] = model.gather_dim(tables[name], 0)
            if split[1]:
                tables[name] = data.gather_dim(tables[name], d_dim)
        out, aux = _moe_ffn_local(tables, data.gather_dim(
            L.seq_gather(x, seq), 0), cfg, capacity_factor, True)
        out = L.seq_chunk(out.narrow(0, data.index * b_loc, b_loc), seq)
    return (out, aux) if return_aux else out


def moe_ffn_sharded(params: L.Params, x: torch.Tensor, cfg: ModelConfig,
                    data, model, capacity_factor: float = CAPACITY_FACTOR,
                    return_aux: bool = True):
    """The reference's ``_moe_ffn_sharded`` body on this rank's (B_loc,
    S_loc, D) tokens → (its out, aux over every rank's tokens).

    ``data`` and ``model`` are the mesh's groups
    (:class:`repro_torch.core.collectives.Group`); ``params`` holds the
    router whole and this rank's (E/M, D/Dn, F) / (E/M, F, D/Dn) expert
    tables. Route the local tokens; scatter them into an (E, C_s, D) send
    buffer, C_s = ⌈cf·k·T_loc/E⌉ rounded up to 8 (a capacity per expert
    and source shard: it decides which slots drop, not the global C); an
    all-to-all over model carries each expert's slots to its owner; gather
    the tables over data (FSDP); the expert products; the reverse
    all-to-all; the local weighted combine. aux (None unless
    ``return_aux``) takes its two means averaged over every rank."""
    b, s, d = x.shape
    e = cfg.moe.num_experts
    m = model.k
    e_loc = e // m
    xt = x.reshape(b * s, d)
    logits = router_logits(params, x)
    weights, indices, pos, cap = routing(logits, cfg, capacity_factor)

    aux = None
    if return_aux:
        me, ce = _load_terms(logits, indices, cfg)
        n = data.k * model.k
        me = CL._div_exact(model.sum(data.sum(me)), n)
        ce = CL._div_exact(model.sum(data.sum(ce)), n)
        aux = e * torch.sum(me * ce)

    buf = _dispatch(xt, indices, pos, cap, e)            # (E, C_s, D)
    # dispatch: the slots of the experts of model rank j go to rank j
    recv = model.all_to_all(buf.reshape(m, e_loc, cap, d))
    xe = recv.transpose(0, 1).reshape(e_loc, m * cap, d)
    ye = _experts(xe, data.gather_dim(params["w_gate"], 1),
                  data.gather_dim(params["w_up"], 1),
                  data.gather_dim(params["w_down"], 2))
    # the return trip
    ye = ye.reshape(e_loc, m, cap, d).transpose(0, 1)
    back = model.all_to_all(ye)
    out = _combine(back.reshape(e * cap, d), indices, pos, weights, cap)
    return out.reshape(b, s, d), aux


def moe_ffn_onehot(params: L.Params, x: torch.Tensor, cfg: ModelConfig,
                   data, model, split: Tuple[bool, bool] = (True, True),
                   capacity_factor: float = CAPACITY_FACTOR,
                   return_aux: bool = True):
    """The function of the reference's ``_moe_ffn_onehot`` (decode-sized
    T on a mesh) on this rank's (B_loc, S, D) rows → (their out, aux),
    with the expert tables left where they sit: the activations move.

    The batch is gathered over data, so every rank routes every token as
    one device would (the capacity from the whole T). A rank dispatches the
    slots of its E/M experts, on its d_model slice; its partial products
    over that slice are summed over data (f32); its experts' outputs on its
    d_model slice are combined for every token and the partials summed over
    model (f32); the d_model slices are gathered over data and the rank
    keeps its rows. ``split``: whether the tables are split over experts
    (model) and over d_model (data). aux is None unless ``return_aux``."""
    b_loc, s, d = x.shape
    e = cfg.moe.num_experts
    xg = data.gather_dim(x, 0)
    t = xg.shape[0] * s
    xt = xg.reshape(t, d)
    logits = router_logits(params, xg)
    weights, indices, pos, cap = routing(logits, cfg, capacity_factor)
    aux = load_balance(logits, indices, cfg) if return_aux else None

    wg, wu, wd = params["w_gate"], params["w_up"], params["w_down"]
    e_loc, d_loc = wg.shape[0], wg.shape[1]
    split_e, split_d = split
    lo = model.index * e_loc if split_e else 0
    mine = (indices >= lo) & (indices < lo + e_loc)
    local = torch.where(mine, indices - lo, 0)
    # a slot of another rank's expert goes to the spare row, like a drop
    pos_mine = torch.where(mine, pos, cap)
    if split_d:
        xt = xt.narrow(1, data.index * d_loc, d_loc)
    buf = _dispatch(xt, local, pos_mine, cap, e_loc)    # (E_loc, C, D_loc)
    dtype = buf.dtype

    def over_d(part):
        return data.sum(part.float()).to(dtype) if split_d else part
    gate = over_d(torch.bmm(buf, wg.to(dtype)))
    up = over_d(torch.bmm(buf, wu.to(dtype)))
    ye = torch.bmm(F.silu(gate) * up, wd.to(dtype))     # (E_loc, C, D_loc)
    out = _combine(ye.reshape(e_loc * cap, d_loc), local, pos_mine,
                   weights, cap)
    if split_e:
        out = model.sum(out.float()).to(dtype)
    if split_d:
        out = data.gather_dim(out, 1)
    out = out.reshape(-1, s, d).narrow(0, data.index * b_loc, b_loc)
    return out, aux
