"""Local-SGD (MSF) trainer: the paper's DMS algorithm generalized to LMs, the
port of ``repro.core.local_sgd``, on one process or across the ranks of a
mesh (:mod:`repro_torch.launch.mesh`).

Two step flavors, selected by ``SyncConfig.strategy``:

* ``sync_every_step`` → :func:`make_ddp_step`: one optimizer step on the
  gradient of the whole global batch (the paper's MSF = 1 analog); across
  ranks each rank takes its rows and the gradient is all-reduced every
  step.
* ``periodic`` → :func:`make_local_sgd_block`: K replicas each take H
  optimizer steps on their own rows of every microbatch, then average
  (:func:`repro_torch.core.sync.sync_point`). ``hierarchical`` is the same
  block on a ``(pod, data)`` mesh: the replicas are the ``pod`` axis, synced
  every H steps, and each replica's gradient is all-reduced over its
  ``data`` ranks every step (reference ``core/sync.py``'s strategy table).

Across ranks each rank holds one replica's params, moments and sync state
(every leaf's leading dim 1, as the reference's inside ``shard_map``), takes
the rows the reference's in-spec ``P(None, replica_axis)`` gives it
(``DataPipeline(…, mesh=mesh)``), and syncs over the replica axis's
collectives. :func:`scatter_replicas` and :func:`gather_replicas` take the
one-process K-replica state to each rank's share and back (the port's
``build_state_axes`` / ``state_shardings``).

On a mesh with a ``model`` axis (``(data, model)`` for DDP, ``(pod, data,
model)`` for local SGD; :func:`repro_torch.sharding.training_rules`) the
step runs under the mesh rules, as the reference's runs its data and model
axes in XLA's auto mode, and a rank holds every leaf as the reference's
``state_shardings`` places it (:func:`repro_torch.sharding.train_specs`:
the attention's heads, the MLP's columns, the Mamba2 mixers' heads, the
vocab and the experts over model, each d_model dim over data, a dim held
whole where it does not divide; the moments and sync state as their
params, :func:`state_specs`). The layers run tensor and sequence parallel
on the rank's data rows (:mod:`repro_torch.models.layers`), the MoE and the
embedding on their mesh paths, the CE vocab-parallel
(:func:`repro_torch.models.losses.ce_loss`), and the collectives carry the
gradient between the ranks, each backward its transpose.

The gradient's scale: every rank differentiates the loss it computes, the
mean over its data rows (alike on the model ranks of a data row, each of
which holds its part of every product), and the collectives' transposes
make each rank's gradient that of the sum of those losses over the
replica's n ranks, with respect to the blocks it holds. That sum is n
times the reference's loss (a whole-batch mean; the MoE's aux a mean over
every rank already). So each leaf's gradient is summed over the ranks that
hold the same block of it, and divided by n (:class:`Within`): a leaf held
whole (a norm's scale, the KV projections of paligemma's one KV head) over
every rank of the replica, a split leaf over the axes its spec leaves free
(the ranks of the other data rows). ``grad_clip`` reads the whole tree's
norm, each block's squares summed over its blocks' ranks once; the int8
sync packs each block with its whole leaf's scale. The hybrid's shared
block is one leaf of every rank whose gradient is a sum over its
application points.

State layout (plain dict), the reference's:

    {"params": …, "opt": …, "sync": …, "step": int}

Params are the reference's tree, one tensor per reference leaf with each
layer stack (``layers``; the enc-dec's ``enc_layers`` and ``dec_layers``)
as ``(depth, …)`` leaves, in sorted-key leaf order (so a sync
quantizes and shards each leaf as the reference does, about a dozen kernel
calls a sync). Under local SGD every leaf of params/opt/sync gains a leading
replica dim K; the model reads per-layer views of one replica's leaves.
Optimizer moments stay local to each replica between syncs.

On one card the replicas' local steps run one replica after another, so only
one replica's activations are alive at a time. A block keeps the params it
started from (the sync's ``params_start``) and steps a copy of them, and it
steps the optimizer moments of the state it is given in place, as the
reference's trainer donates its state to the jitted block
(``donate_argnums``) and XLA reuses the buffers: the given state's ``opt``
is the returned state's, and the given state must not be stepped again.
The every-step flavor updates the given params and moments in place the same
way. Each update is written leaf by leaf
(:func:`repro_torch.optim.apply_updates_`), and the blocking sync writes the
synchronized params over the block's working copy, which it is handed
(:func:`repro_torch.core.sync.sync_point`), so no second copy of either is
alive at once. A caller that needs to step from a state twice keeps its own
copy (:class:`repro_torch.runtime.ft.StepRunner` keeps one on the host). A
block that left its moments alone would hold a second copy of them (two f32
values a parameter a replica) while it runs, which a full-width model on
one card cannot afford (``scripts/train_peak_memory.py``).

``telemetry=`` (a :class:`repro_torch.core.telemetry.BlockTelemetry`) wraps
a step in :func:`timed_step`; the local-SGD block also times its
``sync_point`` (CUDA events on the card), so the telemetry gets the block's
T_sync as measured. :func:`ladder_switch_state` is the H-ladder's switch.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import sharding as S
from repro_torch import tree as T
from repro_torch.config.base import TrainConfig
from repro_torch.core import collectives as CL
from repro_torch.core import sync as SY
from repro_torch.device import wait
from repro_torch.models import layers as L
from repro_torch.optim import apply_updates_, init_opt_state


# ---------------------------------------------------------------------------
# state construction
# ---------------------------------------------------------------------------

def _stack(layers):
    """Per-layer trees → one tree of ``(depth, …)`` leaves."""
    return T.map(lambda *xs: torch.stack(xs), *layers)


def init_state(model, cfg: TrainConfig, gen: torch.Generator,
               replicas: int = 0, rules=None, mesh=None):
    """Fresh state on ``gen``'s device (the draws of ``model.init``, each
    layer stack stacked into the reference's layout); ``replicas > 0`` adds
    the leading replica dim (local-SGD layout), every replica a copy of one
    draw. With mesh ``rules`` (:func:`repro_torch.sharding.training_rules`)
    each leaf is drawn whole, this rank's shard of it kept and the leaf
    freed before the next is drawn: the one-process draw's values, without
    the whole model on the rank."""
    dtype = getattr(torch, cfg.model.param_dtype)
    defs = model.param_defs()
    if rules is None:
        params = L.init_params(defs, gen, dtype)
    else:
        def shard(p, spec):
            leaf = L.init_leaf(p, gen, dtype)
            return S.shard_of(leaf, spec, mesh).clone() if any(spec) \
                else leaf
        params = S.map_with_specs(shard, defs, S.serve_specs(defs, rules))
    return state_of(params, cfg, replicas)


def state_of(params, cfg: TrainConfig, replicas: int = 0):
    """The fresh state around one draw of per-layer ``params`` (each layer
    stack stacked here), with zero moments and sync state on the params'
    device; ``replicas > 0`` as :func:`init_state`. On the meta device
    (``layers.empty_params(..., "meta")``) it sizes a state without
    drawing it."""
    for key in L.STACKS:
        if key in params:
            params[key] = _stack(params[key])
    state = {
        "params": params,
        "opt": init_opt_state(cfg.optimizer, params),
        "sync": SY.init_sync_state(cfg.sync, params),
        "step": 0,
    }
    if replicas:
        def stack(x):
            return x.unsqueeze(0).repeat((replicas,) + (1,) * x.dim())
        state = {key: (T.map(stack, value) if key != "step" else value)
                 for key, value in state.items()}
    return state


# ---------------------------------------------------------------------------
# one replica's loss and gradient
# ---------------------------------------------------------------------------

def value_and_grad(model, params, batch) -> Tuple[torch.Tensor, Dict, Dict]:
    """``model.loss`` at ``params`` (one replica, the reference's layout) and
    its gradient in the same layout: (loss, metrics, grads), all detached.

    Each layer stack is handed to the model as per-layer leaves that require
    grad, and their gradients are stacked once at the end (differentiating
    through per-layer views of the stacked leaves would add a full-size
    gradient buffer for every layer)."""
    def leaf(p):
        return p.detach().requires_grad_()
    stacks = [k for k in L.STACKS if k in params]
    view = T.map(leaf, {k: v for k, v in params.items() if k not in stacks})
    for key in stacks:
        view[key] = [T.map(leaf, lp) for lp in L.layer_list(params[key])]
    with torch.enable_grad():
        loss, metrics = model.loss(view, batch)
        flat, unflatten = T.flatten(view)
        grads = unflatten(list(torch.autograd.grad(loss, flat)))
    for key in stacks:
        grads[key] = _stack(grads[key])
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, grads


def state_specs(state, param_specs, replicated: bool):
    """The specs of a trainer state's leaves (``state``: its ``params``,
    ``opt`` and ``sync``) given one replica's param specs (:func:`repro_torch
    .sharding.train_specs`): every moment and every per-leaf sync buffer
    (``ef``, ``pending``, ``anchor``, ``slowmo_m``, ``sent``, ``mixbuf``)
    its param's, the schedule counters whole; ``replicated`` leaves the
    leading replica dim whole too."""
    lead = (None,) if replicated else ()

    def with_lead(spec):
        return lead + spec if any(spec) else ()
    params = S.map_with_specs(lambda spec, _: with_lead(spec), param_specs,
                              param_specs)
    return {"params": params,
            "opt": {name: params for name in state["opt"]},
            "sync": {name: (params if isinstance(value, dict) else ())
                     for name, value in state["sync"].items()}}


class Within:
    """The ranks of one replica on a mesh with a model axis (every mesh
    axis but the replica axis under local SGD, every axis under DDP), and
    how they hold each param leaf: ``shards``, a tree like the params of
    :class:`repro_torch.core.collectives.Shards` from the leaves' specs
    (split over the axes a spec names, repeated over the others).
    :meth:`reduce_` makes each rank's gradient of its own loss the
    reference's gradient of the whole batch's (the module docstring),
    :meth:`mean` a metric's mean over the ranks, :meth:`norm` the whole
    tree's gradient norm."""

    def __init__(self, model, cfg: TrainConfig, mesh, rules,
                 replicated: bool):
        replica_axis = cfg.mesh.replica_axis or "pod"
        axes = [a for a in mesh.axes
                if not (replicated and a == replica_axis)]
        self.n = 1
        for a in axes:
            self.n *= mesh.size(a)
        self.groups = {a: CL.Group(mesh.group(a), mesh.device, mesh.backend)
                       for a in axes if mesh.size(a) > 1}
        self.rules = rules
        self.specs = S.train_specs(model.param_defs(), rules)

        def layout(spec, _):
            used = S.spec_axes(spec)
            return CL.Shards(
                [g for a, g in self.groups.items() if a in used],
                [g for a, g in self.groups.items() if a not in used])
        self.shards = S.map_with_specs(layout, self.specs, self.specs)

    def reduce_(self, grads) -> None:
        """Each gradient leaf in place ← its sum over the ranks that hold
        the same block, divided by the replica's ranks."""
        for g, sh in zip(T.leaves(grads), T.leaves(self.shards)):
            sh.sum_copies_(g)
            g.copy_(CL._div_exact(g, self.n))

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """A 0-dim metric's mean over the replica's ranks."""
        out = x.detach().reshape(1).clone()
        for g in self.groups.values():
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=g.group)
        return CL._div_exact(out, self.n)[0]

    def norm(self, grads) -> torch.Tensor:
        """The L2 norm of the whole gradient tree: a whole leaf's squares
        counted once, a shard's summed over the ranks of its blocks."""
        parts: Dict[tuple, torch.Tensor] = {}
        split: Dict[tuple, CL.Shards] = {}
        for g, sh in zip(T.leaves(grads), T.leaves(self.shards)):
            key = tuple(id(x) for x in sh.split)
            sq = torch.sum(torch.square(g.float()))
            parts[key] = parts[key] + sq if key in parts else sq
            split[key] = sh
        total = sum(split[key].sum_split(sq.reshape(1))[0]
                    for key, sq in parts.items())
        return torch.sqrt(total)


def _within(model, cfg: TrainConfig, mesh, replicated: bool):
    """The :class:`Within` of a mesh with a model axis, else None."""
    rules = S.training_rules(cfg, mesh)
    if rules is None:
        return None
    return Within(model, cfg, mesh, rules, replicated)


def _grad_under(within, model, params, batch):
    """:func:`value_and_grad` under the mesh rules of ``within`` (None: as
    it is)."""
    if within is None:
        return value_and_grad(model, params, batch)
    with S.use_rules(within.rules):
        return value_and_grad(model, params, batch)


def _replica(tree, r: int):
    return T.map(lambda x: x[r], tree)


def _rows(batch, lo: int, hi: int):
    return {k: v[lo:hi] for k, v in batch.items()}


# ---------------------------------------------------------------------------
# flavor A — every-step sync (paper baseline / canonical DDP)
# ---------------------------------------------------------------------------

def _data_group(mesh, cfg: TrainConfig):
    """(group, size) of the mesh's within-replica data axis, or (None, 1):
    the ranks a replica's gradient is all-reduced over every step."""
    replica_axis = cfg.mesh.replica_axis or "pod"
    others = [a for a in mesh.axes if a != replica_axis and mesh.size(a) > 1]
    if not others:
        return None, 1
    if others != ["data"]:
        raise ValueError(f"the trainer splits a replica over one 'data' axis; "
                         f"the mesh has {mesh!r}")
    return mesh.group("data"), mesh.size("data")


def _world_mean(x: torch.Tensor, group, k: int) -> torch.Tensor:
    out = x.detach().reshape(1).clone()
    CL.all_reduce_mean_([out], group, k)
    return out[0]


def make_ddp_step(model, cfg: TrainConfig, *, grad_accum: int = 1,
                  telemetry=None, mesh=None) -> Callable:
    """(state, batch) → (state, metrics): one optimizer step on the gradient
    of the whole batch, written into the given state's params and optimizer
    moments (:func:`repro_torch.optim.apply_updates_`, the reference's
    donated state), which the returned state holds. ``grad_accum`` > 1
    takes the gradient over that many equal row slices of the batch, one
    after another, and averages them:
    with every position counted (no ``loss_mask``) that is the same mean
    loss, for a smaller peak of activations. With a ``mesh`` ``batch`` is
    this rank's rows (``DataPipeline(…, mesh=mesh)``) and the gradient and
    the metrics are all-reduced to their mean over every rank of the mesh
    (the reference shards the batch over all its axes), so each rank takes
    the same step. On a ``(data, model)`` mesh the state is this rank's
    shards (:func:`init_state` with the mesh rules, or
    ``interop.rank_train_state_from_jax``), the model ranks of a data row
    take its rows alike, and each leaf's gradient is reduced as the module
    docstring says; the step of every rank is then the reference's on its
    block."""
    within = (_within(model, cfg, mesh, replicated=False)
              if mesh is not None else None)

    def step(state, batch):
        b = next(iter(batch.values())).shape[0]
        if grad_accum < 1 or b % grad_accum:
            raise ValueError(f"grad_accum {grad_accum} must divide the "
                             f"batch of {b} rows")
        per = b // grad_accum
        loss, grads, aux = 0.0, None, {}
        for i in range(grad_accum):
            li, mi, gi = _grad_under(within, model, state["params"],
                                     _rows(batch, i * per, (i + 1) * per))
            if grad_accum > 1:
                li = li / grad_accum
                mi = {k: v / grad_accum for k, v in mi.items()}
                gi = T.map(lambda g: g / grad_accum, gi)
            loss = loss + li
            aux = {k: aux.get(k, 0.0) + v for k, v in mi.items()}
            grads = gi if grads is None else T.map(torch.add, grads, gi)
        norm = {}
        if within is not None:
            within.reduce_(grads)
            loss = within.mean(loss)
            aux = {k: within.mean(v) for k, v in aux.items()}
            norm = {"global_norm": within.norm}
        elif mesh is not None:
            world = mesh.size()
            CL.all_reduce_mean_(T.leaves(grads), None, world)
            loss = _world_mean(loss, None, world)
            aux = {k: _world_mean(v, None, world) for k, v in aux.items()}
        apply_updates_(cfg.optimizer, grads, state["opt"], state["params"],
                       state["step"], **norm)
        new_state = {"params": state["params"], "opt": state["opt"],
                     "sync": state["sync"], "step": state["step"] + 1}
        return new_state, {"loss": loss, **aux}

    return timed_step(step, 1, telemetry) if telemetry is not None else step


# ---------------------------------------------------------------------------
# flavor B — periodic sync over the replica dim (paper's DMS / local SGD)
# ---------------------------------------------------------------------------

def make_local_sgd_block(model, cfg: TrainConfig, *,
                         quant_impl: str = "kernel", telemetry=None,
                         mesh=None) -> Callable:
    """(state, batch) → (state, metrics).

    ``batch`` leaves are (H, B_global, …): H microbatches per sync block.
    Replica r takes rows ``[r·B/K, (r+1)·B/K)`` of every microbatch (the
    reference's in-spec ``P(None, replica_axis)``). ``quant_impl`` is the
    int8 wire's quantize/dequantize: the quant kernel or its plain version
    (``"torch"``, the comparison run). The given state's optimizer moments
    are updated in place and returned (see the module docstring); its
    params and sync state are left as they were.

    With a ``mesh`` the replicas are its ``cfg.mesh.replica_axis`` (default
    ``"pod"``, whose size must be ``cfg.mesh``'s), each rank holds one
    (:func:`scatter_replicas`), ``batch`` leaves are (H, B_local, …), this
    rank's rows (``DataPipeline(…, mesh=mesh)``), and the sync is over the
    replica axis's collectives. Where the mesh also has a ``data`` axis of
    more than one rank (``strategy="hierarchical"``, which needs one), the
    replica's gradient and loss are all-reduced over it every step. Where
    it also has a ``model`` axis (``(pod, data, model)``) each rank holds
    its shards of the replica (the module docstring), the step runs under
    the mesh rules with the replica axis stripped, and the sync runs over
    the replica axis on each rank's shards.

    ``telemetry`` records each block's wall time keyed by its H (the
    batch's leading dim, ``cfg.sync.period`` unless an H-ladder re-blocks
    the data) and its sync's time (:func:`timed_step`).
    """
    replica_axis = cfg.mesh.replica_axis or "pod"
    data_group, n_data = None, 1
    within = None
    if mesh is not None:
        k_cfg = cfg.mesh.axis_size(replica_axis)
        if mesh.size(replica_axis) != k_cfg:
            raise ValueError(f"mesh axis {replica_axis!r} has "
                             f"{mesh.size(replica_axis)} ranks, but the "
                             f"config has {k_cfg} replicas")
        within = _within(model, cfg, mesh, replicated=True)
        if within is None:
            data_group, n_data = _data_group(mesh, cfg)
    splits_data = data_group is not None or (
        within is not None and cfg.mesh.data_axis in within.groups)
    if cfg.sync.strategy == "hierarchical" and not splits_data:
        raise ValueError(
            "strategy='hierarchical' all-reduces each replica's gradient over "
            "a data axis every step: pass a (pod, data) mesh with more than "
            "one data rank (on one process 'periodic' computes the same)")
    rep = CL.replicas(mesh, replica_axis)
    clock = SyncClock() if telemetry is not None else None

    def step_fn(state, batch):
        start = state["params"]
        k = T.leaves(start)[0].shape[0]
        if mesh is not None and k != 1:
            raise ValueError(f"a rank holds one replica (leading dim 1), "
                             f"got {k}: scatter_replicas gives its share")
        h, b = next(iter(batch.values())).shape[:2]
        if b % k:
            raise ValueError(f"global batch {b} does not split over {k} "
                             f"replicas")
        per = b // k
        params = T.map(torch.clone, start)
        opt = state["opt"]
        losses = torch.zeros((k, h), dtype=torch.float32,
                             device=T.leaves(start)[0].device)
        for r in range(k):
            p_r, o_r = _replica(params, r), _replica(opt, r)
            for j in range(h):
                mb = _rows({n: v[j] for n, v in batch.items()},
                           r * per, (r + 1) * per)
                loss, _, grads = _grad_under(within, model, p_r, mb)
                norm = {}
                if within is not None:
                    within.reduce_(grads)
                    loss = within.mean(loss)
                    norm = {"global_norm": within.norm}
                elif data_group is not None:
                    CL.all_reduce_mean_(T.leaves(grads), data_group, n_data)
                    loss = _world_mean(loss, data_group, n_data)
                apply_updates_(cfg.optimizer, grads, o_r, p_r,
                               state["step"] + j, **norm)
                del grads
                losses[r, j] = loss
        step = state["step"] + h
        sync = (SY.sync_point if clock is None
                else clock.wrap(SY.sync_point))
        params, sync_state = sync(
            start, params, state["sync"], cfg.sync, impl=quant_impl,
            mesh=mesh, axis=replica_axis,
            shards=within.shards if within is not None else None)
        mean_loss = losses.mean(dim=1).mean()
        if mesh is not None:
            mean_loss = rep.mean(mean_loss.reshape(1))[0]
        metrics = {"loss": mean_loss}
        if cfg.sync.eval_at_sync:
            metrics["sync_eval_loss"] = _sync_eval_loss(
                model, cfg, params, sync_state,
                {n: v[-1] for n, v in batch.items()}, per, rep,
                data_group, n_data, within)
        return ({"params": params, "opt": opt, "sync": sync_state,
                 "step": step}, metrics)

    if telemetry is not None:
        return timed_step(step_fn, None, telemetry, sync_clock=clock,
                          mesh=mesh)
    return step_fn


def _sync_eval_loss(model, cfg: TrainConfig, params, sync_state, last_mb,
                    per: int, rep=CL.STACKED, data_group=None,
                    n_data: int = 1, within=None) -> torch.Tensor:
    """The paper's per-sync convergence check (§V-C2): each replica's loss
    on its rows of the last microbatch under the *synchronized* model,
    averaged over replicas. Under overlap the block-end params are still
    per-replica divergent, so the synchronized model is reconstructed:
    params + pending under delayed, and a replica mean under chunked and any
    gossip topology."""
    eval_params = params
    if cfg.sync.overlap == "delayed":
        eval_params = T.map(lambda p, q: (p.float() + q).to(p.dtype),
                            params, sync_state["pending"])
    if cfg.sync.overlap == "chunked" or cfg.sync.topology != "all":
        eval_params = T.map(lambda p: rep.mean(p.float())
                            .expand(p.shape).to(p.dtype), eval_params)
    k = T.leaves(params)[0].shape[0]
    with torch.no_grad(), S.use_rules(within.rules if within else None):
        losses = [model.loss(_replica(eval_params, r),
                             _rows(last_mb, r * per, (r + 1) * per))[0]
                  for r in range(k)]
    out = torch.stack(losses).mean()
    if within is not None:
        out = within.mean(out)
    elif data_group is not None:
        out = _world_mean(out, data_group, n_data)
    if rep is not CL.STACKED:
        out = rep.mean(out.reshape(1))[0]
    return out


def finalize_state(state, cfg: TrainConfig, mesh=None):
    """Make the trained state globally consistent before checkpoint/eval.

    Under ``overlap="delayed"``/``"chunked"`` and any gossip topology the
    replicas are divergent between blocks; this collapses params to the
    fully synchronized model (``sync.flush_overlap``) and clears the pending
    correction and the error-feedback residual (the flush folds the EF into
    the params), and re-seeds the async double buffers from the flushed
    model. A no-op for ``overlap="none"`` with ``topology="all"``. With a
    ``mesh`` the state is this rank's replica and the collapse is a mean
    over the replica axis.
    """
    if cfg.sync.overlap == "none" and cfg.sync.topology == "all":
        return state
    new_sync = dict(state["sync"])
    if "pending" in new_sync:
        new_sync["pending"] = T.map(torch.zeros_like, new_sync["pending"])
    if "ef" in new_sync:
        new_sync["ef"] = T.map(torch.zeros_like, new_sync["ef"])
    flushed = SY.flush_overlap(state["params"], state["sync"], cfg.sync,
                               mesh=mesh, axis=cfg.mesh.replica_axis or "pod")
    if "sent" in new_sync:
        new_sync["sent"], new_sync["mixbuf"] = SY.init_async_buffers(
            flushed, cfg.sync.topology)
    return {**state, "params": flushed, "sync": new_sync}


def ladder_switch_state(state, cfg: TrainConfig, mesh=None):
    """Exact state for resuming the schedule at a *different* H mid-run —
    the H-ladder runtime's switch transform (layout-preserving).

    :func:`finalize_state` collapses the replicas to the fully synchronized
    model and zeroes/re-seeds the carried sync buffers (pending correction,
    EF residual, async ``sent``/``mixbuf``); on top of that the schedule
    *counters* restart (``chunk_idx``, ``gossip_round`` → 0) and the
    chunked-slowmo ``anchor`` re-seeds from the flushed params — exactly
    :func:`repro_torch.core.sync.init_sync_state` evaluated at the flushed
    model. The result is therefore bit-identical to launching a fresh run at
    the new H from the flushed model (with the optimizer state and the
    slowmo outer momentum carried over). Under the blocking global sync with
    error feedback, where the flush is a no-op, the EF residual's replica
    mean is folded into the params (what the next sync's average would have
    spread to every replica) and the buffer zeroed. The state given is left
    as it was; a returned leaf may be one of its tensors. With a ``mesh``
    the state is this rank's replica and every replica mean is over the
    replica axis (the same stacked mean as one process's, so the switched
    state is bitwise the one-process switch's row for this replica).
    """
    sync = state["sync"]
    if (cfg.sync.overlap == "none" and cfg.sync.topology == "all"
            and "ef" in sync):
        rep = CL.replicas(mesh, cfg.mesh.replica_axis or "pod")
        params = T.map(lambda p, e: (p.float() + rep.mean(e)).to(p.dtype),
                       state["params"], sync["ef"])
        state = {**state, "params": params,
                 "sync": {**sync, "ef": T.map(torch.zeros_like, sync["ef"])}}
    state = finalize_state(state, cfg, mesh)
    new_sync = dict(state["sync"])
    for counter in ("chunk_idx", "gossip_round"):
        if counter in new_sync:
            new_sync[counter] = torch.zeros_like(new_sync[counter])
    if "anchor" in new_sync:
        new_sync["anchor"] = T.map(lambda p: p.to(torch.float32, copy=True),
                                   state["params"])
    return {**state, "sync": new_sync}


# ---------------------------------------------------------------------------
# block-time telemetry
# ---------------------------------------------------------------------------

class SyncClock:
    """Times the sync of each block: CUDA events around it on the card
    (read once the block has been waited for), the host clock on the
    CPU."""

    def __init__(self):
        self._last = None

    def wrap(self, fn: Callable) -> Callable:
        def timed(params_start, *args, **kw):
            if T.leaves(params_start)[0].is_cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(params_start, *args, **kw)
                end.record()
                self._last = (start, end)
            else:
                t0 = time.perf_counter()
                out = fn(params_start, *args, **kw)
                self._last = time.perf_counter() - t0
            return out
        return timed

    def take(self) -> Optional[float]:
        """Seconds of the last sync timed since the last ``take``, or None;
        on the card call it after the block has been waited for."""
        last, self._last = self._last, None
        if isinstance(last, tuple):
            return last[0].elapsed_time(last[1]) * 1e-3
        return last


def timed_step(step_fn: Callable, h: Optional[int], telemetry, *,
               sync_clock: Optional[SyncClock] = None,
               mesh=None) -> Callable:
    """Wrap a (state, batch) step with the block-time telemetry hook.

    The timer brackets the host-side call and waits for the card on the
    returned params (``torch.cuda.synchronize``, the reference's
    ``block_until_ready``), so the wall time is the device's too. ``h`` is
    the optimizer steps one call advances — the telemetry's key for
    separating T_step from T_sync (see ``core.telemetry``); ``None`` reads
    it from the batch's leading dim (a block of H microbatches); with a
    ``sync_clock`` that the step times its sync with, the block's T_sync
    goes in beside it and the split is exact. The reference's ``jit_step``
    parameter is gone: the port has no jit, so the step is timed as it is
    (the reference's ``jit_step=False``). The telemetry's warmup discards
    the first sample, inflated by a first kernel load. With a ``mesh`` the
    block wall and the sync seconds are each the max over the world's ranks
    (one all-reduce a block, :func:`repro_torch.core.collectives.max_over`),
    so every rank's telemetry holds the same samples: the world's block, as
    slow as its slowest rank, as the reference's one controller sees it.
    """
    def timed(state, batch):
        t0 = time.perf_counter()
        out = step_fn(state, batch)
        wait(out[0]["params"])
        wall = time.perf_counter() - t0
        sync_s = sync_clock.take() if sync_clock is not None else None
        if mesh is not None:
            wall, sync_s = CL.max_over(
                [wall, -1.0 if sync_s is None else sync_s])
            sync_s = None if sync_s < 0 else sync_s
        steps = h if h is not None else next(iter(batch.values())).shape[0]
        telemetry.record_block(steps, wall, sync_s)
        return out
    return timed


# ---------------------------------------------------------------------------
# the K-replica state across ranks
# ---------------------------------------------------------------------------

def _replicated_parts(state):
    return [key for key in ("params", "opt", "sync") if key in state]


def scatter_replicas(state, mesh, axis: str = "pod"):
    """This rank's share of a one-process K-replica state (every leaf of
    params/opt/sync stacked on a leading dim of K = ``mesh``'s ``axis``):
    replica ``mesh.rank(axis)``, its leaves with a leading dim of 1, copied
    onto the mesh's device; ``step`` as it is. Every rank passes the same
    state (``interop.lm_train_state_from_jax`` followed by this gives
    every rank the reference's state). The port's ``state_shardings``."""
    k, r = mesh.size(axis), mesh.rank(axis)
    out = dict(state)
    for key in _replicated_parts(state):
        def share(x):
            if x.shape[0] != k:
                raise ValueError(f"a {key} leaf of leading dim {x.shape[0]} "
                                 f"is not stacked over the {k} replicas of "
                                 f"axis {axis!r}")
            return x[r:r + 1].to(mesh.device, copy=True)
        out[key] = T.map(share, state[key])
    return out


def gather_replicas(state, mesh, axis: str = "pod"):
    """The one-process K-replica state from every rank's share along
    ``mesh``'s ``axis`` (a collective: every rank calls it, and gets the
    whole state on its device); the inverse of :func:`scatter_replicas`."""
    rep = CL.replicas(mesh, axis)
    out = dict(state)
    for key in _replicated_parts(state):
        out[key] = T.map(rep.gather, state[key])
    return out


def rank_state_specs(model, cfg: TrainConfig, mesh, state):
    """The specs of this rank's share of a trainer state on ``mesh``
    (:func:`state_specs` of the mesh rules' :func:`repro_torch.sharding
    .train_specs`: every params leaf, moment and per-leaf sync buffer as
    ``spec_for`` splits its param), or None where the mesh has no model
    axis (every leaf whole)."""
    rules = S.training_rules(cfg, mesh)
    if rules is None:
        return None
    return state_specs(state, S.train_specs(model.param_defs(), rules),
                       SY.needs_replica_axis(cfg.sync))


def gather_shards(state, specs, mesh):
    """Each params/opt/sync leaf of this rank's share put back together
    from the blocks its ``specs`` (:func:`rank_state_specs`) split it into
    (a collective over the axes of each spec: every rank calls it, and
    gets the whole leaves on its device); the inverse of
    ``sharding.shard_tree``."""
    groups = {}

    def whole(x, spec):
        for dim in range(len(spec) - 1, -1, -1):
            # the last axis of an entry varies fastest: gather it first
            for axis in reversed(S.entry_axes(spec[dim])):
                if axis not in groups:
                    groups[axis] = CL.Group(mesh.group(axis), mesh.device,
                                            mesh.backend)
                x = groups[axis]._gather_dim(x, dim)
        return x
    out = dict(state)
    for key in _replicated_parts(state):
        out[key] = S.map_with_specs(whole, state[key], specs[key])
    return out


def make_train_step(model, cfg: TrainConfig, *, quant_impl: str = "kernel",
                    telemetry=None, mesh=None) -> Callable:
    if SY.needs_replica_axis(cfg.sync):
        return make_local_sgd_block(model, cfg, quant_impl=quant_impl,
                                    telemetry=telemetry, mesh=mesh)
    return make_ddp_step(model, cfg, telemetry=telemetry, mesh=mesh)
