"""Local-SGD (MSF) trainer: the paper's DMS algorithm generalized to LMs, the
port of ``repro.core.local_sgd`` on one card.

Two step flavors, selected by ``SyncConfig.strategy``:

* ``sync_every_step`` → :func:`make_ddp_step`: one optimizer step on the
  gradient of the whole global batch (the paper's MSF = 1 analog).
* ``periodic`` → :func:`make_local_sgd_block`: K replicas each take H
  optimizer steps on their own rows of every microbatch, then average
  (:func:`repro_torch.core.sync.sync_point`). ``hierarchical`` needs a data
  axis across cards (ROADMAP §1 item 9) and raises.

State layout (plain dict), the reference's:

    {"params": …, "opt": …, "sync": …, "step": int}

Params are the reference's tree, one tensor per reference leaf with the
layer stack as ``(n_layers, …)`` leaves, in sorted-key leaf order (so a sync
quantizes and shards each leaf as the reference does, about a dozen kernel
calls a sync). Under local SGD every leaf of params/opt/sync gains a leading
replica dim K; the model reads per-layer views of one replica's leaves.
Optimizer moments stay local to each replica between syncs.

On one card the replicas' local steps run one replica after another, so only
one replica's activations are alive at a time. A block keeps the params it
started from (the sync's ``params_start``) and steps a copy of them in place;
the optimizer moments of the state it is given are updated in place (the
reference donates the state to its jitted block).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch import tree as T
from repro_torch.config.base import TrainConfig
from repro_torch.core import sync as S
from repro_torch.models import layers as L
from repro_torch.optim import apply_updates, init_opt_state


# ---------------------------------------------------------------------------
# state construction
# ---------------------------------------------------------------------------

def init_state(model, cfg: TrainConfig, gen: torch.Generator,
               replicas: int = 0):
    """Fresh state on ``gen``'s device (the draws of ``model.init``, its
    layers stacked into the reference's layout); ``replicas > 0`` adds the
    leading replica dim (local-SGD layout), every replica a copy of one
    draw."""
    params = L.init_params(model.param_defs(), gen,
                           getattr(torch, cfg.model.param_dtype))
    params["layers"] = T.map(lambda *xs: torch.stack(xs), *params["layers"])
    state = {
        "params": params,
        "opt": init_opt_state(cfg.optimizer, params),
        "sync": S.init_sync_state(cfg.sync, params),
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

    The layer stack is handed to the model as per-layer leaves that require
    grad, and their gradients are stacked once at the end (differentiating
    through per-layer views of the stacked leaves would add a full-size
    gradient buffer for every layer)."""
    layers = L.layer_list(params["layers"])
    view = {k: v for k, v in params.items() if k != "layers"}
    view = T.map(lambda p: p.detach().requires_grad_(), view)
    view["layers"] = [T.map(lambda p: p.detach().requires_grad_(), lp)
                      for lp in layers]
    with torch.enable_grad():
        loss, metrics = model.loss(view, batch)
        flat, unflatten = T.flatten(view)
        grads = unflatten(list(torch.autograd.grad(loss, flat)))
    grads["layers"] = T.map(lambda *xs: torch.stack(xs), *grads["layers"])
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, grads


def _replica(tree, r: int):
    return T.map(lambda x: x[r], tree)


def _write(dst_tree, src_tree) -> None:
    for dst, src in zip(T.leaves(dst_tree), T.leaves(src_tree)):
        dst.copy_(src)


def _rows(batch, lo: int, hi: int):
    return {k: v[lo:hi] for k, v in batch.items()}


# ---------------------------------------------------------------------------
# flavor A — every-step sync (paper baseline / canonical DDP)
# ---------------------------------------------------------------------------

def make_ddp_step(model, cfg: TrainConfig, *, grad_accum: int = 1
                  ) -> Callable:
    """(state, batch) → (state, metrics): one optimizer step on the gradient
    of the whole batch. ``grad_accum`` > 1 takes the gradient over that many
    equal row slices of the batch, one after another, and averages them:
    with every position counted (no ``loss_mask``) that is the same mean
    loss, for a smaller peak of activations."""
    def step(state, batch):
        b = next(iter(batch.values())).shape[0]
        if grad_accum < 1 or b % grad_accum:
            raise ValueError(f"grad_accum {grad_accum} must divide the "
                             f"batch of {b} rows")
        per = b // grad_accum
        loss, grads, aux = 0.0, None, {}
        for i in range(grad_accum):
            li, mi, gi = value_and_grad(model, state["params"],
                                        _rows(batch, i * per, (i + 1) * per))
            if grad_accum > 1:
                li = li / grad_accum
                mi = {k: v / grad_accum for k, v in mi.items()}
                gi = T.map(lambda g: g / grad_accum, gi)
            loss = loss + li
            aux = {k: aux.get(k, 0.0) + v for k, v in mi.items()}
            grads = gi if grads is None else T.map(torch.add, grads, gi)
        params, opt = apply_updates(cfg.optimizer, grads, state["opt"],
                                    state["params"], state["step"])
        new_state = {"params": params, "opt": opt, "sync": state["sync"],
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, **aux}

    return step


# ---------------------------------------------------------------------------
# flavor B — periodic sync over the replica dim (paper's DMS / local SGD)
# ---------------------------------------------------------------------------

def make_local_sgd_block(model, cfg: TrainConfig, *,
                         quant_impl: str = "kernel") -> Callable:
    """(state, batch) → (state, metrics).

    ``batch`` leaves are (H, B_global, …): H microbatches per sync block.
    Replica r takes rows ``[r·B/K, (r+1)·B/K)`` of every microbatch (the
    reference's in-spec ``P(None, replica_axis)``). ``quant_impl`` is the
    int8 wire's quantize/dequantize: the quant kernel or its plain version
    (``"torch"``, the comparison run).
    """
    if cfg.sync.strategy == "hierarchical":
        raise NotImplementedError(
            "strategy='hierarchical' syncs a data axis across cards every "
            "step; the port has one card so far (ROADMAP §1 item 9)")

    def step_fn(state, batch):
        start = state["params"]
        k = T.leaves(start)[0].shape[0]
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
                loss, _, grads = value_and_grad(model, p_r, mb)
                new_p, new_o = apply_updates(cfg.optimizer, grads, o_r, p_r,
                                             state["step"] + j)
                _write(p_r, new_p)
                _write(o_r, new_o)
                losses[r, j] = loss
        step = state["step"] + h
        params, sync_state = S.sync_point(start, params, state["sync"],
                                          cfg.sync, impl=quant_impl)
        metrics = {"loss": losses.mean(dim=1).mean()}
        if cfg.sync.eval_at_sync:
            metrics["sync_eval_loss"] = _sync_eval_loss(
                model, cfg, params, sync_state,
                {n: v[-1] for n, v in batch.items()}, per)
        return ({"params": params, "opt": opt, "sync": sync_state,
                 "step": step}, metrics)

    return step_fn


def _sync_eval_loss(model, cfg: TrainConfig, params, sync_state, last_mb,
                    per: int) -> torch.Tensor:
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
        eval_params = T.map(lambda p: p.float().mean(dim=0, keepdim=True)
                            .expand(p.shape).to(p.dtype), eval_params)
    k = T.leaves(params)[0].shape[0]
    with torch.no_grad():
        losses = [model.loss(_replica(eval_params, r),
                             _rows(last_mb, r * per, (r + 1) * per))[0]
                  for r in range(k)]
    return torch.stack(losses).mean()


def finalize_state(state, cfg: TrainConfig):
    """Make the trained state globally consistent before checkpoint/eval.

    Under ``overlap="delayed"``/``"chunked"`` and any gossip topology the
    replicas are divergent between blocks; this collapses params to the
    fully synchronized model (``sync.flush_overlap``) and clears the pending
    correction and the error-feedback residual (the flush folds the EF into
    the params), and re-seeds the async double buffers from the flushed
    model. A no-op for ``overlap="none"`` with ``topology="all"``.
    """
    if cfg.sync.overlap == "none" and cfg.sync.topology == "all":
        return state
    new_sync = dict(state["sync"])
    if "pending" in new_sync:
        new_sync["pending"] = T.map(torch.zeros_like, new_sync["pending"])
    if "ef" in new_sync:
        new_sync["ef"] = T.map(torch.zeros_like, new_sync["ef"])
    flushed = S.flush_overlap(state["params"], state["sync"], cfg.sync)
    if "sent" in new_sync:
        new_sync["sent"], new_sync["mixbuf"] = S.init_async_buffers(
            flushed, cfg.sync.topology)
    return {**state, "params": flushed, "sync": new_sync}


def make_train_step(model, cfg: TrainConfig, *,
                    quant_impl: str = "kernel") -> Callable:
    if S.needs_replica_axis(cfg.sync):
        return make_local_sgd_block(model, cfg, quant_impl=quant_impl)
    return make_ddp_step(model, cfg)
