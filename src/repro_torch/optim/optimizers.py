"""Optimizers as functions over param trees, the port of
``repro.optim.optimizers``.

Params, gradients and moments are nested dicts of tensors of one structure
(:mod:`repro_torch.tree`). ``init_opt_state`` builds the state,
``apply_updates`` maps ``(grads, state, params, step) → (new_params,
new_state)`` and leaves its inputs as they were, as the reference's pure
functions do; ``apply_updates_`` writes the same values into the params and
moments it is given, leaf by leaf. Every update is computed in f32, in the
reference's order of operations; the learning rate is an f32 scalar
computed as the reference computes it.

Schedules include the paper's ``α = 1/(1+t)`` epoch-decaying rate
(``paper_inverse``), used by the SVM reproduction.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Union

import torch

from repro_torch import tree as T
from repro_torch.config.base import OptimizerConfig

OptState = Dict[str, Any]
Step = Union[int, torch.Tensor]


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def make_schedule(cfg: OptimizerConfig) -> Callable[[Step], torch.Tensor]:
    """step (int) → learning rate (f32 0-dim tensor on the CPU)."""
    base = cfg.learning_rate

    if cfg.schedule == "constant":
        return lambda step: _f32(base)

    if cfg.schedule == "paper_inverse":
        # the paper's α = 1/(1+t); `t` is the epoch/step counter. `base`
        # rescales (paper uses base=1).
        return lambda step: _f32(base) / (1.0 + _f32(step))

    if cfg.schedule == "cosine":
        warm = max(1, cfg.warmup_steps)
        total = max(cfg.total_steps, warm + 1)

        def sched(step):
            step = _f32(step)
            warm_lr = base * step / warm
            prog = torch.clamp((step - warm) / (total - warm), 0.0, 1.0)
            cos_lr = 0.5 * base * (1.0 + torch.cos(math.pi * prog))
            return torch.where(step < warm, warm_lr, cos_lr)

        return sched

    raise ValueError(f"unknown schedule {cfg.schedule!r}")


# ---------------------------------------------------------------------------
# state init
# ---------------------------------------------------------------------------

def init_opt_state(cfg: OptimizerConfig, params) -> OptState:
    mdt = getattr(torch, cfg.moment_dtype)

    def zeros_like():
        return T.map(lambda p: torch.zeros(p.shape, dtype=mdt,
                                           device=p.device), params)
    if cfg.name == "sgd":
        return {}
    if cfg.name == "momentum":
        return {"mu": zeros_like()}
    if cfg.name == "adamw":
        return {"mu": zeros_like(), "nu": zeros_like()}
    raise ValueError(f"unknown optimizer {cfg.name!r}")


# ---------------------------------------------------------------------------
# update rules
# ---------------------------------------------------------------------------

def _global_norm(tree) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(x.float())) for x in T.leaves(tree))
    return torch.sqrt(sq)


def _maybe_clip(grads, clip: float, global_norm=_global_norm):
    if not clip:
        return grads
    norm = global_norm(grads)
    scale = torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)
    return T.map(lambda g: (g * scale).to(g.dtype), grads)


MOMENTS = {"sgd": (), "momentum": ("mu",), "adamw": ("mu", "nu")}


def _into(t: torch.Tensor) -> Optional[torch.Tensor]:
    """``t`` where an f32 result can be written into it, else None (the
    result is a new f32 tensor, rounded into ``t`` after its last use)."""
    return t if t.dtype == torch.float32 else None


def _leaf_update_(cfg: OptimizerConfig, lr, bc, p, g, moments) -> None:
    """One leaf's update, in f32 in the reference's order of operations,
    written into ``p`` and its moments: each one's last operation writes its
    result there (``out=``); its temporaries die when it returns."""
    p32 = p.float()
    if cfg.weight_decay:
        p32 = p32 * (1.0 - lr * cfg.weight_decay)
    if cfg.name == "sgd":
        torch.sub(p32, lr * g.float(), out=p)
        return
    if cfg.name == "momentum":
        (m,) = moments
        m32 = torch.add(cfg.momentum * m.float(), g.float(), out=_into(m))
        torch.sub(p32, lr * m32, out=p)
        new = (m32,)
    else:
        m, v = moments
        g32 = g.float()
        m32 = torch.add(cfg.beta1 * m.float(), (1 - cfg.beta1) * g32,
                        out=_into(m))
        v32 = torch.add(cfg.beta2 * v.float(), (1 - cfg.beta2) * g32 * g32,
                        out=_into(v))
        mhat = m32 / bc[0]
        vhat = v32 / bc[1]
        torch.sub(p32, lr * mhat / (torch.sqrt(vhat) + cfg.eps), out=p)
        new = (m32, v32)
    for mom, m32 in zip(moments, new):
        if m32 is not mom:
            mom.copy_(m32)


def apply_updates_(cfg: OptimizerConfig, grads, state: OptState, params,
                   step: Step, lr: Optional[torch.Tensor] = None,
                   global_norm: Callable = _global_norm) -> None:
    """The update written into ``params`` and ``state``'s moments leaf by
    leaf, as the reference's trainer donates its state to the jitted step
    and XLA updates the buffers in place: no second copy of the params or
    moments is alive at once, only one leaf's temporaries. ``step`` is the
    global step counter. ``global_norm`` (grads → 0-dim) is the norm that
    ``grad_clip`` reads: on a mesh the whole tree's over its ranks'
    shards."""
    if cfg.name not in MOMENTS:
        raise ValueError(f"unknown optimizer {cfg.name!r}")
    if lr is None:
        lr = make_schedule(cfg)(step)
    bc = None
    if cfg.name == "adamw":
        t = _f32(step) + 1.0
        bc = (1.0 - torch.pow(_f32(cfg.beta1), t),
              1.0 - torch.pow(_f32(cfg.beta2), t))
    grads = _maybe_clip(grads, cfg.grad_clip, global_norm)
    flat = T.leaves(params)
    moments = [T.leaves(state[name]) for name in MOMENTS[cfg.name]]
    per_leaf = list(zip(*moments)) if moments else [()] * len(flat)
    for p, g, ms in zip(flat, T.leaves(grads), per_leaf):
        _leaf_update_(cfg, lr, bc, p, g, ms)


def apply_updates(cfg: OptimizerConfig, grads, state: OptState, params,
                  step: Step, lr: Optional[torch.Tensor] = None):
    """Returns (new_params, new_state), the inputs left as they were: the
    values :func:`apply_updates_` writes, into copies."""
    new_params = T.map(torch.clone, params)
    new_state = T.map(torch.clone, state)
    apply_updates_(cfg, grads, new_state, new_params, step, lr)
    return new_params, new_state
