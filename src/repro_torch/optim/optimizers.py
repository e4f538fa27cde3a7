"""Optimizers as functions over param trees, the port of
``repro.optim.optimizers``.

Params, gradients and moments are nested dicts of tensors of one structure
(:mod:`repro_torch.tree`). ``init_opt_state`` builds the state,
``apply_updates`` maps ``(grads, state, params, step) → (new_params,
new_state)`` and leaves its inputs as they were, as the reference's pure
functions do. Every update is computed in f32, in the reference's order of
operations; the learning rate is an f32 scalar computed as the reference
computes it.

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


def _maybe_clip(grads, clip: float):
    if not clip:
        return grads
    norm = _global_norm(grads)
    scale = torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)
    return T.map(lambda g: (g * scale).to(g.dtype), grads)


def apply_updates(cfg: OptimizerConfig, grads, state: OptState, params,
                  step: Step, lr: Optional[torch.Tensor] = None):
    """Returns (new_params, new_state). ``step`` is the global step counter."""
    if lr is None:
        lr = make_schedule(cfg)(step)
    grads = _maybe_clip(grads, cfg.grad_clip)

    if cfg.name == "sgd":
        def upd(p, g):
            p32 = p.float()
            if cfg.weight_decay:
                p32 = p32 * (1.0 - lr * cfg.weight_decay)
            return (p32 - lr * g.float()).to(p.dtype)
        return T.map(upd, params, grads), state

    if cfg.name == "momentum":
        flat, unflatten = T.flatten(params)
        new_p, new_mu = [], []
        for p, g, m in zip(flat, T.leaves(grads), T.leaves(state["mu"])):
            m32 = cfg.momentum * m.float() + g.float()
            p32 = p.float()
            if cfg.weight_decay:
                p32 = p32 * (1.0 - lr * cfg.weight_decay)
            new_p.append((p32 - lr * m32).to(p.dtype))
            new_mu.append(m32.to(m.dtype))
        return unflatten(new_p), {"mu": unflatten(new_mu)}

    if cfg.name == "adamw":
        t = _f32(step) + 1.0
        bc1 = 1.0 - torch.pow(_f32(cfg.beta1), t)
        bc2 = 1.0 - torch.pow(_f32(cfg.beta2), t)
        flat, unflatten = T.flatten(params)
        new_p, new_mu, new_nu = [], [], []
        for p, g, m, v in zip(flat, T.leaves(grads), T.leaves(state["mu"]),
                              T.leaves(state["nu"])):
            g32 = g.float()
            m32 = cfg.beta1 * m.float() + (1 - cfg.beta1) * g32
            v32 = cfg.beta2 * v.float() + (1 - cfg.beta2) * g32 * g32
            mhat = m32 / bc1
            vhat = v32 / bc2
            p32 = p.float()
            if cfg.weight_decay:
                p32 = p32 * (1.0 - lr * cfg.weight_decay)
            p32 = p32 - lr * mhat / (torch.sqrt(vhat) + cfg.eps)
            new_p.append(p32.to(p.dtype))
            new_mu.append(m32.to(m.dtype))
            new_nu.append(v32.to(v.dtype))
        return unflatten(new_p), {"mu": unflatten(new_mu),
                                  "nu": unflatten(new_nu)}

    raise ValueError(f"unknown optimizer {cfg.name!r}")
