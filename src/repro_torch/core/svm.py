"""Paper-faithful SGD-SVM in PyTorch: Algorithms 1 (SGD), 2 (SRDMS), 3 (DMS).

The port of ``repro.core.svm`` (see its module docstring for the math and
the overlap/topology modes). Hinge objective ``J = ½‖w‖² + C·Σ max(0, 1 −
y⟨w,x⟩)``; a block's points all start from the same ``w`` and the block's
update is ``w ← w − α·mean_i ∇Jᵢ(w)`` with ``α = 1/(1+t)`` per epoch, so

    DMS(K workers, block s_b)  ≡  SRDMS(block K·s_b)   (exactly, in fp64)

* :func:`seq_sgd` — Algorithm 1, a Python loop over points.
* :func:`srdms`   — Algorithm 2, a Python loop over blocks.
* :func:`dms`     — Algorithm 3. ``backend="vmap"`` runs the K workers on one
  device as an explicit leading worker dim: each block is ONE batched
  gradient call for all K workers (one kernel launch on the card), followed
  by the sync as a mean or a gossip mixing matrix over that dim.

``grad_impl="kernel"`` (the default) sends the block gradient through the
hand-written CUDA hinge kernel on CUDA tensors (:mod:`repro_torch.kernels.hinge`)
and through its plain version on CPU tensors; ``grad_impl="torch"`` always
takes the plain version, the comparison run on the card.

Entry points take ``device=`` (default ``"cuda"``) and raise if CUDA is
absent; pass ``device="cpu"`` to run on the CPU. Arithmetic is in the dtype of
``w0`` (float32 by default, as the reference's ``jnp.zeros(d)``); the data is
cast to it, as the reference's ``jnp.asarray`` does without x64.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.hinge import ops as hinge_ops
from repro_torch.kernels.hinge import ref as hinge_ref

ArrayLike = Union[torch.Tensor, np.ndarray]
OVERLAPS = ("none", "delayed", "chunked")


def _alpha(t: int, dtype: torch.dtype) -> torch.Tensor:
    """``α = 1/(1+t)`` rounded once, in the working dtype (reference
    ``svm.py:123``). A 0-dim CPU tensor: it scales device tensors as a
    scalar, with no copy to the device."""
    one = torch.ones((), dtype=dtype)
    return one / (one + t)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def hinge_objective(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    c: float = 1.0) -> torch.Tensor:
    """Paper eq. (2): ½‖w‖² + C·Σ hinge."""
    margins = 1.0 - y * (x @ w)
    return 0.5 * torch.dot(w, w) + c * torch.sum(torch.clamp(margins, min=0.0))


def accuracy(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Share of correct signs, as float32 in every working dtype (the
    reference's ``jnp.mean`` of a bool array is float32 even under x64).

    Computed as the reference computes it, the count times ``float32(1/n)``:
    a division rounds differently at some counts, by one float32 ulp."""
    pred = torch.where(x @ w >= 0, 1.0, -1.0).to(y.dtype)
    count = (pred == y).sum().to(torch.float32)
    return count * torch.tensor(1.0 / y.numel(), dtype=torch.float32)


def _padded_width(d: int, chunks: int) -> int:
    """Feature count padded up to a chunk multiple (the chunked carry width)."""
    return -(-d // chunks) * chunks


def block_grad(w: torch.Tensor, xb: torch.Tensor, yb: torch.Tensor, c: float,
               impl: str = "kernel") -> torch.Tensor:
    """Mean subgradient of a block (same incoming w for every point).

    ``∇ = w − C·mean_i(violᵢ·yᵢ·xᵢ)`` where viol = 1{1 − y⟨w,x⟩ > 0}. Takes
    the batched forms of :func:`repro_torch.kernels.hinge.ref.hinge_block_grad`
    too: xb ``(K, n, d)`` with w ``(d,)`` or ``(K, d)``.
    """
    if impl == "kernel":
        return hinge_ops.hinge_block_grad(w, xb, yb, c)
    if impl == "torch":
        return hinge_ref.hinge_block_grad(w, xb, yb, c)
    raise ValueError(f"unknown grad impl: {impl!r} (kernel | torch)")


def _point_update(w, x, y, alpha, c):
    """Algorithm 1 inner step (single point)."""
    margin = 1.0 - y * torch.dot(x, w)
    grad = torch.where(margin > 0, w - c * y * x, w)
    return w - alpha * grad


def _as(v: ArrayLike, device: torch.device,
        dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    return torch.as_tensor(v, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Algorithm 1 — sequential SGD
# ---------------------------------------------------------------------------

def seq_sgd(w0: ArrayLike, x: ArrayLike, y: ArrayLike, *, epochs: int,
            c: float = 1.0, device: Union[str, torch.device] = "cuda"
            ) -> torch.Tensor:
    dev = resolve_device(device)
    w = _as(w0, dev)
    x, y = _as(x, dev, w.dtype), _as(y, dev, w.dtype)
    for t in range(epochs):
        alpha = _alpha(t, w.dtype)
        for i in range(x.shape[0]):
            w = _point_update(w, x[i], y[i], alpha, c)
    return w


# ---------------------------------------------------------------------------
# Algorithm 2 — SRDMS (sequential replica of the distributed algorithm)
# ---------------------------------------------------------------------------

def srdms(w0: ArrayLike, x: ArrayLike, y: ArrayLike, *, epochs: int,
          block_size: int, c: float = 1.0, grad_impl: str = "kernel",
          x_cv: Optional[ArrayLike] = None, y_cv: Optional[ArrayLike] = None,
          with_history: bool = False, eval_every_sync: bool = False,
          device: Union[str, torch.device] = "cuda"):
    """Algorithm 2. Data is truncated to a whole number of blocks.

    With ``with_history`` returns ``(w, (objective, cv_accuracy))``, one
    entry per epoch (accuracy NaN without cv arrays). ``eval_every_sync``
    recomputes both at EVERY block, as the paper's §V-C2 methodology does,
    and keeps each epoch's last.
    """
    dev = resolve_device(device)
    w = _as(w0, dev)
    x, y = _as(x, dev, w.dtype), _as(y, dev, w.dtype)
    if x_cv is not None:
        x_cv, y_cv = _as(x_cv, dev, w.dtype), _as(y_cv, dev, w.dtype)
    n, d = x.shape
    nb = n // block_size
    xb = x[: nb * block_size].reshape(nb, block_size, d)
    yb = y[: nb * block_size].reshape(nb, block_size)

    def evaluate(w):
        obj = hinge_objective(w, x, y, c)
        acc = (accuracy(w, x_cv, y_cv) if x_cv is not None
               else torch.tensor(float("nan"), device=dev))
        return obj, acc

    hist = []
    for t in range(epochs):
        alpha = _alpha(t, w.dtype)
        stats = None
        for i in range(nb):
            w = w - alpha * block_grad(w, xb[i], yb[i], c, grad_impl)
            if eval_every_sync:
                stats = evaluate(w)
        if with_history:
            stats = evaluate(w)
        if stats is not None:
            hist.append(stats)
    if not (with_history or eval_every_sync):
        return w
    return w, (torch.stack([h[0] for h in hist]),
               torch.stack([h[1] for h in hist]))


# ---------------------------------------------------------------------------
# Algorithm 3 — DMS (distributed model synchronizing SGD)
# ---------------------------------------------------------------------------

def _shard_data(x: ArrayLike, y: ArrayLike, k: int):
    """Equal-load split across K workers (paper's load balancing)."""
    n = (x.shape[0] // k) * k
    return (x[:n].reshape(k, n // k, -1), y[:n].reshape(k, n // k))


def _dms_vmap(w0: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor, *,
              epochs: int, block_size: int, c: float, grad_impl: str,
              overlap: str = "none", chunks: int = 4, topology: str = "all",
              gossip_async: bool = False) -> torch.Tensor:
    """K workers on one device: xs ``(K, n_local, d)``. Every worker holds its
    own w between syncs; the sync is a mean over the worker dim after each
    block (blocking), stale-by-one (delayed) or one w-segment per block
    (chunked). ``topology != "all"`` replaces the mean with the gossip mixing
    matrix ``w ← M w`` (``costmodel.mixing_matrices``). ``gossip_async``
    mixes the *last transmitted* snapshot: the boundary applies the banked
    correction, then banks ``M·(post-correction w) − w`` for the next."""
    k, n_local, d = xs.shape
    nb = n_local // block_size
    # (K, nb, bs, d) view; block i is the worker-major view xb[:, i], which
    # the kernel reads in place through its worker stride
    xb = xs[:, : nb * block_size].reshape(k, nb, block_size, d)
    yb = ys[:, : nb * block_size].reshape(k, nb, block_size)
    dtype, dev = w0.dtype, w0.device

    def grads_of(w, i):
        return block_grad(w, xb[:, i], yb[:, i], c, grad_impl)

    if topology != "all":
        from repro_torch.core import costmodel
        mats = [torch.as_tensor(m, dtype=dtype, device=dev)
                for m in costmodel.mixing_matrices(k, topology)]

        def mix(w, rnd):
            """w (K, cols) ← M_rnd w; rnd selects the pairwise parity."""
            return mats[rnd % 2 if len(mats) > 1 else 0] @ w

        dp = _padded_width(d, chunks) if overlap == "chunked" else d
        seg = dp // chunks
        wk = torch.zeros((k, dp), dtype=dtype, device=dev)
        wk[:, :d] = w0
        pending = torch.zeros((k, dp), dtype=dtype, device=dev)
        cnt = 0
        for t in range(epochs):
            alpha = _alpha(t, dtype)
            for i in range(nb):
                grads = grads_of(wk[:, :d], i)
                if dp != d:
                    grads = torch.nn.functional.pad(grads, (0, dp - d))
                w_end = wk - alpha * grads
                if gossip_async:
                    # apply the correction banked at the previous boundary,
                    # then bank M·(post-correction snapshot) − it
                    wk = w_end + pending
                    pending = mix(wk, cnt) - wk
                elif overlap == "none":
                    wk = mix(w_end, cnt)
                elif overlap == "delayed":
                    # apply the previous boundary's gossip correction; this
                    # boundary's mix feeds only the pending state
                    wk, pending = w_end + pending, mix(w_end, cnt) - w_end
                else:
                    s = (cnt % chunks) * seg
                    w_end[:, s:s + seg] = mix(w_end[:, s:s + seg],
                                              cnt // chunks)
                    wk = w_end
                cnt += 1
        # flush: the worker mean is invariant under doubly stochastic mixing
        return wk.mean(dim=0)[:d]

    if overlap == "none":
        w = w0
        for t in range(epochs):
            alpha = _alpha(t, dtype)
            for i in range(nb):
                w_locals = w - alpha * grads_of(w, i)   # (K, d) worker models
                w = w_locals.mean(dim=0)                # MPI_AllReduce / K
        return w

    if overlap == "delayed":
        # per-worker models + pending correction (meanΔ − ownΔ of the
        # previous block): a block never consumes its own mean
        wk = w0.expand(k, d)
        pending = torch.zeros((k, d), dtype=dtype, device=dev)
        for t in range(epochs):
            alpha = _alpha(t, dtype)
            for i in range(nb):
                delta = -alpha * grads_of(wk, i)
                mean = delta.mean(dim=0)
                wk, pending = wk + delta + pending, mean[None] - delta
        # flush: the workers' mean is anchor + meanΔ_last
        return wk.mean(dim=0)

    # chunked: one w-segment value-averaged per block
    dp = _padded_width(d, chunks)
    seg = dp // chunks
    wk = torch.zeros((k, dp), dtype=dtype, device=dev)
    wk[:, :d] = w0
    cnt = 0
    for t in range(epochs):
        alpha = _alpha(t, dtype)
        for i in range(nb):
            grads = torch.nn.functional.pad(grads_of(wk[:, :d], i),
                                            (0, dp - d))
            wk = wk - alpha * grads
            s = (cnt % chunks) * seg
            wk[:, s:s + seg] = wk[:, s:s + seg].mean(dim=0)
            cnt += 1
    return wk.mean(dim=0)[:d]


def dms(w0: ArrayLike, x: ArrayLike, y: ArrayLike, *, workers: int,
        epochs: int, block_size: int, c: float = 1.0,
        grad_impl: str = "kernel", backend: str = "vmap",
        overlap: str = "none", chunks: int = 4, topology: str = "all",
        gossip_async: bool = False,
        device: Union[str, torch.device] = "cuda") -> torch.Tensor:
    """Algorithm 3 entry point. ``block_size`` is points per worker per sync
    (the paper's MSF knob: larger block ⇒ lower sync frequency);
    ``overlap`` ∈ {"none", "delayed", "chunked"} selects how the residual
    sync is taken off the critical path and ``topology`` ∈ {"all", "ring",
    "pairwise"} which workers it couples; ``gossip_async`` switches a gossip
    topology to the double-buffered unsynchronized-round exchange (requires
    ``overlap="none"``). ``x``/``y`` may be numpy arrays or tensors; a tensor
    already on ``device`` is not copied."""
    if gossip_async and (topology == "all" or overlap != "none"):
        raise ValueError("gossip_async needs a gossip topology and "
                         f"overlap='none'; got topology={topology!r}, "
                         f"overlap={overlap!r}")
    if overlap not in OVERLAPS:
        raise ValueError(f"unknown overlap mode: {overlap!r}")
    dev = resolve_device(device)
    w0 = _as(w0, dev)
    xs, ys = _shard_data(x, y, workers)
    xs, ys = _as(xs, dev, w0.dtype), _as(ys, dev, w0.dtype)
    if backend == "vmap":
        return _dms_vmap(w0, xs, ys, epochs=epochs, block_size=block_size,
                         c=c, grad_impl=grad_impl, overlap=overlap,
                         chunks=chunks, topology=topology,
                         gossip_async=gossip_async)
    if backend == "shard_map":
        raise NotImplementedError(
            "backend='shard_map' (real collectives across devices) comes with "
            "the distributed slice of the port: torch.distributed in place of "
            "shard_map; use backend='vmap'")
    raise ValueError(backend)
