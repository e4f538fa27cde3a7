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
  by the sync as a mean or a gossip mix over that dim — a loop of
  :func:`dms_block_stepper`.
* :func:`dms_block_stepper` — one DMS block (compute + boundary sync) on a
  carry from :func:`dms_stepper_init`, the K workers its leading dim; with
  :func:`dms_block_ladder` (a rung per block size) and
  :func:`dms_ladder_switch` the block size moves mid-run.
* :func:`dms_timed_steps` — compute and sync as separate callables, timed
  into a :class:`repro_torch.core.telemetry.BlockTelemetry` (the paper's
  Figs 10–12 method on one card).

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

import time
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.device import resolve_device, wait
from repro_torch.kernels.hinge import ops as hinge_ops
from repro_torch.kernels.hinge import ref as hinge_ref

ArrayLike = Union[torch.Tensor, np.ndarray]
OVERLAPS = ("none", "delayed", "chunked")
TOPOLOGIES = ("all", "ring", "pairwise")


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
    """K workers on one device: xs ``(K, n_local, d)``, the blocks of every
    epoch through :func:`dms_block_stepper` from
    :func:`dms_stepper_init`, then the flush to one model.

    The reference's ``_dms_vmap`` keeps one shared ``(d,)`` w under the
    blocking mean; here it is the carry's K equal rows (a stride-0 view),
    and row 0 is returned: the same values, bitwise. The reference mixes a
    gossip topology as the matrix product ``M·w``; the stepper takes the
    neighbour sums of its ``shard_map`` path, which round differently (a
    few float32 ulps a block). ``gossip_async`` alone keeps the reference's
    own loop (:func:`_dms_async_vmap`): the async ring is unstable at α = 1
    and grows that rounding into the model.
    """
    k, n_local, d = xs.shape
    nb = n_local // block_size
    # (K, nb, bs, d) view; block i is the worker-major view xb[:, i], which
    # the kernel reads in place through its worker stride
    xb = xs[:, : nb * block_size].reshape(k, nb, block_size, d)
    yb = ys[:, : nb * block_size].reshape(k, nb, block_size)
    if gossip_async:
        return _dms_async_vmap(w0, xb, yb, epochs=epochs, c=c,
                               grad_impl=grad_impl, topology=topology)
    modes = dict(overlap=overlap, chunks=chunks, topology=topology,
                 gossip_async=gossip_async)
    step = dms_block_stepper(d=d, c=c, grad_impl=grad_impl, **modes)
    carry = dms_stepper_init(w0, k, **modes)
    for t in range(epochs):
        alpha = _alpha(t, w0.dtype)
        for i in range(nb):
            carry = step(carry, xb[:, i], yb[:, i], alpha)
    if overlap == "none" and topology == "all":
        return carry["w"][0]            # K equal rows after a blocking mean
    # flush: the worker mean (invariant under doubly stochastic mixing;
    # under delayed, anchor + meanΔ of the last block)
    return carry["w"].mean(dim=0)[:d]


def _dms_async_vmap(w0: torch.Tensor, xb: torch.Tensor, yb: torch.Tensor,
                    *, epochs: int, c: float, grad_impl: str,
                    topology: str) -> torch.Tensor:
    """Async gossip over blocks xb ``(K, nb, bs, d)`` as the reference's
    ``_dms_vmap`` runs it: the boundary applies the banked correction, then
    banks ``M·(post-correction w) − w`` for the next, ``M`` the mixing
    matrix as a product. Async ring is ``w ← (M − αI)·w + α·g``: at α = 1 an
    even ring has the eigenvalue 1/3 − 2/3 of M, a mode grows by 4/3 a block,
    and the stepper's arithmetic (neighbour sums, the bank as ``mixbuf +
    (M_ii − 1)·sent``) lands a visible distance from the reference's."""
    from repro_torch.core import costmodel
    k, nb, _, d = xb.shape
    mats = [torch.as_tensor(m, dtype=w0.dtype, device=w0.device)
            for m in costmodel.mixing_matrices(k, topology)]
    wk = w0.expand(k, d).clone()
    pending = torch.zeros_like(wk)
    cnt = 0
    for t in range(epochs):
        alpha = _alpha(t, w0.dtype)
        for i in range(nb):
            wk = wk - alpha * block_grad(wk, xb[:, i], yb[:, i], c,
                                         grad_impl) + pending
            pending = mats[cnt % len(mats)] @ wk - wk
            cnt += 1
    return wk.mean(dim=0)


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


# ---------------------------------------------------------------------------
# compute and sync timed apart — the paper's Figs 10–12 method on one card
# ---------------------------------------------------------------------------

def _round_select(x: torch.Tensor, cnt, fn) -> torch.Tensor:
    """``fn(x, round)`` for the pairwise parity of ``cnt`` without reading
    the counter on the host: both parities are computed and the one of
    ``cnt % 2`` is kept (a device int scalar selects on the device)."""
    if not isinstance(cnt, torch.Tensor):
        return fn(x, int(cnt))
    return torch.where(cnt % 2 == 0, fn(x, 0), fn(x, 1))


def _exchange(v: torch.Tensor, topology: str, cnt=None) -> torch.Tensor:
    """The boundary exchange over the worker dim: the mean (kept as (K, …)),
    or the topology's gossip mix (``cnt`` the pairwise round)."""
    from repro_torch.core import sync as _sync
    if topology == "all":
        return v.mean(dim=0, keepdim=True).expand(v.shape)
    if topology == "ring":
        return _sync.gossip_mix(v, topology)
    return _round_select(v, cnt, lambda x, r: _sync.gossip_mix(x, topology,
                                                                r))


def _recv(v: torch.Tensor, topology: str, cnt=None) -> torch.Tensor:
    """Receive half of the gossip exchange (no self term)."""
    from repro_torch.core import sync as _sync
    if topology == "ring":
        return _sync.gossip_recv(v, topology)
    return _round_select(v, cnt, lambda x, r: _sync.gossip_recv(x, topology,
                                                                 r))


def _segment(w: torch.Tensor, cnt, chunks: int) -> torch.Tensor:
    """Column indices of this boundary's w-segment, ``cnt % chunks`` of
    ``chunks``, on ``w``'s device (a device counter is not read on the
    host)."""
    seg = w.shape[-1] // chunks
    cols = torch.arange(seg, device=w.device)
    if isinstance(cnt, torch.Tensor):
        return (cnt.long() % chunks) * seg + cols
    return (int(cnt) % chunks) * seg + cols


def dms_timed_steps(*, block_size: int, c: float = 1.0,
                    grad_impl: str = "kernel", overlap: str = "none",
                    chunks: int = 4, topology: str = "all",
                    gossip_async: bool = False, telemetry=None):
    """Returns (compute_step, sync_step), separately callable so that
    computation and communication are timed apart, as the paper's Figs
    10–12 instrument around MPI_AllReduce. The port of the reference's
    ``dms_timed_steps`` with the K workers as the leading dim of every
    argument (no mesh: ``xb`` is (K, bs, d), ``yb`` (K, bs)).

    ``telemetry`` (a :class:`repro_torch.core.telemetry.BlockTelemetry`)
    wraps both with host timers that wait for the card: each compute call
    records ``block_size`` steps' compute time, each sync call one sync.

    ``compute(w, xb, yb, alpha) → w_locals`` (K, d): each worker's block
    update from a shared w (d,) under the blocking ``topology="all"``, from
    per-worker w (K, d) otherwise. ``overlap`` sets the sync's signature:

        none:    sync(w_locals) → w                       (blocking mean)
        delayed: sync(w_start_locals, w_end_locals, pending)
                     → (w_new_locals, new_pending)        (stale-by-one)
        chunked: sync(w_end_locals, cnt) → w_new_locals   (one segment;
                 d must be divisible by ``chunks``; caller increments cnt)

    ``topology != "all"`` (with ``overlap="none"``) mixes instead; models
    stay per-worker:

        gossip:  sync(w_locals, cnt) → w_new_locals
        async:   sync(w_locals, sent, mixbuf, cnt)
                     → (w_new_locals, new_sent, new_mixbuf)
                 (seed sent/mixbuf with :func:`dms_async_buffers_init`)
    """
    from repro_torch.core import sync as _sync
    gossip = topology != "all"
    if gossip and overlap != "none":
        raise ValueError("dms_timed_steps times gossip only for "
                         "overlap='none' (use dms_block_stepper otherwise)")
    if gossip_async and not gossip:
        raise ValueError("gossip_async needs topology='ring'/'pairwise'")
    if overlap not in OVERLAPS:
        raise ValueError(f"unknown overlap mode: {overlap!r}")

    def compute(w, xb, yb, alpha):
        return w - alpha * block_grad(w, xb, yb, c, grad_impl)

    if gossip_async:
        w_self = _sync.gossip_self_weight(topology)

        def sync(w_locals, sent, mixbuf, cnt):
            new_w = w_locals + mixbuf + (w_self - 1.0) * sent
            return new_w, new_w, _recv(new_w, topology, cnt)
    elif gossip:
        def sync(w_locals, cnt):
            return _exchange(w_locals, topology, cnt)
    elif overlap == "none":
        def sync(w_locals):
            return w_locals.mean(dim=0)
    elif overlap == "delayed":
        def sync(w_start_locals, w_end_locals, pending):
            delta = w_end_locals - w_start_locals
            mean = delta.mean(dim=0, keepdim=True)
            return w_end_locals + pending, mean - delta
    else:
        def sync(w_end_locals, cnt):
            d = w_end_locals.shape[-1]
            if d % chunks:
                raise ValueError(f"d={d} is not divisible by chunks={chunks}")
            cols = _segment(w_end_locals, cnt, chunks)
            rows = w_end_locals.index_select(1, cols)
            return w_end_locals.index_copy(
                1, cols, rows.mean(dim=0, keepdim=True).expand(rows.shape))

    if telemetry is None:
        return compute, sync

    def timed_compute(*args):
        t0 = time.perf_counter()
        out = compute(*args)
        wait(out)
        telemetry.record_step_time(time.perf_counter() - t0,
                                   steps=block_size)
        return out

    def timed_sync(*args):
        t0 = time.perf_counter()
        out = sync(*args)
        wait(out)
        telemetry.record_sync_time(time.perf_counter() - t0)
        return out

    return timed_compute, timed_sync


def dms_async_buffers_init(w_locals: torch.Tensor, topology: str):
    """Seed ``(sent, mixbuf)`` for the async carries and timed-sync path —
    the engine's zero-first-correction seed
    (:func:`repro_torch.core.sync.init_async_buffers`)."""
    from repro_torch.core import sync as _sync
    return _sync.init_async_buffers(w_locals, topology)


# ---------------------------------------------------------------------------
# single-block stepper and the block-size ladder
# ---------------------------------------------------------------------------

def _needs_round(overlap: str, topology: str) -> bool:
    """Pairwise none/delayed carries a round counter for the pairing parity
    (chunked reuses its own cnt)."""
    return topology == "pairwise" and overlap != "chunked"


def dms_stepper_init(w0: torch.Tensor, workers: int, *, overlap: str = "none",
                     chunks: int = 4, topology: str = "all",
                     gossip_async: bool = False):
    """Initial carry for :func:`dms_block_stepper`, every leaf with the
    leading worker dim but ``cnt``, an int32 scalar on ``w0``'s device:

        none:    {"w": (K, d)}
        delayed: {"w": (K, d), "pending": (K, d)}
        chunked: {"w": (K, dp), "cnt"}      dp = d padded to chunks·seg
        async:   {"w": (K, d), "sent": (K, d), "mixbuf": (K, d)}

    with ``cnt`` added for pairwise none/delayed."""
    d = w0.shape[0]
    dev = w0.device
    wk = w0.expand(workers, d)
    if gossip_async:
        sent, mixbuf = dms_async_buffers_init(wk, topology)
        carry = {"w": wk, "sent": sent, "mixbuf": mixbuf}
    elif overlap == "none":
        carry = {"w": wk}
    elif overlap == "delayed":
        carry = {"w": wk, "pending": torch.zeros((workers, d), dtype=w0.dtype,
                                                 device=dev)}
    elif overlap == "chunked":
        wp = torch.zeros((workers, _padded_width(d, chunks)), dtype=w0.dtype,
                         device=dev)
        wp[:, :d] = wk
        carry = {"w": wp, "cnt": torch.zeros((), dtype=torch.int32,
                                             device=dev)}
    else:
        raise ValueError(f"unknown overlap mode: {overlap!r}")
    if _needs_round(overlap, topology):
        carry["cnt"] = torch.zeros((), dtype=torch.int32, device=dev)
    return carry


def dms_block_stepper(*, d: int, c: float = 1.0, grad_impl: str = "kernel",
                      overlap: str = "none", chunks: int = 4,
                      topology: str = "all", gossip_async: bool = False):
    """One DMS block (compute + boundary sync) as a step:

        step(carry, xblk, yblk, alpha) → carry

    with ``carry`` from :func:`dms_stepper_init` and ``xblk`` (K, bs, d) /
    ``yblk`` (K, bs), the workers the leading dim (the reference's
    ``shard_map`` over a mesh axis, as ``dms(backend="vmap")`` runs it).
    Each block is one batched gradient call for the K workers (one hinge
    launch on the card) from each worker's own w, then the boundary:

    * none: the mean (or gossip mix) of the block-end models;
    * delayed: the previous boundary's pending correction applied, this
      boundary's exchange banked as pending (``mean(Δ) − Δ``, value-form
      ``mix(w_end) − w_end`` under gossip);
    * chunked: one w-segment, ``cnt % chunks``, exchanged;
    * ``gossip_async``: the stale correction ``mixbuf + (M_ii−1)·sent``
      applied, then this boundary's receive banked for the next.

    ``cnt`` stays on the device: the segment and the pairwise parity are
    selected there, so a block never waits for the host.
    """
    if gossip_async and (topology == "all" or overlap != "none"):
        raise ValueError("gossip_async needs a gossip topology and "
                         f"overlap='none'; got topology={topology!r}, "
                         f"overlap={overlap!r}")
    if overlap not in OVERLAPS:
        raise ValueError(f"unknown overlap mode: {overlap!r}")
    if topology not in TOPOLOGIES:
        raise ValueError(f"unknown topology: {topology!r}")
    from repro_torch.core import sync as _sync

    def bump(out, carry):
        if _needs_round(overlap, topology):
            out["cnt"] = carry["cnt"] + 1
        return out

    def step(carry, xblk, yblk, alpha):
        cnt = carry.get("cnt")
        w = carry["w"]
        if gossip_async:
            w_self = _sync.gossip_self_weight(topology)
            w_end = w - alpha * block_grad(w, xblk, yblk, c, grad_impl)
            new_w = w_end + carry["mixbuf"] + (w_self - 1.0) * carry["sent"]
            return bump({"w": new_w, "sent": new_w,
                         "mixbuf": _recv(new_w, topology, cnt)}, carry)
        if overlap == "none":
            w_local = w - alpha * block_grad(w, xblk, yblk, c, grad_impl)
            return bump({"w": _exchange(w_local, topology, cnt)}, carry)
        if overlap == "delayed":
            delta = -alpha * block_grad(w, xblk, yblk, c, grad_impl)
            w_end = w + delta
            if topology != "all":
                pending = _exchange(w_end, topology, cnt) - w_end
            else:
                pending = delta.mean(dim=0, keepdim=True) - delta
            return bump({"w": w_end + carry["pending"], "pending": pending},
                        carry)
        # chunked: one w-segment value-exchanged per block
        dp = w.shape[-1]
        g = block_grad(w[:, :d], xblk, yblk, c, grad_impl)
        w_end = w - alpha * torch.nn.functional.pad(g, (0, dp - d))
        cols = _segment(w_end, cnt, chunks)
        row = _exchange(w_end.index_select(1, cols), topology, cnt // chunks)
        return {"w": w_end.index_copy(1, cols, row), "cnt": cnt + 1}

    return step


def dms_block_ladder(*, d: int, workers: int, block_sizes, c: float = 1.0,
                     grad_impl: str = "kernel", overlap: str = "none",
                     chunks: int = 4, topology: str = "all",
                     gossip_async: bool = False,
                     dtype: torch.dtype = torch.float32,
                     device: Union[str, torch.device] = "cuda"):
    """Block-size ladder for the SVM path — the DMS analog of the LM
    trainer's H-ladder (:mod:`repro_torch.runtime.ladder`): ``{bs: rung}``,
    one :func:`dms_block_stepper` (its carry layout is block-size
    independent) behind a rung per block size. ``rung(carry, xblk, yblk,
    alpha)`` takes ``xblk`` (K, bs, d) / ``yblk`` (K, bs) of ``dtype`` on
    ``device`` and raises on any other. Every kernel a rung's step reaches
    is built and loaded here (the hinge kernels, on the card with
    ``grad_impl="kernel"``), so no block waits on nvcc. A mid-run MSF move
    is :func:`dms_ladder_switch` on the carry + another rung + re-blocking
    the data stream.
    """
    from repro_torch.runtime.ladder import warm_kernels
    dev = resolve_device(device)
    step = dms_block_stepper(d=d, c=c, grad_impl=grad_impl, overlap=overlap,
                             chunks=chunks, topology=topology,
                             gossip_async=gossip_async)
    kernels = ()
    if grad_impl == "kernel" and dev.type == "cuda":
        kernels = (hinge_ops.load_library, hinge_ops.load_cluster_library)

    def as_batch_step(bs):
        def rung(carry, xblk, yblk, alpha):
            for name, t, shape in (("xblk", xblk, (workers, bs, d)),
                                   ("yblk", yblk, (workers, bs))):
                if tuple(t.shape) != shape or t.dtype != dtype \
                        or t.device.type != dev.type or (
                            dev.index is not None
                            and t.device.index != dev.index):
                    raise ValueError(
                        f"rung bs={bs} takes {name} {shape} {dtype} on "
                        f"{dev}; got {tuple(t.shape)} {t.dtype} on "
                        f"{t.device}")
            return step(carry, xblk, yblk, alpha)
        return rung

    warm_kernels(kernels)
    return {bs: as_batch_step(bs)
            for bs in sorted(set(int(b) for b in block_sizes))}


def dms_ladder_switch(carry, *, overlap: str = "none", chunks: int = 4,
                      topology: str = "all", gossip_async: bool = False,
                      d: Optional[int] = None):
    """Exact carry for resuming DMS at a different block size.

    Collapses the carry to the flushed model — delayed folds the pending
    correction first, then the worker mean (exact: workers are identical
    under blocking ``topology="all"``; within one block's drift under
    delayed; and the mean is the invariant consensus target under any
    gossip topology, chunked staleness included) — and re-seeds a fresh
    carry at that model via :func:`dms_stepper_init`. By construction the
    result is bit-identical to a fresh start from the flushed weights.
    """
    wk = carry["w"].float()
    if overlap == "delayed":
        wk = wk + carry["pending"].float()
    w = wk.mean(dim=0)
    if overlap == "chunked" and d is not None:
        w = w[:d]
    return dms_stepper_init(w.to(carry["w"].dtype), carry["w"].shape[0],
                            overlap=overlap, chunks=chunks, topology=topology,
                            gossip_async=gossip_async)
