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
  :func:`dms_block_stepper`. On the card an epoch of blocks is one CUDA
  graph replay (:class:`DmsEpochs`), as the reference jits its scan.
* :func:`dms_block_stepper` — one DMS block (compute + boundary sync) on a
  carry from :func:`dms_stepper_init`, the K workers its leading dim; with
  :func:`dms_block_ladder` (a rung per block size) and
  :func:`dms_ladder_switch` the block size moves mid-run.
  ``backend="dist"`` runs one worker a process, K the size of a mesh axis
  (:mod:`repro_torch.launch.mesh`), the sync that axis's collectives:
  the reference's ``backend="shard_map"``.
* :func:`dms_timed_steps` — compute and sync as separate callables, timed
  into a :class:`repro_torch.core.telemetry.BlockTelemetry` (the paper's
  Figs 10–12 method), on one card or across the ranks of a mesh.

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
from collections import OrderedDict
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core import collectives as CL
from repro_torch.device import resolve_device, wait
from repro_torch.kernels.hinge import ops as hinge_ops
from repro_torch.kernels.hinge import ref as hinge_ref
from repro_torch.runtime import graphs as G

ArrayLike = Union[torch.Tensor, np.ndarray]
OVERLAPS = ("none", "delayed", "chunked")
TOPOLOGIES = ("all", "ring", "pairwise")
BACKENDS = ("vmap", "dist")


def _alpha(t: int, dtype: torch.dtype) -> torch.Tensor:
    """``α = 1/(1+t)`` rounded once, in the working dtype (reference
    ``svm.py:123``). A 0-dim CPU tensor: it scales device tensors as a
    scalar, with no copy to the device. A captured epoch reads it from a
    device scalar filled with this value (:class:`DmsEpochs`)."""
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
              gossip_async: bool = False, graphs: bool = False
              ) -> torch.Tensor:
    """K workers on one device: xs ``(K, n_local, d)``, the blocks of every
    epoch through :func:`dms_block_stepper` (:class:`DmsEpochs`, one CUDA
    graph replay an epoch with ``graphs``), then the flush to one model.

    The reference's ``_dms_vmap`` keeps one shared ``(d,)`` w under the
    blocking mean; here it is the carry's K equal rows, and row 0 is
    returned: the same values, bitwise. The reference mixes a gossip
    topology as the matrix product ``M·w``; the stepper takes the
    neighbour sums of its ``shard_map`` path, which round differently (a
    few float32 ulps a block). ``gossip_async`` alone keeps the reference's
    own loop (:func:`_dms_async_vmap`), eagerly: the async ring is unstable
    at α = 1 and grows that rounding into the model.
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
    kw = dict(c=c, grad_impl=grad_impl, overlap=overlap, chunks=chunks,
              topology=topology)
    run = _captured(w0, xb, yb, **kw) if graphs else DmsEpochs(w0, xb, yb,
                                                               **kw)
    for t in range(epochs):
        run.epoch(t)
    return run.model()


# the captured epochs of recent dms calls, the newest last, by what a graph
# reads (see _captured); clear it to free their graphs
DMS_GRAPHS: "OrderedDict[tuple, DmsEpochs]" = OrderedDict()
DMS_GRAPHS_MAX = 8


def _captured(w0: torch.Tensor, xb: torch.Tensor, yb: torch.Tensor,
              **kw) -> "DmsEpochs":
    """The captured epoch for blocks xb / yb, reset to ``w0``: as
    ``jax.jit`` keeps its program, a capture is kept for later calls on
    the same data (:data:`DMS_GRAPHS`, the :data:`DMS_GRAPHS_MAX` most
    recent). A graph reads the data by address, so the key is the data's
    address, shape, strides, dtype and device with the options baked into
    the graph; it keeps no reference to the data, and a later tensor at
    that address with that layout is what a hit reads."""
    key = (xb.device, xb.dtype, tuple(xb.shape), xb.stride(), xb.data_ptr(),
           yb.stride(), yb.data_ptr(), tuple(sorted(kw.items())))
    run = DMS_GRAPHS.pop(key, None)
    if run is None:
        run = DmsEpochs(w0, xb, yb, graphs=True, **kw)
    else:
        run.reset(w0)
    DMS_GRAPHS[key] = run
    while len(DMS_GRAPHS) > DMS_GRAPHS_MAX:
        DMS_GRAPHS.popitem(last=False)
    return run


class DmsEpochs:
    """The ``nb`` blocks of one :func:`dms` epoch over resident data, xb
    ``(K, nb, bs, d)`` / yb ``(K, nb, bs)``, as one body of
    :class:`repro_torch.runtime.graphs.Compiled`: captured once as a CUDA
    graph (``graphs=True``) and replayed an epoch a call, or run eagerly.

    The body steps :func:`dms_block_stepper` over the views ``xb[:, i]``
    from a static carry (:func:`dms_stepper_init`'s leaves, materialised)
    with α read from a static device scalar, and copies the epoch-end carry
    back into the static one inside the body, since a graph's own outputs
    are overwritten by its next replay. :meth:`epoch` fills α with the
    same rounded ``1/(1+t)`` as :func:`_alpha` before each call;
    :meth:`reset` starts the carry again from another ``w0``. The kernel
    libraries are loaded before the capture. ``compiled`` holds the
    capture's host times (None eagerly).
    """

    def __init__(self, w0: torch.Tensor, xb: torch.Tensor, yb: torch.Tensor,
                 *, c: float, grad_impl: str, overlap: str = "none",
                 chunks: int = 4, topology: str = "all", graphs: bool = False):
        k, nb, _, d = xb.shape
        self.d, self.dtype = d, w0.dtype
        self.modes = dict(workers=k, overlap=overlap, chunks=chunks,
                          topology=topology)
        step = dms_block_stepper(d=d, c=c, grad_impl=grad_impl,
                                 overlap=overlap, chunks=chunks,
                                 topology=topology)
        self.carry = {name: v.clone(memory_format=torch.contiguous_format)
                      for name, v in dms_stepper_init(w0, **self.modes)
                      .items()}
        self.alpha = torch.zeros((), dtype=w0.dtype, device=w0.device)

        def body(carry, alpha):
            out = carry
            for i in range(nb):
                out = step(out, xb[:, i], yb[:, i], alpha)
            for name, v in carry.items():
                v.copy_(out[name])

        if graphs and grad_impl == "kernel":
            hinge_ops.load_library()
            hinge_ops.load_cluster_library()
        self.compiled = G.Compiled(body, self.carry, self.alpha,
                                   graph=graphs)

    def reset(self, w0: torch.Tensor) -> None:
        """Start the carry again from ``w0``, as :func:`dms_stepper_init`."""
        for name, v in dms_stepper_init(w0, **self.modes).items():
            self.carry[name].copy_(v)

    def epoch(self, t: int) -> None:
        """Run epoch ``t`` (α = 1/(1+t)) on the carry."""
        self.alpha.fill_(float(_alpha(t, self.dtype)))
        self.compiled()

    def model(self) -> torch.Tensor:
        """The flushed model, a tensor of its own (the carry is the next
        call's): row 0 after a blocking mean (K equal rows), else the worker
        mean (invariant under doubly stochastic mixing; under delayed,
        anchor + meanΔ of the last block)."""
        return dms_flush(self.carry, d=self.d, overlap=self.modes["overlap"],
                         topology=self.modes["topology"])


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
        grad_impl: str = "kernel", backend: str = "vmap", mesh=None,
        axis: str = "data", overlap: str = "none", chunks: int = 4,
        topology: str = "all", gossip_async: bool = False,
        device: Union[str, torch.device, None] = None,
        graphs: Optional[bool] = None) -> torch.Tensor:
    """Algorithm 3 entry point. ``block_size`` is points per worker per sync
    (the paper's MSF knob: larger block ⇒ lower sync frequency);
    ``overlap`` ∈ {"none", "delayed", "chunked"} selects how the residual
    sync is taken off the critical path and ``topology`` ∈ {"all", "ring",
    "pairwise"} which workers it couples; ``gossip_async`` switches a gossip
    topology to the double-buffered unsynchronized-round exchange (requires
    ``overlap="none"``). ``x``/``y`` may be numpy arrays or tensors; a tensor
    already on ``device`` is not copied.

    ``backend="vmap"`` runs the K workers on one device (default
    ``"cuda"``). ``graphs``: each epoch one CUDA graph replay (None: on a
    card, but under ``gossip_async``, whose loop stays eager), the capture
    kept for later calls on the same data (:data:`DMS_GRAPHS`), or eagerly
    (False); True on the CPU or with ``gossip_async`` raises.

    ``backend="dist"`` is the reference's ``shard_map``: every rank of
    ``mesh`` calls it with the same ``x`` and ``y``; the ranks along
    ``axis`` (whose size must be ``workers``) are the K workers, rank r
    takes row block r of the equal-load split, and the sync is the axis's
    collectives (:func:`dms_block_stepper` with the mesh). It runs on the
    mesh's device (default), eagerly: gloo's collectives cannot be captured
    in a CUDA graph, and NCCL capture waits for ROADMAP item 19, so
    ``graphs=True`` raises. Under ``delayed`` and ``gossip_async`` the
    boundary's collective, which feeds only carried state, is waited for
    at the next boundary. Every rank returns the flushed model (the same
    on every rank under the blocking mean)."""
    if gossip_async and (topology == "all" or overlap != "none"):
        raise ValueError("gossip_async needs a gossip topology and "
                         f"overlap='none'; got topology={topology!r}, "
                         f"overlap={overlap!r}")
    if overlap not in OVERLAPS:
        raise ValueError(f"unknown overlap mode: {overlap!r}")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} "
                         f"({' | '.join(BACKENDS)})")
    if gossip_async and graphs:
        raise ValueError("gossip_async runs eagerly: its mixing matrix is "
                         "picked on the host block by block (graphs=False)")
    if backend == "dist":
        return _dms_dist(w0, x, y, workers=workers, epochs=epochs,
                         block_size=block_size, c=c, grad_impl=grad_impl,
                         mesh=mesh, axis=axis, overlap=overlap, chunks=chunks,
                         topology=topology, gossip_async=gossip_async,
                         device=device, graphs=graphs)
    dev = resolve_device("cuda" if device is None else device)
    graphs = G.use_graphs(graphs, dev) and not gossip_async
    w0 = _as(w0, dev)
    xs, ys = _shard_data(x, y, workers)
    xs, ys = _as(xs, dev, w0.dtype), _as(ys, dev, w0.dtype)
    return _dms_vmap(w0, xs, ys, epochs=epochs, block_size=block_size,
                     c=c, grad_impl=grad_impl, overlap=overlap,
                     chunks=chunks, topology=topology,
                     gossip_async=gossip_async, graphs=graphs)


def _mesh_axis(mesh, axis: str, workers: int) -> None:
    """Check that ``mesh``'s ``axis`` holds ``workers`` ranks."""
    if mesh is None:
        raise ValueError("backend='dist' needs a mesh "
                         "(repro_torch.launch.mesh.make_mesh)")
    if mesh.size(axis) != workers:
        raise ValueError(f"mesh axis {axis!r} has {mesh.size(axis)} ranks, "
                         f"but workers={workers}: one worker a rank")


def _dms_dist(w0, x, y, *, workers: int, epochs: int, block_size: int,
              c: float, grad_impl: str, mesh, axis: str, overlap: str,
              chunks: int, topology: str, gossip_async: bool, device,
              graphs) -> torch.Tensor:
    """One worker a rank along ``mesh``'s ``axis``: the reference's
    ``_dms_shard_map``. The worker's carry keeps a leading dim of 1, so
    the blocks go through :func:`dms_block_stepper` as on one card."""
    if graphs:
        raise ValueError("backend='dist' runs eagerly (graphs=False): gloo's "
                         "collectives cannot be captured in a CUDA graph, "
                         "and NCCL capture is ROADMAP item 19")
    _mesh_axis(mesh, axis, workers)
    dev = resolve_device(mesh.device if device is None else device)
    w0 = _as(w0, dev)
    xs, ys = _shard_data(x, y, workers)
    r = mesh.rank(axis)
    # only this rank's row block is copied (x may be a memory map)
    xs, ys = _as(xs[r:r + 1], dev, w0.dtype), _as(ys[r:r + 1], dev, w0.dtype)
    _, n_local, d = xs.shape
    nb = n_local // block_size
    xb = xs[:, : nb * block_size].reshape(1, nb, block_size, d)
    yb = ys[:, : nb * block_size].reshape(1, nb, block_size)
    modes = dict(overlap=overlap, chunks=chunks, topology=topology,
                 gossip_async=gossip_async)
    step = dms_block_stepper(d=d, c=c, grad_impl=grad_impl, mesh=mesh,
                             axis=axis, **modes)
    carry = dms_stepper_init(w0, 1, **modes)
    for t in range(epochs):
        alpha = _alpha(t, w0.dtype)
        for i in range(nb):
            carry = step(carry, xb[:, i], yb[:, i], alpha)
    return dms_flush(carry, d=d, overlap=overlap, topology=topology,
                     mesh=mesh, axis=axis)


def dms_flush(carry, *, d: int, overlap: str = "none", topology: str = "all",
              mesh=None, axis: str = "data") -> torch.Tensor:
    """A :func:`dms_block_stepper` carry collapsed to the synchronized
    ``(d,)`` model (reference ``_carry_flush``): the blocking mean's model
    as it is, else the worker mean (invariant under doubly stochastic
    mixing; under delayed, anchor + meanΔ of the last block). Collectives
    still in flight are waited for first."""
    rep = CL.replicas(mesh, axis)
    for v in carry.values():
        CL.resolve(v)
    w = carry["w"]
    if overlap == "none" and topology == "all":
        return w[0].clone()
    return rep.mean(w)[0][:d]


# ---------------------------------------------------------------------------
# compute and sync timed apart — the paper's Figs 10–12 method
# ---------------------------------------------------------------------------

def _round_select(x: torch.Tensor, cnt, fn, rep=CL.STACKED) -> torch.Tensor:
    """``fn(x, round)`` for the pairwise parity of ``cnt``. On one device
    the counter is not read on the host: both parities are computed and the
    one of ``cnt % 2`` is kept (a device int scalar selects on the device).
    Across processes the ranks' counters advance alike, and each reads its
    own, so only the round's exchange is made."""
    if not isinstance(cnt, torch.Tensor) or rep is not CL.STACKED:
        return fn(x, int(cnt))
    return torch.where(cnt % 2 == 0, fn(x, 0), fn(x, 1))


def _exchange(v: torch.Tensor, topology: str, cnt=None,
              rep=CL.STACKED) -> torch.Tensor:
    """The boundary exchange over the worker axis ``rep``: the mean (kept
    as (K, …)), or the topology's gossip mix (``cnt`` the pairwise
    round)."""
    from repro_torch.core import sync as _sync
    if topology == "all":
        return rep.mean(v).expand(v.shape)
    if topology == "ring":
        return _sync.gossip_mix(v, topology, rep=rep)
    return _round_select(v, cnt, lambda x, r: _sync.gossip_mix(
        x, topology, r, rep), rep)


def _recv(v: torch.Tensor, topology: str, cnt=None,
          rep=CL.STACKED) -> torch.Tensor:
    """Receive half of the gossip exchange (no self term)."""
    from repro_torch.core import sync as _sync
    if topology == "ring":
        return _sync.gossip_recv(v, topology, rep=rep)
    return _round_select(v, cnt, lambda x, r: _sync.gossip_recv(
        x, topology, r, rep), rep)


def _exchange_later(v: torch.Tensor, topology: str, cnt, rep,
                    self_term: bool = True) -> CL.Deferred:
    """:func:`_exchange` (or :func:`_recv`, without ``self_term``) across
    processes, issued and waited for at the returned Deferred's ``wait()``:
    for a collective whose output feeds only carried state."""
    from repro_torch.core import sync as _sync
    if topology == "all":
        return rep.mean(v, async_op=True)
    rnd = None if topology == "ring" else int(cnt)
    return _sync.gossip_later(v, topology, rnd, rep, self_term=self_term)


def _segment(w: torch.Tensor, cnt, chunks: int) -> torch.Tensor:
    """Column indices of this boundary's w-segment, ``cnt % chunks`` of
    ``chunks``, on ``w``'s device (a device counter is not read on the
    host)."""
    seg = w.shape[-1] // chunks
    cols = torch.arange(seg, device=w.device)
    if isinstance(cnt, torch.Tensor):
        return (cnt.long() % chunks) * seg + cols
    return (int(cnt) % chunks) * seg + cols


def dms_timed_steps(mesh=None, axis: str = "data", *, block_size: int,
                    c: float = 1.0, grad_impl: str = "kernel",
                    overlap: str = "none", chunks: int = 4,
                    topology: str = "all", gossip_async: bool = False,
                    telemetry=None):
    """Returns (compute_step, sync_step), separately callable so that
    computation and communication are timed apart, as the paper's Figs
    10–12 instrument around MPI_AllReduce. The port of the reference's
    ``dms_timed_steps(mesh, axis, …)``: without a mesh the K workers are the
    leading dim of every argument on one device (``xb`` (K, bs, d), ``yb``
    (K, bs)); with a mesh each rank along ``axis`` passes its own worker's
    (``xb`` (1, bs, d), per-worker tensors (1, …)) and the sync is the
    axis's collectives.

    ``telemetry`` (a :class:`repro_torch.core.telemetry.BlockTelemetry`)
    wraps both with host timers that wait for the card (and, across ranks,
    for the collective's completion on the host): each compute call times
    ``block_size`` steps' compute, each sync call one sync. Without a mesh
    each time is recorded as it is taken. With a mesh the times are kept
    on the rank, and ``sync_step.flush()`` — a collective every rank calls
    after its timed window — records in the telemetry each call's time as
    the max over the ranks (the slowest rank sets a synchronous block's
    pace).

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
    rep = CL.replicas(mesh, axis)

    def compute(w, xb, yb, alpha):
        return w - alpha * block_grad(w, xb, yb, c, grad_impl)

    if gossip_async:
        w_self = _sync.gossip_self_weight(topology)

        def sync(w_locals, sent, mixbuf, cnt):
            new_w = w_locals + mixbuf + (w_self - 1.0) * sent
            return new_w, new_w, _recv(new_w, topology, cnt, rep)
    elif gossip:
        def sync(w_locals, cnt):
            return _exchange(w_locals, topology, cnt, rep)
    elif overlap == "none":
        def sync(w_locals):
            return rep.mean(w_locals)[0]
    elif overlap == "delayed":
        def sync(w_start_locals, w_end_locals, pending):
            delta = w_end_locals - w_start_locals
            mean = rep.mean(delta)
            return w_end_locals + pending, mean - delta
    else:
        def sync(w_end_locals, cnt):
            d = w_end_locals.shape[-1]
            if d % chunks:
                raise ValueError(f"d={d} is not divisible by chunks={chunks}")
            cols = _segment(w_end_locals, cnt, chunks)
            rows = w_end_locals.index_select(1, cols)
            return w_end_locals.index_copy(
                1, cols, rep.mean(rows).expand(rows.shape))

    if telemetry is None:
        return compute, sync
    steps, syncs = [], []

    def timed(fn, times):
        def call(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            wait(out)
            times.append(time.perf_counter() - t0)
            if mesh is None:
                record()
            return out
        return call

    def record():
        for s in steps:
            telemetry.record_step_time(s, steps=block_size)
        for s in syncs:
            telemetry.record_sync_time(s)
        steps.clear()
        syncs.clear()

    def flush():
        """Record the times kept since the last flush, each the max over
        the mesh's ranks (a collective: every rank calls it, after the
        same number of timed calls)."""
        if mesh is not None and (steps or syncs):
            both = CL.max_over(steps + syncs)
            steps[:], syncs[:] = both[:len(steps)], both[len(steps):]
        record()

    timed_compute, timed_sync = timed(compute, steps), timed(sync, syncs)
    timed_compute.flush = timed_sync.flush = flush
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
                      topology: str = "all", gossip_async: bool = False,
                      mesh=None, axis: str = "data"):
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

    With a ``mesh`` each rank along ``axis`` is one worker: its carry and
    blocks have a leading dim of 1 (``dms_stepper_init(w0, 1, …)``), the
    exchange is the axis's collectives, and the pairwise parity is read on
    the host. The exchange banked under delayed and ``gossip_async`` is
    issued at its boundary and waited for at the next (the carry holds a
    :class:`repro_torch.core.collectives.Deferred` in between; see
    :func:`dms_flush`), so it runs under the next block's gradient.
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
    rep = CL.replicas(mesh, axis)
    later = mesh is not None

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
            new_w = (w_end + CL.resolve(carry["mixbuf"])
                     + (w_self - 1.0) * carry["sent"])
            recv = (_exchange_later(new_w, topology, cnt, rep,
                                    self_term=False) if later
                    else _recv(new_w, topology, cnt))
            return bump({"w": new_w, "sent": new_w, "mixbuf": recv}, carry)
        if overlap == "none":
            w_local = w - alpha * block_grad(w, xblk, yblk, c, grad_impl)
            return bump({"w": _exchange(w_local, topology, cnt, rep)}, carry)
        if overlap == "delayed":
            delta = -alpha * block_grad(w, xblk, yblk, c, grad_impl)
            w_end = w + delta
            new_w = w_end + CL.resolve(carry["pending"])
            if later:
                ex = _exchange_later(w_end if topology != "all" else delta,
                                     topology, cnt, rep)
                pending = ex.then(lambda m: m - (w_end if topology != "all"
                                                 else delta))
            elif topology != "all":
                pending = _exchange(w_end, topology, cnt) - w_end
            else:
                pending = delta.mean(dim=0, keepdim=True) - delta
            return bump({"w": new_w, "pending": pending}, carry)
        # chunked: one w-segment value-exchanged per block
        dp = w.shape[-1]
        g = block_grad(w[:, :d], xblk, yblk, c, grad_impl)
        w_end = w - alpha * torch.nn.functional.pad(g, (0, dp - d))
        cols = _segment(w_end, cnt, chunks)
        row = _exchange(w_end.index_select(1, cols), topology, cnt // chunks,
                        rep)
        return {"w": w_end.index_copy(1, cols, row), "cnt": cnt + 1}

    return step


def dms_block_ladder(*, d: int, workers: int, block_sizes, c: float = 1.0,
                     grad_impl: str = "kernel", overlap: str = "none",
                     chunks: int = 4, topology: str = "all",
                     gossip_async: bool = False,
                     dtype: torch.dtype = torch.float32,
                     device: Union[str, torch.device, None] = None,
                     mesh=None, axis: str = "data"):
    """Block-size ladder for the SVM path — the DMS analog of the LM
    trainer's H-ladder (:mod:`repro_torch.runtime.ladder`): ``{bs: rung}``,
    one :func:`dms_block_stepper` (its carry layout is block-size
    independent) behind a rung per block size. ``rung(carry, xblk, yblk,
    alpha)`` takes ``xblk`` (K, bs, d) / ``yblk`` (K, bs) of ``dtype`` on
    ``device`` and raises on any other. Every kernel a rung's step reaches
    is built and loaded here (the hinge kernels, on the card with
    ``grad_impl="kernel"``), so no block waits on nvcc. A mid-run MSF move
    is :func:`dms_ladder_switch` on the carry + another rung + re-blocking
    the data stream. ``device`` defaults to ``"cuda"``, or with a ``mesh``
    to its device; with a mesh (whose ``axis`` must hold ``workers`` ranks)
    a rung takes this rank's worker, ``xblk`` (1, bs, d) / ``yblk`` (1,
    bs), and its sync is the axis's collectives (the reference's ladder
    over ``mesh``, ``axis``).
    """
    from repro_torch.runtime.ladder import warm_kernels
    if mesh is not None:
        _mesh_axis(mesh, axis, workers)
    dev = resolve_device(device if device is not None else
                         mesh.device if mesh is not None else "cuda")
    step = dms_block_stepper(d=d, c=c, grad_impl=grad_impl, overlap=overlap,
                             chunks=chunks, topology=topology,
                             gossip_async=gossip_async, mesh=mesh, axis=axis)
    local = 1 if mesh is not None else workers
    kernels = ()
    if grad_impl == "kernel" and dev.type == "cuda":
        kernels = (hinge_ops.load_library, hinge_ops.load_cluster_library)

    def as_batch_step(bs):
        def rung(carry, xblk, yblk, alpha):
            for name, t, shape in (("xblk", xblk, (local, bs, d)),
                                   ("yblk", yblk, (local, bs))):
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
                      d: Optional[int] = None, mesh=None,
                      axis: str = "data"):
    """Exact carry for resuming DMS at a different block size.

    Collapses the carry to the flushed model — delayed folds the pending
    correction first, then the worker mean (exact: workers are identical
    under blocking ``topology="all"``; within one block's drift under
    delayed; and the mean is the invariant consensus target under any
    gossip topology, chunked staleness included) — and re-seeds a fresh
    carry at that model via :func:`dms_stepper_init`. By construction the
    result is bit-identical to a fresh start from the flushed weights. With
    a ``mesh`` the carry is this rank's worker and the mean is over
    ``axis``; a collective still in flight is waited for first.
    """
    carry = {k: CL.resolve(v) for k, v in carry.items()}
    wk = carry["w"].float()
    if overlap == "delayed":
        wk = wk + carry["pending"].float()
    w = CL.replicas(mesh, axis).mean(wk)[0]
    if overlap == "chunked" and d is not None:
        w = w[:d]
    return dms_stepper_init(w.to(carry["w"].dtype), carry["w"].shape[0],
                            overlap=overlap, chunks=chunks, topology=topology,
                            gossip_async=gossip_async)
