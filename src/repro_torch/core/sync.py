"""Model-synchronization engine, the port of ``repro.core.sync``.

The paper's finding: the *frequency* of model synchronization (MSF) is a
free knob, so the sync schedule is config. This module turns
:class:`repro_torch.config.SyncConfig` into the sync point taken at every
block boundary of local SGD:

    sync_point(params_start, params_end, sync_state, cfg)
        → (new_params, new_sync_state)

with the reference's strategy × overlap × topology matrix (see
``repro.core.sync`` for the semantics of each mode): blocking mean, delayed
(stale-by-one), chunked (one byte-balanced shard per boundary), gossip over
a ring or rotating pairs, asynchronous gossip with double buffers, int8
(error feedback, through the quant kernel) and int16 wires, and slowmo.

The replica axis is a :mod:`repro_torch.core.collectives` object. On one
card (no ``mesh``) the K replicas are the leading dim of every leaf of
``params``/``sync_state`` (the layout the reference's ``init_state(…,
replicas=K)`` builds and ``dms(backend="vmap")`` uses), and the replica
mesh axis's collectives are operations over that dim:

* ``lax.pmean``/``psum``/``pmax`` → a mean/sum/max over dim 0, kept as a
  ``(1, …)`` dim that broadcasts back to every replica;
* ``lax.ppermute`` → indexing dim 0 by the permutation's sources;
* ``lax.all_gather`` → the stacked leaf itself.

Given a ``mesh`` (:class:`repro_torch.launch.mesh.Mesh`) and its replica
``axis``, each process holds one replica (every leaf's leading dim is 1, as
in the reference inside ``shard_map``) and those operations are the axis
group's ``torch.distributed`` collectives: an all-reduce, a
``batch_isend_irecv`` of the permutation's pairs, an all-gather. The int16
wire's sum runs on int32 (NCCL has no int16 reduction); the ``qmax = 32767
// K`` guard keeps it exact, so it equals the reference's int16 ``psum``.

On a mesh with a model axis a rank holds its block of some leaves
(``shards``, a tree like the params of
:class:`repro_torch.core.collectives.Shards`; the trainer's
``local_sgd.Within.shards``). Every step here is
elementwise over the replica axis, so it runs on the blocks as they are;
the compressed wires take each leaf's scale over the whole leaf (its
blocks' amax maxed over the ranks that hold them,
:func:`repro_torch.core.compression.quantize_shard`), and the chunked
sync assigns leaves to shards by their whole sizes.

The schedule counters (``chunk_idx``, ``gossip_round``) are read on the host
(the reference selects with ``lax.switch``/``lax.cond``); across processes
they advance alike on every rank, so no collective reads them. The
reference's ``sync_state_axes`` places state on a sharded mesh; here
:func:`repro_torch.core.local_sgd.scatter_replicas` gives each rank its
replica's state.

Every function but the blocking ``sync_point``, which writes its result into
``params_end``, is pure: it returns new tensors and leaves its arguments as
they were (a returned leaf may share memory with an argument or with another
returned leaf, as JAX arrays may).

Byte accounting lives in :mod:`repro_torch.core.costmodel`.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import tree as T
from repro_torch.config.base import SyncConfig
from repro_torch.core import collectives as CL
from repro_torch.core import compression as C
from repro_torch.core import costmodel


def needs_replica_axis(cfg: SyncConfig) -> bool:
    return cfg.strategy in ("periodic", "hierarchical")


def validate(cfg: SyncConfig) -> None:
    if cfg.overlap not in ("none", "delayed", "chunked"):
        raise ValueError(f"unknown overlap mode: {cfg.overlap!r}")
    if cfg.topology not in ("all", "ring", "pairwise"):
        raise ValueError(f"unknown sync topology: {cfg.topology!r}")
    if cfg.topology != "all" and cfg.slowmo > 0.0:
        raise ValueError("slowmo steps on the globally averaged delta; "
                         "gossip topologies never materialize a global mean")
    if cfg.gossip_async:
        if cfg.topology == "all":
            raise ValueError(
                "gossip_async is the unsynchronized-round gossip mode; it "
                "needs topology='ring' or 'pairwise' (a global collective "
                "has no per-neighbor buffer to double-buffer)")
        if cfg.overlap != "none":
            raise ValueError(
                "gossip_async already runs the exchange a full block ahead "
                "of its consumer (bounded staleness = 1 round); "
                f"overlap={cfg.overlap!r} would compound the staleness — "
                "use overlap='none'")
    if cfg.overlap == "chunked" and cfg.chunks < 1:
        raise ValueError(f"chunks must be >= 1, got {cfg.chunks}")
    if cfg.adaptive:
        if cfg.adapt_every < 1:
            raise ValueError(
                f"adapt_every must be >= 1, got {cfg.adapt_every}")
        if cfg.adapt_hysteresis < 0.0:
            raise ValueError("adapt_hysteresis must be >= 0, "
                             f"got {cfg.adapt_hysteresis}")
        if cfg.adapt_rung_hysteresis < 1:
            raise ValueError("adapt_rung_hysteresis must be >= 1, "
                             f"got {cfg.adapt_rung_hysteresis}")
        if cfg.adapt_h_max < 1:
            raise ValueError(f"adapt_h_max must be >= 1, "
                             f"got {cfg.adapt_h_max}")
        if any(h < 1 for h in cfg.adapt_ladder):
            raise ValueError(f"adapt_ladder rungs must be >= 1, "
                             f"got {cfg.adapt_ladder}")


def init_sync_state(cfg: SyncConfig, params) -> Dict[str, Any]:
    """The sync state of one replica's ``params`` (no replica dim; the
    trainer's ``init_state`` stacks it K times)."""
    validate(cfg)
    state: Dict[str, Any] = {}

    def zeros():
        return T.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)

    def counter():
        return torch.zeros((), dtype=torch.int32,
                           device=T.leaves(params)[0].device)

    if cfg.compression in ("int8", "int16"):
        state["ef"] = C.init_error_feedback(params)
    if cfg.slowmo > 0.0:
        state["slowmo_m"] = zeros()
    if cfg.overlap == "delayed":
        # pending correction = (averaged step delta − own local delta) of the
        # previous block; applied to this block's end params (stale-by-one)
        state["pending"] = zeros()
    if cfg.overlap == "chunked":
        state["chunk_idx"] = counter()
        if cfg.slowmo > 0.0:
            # per-shard outer momentum needs a per-leaf reference: the value
            # this leaf held right after ITS last slowmo step
            state["anchor"] = T.map(
                lambda p: p.to(torch.float32, copy=True), params)
    if cfg.gossip_async:
        state["sent"], state["mixbuf"] = init_async_buffers(params,
                                                            cfg.topology)
    if cfg.topology == "pairwise" and cfg.overlap != "chunked":
        # round parity selects the odd/even pairing (chunked derives the
        # round from chunk_idx instead)
        state["gossip_round"] = counter()
    return state


# ---------------------------------------------------------------------------
# the exchange primitives (shared by every overlap mode)
# ---------------------------------------------------------------------------

def _gossip_perms(k: int, topology: str):
    """Static (source → dest) lists, one list per wire exchange.

    ``ring`` returns both neighbor shifts; ``pairwise`` returns the two
    alternating pairings (even rounds pair (0,1)(2,3)…, odd rounds
    (1,2)(3,4)…(K−1,0)) — the caller selects by round parity.
    """
    if topology == "ring":
        return [[(i, (i + 1) % k) for i in range(k)],
                [(i, (i - 1) % k) for i in range(k)]]
    if topology == "pairwise":
        if k % 2:
            raise ValueError(
                f"topology='pairwise' needs an even replica count, got {k}")
        even = [(i, i ^ 1) for i in range(k)]
        odd = [(i, (i - 1) % k if i % 2 == 0 else (i + 1) % k)
               for i in range(k)]
        return [even, odd]
    raise ValueError(f"unknown gossip topology: {topology!r}")


def _round(counter: Optional[torch.Tensor]) -> Optional[int]:
    """A replicated schedule counter (one value per replica, all equal) as a
    host int."""
    return None if counter is None else int(counter.reshape(-1)[0])


def _terms(k: int, topology: str, round_idx):
    """(the permutations one gossip exchange sends, the divisor of its
    weighted sum): ring both shifts and thirds, pairwise the pairing of the
    round's parity and halves."""
    perms = _gossip_perms(k, topology)
    if topology == "ring":
        return perms, 3.0
    if round_idx is None:
        # a frozen pairing would "converge" each disjoint pair to its own
        # mean and never reach global consensus
        raise ValueError("topology='pairwise' alternates its pairing by "
                         "round; pass round_idx")
    return [perms[round_idx % 2]], 2.0


def _combine(received, div: float, self_val=None):
    """``(self + r₀ + r₁ …) / div`` summed left to right (no self term
    without ``self_val``)."""
    acc = self_val
    for r in received:
        acc = r if acc is None else acc + r
    return acc / div


def _mix_with(self_val, send, k: int, topology: str, round_idx):
    """Topology-weighted combine of own payload with the neighbors'.

    ``send(perm)`` returns the permuted payload for one wire exchange — the
    single definition of the gossip weighting (ring thirds, pairwise halves
    with the pairing chosen by round parity), shared by the raw-value and
    compressed paths.
    """
    if k == 1:
        return self_val
    perms, div = _terms(k, topology, round_idx)
    return _combine([send(p) for p in perms], div, self_val)


def gossip_self_weight(topology: str) -> float:
    """Diagonal ``M_ii`` of the gossip mixing matrix (same for every i):
    ring thirds, pairwise halves."""
    if topology == "ring":
        return 1.0 / 3.0
    if topology == "pairwise":
        return 0.5
    raise ValueError(f"unknown gossip topology: {topology!r}")


def _recv_with(send, k: int, topology: str, round_idx):
    """Neighbor-weighted payload sum ``Σ_{j≠i} M_ij x_j`` — the receive
    half of one wire exchange (no self term)."""
    perms, div = _terms(k, topology, round_idx)
    return _combine([send(p) for p in perms], div)


def gossip_mix(x: torch.Tensor, topology: str, round_idx=None,
               rep=CL.STACKED):
    """Mix ``x`` with its topology neighbors over the replica axis ``rep``
    (a stacked ``(K, …)`` tensor by default) — the doubly stochastic gossip
    step ``x ← Σ_j M_ij x_j``. ``round_idx`` selects the pairwise pairing
    (required for ``pairwise``)."""
    return gossip_later(x, topology, round_idx, rep).wait()


def gossip_recv(x: torch.Tensor, topology: str, round_idx=None,
                rep=CL.STACKED):
    """Receive half of one gossip exchange: ``Σ_{j≠i} M_ij x_j``.
    ``gossip_mix(x) ≡ gossip_self_weight·x + gossip_recv(x)``."""
    return gossip_later(x, topology, round_idx, rep, self_term=False).wait()


def gossip_later(x: torch.Tensor, topology: str, round_idx=None,
                 rep=CL.STACKED, self_term: bool = True) -> CL.Deferred:
    """:func:`gossip_mix` (or, without ``self_term``, :func:`gossip_recv`)
    with its exchanges issued and not waited for: the returned
    :class:`repro_torch.core.collectives.Deferred` finishes them at its
    ``wait()``, the same sums in the same order."""
    k = rep.size(x)
    if k == 1 and self_term:
        return CL.done(x)
    perms, div = _terms(k, topology, round_idx)
    sends = [rep.permute(x, p, tag=j, async_op=True)
             for j, p in enumerate(perms)]
    return CL.Deferred(sends, lambda: _combine(
        [d.wait() for d in sends], div, x if self_term else None))


_div_exact = CL._div_exact


def _wire_dequant(val: torch.Tensor, compression: str, impl: str,
                  shards: CL.Shards = CL.WHOLE) -> torch.Tensor:
    """Each replica's own dequantized payload of ``val`` (K, …) under a
    point-to-point wire: a per-sender scale, the full int range. int8 goes
    through the quant kernel; int16 has no kernel in the reference either.
    A block of a split leaf takes the whole leaf's scale."""
    if compression == "int8":
        q, s = C.quantize_shard(val, shards, rows=True, impl=impl)
        return C.dequantize(q, s, impl=impl)
    qmax = 32767
    amax = shards.whole_max(val.abs().reshape(val.shape[0], -1).amax(dim=1))
    scale = _div_exact(torch.clamp(amax, min=1e-12), qmax)
    scale = scale.reshape((-1,) + (1,) * (val.dim() - 1))
    q = torch.clamp(torch.round(val / scale), -qmax, qmax).to(torch.int16)
    return q.float() * scale


def _held(shards, n: int):
    """The flat list of ``shards`` (a tree), or every leaf whole."""
    return T.leaves(shards) if shards is not None else [CL.WHOLE] * n


def _gossip_exchange(values, ef, cfg: SyncConfig, round_idx,
                     impl: str = "kernel", rep=CL.STACKED, shards=None):
    """Neighbor-mixed tree under ``cfg.topology``/``cfg.compression``.

    Returns ``(mixed_tree, new_ef_tree_or_None)``. Compressed wires carry
    ``(q, per-sender scale)``; every replica mixes its *own dequantized*
    payload, so the mixing matrix stays doubly stochastic over what was
    transmitted, and the quantization residual goes to error feedback. A
    neighbor's dequantized payload is the sender's own (the same q times the
    same scale), so the K payloads are dequantized once and permuted.
    """
    if cfg.compression in ("int8", "int16"):
        flat, unflatten = T.flatten(values)
        mixed, new_ef = [], []
        for v, e, sh in zip(flat, T.leaves(ef), _held(shards, len(flat))):
            val = v.float() + e
            deq = _wire_dequant(val, cfg.compression, impl, sh)
            mixed.append(_mix_with(deq,
                                   lambda perm, d=deq: rep.permute(d, perm),
                                   rep.size(v), cfg.topology, round_idx))
            new_ef.append(val - deq)
        return unflatten(mixed), unflatten(new_ef)
    return T.map(lambda v: gossip_mix(v.float(), cfg.topology, round_idx,
                                      rep), values), None


def init_async_buffers(params, topology: str):
    """Seed ``(sent, mixbuf)`` for the async double buffers from a params
    tree: as if every replica had transmitted its current model at a
    previous boundary, so when replicas start identical the first stale
    correction ``mixbuf + (M_ii−1)·sent`` is exactly zero."""
    w_self = gossip_self_weight(topology)
    # at least f32 (bf16 params get f32 buffers) without downcasting f64
    sent = T.map(lambda p: p.to(torch.promote_types(p.dtype, torch.float32),
                                copy=True), params)
    mixbuf = T.map(lambda p: (1.0 - w_self) * p, sent)
    return sent, mixbuf


def _gossip_async_exchange(values, ef, cfg: SyncConfig, round_idx,
                           impl: str = "kernel", rep=CL.STACKED,
                           shards=None):
    """Double-buffered half-exchange: returns ``(recv_tree, sent_tree,
    new_ef_tree_or_None)`` — what lands in the buffers, consumed at the next
    boundary. Under compression ``sent`` is the own *dequantized* payload."""
    if cfg.compression in ("int8", "int16"):
        flat, unflatten = T.flatten(values)
        recv, sent, new_ef = [], [], []
        for v, e, sh in zip(flat, T.leaves(ef), _held(shards, len(flat))):
            val = v + e
            deq = _wire_dequant(val, cfg.compression, impl, sh)
            recv.append(_recv_with(lambda perm, d=deq: rep.permute(d, perm),
                                   rep.size(v), cfg.topology, round_idx))
            sent.append(deq)
            new_ef.append(val - deq)
        return unflatten(recv), unflatten(sent), unflatten(new_ef)
    return (T.map(lambda v: gossip_recv(v, cfg.topology, round_idx, rep),
                  values), values, None)


def _exchange_mean(values, ef, cfg: SyncConfig, round_idx=None,
                   impl: str = "kernel", rep=CL.STACKED, shards=None):
    """Replica exchange of a tree of ``(K, …)`` leaves under
    cfg.compression.

    ``topology="all"`` returns the exact replica mean, as ``(1, …)`` leaves;
    gossip topologies return the neighbor-mixed ``(K, …)`` values
    (``round_idx`` selects the pairwise pairing). Returns ``(tree,
    new_ef_tree_or_None)``.
    """
    if cfg.topology != "all":
        return _gossip_exchange(values, ef, cfg, round_idx, impl, rep,
                                shards)
    if cfg.compression == "int8":
        q, s, new_ef = C.compress_tree(values, ef, rows=True, impl=impl,
                                       shards=shards)
        return C.allgather_mean_dequant(q, s, impl=impl, rep=rep), new_ef
    if cfg.compression == "int16":
        # fixed-point 2-byte wire through an ordinary sum, with one scale
        # shared by the replicas (the reference's pmax) and headroom for the
        # sum: K·qmax ≤ 32767. The sum runs on int32 (across processes
        # that is the wire: NCCL has no int16 reduction); the guard keeps it
        # exact, so it equals an int16 sum
        flat, unflatten = T.flatten(values)
        k = rep.size(flat[0]) if flat else 1
        qmax = 32767 // k
        mean, new_ef = [], []
        for d, e, sh in zip(flat, T.leaves(ef), _held(shards, len(flat))):
            v = d + e
            scale = _div_exact(torch.clamp(sh.whole_max(rep.amax(v.abs())),
                                           min=1e-12), qmax)
            q = torch.clamp(torch.round(v / scale), -qmax, qmax
                            ).to(torch.int16)
            summed = rep.sum(q.to(torch.int32)).float()
            mean.append(_div_exact(summed * scale, k))
            new_ef.append(v - q.float() * scale)
        return unflatten(mean), unflatten(new_ef)
    return T.map(rep.mean, values), None


def _slowmo_step(mean_delta, sync_state, new_state, cfg: SyncConfig):
    """Outer momentum on the averaged delta; returns the applied delta."""
    if cfg.slowmo <= 0.0:
        return mean_delta
    m = T.map(lambda mm, d: cfg.slowmo * mm + d, sync_state["slowmo_m"],
              mean_delta)
    new_state["slowmo_m"] = m
    return T.map(lambda mm: cfg.slowmo_lr * mm, m)


def _f32_delta(params_end, params_start):
    return T.map(lambda e, s: e.float() - s.float(), params_end,
                 params_start)


def _apply_f32(params, delta):
    return T.map(lambda p, d: (p.float() + d).to(p.dtype), params, delta)


def _delta_into(e: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """e − s in f32, written into ``e`` where it is f32."""
    if e.dtype == torch.float32:
        return e.sub_(s.float())
    return e.float() - s.float()


def _cast_like(values, params):
    """``values`` in the dtypes of ``params``, as new tensors of their
    shapes (a ``(1, …)`` mean is written out for every replica)."""
    return T.map(lambda m, p: m.to(p.dtype).expand(p.shape).contiguous(),
                 values, params)


# ---------------------------------------------------------------------------
# sync point — one call per block boundary
# ---------------------------------------------------------------------------

def sync_point(params_start, params_end, sync_state: Dict[str, Any],
               cfg: SyncConfig, *, impl: str = "kernel", mesh=None,
               axis: str = "pod", shards=None
               ) -> Tuple[Any, Dict[str, Any]]:
    """One model synchronization over the replica axis: the leading dim of
    every leaf on one process, or ``mesh``'s ``axis`` across processes
    (each holding one replica; see the module docstring).

    ``params_start`` — the params the block started from (identical across
    replicas for ``overlap="none"``; per-replica under delayed/chunked and
    any gossip topology); ``params_end`` — the replicas' drifted params.
    ``impl`` selects the int8 wire's quantize/dequantize: the quant kernel
    (``"kernel"``) or its plain version (``"torch"``). ``shards`` (a tree
    like the params, or None: every leaf whole) says how the ranks of a
    replica hold each leaf (the module docstring).

    The blocking global sync takes ``params_end`` over, as the reference's
    trainer donates its state (``params_end`` is the local-SGD block's
    working copy, and must not share memory with ``params_start``): it
    computes its f32 leaves' deltas in place, writes the synchronized
    params into its leaves and returns it. At full width that keeps one
    copy of the params fewer alive. The other modes leave ``params_end`` as
    it was.
    """
    rep = CL.replicas(mesh, axis)
    if cfg.gossip_async:
        return _sync_point_gossip_async(params_end, sync_state, cfg, impl,
                                        rep, shards)
    if cfg.topology != "all" and cfg.overlap != "chunked":
        return _sync_point_gossip(params_end, sync_state, cfg, impl, rep,
                                  shards)
    if cfg.overlap == "delayed":
        return _sync_point_delayed(params_start, params_end, sync_state,
                                   cfg, impl, rep, shards)
    if cfg.overlap == "chunked":
        return _sync_point_chunked(params_end, sync_state, cfg, impl, rep,
                                   shards)

    delta = T.map(_delta_into, params_end, params_start)
    new_state = dict(sync_state)
    if cfg.compression == "int8" and cfg.slowmo <= 0.0:
        # each leaf's mean written into params_end as soon as it is
        # dequantized: no tree of means is held beside the params, the
        # start copy and two error-feedback residuals (a copy fewer)
        q, s, new_state["ef"] = C.compress_tree(
            delta, sync_state["ef"], rows=True, impl=impl, shards=shards)
        del delta
        for e, st, qq, ss in zip(T.leaves(params_end),
                                 T.leaves(params_start), T.leaves(q),
                                 T.leaves(s)):
            torch.add(st.float(), C.mean_dequant(qq, ss, impl=impl, rep=rep),
                      out=e)
        return params_end, new_state
    mean_delta, new_ef = _exchange_mean(delta, sync_state.get("ef"), cfg,
                                        impl=impl, rep=rep, shards=shards)
    del delta
    if new_ef is not None:
        new_state["ef"] = new_ef
    step_delta = _slowmo_step(mean_delta, sync_state, new_state, cfg)
    for e, s, d in zip(T.leaves(params_end), T.leaves(params_start),
                       T.leaves(step_delta)):
        torch.add(s.float(), d, out=e)
    return params_end, new_state


def _sync_point_delayed(params_start, params_end, sync_state, cfg, impl,
                        rep, shards=None):
    """Stale-by-one averaging: compute this block's mean, apply last
    block's. Replica k's params stay ``anchor + own latest local delta``;
    applying ``pending = mean_{i−1} − Δ_{i−1,k}`` swaps the stale local
    delta for its average."""
    delta = _f32_delta(params_end, params_start)
    new_state = dict(sync_state)
    mean_delta, new_ef = _exchange_mean(delta, sync_state.get("ef"), cfg,
                                        impl=impl, rep=rep, shards=shards)
    if new_ef is not None:
        new_state["ef"] = new_ef
    step_delta = _slowmo_step(mean_delta, sync_state, new_state, cfg)
    # apply the PREVIOUS boundary's correction to this block's end params
    new_params = _apply_f32(params_end, sync_state["pending"])
    new_state["pending"] = T.map(lambda m, d: m - d, step_delta, delta)
    return new_params, new_state


def _sync_point_gossip(params_end, sync_state, cfg, impl, rep, shards=None):
    """Gossip sync (ring/pairwise): mix parameter *values* with neighbors
    (value form keeps the replica mean invariant). ``overlap="delayed"``
    carries the gossip correction ``mix(w) − w`` one block stale."""
    new_state = dict(sync_state)
    rnd = sync_state.get("gossip_round")
    if rnd is not None:
        new_state["gossip_round"] = rnd + 1
    vals = T.map(lambda p: p.float(), params_end)
    mixed, new_ef = _gossip_exchange(vals, sync_state.get("ef"), cfg,
                                     _round(rnd), impl, rep, shards)
    if new_ef is not None:
        new_state["ef"] = new_ef
    if cfg.overlap == "delayed":
        new_params = _apply_f32(params_end, sync_state["pending"])
        new_state["pending"] = T.map(lambda m, v: m - v, mixed, vals)
        return new_params, new_state
    return _cast_like(mixed, params_end), new_state


def _sync_point_gossip_async(params_end, sync_state, cfg, impl, rep,
                             shards=None):
    """Asynchronous (unsynchronized-round) gossip: mix with the *last
    received* neighbor snapshot. The correction applied here is
    ``mixbuf + M_ii·sent − sent``, the doubly stochastic mix of the snapshot
    every replica transmitted at its previous boundary; this boundary then
    transmits the post-correction params."""
    new_state = dict(sync_state)
    rnd = sync_state.get("gossip_round")
    if rnd is not None:
        new_state["gossip_round"] = rnd + 1
    w_self = gossip_self_weight(cfg.topology)
    vals = T.map(lambda p: p.float(), params_end)
    new_w = T.map(lambda v, rb, s: v + rb + (w_self - 1.0) * s,
                  vals, sync_state["mixbuf"], sync_state["sent"])
    recv, sent, new_ef = _gossip_async_exchange(
        new_w, sync_state.get("ef"), cfg, _round(rnd), impl, rep, shards)
    new_state["mixbuf"] = recv
    new_state["sent"] = sent
    if new_ef is not None:
        new_state["ef"] = new_ef
    return _cast_like(new_w, params_end), new_state


def chunk_assignment(leaves, chunks: int, blocks=None):
    """Leaf index → shard id, byte-balanced (greedy largest-first onto the
    lightest shard; ties broken by leaf order, so equal-size leaves land
    round-robin). ``leaves`` are tensors (or anything with ``shape`` and
    ``element_size()``), one replica's, in tree-leaf order; ``blocks`` (one
    int a leaf, or None) the blocks a leaf is split into across ranks, so
    that its whole size is weighed."""
    counts = blocks if blocks is not None else [1] * len(leaves)
    sizes = [math.prod(leaf.shape) * leaf.element_size() * n
             for leaf, n in zip(leaves, counts)]
    order = sorted(range(len(leaves)), key=lambda i: (-sizes[i], i))
    load = [0] * max(1, chunks)
    assign = [0] * len(leaves)
    for i in order:
        s = min(range(len(load)), key=lambda rr: (load[rr], rr))
        assign[i] = s
        load[s] += sizes[i]
    return assign


def _sync_point_chunked(params_end, sync_state, cfg, impl, rep,
                        shards=None):
    """Value-average one shard of the tree per boundary (the shard of
    ``chunk_idx % chunks``; only its leaves cross the wire). Under a gossip
    topology the shard is neighbor-mixed, the pairwise round advancing once
    per full pass (``chunk_idx // chunks``). ``slowmo > 0`` composes via a
    per-shard outer momentum against each leaf's ``anchor``:

        m ← β·m + (mean_K(w_leaf) − anchor);  w_leaf ← anchor + lr_out·m
    """
    r = max(1, cfg.chunks)
    idx = _round(sync_state["chunk_idx"])
    ef = sync_state.get("ef")
    have_ef = ef is not None
    slowmo = cfg.slowmo > 0.0
    leaves, unflatten = T.flatten(params_end)
    held = _held(shards, len(leaves))
    assign = chunk_assignment([p[0] for p in leaves], r,
                              [sh.count for sh in held])
    ef_leaves = T.leaves(ef) if have_ef else [None] * len(leaves)
    m_leaves = T.leaves(sync_state["slowmo_m"]) if slowmo else None
    a_leaves = T.leaves(sync_state["anchor"]) if slowmo else None
    sub = [i for i in range(len(leaves)) if assign[i] == idx % r]
    vals = {i: leaves[i].float() for i in sub}
    efs = {i: ef_leaves[i] for i in sub} if have_ef else None
    mean, new_ef = _exchange_mean(vals, efs, cfg, round_idx=idx // r,
                                  impl=impl, rep=rep,
                                  shards={i: held[i] for i in sub})
    new_leaves = list(leaves)
    new_ef_leaves = list(ef_leaves)
    new_m = list(m_leaves) if slowmo else None
    new_a = list(a_leaves) if slowmo else None
    for i in sub:
        if slowmo:
            m = cfg.slowmo * m_leaves[i] + (mean[i] - a_leaves[i])
            w_new = a_leaves[i] + cfg.slowmo_lr * m
            new_m[i] = m
            new_a[i] = w_new
            new_leaves[i] = w_new.to(leaves[i].dtype)
        else:
            new_leaves[i] = mean[i].to(leaves[i].dtype).expand(
                leaves[i].shape).contiguous()
        if have_ef:
            new_ef_leaves[i] = new_ef[i]
    new_state = dict(sync_state)
    new_state["chunk_idx"] = sync_state["chunk_idx"] + 1
    if have_ef:
        new_state["ef"] = unflatten(new_ef_leaves)
    if slowmo:
        new_state["slowmo_m"] = unflatten(new_m)
        new_state["anchor"] = unflatten(new_a)
    return unflatten(new_leaves), new_state


def flush_overlap(params, sync_state, cfg: SyncConfig, *, mesh=None,
                  axis: str = "pod"):
    """Collapse overlap staleness to the fully synchronized model.

    ``params``/``sync_state`` in the stacked layout (leading replica dim),
    or, with a ``mesh``, this rank's replica of them (the mean is then over
    ``axis``).
    Under ``delayed`` ``params + pending`` is ``anchor + stepΔ`` on every
    replica; chunked, gossip and async-gossip replicas average to the
    consistent model. With compression on, the error-feedback residual is
    folded in before the collapse. Returns the stacked layout with all
    replicas equal.
    """
    if cfg.overlap == "none" and cfg.topology == "all":
        return params
    if cfg.overlap == "delayed":
        params = T.map(lambda p, q: (p.float() + q).to(p.dtype), params,
                       sync_state["pending"])
    if "ef" in sync_state:
        params = T.map(lambda p, e: (p.float() + e).to(p.dtype), params,
                       sync_state["ef"])

    rep = CL.replicas(mesh, axis)

    def leaf(p):
        m = rep.mean(p.float())
        return m.expand(p.shape).to(p.dtype).contiguous()
    return T.map(leaf, params)


# ---------------------------------------------------------------------------
# analytic byte accounting (delegates to the shared cost module)
# ---------------------------------------------------------------------------

def collective_bytes_per_sync(param_bytes: int, world: int,
                              cfg: SyncConfig) -> int:
    """Analytic wire bytes of one executed sync:
    :func:`repro_torch.core.costmodel.wire_bytes_per_sync`."""
    return int(costmodel.wire_bytes_per_sync(param_bytes, world, cfg))


def amortized_bytes_per_step(param_bytes: int, world: int,
                             cfg: SyncConfig) -> float:
    if cfg.strategy == "sync_every_step":
        return costmodel.wire_bytes_per_sync(param_bytes, world, cfg)
    return costmodel.wire_bytes_per_sync(param_bytes, world, cfg) / max(
        1, cfg.period)
