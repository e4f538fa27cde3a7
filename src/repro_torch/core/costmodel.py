"""Sync-collective cost accounting, copied whole from ``repro.core.costmodel``.

In the reference, ``core.sync.collective_bytes_per_sync`` and
``core.autotune.sync_time_s`` derive from :func:`wire_bytes_per_sync`; in the
port, ``core.autotune`` and ``core.sync`` read it. The module is numpy-only and a test holds every function
exactly equal to the reference's.

Accounting conventions (per chip, ``param_bytes`` is the fp32 footprint of
the synced tree on this chip):

* fp32 ring all-reduce moves ``2·P·(K−1)/K`` bytes.
* int8 exchange is an all-gather (summing int8 on the wire would overflow):
  ``P/4·(K−1)`` bytes.
* int16 fixed-point all-reduce: ``P/2`` payload through the ring,
  ``2·(P/2)·(K−1)/K = P·(K−1)/K`` bytes.

Overlap modes (``SyncConfig.overlap``):

* ``delayed`` moves the same bytes — it hides them behind the next block's
  compute instead of shrinking them, so the *bytes* are unchanged and only
  the *time* model (:func:`overlapped_step_time`) differs.
* ``chunked`` syncs one of ``cfg.chunks`` round-robin shards per sync point,
  dividing per-sync wire bytes by the shard count.

Topologies (``SyncConfig.topology``):

* ``all`` — the global collective above; wire bytes grow with ``(K−1)/K``
  (fp32/int16 ring all-reduce) or ``K−1`` (int8 all-gather).
* ``ring`` — each chip sends its payload to exactly two ``ppermute``
  neighbors: ``2·payload`` bytes per sync, **independent of K**. The point-
  to-point wire carries the compressed payload directly (fp32 ``P``, int16
  ``P/2``, int8 ``P/4``), with a per-sender scale instead of the all-reduce's
  shared one.
* ``pairwise`` — one rotating partner per sync: ``1·payload`` bytes.

Gossip pays for the byte saving in *mixing speed*: one round contracts the
replica disagreement by only λ₂ (the mixing matrix's second-largest
eigenvalue modulus, :func:`gossip_lambda2`) instead of collapsing it to
zero. The auto-tuner converts the spectral gap ``1 − λ₂`` into a tighter H
cap (``repro.core.autotune.choose_period``).
"""
from __future__ import annotations

import functools

import numpy as np

from repro_torch.config.base import SyncConfig


def _payload_factor(compression: str) -> float:
    """Wire bytes per fp32 parameter byte for the compressed payload."""
    if compression == "int8":
        return 0.25
    if compression == "int16":
        return 0.5
    return 1.0


def gossip_degree(topology: str) -> int:
    """Neighbors a replica SENDS to per sync round (0 = global collective)."""
    if topology == "ring":
        return 2
    if topology == "pairwise":
        return 1
    return 0


def wire_bytes_per_sync(param_bytes: int, world: int, cfg: SyncConfig) -> float:
    """Wire bytes of ONE executed sync collective (per chip)."""
    if cfg.topology in ("ring", "pairwise"):
        # point-to-point neighbor exchange: degree × compressed payload,
        # independent of the replica count (no global barrier, no ring pass)
        wire = gossip_degree(cfg.topology) * param_bytes * _payload_factor(
            cfg.compression)
    elif cfg.compression == "int8":
        wire = param_bytes / 4 * (world - 1)
    elif cfg.compression == "int16":
        wire = param_bytes * (world - 1) / world
    else:
        wire = 2 * param_bytes * (world - 1) / world
    if cfg.overlap == "chunked":
        wire /= max(1, cfg.chunks)
    return wire


# ---------------------------------------------------------------------------
# gossip mixing matrices and their spectra (shared with the sync engine's
# vmap simulation and the auto-tuner's convergence guardrail)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def mixing_matrices(world: int, topology: str):
    """Per-round doubly stochastic mixing matrices as a tuple of (K, K)
    ``np.float64`` arrays; round r applies matrix ``r % len(out)``.

    * ``all``      → one matrix, ``1/K`` everywhere (exact consensus).
    * ``ring``     → one circulant: 1/3 on the diagonal and both off-ring
                     diagonals (for K=2 the single neighbor arrives twice,
                     giving [[1/3, 2/3], [2/3, 1/3]] — still doubly
                     stochastic).
    * ``pairwise`` → two alternating odd–even pairings: even rounds average
                     pairs (0,1)(2,3)…, odd rounds (1,2)(3,4)…(K−1,0).
                     Requires even K so every replica has a partner.
    """
    if topology == "all":
        return (np.full((world, world), 1.0 / world),)
    if topology == "ring":
        m = np.zeros((world, world))
        for i in range(world):
            m[i, i] += 1.0 / 3.0
            m[i, (i + 1) % world] += 1.0 / 3.0
            m[i, (i - 1) % world] += 1.0 / 3.0
        return (m,)
    if topology == "pairwise":
        if world % 2:
            raise ValueError(
                f"topology='pairwise' needs an even replica count, got {world}")
        mats = []
        for parity in (0, 1):
            m = np.zeros((world, world))
            for i in range(world):
                if parity == 0:
                    j = i ^ 1
                else:
                    j = (i - 1) % world if i % 2 == 0 else (i + 1) % world
                m[i, i] = m[i, j] = 0.5
            mats.append(m)
        return tuple(mats)
    raise ValueError(f"unknown topology: {topology!r}")


@functools.lru_cache(maxsize=None)
def gossip_lambda2(world: int, topology: str) -> float:
    """Per-round disagreement contraction factor λ₂ ∈ [0, 1).

    Second-largest eigenvalue modulus of the round-averaged mixing operator:
    one gossip round shrinks ``‖w_k − mean(w)‖`` by at most λ₂. For the
    alternating pairwise schedule λ₂ is the geometric per-round mean over
    the two-round product (a single pairwise round alone does not contract
    the worst-case disagreement). ``all`` → 0 (exact consensus per round).
    """
    if world <= 1 or topology == "all":
        return 0.0
    mats = mixing_matrices(world, topology)
    prod = functools.reduce(np.matmul, reversed(mats))
    eig = np.sort(np.abs(np.linalg.eigvals(prod)))[::-1]
    lam = float(eig[1]) if len(eig) > 1 else 0.0
    return min(1.0, max(0.0, lam ** (1.0 / len(mats))))


def spectral_gap(world: int, topology: str) -> float:
    """``1 − λ₂``: the per-round consensus gain of the topology."""
    return 1.0 - gossip_lambda2(world, topology)


def effective_spectral_gap(world: int, topology: str, *,
                           staleness: int = 0) -> float:
    """Staleness-aware consensus gain of a gossip round.

    Async (unsynchronized-round) gossip mixes snapshots that are
    ``staleness`` rounds old. The drift-free contraction *rate* is
    unchanged — with zero local drift the double-buffered recurrence
    collapses to synchronous gossip ``staleness`` rounds behind
    (``w_t = M w_{t−1}``, tested in test_async_gossip) — but each block's
    local drift now waits ``staleness`` extra rounds before its first
    mixing, so the unmixed-drift window grows from ``H/gap`` steps to
    ``(1+staleness)·H/gap``. The drift guardrail scales its cap by the
    gap, so charging staleness as ``gap/(1+s)`` makes the effective
    averaging period — and therefore the H cap — account for the stale
    round exactly. ``staleness=0`` is the synchronous gossip gap.
    """
    if staleness < 0:
        raise ValueError(f"staleness must be >= 0, got {staleness}")
    return spectral_gap(world, topology) / (1.0 + staleness)


def overlapped_step_time(step_time_s: float, sync_time_s: float, h: int,
                         cfg: SyncConfig) -> float:
    """Per-optimizer-step wall clock under the configured overlap mode.

    * blocking (``none``/``chunked``): ``T_step + T_sync/H`` — the collective
      sits on the critical path at every block boundary (chunked has already
      shrunk ``T_sync`` by the shard count via the wire-bytes model).
    * ``delayed`` — and ``gossip_async``, whose double-buffered exchange is
      a full block ahead of its consumer by construction:
      ``max(T_step·H, T_sync)/H`` — the collective runs concurrently with
      the next block's H steps of compute and is exposed only when it
      outlasts them.
    """
    h = max(1, h)
    if cfg.overlap == "delayed" or cfg.gossip_async:
        return max(step_time_s * h, sync_time_s) / h
    return step_time_s + sync_time_s / h
