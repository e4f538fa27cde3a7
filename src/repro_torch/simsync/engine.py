"""Discrete-event simulator of the model-synchronization schedule, the port
of ``repro.simsync.engine`` (a copy: numpy only, over the port's own cost
model and config; a test holds it bitwise to the reference).

It replays the *schedule* analytically, the DAG-timeline idea of Shi et al.
(arXiv:1805.03812), over a :class:`ClusterProfile`:

* per-block compute times are sampled from each worker's distribution
  (jitter, persistent slowdowns, transient straggles);
* one sync's wire time is ``costmodel.wire_bytes_per_sync(...) / BW`` plus
  the topology's per-hop latency: the byte accounting the sync engine and
  the auto-tuner read, so simulator and real path cannot drift;
* the event recurrence encodes the schedule semantics of
  :mod:`repro_torch.core.sync`:

  - ``topology="all"``: a sync is a global barrier: it starts at the max
    arrival over all K workers (one straggler stalls everyone).
  - ``"ring"``/``"pairwise"``: a worker's sync waits only for its
    neighborhood (two ring neighbors / one rotating partner), so a
    straggler's delay propagates one hop per round instead of instantly.
  - ``overlap="none"``/``"chunked"``: blocking: the worker resumes when
    its collective completes (chunked has already shrunk the wire bytes by
    the shard count via the cost model).
  - ``overlap="delayed"``: the boundary-*b* collective runs concurrently
    with block *b+1*; the worker stalls at boundary *b+1* only if the
    in-flight collective outlasts that block's compute.
  - ``gossip_async`` (gossip topologies): *unsynchronized rounds*: a
    worker's sync event waits only on messages that have **arrived**,
    never on a neighbor's round completion. Each boundary consumes the
    last received neighbor payload (nominally the neighbor's previous
    round, the 1-round double buffer) and sends its own; a payload that
    has not landed yet stays unconsumed and the buffer's staleness grows
    instead of the worker stalling. A transient straggle therefore delays
    *only the straggled worker's own blocks* (``BlockStats``/``SimResult``
    expose the clean-block mean and the realized buffer staleness so the
    decoupling is measurable).

Every boundary emits per-worker timeline slices (compute / sync / stall)
for the Chrome-trace export (:mod:`repro_torch.simsync.trace`) and per-block
``T_step``/``T_sync``, the numbers the trainer's telemetry reports, which
is what lets :class:`repro_torch.core.autotune.AdaptiveController` close its
loop against the simulator (``simulate_adaptive``) and be graded against
the schedule-level optimum (``oracle_h``). A profile of measured T_step and
T_sync (:func:`repro_torch.simsync.profiles.uniform_profile`) replays the
card's own schedule.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.config.base import SyncConfig
from repro_torch.core import costmodel
from repro_torch.simsync.profiles import ClusterProfile


@dataclasses.dataclass(frozen=True)
class Slice:
    """One timeline span of one worker (for the Chrome-trace export)."""

    worker: int
    kind: str          # compute | sync | stall
    start: float       # seconds
    end: float
    block: int


@dataclasses.dataclass(frozen=True)
class BlockStats:
    """Per-block measurements — what the real telemetry would report.

    ``compute_max_s`` / ``sync_wire_s`` are the *host-observed* pair: a
    timed run (``svm.dms_timed_steps``) measures the
    sharded compute until its slowest shard finishes, then the collective
    alone — so arrival spread lands in the compute number and the sync
    number is the barrier-free occupancy. That pair is what calibrates the
    adaptive controller; ``sync_s`` (mean instrumented around the
    collective, straggler waits included — the paper's Figs 10–12
    methodology) is what the comm-breakdown rows report.
    """

    block_s: float        # mean worker wall time of the block
    compute_s: float      # mean worker compute time inside the block
    compute_max_s: float  # slowest worker's compute (host-observed)
    sync_s: float         # mean instrumented collective time (incl. waits)
    sync_wire_s: float    # barrier-free collective occupancy (α·hops + B/β)
    exposed_s: float      # mean critical-path comm exposure


@dataclasses.dataclass
class SimResult:
    profile: str
    sync_label: str
    h: int
    workers: int
    steps: int
    blocks: int
    wall_clock_s: float        # slowest worker's final clock
    compute_s: float           # mean per-worker total compute
    comm_exposed_s: float      # mean per-worker exposed (critical-path) comm
    comm_wire_s: float         # mean per-worker collective occupancy
    timeline: List[Slice]
    # decoupling metrics: a (worker, block) sample is *clean* when that
    # worker did not draw a transient straggle that block. Synchronized
    # schedules leak neighbor straggles into clean blocks (barrier/group
    # waits); async gossip must keep clean blocks at the straggler-free
    # block time — exactly what the acceptance row compares.
    clean_block_mean_s: float = 0.0
    straggled_frac: float = 0.0
    # realized receive-buffer staleness (rounds behind the consumer's
    # round) — async mode only; the nominal double-buffer value is 1
    stale_rounds_mean: float = 0.0
    stale_rounds_max: int = 0

    @property
    def per_step_s(self) -> float:
        return self.wall_clock_s / max(1, self.steps)

    @property
    def comm_fraction(self) -> float:
        tot = self.compute_s + self.comm_exposed_s
        return self.comm_exposed_s / tot if tot > 0 else 0.0

    def summary(self) -> dict:
        return {
            "profile": self.profile, "sync": self.sync_label, "H": self.h,
            "workers": self.workers, "steps": self.steps,
            "blocks": self.blocks, "wall_s": self.wall_clock_s,
            "compute_s": self.compute_s,
            "comm_exposed_s": self.comm_exposed_s,
            "comm_wire_s": self.comm_wire_s,
            "per_step_us": self.per_step_s * 1e6,
            "comm_fraction": self.comm_fraction,
            "clean_block_mean_s": self.clean_block_mean_s,
            "straggled_frac": self.straggled_frac,
            "stale_rounds_mean": self.stale_rounds_mean,
            "stale_rounds_max": self.stale_rounds_max,
        }


def _latency_hops(cfg: SyncConfig, k: int) -> int:
    """Collective hop count for the α (latency) term of one sync."""
    if cfg.topology == "ring":
        return 2                      # two neighbor exchanges
    if cfg.topology == "pairwise":
        return 1                      # one rotating partner
    if cfg.compression == "int8":
        return max(1, k - 1)          # all-gather
    return max(1, 2 * (k - 1))        # ring all-reduce (RS + AG)


def sync_wire_time_s(profile: ClusterProfile, cfg: SyncConfig) -> float:
    """Occupancy of ONE executed collective: α·hops + bytes/β.

    Bytes come from the shared cost model (including compression and the
    chunked ``/chunks`` factor) — one formula, three consumers (hardware
    engine, auto-tuner, simulator).
    """
    k = max(2, profile.world)
    wire = costmodel.wire_bytes_per_sync(profile.param_bytes, k, cfg)
    return (profile.link.latency * _latency_hops(cfg, k)
            + wire / profile.link.bandwidth)


class ClusterSim:
    """Incremental discrete-event simulation: one ``run_block(h)`` per sync
    block, so a controller can sit in the loop and change H between blocks.
    """

    def __init__(self, profile: ClusterProfile, cfg: Optional[SyncConfig] = None,
                 *, seed: int = 0, record_timeline: bool = False):
        self.profile = profile
        self.cfg = cfg or SyncConfig(strategy="periodic")
        if self.cfg.topology == "pairwise" and profile.world % 2:
            raise ValueError("topology='pairwise' needs an even worker count")
        self.async_rounds = bool(self.cfg.gossip_async)
        if self.async_rounds and self.cfg.topology == "all":
            raise ValueError("gossip_async needs a gossip topology "
                             "(ring/pairwise)")
        k = profile.world
        self.k = k
        self.rng = np.random.default_rng(seed)
        self.t = np.zeros(k)                    # per-worker clock
        self._inflight: Optional[np.ndarray] = None   # delayed-collective done
        self.block_idx = 0
        self.steps = 0
        self.record_timeline = record_timeline
        self.timeline: List[Slice] = []
        self.compute_total = np.zeros(k)
        self.exposed_total = np.zeros(k)
        self.wire_total = np.zeros(k)
        # decoupling accounting: block durations split by whether the
        # worker itself drew a transient straggle that block
        self._clean_dur = 0.0
        self._clean_n = 0
        self._hit_n = 0
        self._last_hit = np.zeros(k, bool)
        # async: per-block send-launch history (for message-arrival lookups)
        # + realized receive staleness stats. Sender index arrays depend
        # only on round parity (ring not even on that) — precompute both.
        self._launch_hist: List[np.ndarray] = []
        if self.async_rounds:
            self._senders = (self._in_senders(0), self._in_senders(1))
        self._stale_sum = 0.0
        self._stale_n = 0
        self._stale_max = 0
        self.t_comm = sync_wire_time_s(profile, self.cfg)
        self._step_mean = np.array([w.step_time * w.slowdown
                                    for w in profile.workers])
        self._jitter = np.array([w.jitter for w in profile.workers])
        self._straggle_p = np.array([w.straggle_prob for w in profile.workers])
        self._straggle_f = np.array([w.straggle_factor
                                     for w in profile.workers])

    # ------------------------------------------------------------------
    def _sample_compute(self, h: int) -> np.ndarray:
        base = h * self._step_mean
        if self._jitter.any():
            # per-STEP noise: independent step jitter averages out over the
            # block (CLT), so the block's relative spread is jitter/sqrt(H).
            # A single per-block factor would make barrier waits grow ∝ H
            # and fabricate a runaway feedback for the adaptive controller.
            sig = self._jitter / np.sqrt(h)
            # unit-mean lognormal so jitter never biases the mean step time
            base = base * self.rng.lognormal(-sig ** 2 / 2, sig)
        if self._straggle_p.any():
            hit = self.rng.random(self.k) < self._straggle_p
            base = np.where(hit, base * self._straggle_f, base)
            self._last_hit = hit
        else:
            self._last_hit = np.zeros(self.k, bool)
        return base

    def _in_senders(self, rnd: int) -> List[np.ndarray]:
        """Per-worker sender indices of the round-``rnd`` exchange (one
        array per incoming wire slot: ring two, pairwise one)."""
        i = np.arange(self.k)
        if self.cfg.topology == "ring":
            return [np.roll(i, 1), np.roll(i, -1)]
        if rnd % 2 == 0:
            return [i ^ 1]
        return [np.where(i % 2 == 0, (i - 1) % self.k, (i + 1) % self.k)]

    def _account_staleness(self, b: int, t_now: np.ndarray) -> None:
        """Record the realized receive-buffer staleness at boundary ``b``:
        for each incoming wire, how many rounds behind the *last arrived*
        message is (nominal double-buffer value: 1). Seed buffers (no
        message arrived yet) are skipped. The backward scan breaks at the
        first (latest) arrived round — normally immediately, and only a
        worker whose sender fell r rounds behind scans r entries."""
        hist = self._launch_hist            # includes this block at [b]
        slots = len(self._senders[0])
        for i in range(self.k):
            deadline = t_now[i]
            for slot in range(slots):
                for r in range(b, -1, -1):
                    j = int(self._senders[r % 2][slot][i])
                    if hist[r][j] + self.t_comm <= deadline:
                        s = b - r
                        self._stale_sum += s
                        self._stale_n += 1
                        if s > self._stale_max:
                            self._stale_max = s
                        break

    def _group_max(self, arr: np.ndarray) -> np.ndarray:
        """Per-worker max arrival over its sync coupling group."""
        if self.k == 1:
            return arr
        topo = self.cfg.topology
        if topo == "all":
            return np.full(self.k, arr.max())
        if topo == "ring":
            return np.maximum(arr, np.maximum(np.roll(arr, 1),
                                              np.roll(arr, -1)))
        # pairwise: alternating odd–even pairings (parity per executed
        # round; chunked advances it once per full round-robin pass —
        # mirrors sync.py's ``chunk_idx // chunks``)
        rnd = self.block_idx
        if self.cfg.overlap == "chunked":
            rnd = self.block_idx // max(1, self.cfg.chunks)
        i = np.arange(self.k)
        if rnd % 2 == 0:
            partner = i ^ 1
        else:
            partner = np.where(i % 2 == 0, (i - 1) % self.k,
                               (i + 1) % self.k)
        return np.maximum(arr, arr[partner])

    # ------------------------------------------------------------------
    def run_block(self, h: int) -> BlockStats:
        """Advance every worker through H local steps + one sync point."""
        h = max(1, int(h))
        start = self.t.copy()
        comp = self._sample_compute(h)
        comp_end = start + comp
        b = self.block_idx

        if self.async_rounds:
            # unsynchronized rounds: the boundary consumes whatever has
            # arrived (never waits on a neighbor's round) and launches its
            # own send, which runs under the next block's compute — zero
            # critical-path exposure; a late message only grows the
            # consumer's buffer staleness (accounted below)
            launch = comp_end
            new_t = comp_end.copy()
            sync_meas = np.zeros(self.k)
            exposed = np.zeros(self.k)
            self._launch_hist.append(launch.copy())
            self._account_staleness(b, new_t)
        elif self.cfg.overlap == "delayed":
            # stall only if the previous boundary's collective outlasts
            # this block's compute
            boundary = (np.maximum(comp_end, self._inflight)
                        if self._inflight is not None else comp_end)
            stall = boundary - comp_end
            launch = boundary
            done = self._group_max(boundary) + self.t_comm
            sync_meas = done - launch        # instrumenting the collective
            self._inflight = done
            new_t = boundary
            exposed = stall
        else:
            # blocking (none/chunked): barrier wait + wire on the critical path
            launch = comp_end
            sync_start = self._group_max(comp_end)
            done = sync_start + self.t_comm
            sync_meas = done - launch
            new_t = done
            exposed = done - comp_end

        if self.record_timeline:
            for i in range(self.k):
                self.timeline.append(Slice(i, "compute", start[i],
                                           comp_end[i], b))
                if self.async_rounds:
                    # the non-blocking send: occupies the wire under the
                    # next block's compute, no stall lane ever
                    self.timeline.append(Slice(i, "sync", launch[i],
                                               launch[i] + self.t_comm, b))
                elif self.cfg.overlap == "delayed":
                    if exposed[i] > 0:
                        self.timeline.append(Slice(i, "stall", comp_end[i],
                                                   new_t[i], b))
                    self.timeline.append(Slice(i, "sync", launch[i], done[i],
                                               b))
                else:
                    self.timeline.append(Slice(i, "sync", comp_end[i],
                                               done[i], b))

        dur = new_t - start
        clean = ~self._last_hit
        self._clean_dur += float(dur[clean].sum())
        self._clean_n += int(clean.sum())
        self._hit_n += int(self._last_hit.sum())
        self.t = new_t
        self.block_idx += 1
        self.steps += h
        self.compute_total += comp
        self.exposed_total += exposed
        self.wire_total += self.t_comm
        return BlockStats(block_s=float(np.mean(new_t - start)),
                          compute_s=float(np.mean(comp)),
                          compute_max_s=float(np.max(comp)),
                          sync_s=float(np.mean(sync_meas)),
                          sync_wire_s=self.t_comm,
                          exposed_s=float(np.mean(exposed)))

    def drain(self) -> None:
        """Wait out the last in-flight delayed collective (end of training)."""
        if self._inflight is not None:
            stall = np.maximum(self._inflight - self.t, 0.0)
            self.exposed_total += stall
            if self.record_timeline:
                for i in range(self.k):
                    if stall[i] > 0:
                        self.timeline.append(Slice(i, "stall", self.t[i],
                                                   self._inflight[i],
                                                   self.block_idx))
            self.t = np.maximum(self.t, self._inflight)
            self._inflight = None

    def result(self, h_label: int) -> SimResult:
        self.drain()
        samples = self.k * max(1, self.block_idx)
        return SimResult(
            profile=self.profile.name, sync_label=self.cfg.msf_label,
            h=h_label, workers=self.k, steps=self.steps,
            blocks=self.block_idx, wall_clock_s=float(self.t.max()),
            compute_s=float(self.compute_total.mean()),
            comm_exposed_s=float(self.exposed_total.mean()),
            comm_wire_s=float(self.wire_total.mean()),
            timeline=self.timeline,
            clean_block_mean_s=(self._clean_dur / self._clean_n
                                if self._clean_n else 0.0),
            straggled_frac=self._hit_n / samples,
            stale_rounds_mean=(self._stale_sum / self._stale_n
                               if self._stale_n else 0.0),
            stale_rounds_max=self._stale_max)


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------

def simulate(profile: ClusterProfile, cfg: Optional[SyncConfig] = None, *,
             h: int, steps: int = 0, blocks: int = 0, seed: int = 0,
             record_timeline: bool = False) -> SimResult:
    """Replay a fixed-H schedule. Give ``steps`` (total optimizer steps —
    the fixed-work comparison the comm ∝ 1/H curve needs) or ``blocks``."""
    if not blocks:
        if not steps:
            raise ValueError("pass steps= or blocks=")
        blocks = max(1, steps // max(1, h))
    sim = ClusterSim(profile, cfg, seed=seed,
                     record_timeline=record_timeline)
    for _ in range(blocks):
        sim.run_block(h)
    return sim.result(h)


def simulate_adaptive(profile: ClusterProfile, cfg: SyncConfig, controller, *,
                      blocks: int, seed: int = 0,
                      record_timeline: bool = False
                      ) -> Tuple[SimResult, List[Tuple[int, int]]]:
    """Closed loop: the controller picks each block's H from the simulated
    telemetry (measured per-step compute + instrumented collective time) —
    the simulator standing in for the cluster the controller would tune on.
    Returns the result plus the controller's ``(block, H)`` history.
    """
    sim = ClusterSim(profile, cfg, seed=seed,
                     record_timeline=record_timeline)
    for _ in range(blocks):
        h = controller.h
        stats = sim.run_block(h)
        # feed the host-observed pair (see BlockStats): slowest-shard
        # compute + barrier-free collective — mean instrumented sync would
        # fold straggler wait into T_sync and make the re-solve chase its
        # own barrier (H runaway)
        controller.observe_block(step_s=stats.compute_max_s / max(1, h),
                                 sync_s=stats.sync_wire_s)
    return sim.result(controller.h), list(controller.history)


def oracle_h(profile: ClusterProfile, cfg: Optional[SyncConfig] = None, *,
             target_overhead: float = 0.05, steps: int = 4096,
             h_max: int = 1024, seed: int = 0) -> int:
    """The simulator's ground-truth H: the smallest period whose simulated
    per-step time is within ``1 + target_overhead`` of the compute-bound
    floor (per-step time at ``h_max``) — the same "as low an MSF as helps,
    and no lower" objective ``choose_period`` solves analytically, but
    graded on the replayed schedule (barrier waits, stragglers, overlap
    exposure included). Bisection is valid because per-step time is
    monotone non-increasing in H.
    """
    def per_step(h: int) -> float:
        return simulate(profile, cfg, h=h, steps=steps, seed=seed).per_step_s

    floor = per_step(h_max)
    budget = (1.0 + target_overhead) * floor
    if per_step(1) <= budget:
        return 1
    lo, hi = 1, h_max                 # per_step(lo) > budget ≥ per_step(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if per_step(mid) <= budget:
            hi = mid
        else:
            lo = mid
    return hi
