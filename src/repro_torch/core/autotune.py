"""MSF auto-tuning — closing the loop the paper left open. The port of
``repro.core.autotune`` (a copy over the port's own cost model: the port
imports nothing of ``repro``).

The paper *sweeps* the model synchronization frequency by hand and
observes (i) communication time ∝ sync rate and (ii) accuracy flat across
the explored range. This module picks H automatically from first
principles, so the framework can set the schedule per (model × mesh ×
fabric) without a sweep:

**Cost model.** Per optimizer step,

    T(H) ≈ T_step + T_sync / H                    (blocking sync)
    T(H) ≈ max(T_step · H, T_sync) / H            (overlap="delayed")
    T_sync = wire_bytes(P, K, compression, overlap) / BW_link

with ``T_step`` the compute+memory-bound step time (from the roofline
terms or measured) and ``T_sync`` the parameter-sync collective on the
sync axis (DCN for the hierarchical strategy). Under delayed overlap the
collective runs concurrently with the next block's compute and is exposed
only when it outlasts the block, so ``choose_period`` picks a *smaller* H
(more frequent sync at the same wall clock — tighter averaging for free).
``overlap="chunked"`` keeps the blocking formula but ``T_sync`` shrinks by
the shard count. Wire bytes come from :mod:`repro_torch.core.costmodel`, the
same accounting the sync engine's ``collective_bytes_per_sync`` reports —
one formula, two consumers. Communication efficiency alone is monotone in
H — the paper's Figs 13–15 plateau.

**Statistical guardrail.** Local SGD analysis (Stich 2018; Wang & Joshi
2018) bounds the extra optimization error of H-step averaging by a term
∝ H·η²·σ²; empirically the safe envelope is to keep the *parameter
drift* per block small relative to the parameter scale. We expose this as
``max_drift``: H is capped so that the predicted per-block drift
(η·E[‖g‖]·H, callers pass measured grad/param norms) stays below
``max_drift`` × ‖w‖. With the default 1% drift cap, the paper's own
regime (its largest explored blocks) is comfortably inside the envelope.
Gossip topologies (``SyncConfig.topology`` ∈ {ring, pairwise}) mix only a
factor ``1 − λ₂`` per round (Stich 2018's inexact-averaging regime), so the
cap additionally shrinks by the topology's spectral gap — sparser mixing ⇒
more frequent sync at the same drift budget.

``choose_period`` returns the smallest H whose *remaining* sync overhead
is below ``target_overhead`` of the step time, clipped to the drift cap —
i.e. "as low an MSF as helps, and no lower", the paper's conclusion as an
algorithm.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.config.base import SyncConfig
from repro_torch.core import costmodel

# The reference's link rates, kept as the same numbers so that both packages
# solve the same H from the same inputs. They are TPU-fabric inputs (a DCN
# and an ICI link per chip), not H100 facts: one card runs no link at all,
# and the trainer's controller reads the measured T_sync instead.
DCN_BW = 6.25e9       # bytes/s per chip, cross-pod
ICI_BW = 50e9         # bytes/s per chip, intra-pod


@dataclasses.dataclass(frozen=True)
class TuneInputs:
    param_bytes_per_chip: int      # sharded parameter bytes on the sync axis
    replicas: int                  # K — sync-axis size (e.g. pods)
    step_time_s: float             # compute/memory-bound time per opt step
    link_bw: float = DCN_BW        # the sync axis' per-chip bandwidth
    grad_norm: float = 1.0         # E‖g‖ (measured or warmup estimate)
    param_norm: float = 1.0        # ‖w‖
    lr: float = 1e-3


def sync_time_s(inp: TuneInputs, cfg: SyncConfig) -> float:
    """One executed parameter sync on the sync axis (ring model, per chip).

    Wire bytes come from the shared cost module — identical to what the
    sync engine's ``collective_bytes_per_sync`` accounts, including the
    compression and chunked-overlap factors.
    """
    wire = costmodel.wire_bytes_per_sync(
        inp.param_bytes_per_chip, max(2, inp.replicas), cfg)
    return wire / inp.link_bw


def drift_cap(inp: TuneInputs, max_drift: float) -> int:
    """Largest H whose predicted per-block drift stays within the cap."""
    per_step_drift = inp.lr * inp.grad_norm / max(inp.param_norm, 1e-12)
    if per_step_drift <= 0:
        return 1 << 16
    return max(1, int(max_drift / per_step_drift))


def choose_period(inp: TuneInputs, cfg: Optional[SyncConfig] = None, *,
                  target_overhead: float = 0.05,
                  max_drift: float = 0.01,
                  overlap: Optional[str] = None,
                  sync_time_override: Optional[float] = None) -> int:
    """Smallest H with *exposed* sync overhead ≤ ``target_overhead``·step
    time, clipped by the statistical drift cap.

    ``overlap`` (or ``cfg.overlap``) changes the overhead condition:
    blocking needs ``T_sync/H ≤ target·T_step``; delayed only needs the
    collective to fit under the next block plus the overhead allowance,
    ``T_sync/H ≤ (1+target)·T_step`` — so delayed H is always ≤ the
    blocking H for the same inputs (more frequent averaging, same wall
    clock).

    ``sync_time_override`` replaces the analytic wire-bytes/bandwidth
    ``T_sync`` with a *measured* collective time (telemetry) — the adaptive
    controller's path: same solver, calibrated inputs.
    """
    cfg = cfg or SyncConfig(strategy="hierarchical")
    if overlap is not None:
        cfg = dataclasses.replace(cfg, overlap=overlap)
    t_sync = (sync_time_override if sync_time_override is not None
              else sync_time_s(inp, cfg))
    if t_sync <= 0 or inp.step_time_s <= 0:
        return 1
    if cfg.overlap == "delayed" or cfg.gossip_async:
        # the collective runs under the next block's compute (async gossip
        # has a full block of slack by construction) and is exposed only
        # when it outlasts the block plus the overhead allowance
        denom = (1.0 + target_overhead) * inp.step_time_s
    else:
        denom = target_overhead * inp.step_time_s
    h_comm = math.ceil(t_sync / denom)
    cap = drift_cap(inp, max_drift)
    if cfg.overlap == "chunked":
        # each leaf only averages every chunks·H steps, so the *effective*
        # averaging period is chunks×H — the drift cap binds H accordingly
        cap = max(1, cap // max(1, cfg.chunks))
    if cfg.topology != "all":
        # gossip convergence guardrail: one round contracts the replica
        # disagreement only by λ₂ (vs 0 for a global average), so reaching
        # the same consensus takes ~1/(1−λ₂) rounds — the effective
        # averaging period is H/(1−λ₂) and the drift cap must bind H at
        # gap·cap. The gossip analog of the chunked ``cap // chunks``.
        # Async gossip additionally mixes 1-round-stale snapshots, which
        # widens the unmixed-drift window by the staleness — the
        # staleness-aware gap halves the cap for the 1-round double buffer.
        gap = costmodel.effective_spectral_gap(
            max(2, inp.replicas), cfg.topology,
            staleness=1 if cfg.gossip_async else 0)
        cap = max(1, int(cap * gap))
    h = max(1, min(h_comm, cap))
    return h


def predicted_step_time(inp: TuneInputs, cfg: SyncConfig, h: int) -> float:
    return costmodel.overlapped_step_time(
        inp.step_time_s, sync_time_s(inp, cfg), h, cfg)


def snap_to_ladder(h: int, ladder) -> int:
    """Nearest ladder rung to ``h`` in log space (geometric ladders make
    "nearest" multiplicative: 6 snaps to 8 on {1,2,4,8}, not to 4).

    Integer-exact: ``h`` is past the lo→hi boundary iff ``h² > lo·hi``
    (the geometric midpoint), so float-log rounding can never flip a
    tie — exact midpoints resolve to the smaller rung (more frequent
    sync is the safe side).
    """
    ladder = sorted(set(int(r) for r in ladder))
    if not ladder:
        raise ValueError("empty ladder")
    h = max(1, int(h))
    best = ladder[0]
    for lo, hi in zip(ladder, ladder[1:]):
        if h * h > lo * hi:
            best = hi
    return best


# ---------------------------------------------------------------------------
# online adaptive MSF: choose_period re-solved from running telemetry
# ---------------------------------------------------------------------------

class AdaptiveController:
    """Closed-loop MSF tuning: re-solve :func:`choose_period` from measured
    ``T_step``/``T_sync`` EMAs every ``adapt_every`` blocks.

    This turns the static tuner into the adaptive sync-interval scheme of
    Keuper & Pfreundt (arXiv:1510.01155): instead of a hand sweep (or one
    analytic guess from nominal bandwidth), the period tracks what the
    fabric and the workload *actually* do — a contended DCN shows up as a
    larger measured ``T_sync`` and the controller raises H; a fast fabric
    lowers it. All of ``choose_period``'s guardrails (drift cap, chunked
    effective-period scaling, gossip spectral-gap cap) still apply because
    it is the same solver — only ``T_sync`` is overridden by telemetry.

    Hysteresis: H only moves when the re-solve differs from the current
    period by more than ``hysteresis`` (relative), so measurement noise
    cannot thrash the schedule. Defaults come from the
    ``SyncConfig.adapt_*`` fields; ``history`` records every ``(block,
    H)`` transition.

    **Ladder mode** (``ladder=(1, 2, 4, …)``): the controller emits moves
    only onto the given rungs — the pre-compiled H ladder of
    :class:`repro_torch.runtime.ladder.LadderRuntime`, where an H change is a
    flush + switch to an already-compiled block (no recompilation). The
    re-solved H snaps to the log-nearest rung and the schedule moves only
    when that rung is at least ``rung_hysteresis`` rungs away from the
    current one (hysteresis in *rung units*; the geometric spacing itself
    absorbs sub-factor-of-two noise, so the relative ``hysteresis`` knob
    is ignored in ladder mode).

    When the telemetry cannot yet separate T_step/T_sync (the LM block
    path sees only whole-block times, and least squares needs two
    distinct H's), the re-solve falls back to the crude per-step time
    with the *analytic* wire-bytes/bandwidth T_sync — enough to make the
    first move, after which the per-rung block times pin the split.

    The driver loop (the trainer's :class:`repro_torch.runtime.ladder
    .LadderRuntime`, or ``dms_timed_steps``'s caller) calls
    :meth:`observe_block` once per executed block and reads back ``.h``::

        ctrl = AdaptiveController(cfg, param_bytes_per_chip=P, replicas=K)
        for block in schedule:
            run_block(h=ctrl.h)
            ctrl.observe_block(step_s=..., sync_s=...)
    """

    def __init__(self, cfg: SyncConfig, *, param_bytes_per_chip: int,
                 replicas: int, link_bw: float = DCN_BW, lr: float = 1e-3,
                 h0: Optional[int] = None,
                 telemetry: Optional["BlockTelemetry"] = None,
                 adapt_every: Optional[int] = None,
                 hysteresis: Optional[float] = None,
                 target_overhead: Optional[float] = None,
                 max_drift: Optional[float] = None,
                 h_max: int = 1024,
                 ladder=None,
                 rung_hysteresis: Optional[int] = None):
        from repro_torch.core.telemetry import BlockTelemetry
        self.cfg = cfg
        self.param_bytes_per_chip = param_bytes_per_chip
        self.replicas = replicas
        self.link_bw = link_bw
        self.lr = lr
        self.telemetry = telemetry or BlockTelemetry()
        self.adapt_every = max(1, adapt_every if adapt_every is not None
                               else cfg.adapt_every)
        self.hysteresis = (hysteresis if hysteresis is not None
                           else cfg.adapt_hysteresis)
        self.target_overhead = (target_overhead if target_overhead is not None
                                else cfg.adapt_target_overhead)
        self.max_drift = (max_drift if max_drift is not None
                          else cfg.adapt_max_drift)
        self.ladder = tuple(sorted(set(int(r) for r in ladder))) \
            if ladder else None
        self.rung_hysteresis = max(1, rung_hysteresis
                                   if rung_hysteresis is not None
                                   else cfg.adapt_rung_hysteresis)
        self.h_max = max(1, h_max if not self.ladder else self.ladder[-1])
        self.h = max(1, min(h0 if h0 is not None else cfg.period,
                            self.h_max))
        if self.ladder:
            self.h = snap_to_ladder(self.h, self.ladder)
        self._grad_norm = _ema_default()
        self._param_norm = _ema_default()
        self._blocks = 0
        self.history = [(0, self.h)]

    def observe_block(self, *, block_s: Optional[float] = None,
                      sync_s: Optional[float] = None,
                      step_s: Optional[float] = None,
                      grad_norm: Optional[float] = None,
                      param_norm: Optional[float] = None) -> int:
        """Feed one block's measurements; returns the (possibly updated) H.

        ``step_s`` is the per-STEP compute time when measured separately
        (timed-step paths); otherwise pass the whole-block ``block_s`` (and
        ``sync_s`` when the collective was instrumented) and the telemetry
        separates the two.
        """
        if step_s is not None:
            self.telemetry.record_step_time(step_s)
            if sync_s is not None:
                self.telemetry.record_sync_time(sync_s)
        elif block_s is not None:
            self.telemetry.record_block(self.h, block_s, sync_s)
        elif sync_s is not None:
            self.telemetry.record_sync_time(sync_s)
        if grad_norm is not None:
            self._grad_norm.update(float(grad_norm))
        if param_norm is not None:
            self._param_norm.update(float(param_norm))
        self._blocks += 1
        if self._blocks % self.adapt_every == 0:
            self._resolve()
        return self.h

    def _resolve(self) -> None:
        est = self.telemetry.estimates()
        if est is None:
            # single-H block telemetry cannot split T_step/T_sync yet —
            # fall back to the (sync-amortized) per-step time + analytic
            # wire T_sync so the first move can happen at all
            t_step = self.telemetry.per_step_s()
            t_sync = None
            if not t_step:
                return
        else:
            t_step, t_sync = est
        if t_step <= 0:
            return
        inp = TuneInputs(
            param_bytes_per_chip=self.param_bytes_per_chip,
            replicas=self.replicas, step_time_s=t_step,
            link_bw=self.link_bw,
            grad_norm=self._grad_norm.value or 1.0,
            param_norm=self._param_norm.value or 1.0, lr=self.lr)
        h_new = min(self.h_max,
                    choose_period(inp, self.cfg,
                                  target_overhead=self.target_overhead,
                                  max_drift=self.max_drift,
                                  sync_time_override=t_sync))
        if self.ladder:
            target = snap_to_ladder(h_new, self.ladder)
            cur = self.ladder.index(self.h)
            tgt = self.ladder.index(target)
            if tgt != cur and abs(tgt - cur) >= self.rung_hysteresis:
                self.h = target
                self.history.append((self._blocks, target))
            return
        if h_new != self.h and abs(h_new - self.h) > self.hysteresis * self.h:
            self.h = h_new
            self.history.append((self._blocks, h_new))

    def to_dict(self) -> dict:
        return {"h": self.h, "blocks": self._blocks,
                "history": list(self.history),
                "telemetry": self.telemetry.to_dict()}


def _ema_default():
    from repro_torch.core.telemetry import EMA
    return EMA(0.9)


def report(inp: TuneInputs, cfg: Optional[SyncConfig] = None) -> dict:
    """Tuning summary across the candidate ladder (for logs/EXPERIMENTS)."""
    cfg = cfg or SyncConfig(strategy="hierarchical")
    h_star = choose_period(inp, cfg)
    ladder = sorted({1, 8, 64, h_star})
    return {
        "sync_time_s": sync_time_s(inp, cfg),
        "chosen_h": h_star,
        "drift_cap": drift_cap(inp, 0.01),
        "ladder": {
            h: {
                "step_s": predicted_step_time(inp, cfg, h),
                # exposed sync fraction — consistent with step_s under
                # overlap (blocking reduces to sync/H/step as before)
                "overhead": (predicted_step_time(inp, cfg, h)
                             - inp.step_time_s) / inp.step_time_s,
            } for h in ladder
        },
    }
