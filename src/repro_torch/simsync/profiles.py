"""Cluster profiles: the simulator's hardware model, the port of
``repro.simsync.profiles`` (a copy; a test holds it to the reference).

A :class:`ClusterProfile` is everything the discrete-event engine needs to
replay a sync schedule: per-worker compute-time distributions (persistent
slowdowns and transient straggle events, the two straggler flavors the
gossip work decouples differently) and one link model for the sync fabric
(bandwidth + per-hop latency, the standard α–β collective cost). Wire
*bytes* are not modeled here: they come from
:mod:`repro_torch.core.costmodel`, the accounting the sync engine reports,
so the simulator and the real path cannot disagree about what a sync moves.

Profiles are plain frozen dataclasses (JSON-friendly via ``to_dict``) so a
measured cluster can be captured as a profile file and replayed: a profile
of the card's own measured T_step and T_sync is built with
:func:`uniform_profile` (``chip_smoke.py``'s phase tooling does so).

The built-ins in :data:`PROFILES` are the reference's, with the reference's
numbers, kept for parity: they describe the reference's TPU fabrics (a DCN
link of 6.25 GB/s and ~50 µs hops across pods, an ICI link of 50 GB/s and
~1 µs hops within one), not an H100 or its links, as
:data:`repro_torch.core.autotune.DCN_BW` does not either:

* ``ici_pod``       — intra-pod ICI syncing a small fast model: a distinct
                      comm/compute balance.
* ``dcn_default``   — cross-pod DCN: the paper's regime, oracle H in the
                      tens (Figs 13–15).
* ``dcn_straggler`` — DCN plus one persistently 4× slower worker: the
                      all-reduce barrier inherits the straggler every
                      block; gossip only couples its neighborhood.
* ``dcn_transient`` — DCN with rare 20× transient straggles on every
                      worker (GC pauses / preemption blips).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

# the link rates the auto-tuner's parity inputs use (the reference's TPU
# fabrics), imported, not redefined, so both read one number
from repro_torch.core.autotune import DCN_BW, ICI_BW

# the reference's per-hop latencies of its TPU fabrics, kept for parity
DCN_LATENCY = 50e-6   # seconds per collective hop across the DCN
ICI_LATENCY = 1e-6    # seconds per hop on the intra-pod interconnect


@dataclasses.dataclass(frozen=True)
class LinkProfile:
    """α–β model of the sync fabric: per-hop latency α, bandwidth β."""

    bandwidth: float               # bytes/s per chip
    latency: float = 0.0           # seconds per collective hop
    name: str = "link"


@dataclasses.dataclass(frozen=True)
class WorkerProfile:
    """Per-worker compute-time distribution for one optimizer step.

    A block of H steps costs ``H · step_time · slowdown`` scaled by a
    unit-mean lognormal jitter factor (σ = ``jitter``), times
    ``straggle_factor`` with probability ``straggle_prob`` per block
    (transient straggles hit whole blocks: GC pause / preemption blip).
    """

    step_time: float               # mean seconds per optimizer step
    jitter: float = 0.0            # lognormal sigma of the per-block factor
    slowdown: float = 1.0          # persistent multiplier (straggler if > 1)
    straggle_prob: float = 0.0     # per-block transient straggle probability
    straggle_factor: float = 1.0   # block-time multiplier when straggling


@dataclasses.dataclass(frozen=True)
class ClusterProfile:
    """One simulated cluster: K workers + the sync-fabric link.

    ``param_bytes`` is the fp32 footprint of the synced tree per chip,
    fed to ``costmodel.wire_bytes_per_sync`` exactly like the real engine's
    byte accounting.
    """

    name: str
    workers: Tuple[WorkerProfile, ...]
    link: LinkProfile
    param_bytes: int

    @property
    def world(self) -> int:
        return len(self.workers)

    def step_times(self) -> np.ndarray:
        return np.array([w.step_time * w.slowdown for w in self.workers])

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "ClusterProfile":
        return ClusterProfile(
            name=d["name"],
            workers=tuple(WorkerProfile(**w) for w in d["workers"]),
            link=LinkProfile(**d["link"]),
            param_bytes=int(d["param_bytes"]))


def uniform_profile(name: str, k: int, *, step_time: float, jitter: float,
                    bandwidth: float, latency: float, param_bytes: int,
                    slow_workers: Dict[int, float] = None,
                    straggle_prob: float = 0.0,
                    straggle_factor: float = 1.0) -> ClusterProfile:
    """K same-spec workers, optionally with per-index persistent slowdowns."""
    slow = slow_workers or {}
    workers = tuple(
        WorkerProfile(step_time=step_time, jitter=jitter,
                      slowdown=slow.get(i, 1.0),
                      straggle_prob=straggle_prob,
                      straggle_factor=straggle_factor)
        for i in range(k))
    return ClusterProfile(name=name, workers=workers,
                          link=LinkProfile(bandwidth=bandwidth,
                                           latency=latency, name=name),
                          param_bytes=param_bytes)


def dcn_profile(k: int = 8, *, step_time: float = 2e-3, jitter: float = 0.02,
                param_bytes: int = 8_000_000, name: str = "dcn_default",
                **kw) -> ClusterProfile:
    """The reference's cross-pod DCN profile (its TPU fabric): the paper's
    comm-bound regime (T_sync ≈ T_step, oracle H in the tens)."""
    return uniform_profile(name, k, step_time=step_time, jitter=jitter,
                           bandwidth=DCN_BW, latency=DCN_LATENCY,
                           param_bytes=param_bytes, **kw)


def ici_profile(k: int = 8, *, step_time: float = 5e-4, jitter: float = 0.01,
                param_bytes: int = 8_000_000, name: str = "ici_pod",
                **kw) -> ClusterProfile:
    """The reference's intra-pod ICI profile (its TPU fabric): 8× the DCN
    bandwidth and µs hops, paired with a small fast model, a *different*
    comm/compute balance than the DCN profile so the controller is graded
    on two distinct operating points."""
    return uniform_profile(name, k, step_time=step_time, jitter=jitter,
                           bandwidth=ICI_BW, latency=ICI_LATENCY,
                           param_bytes=param_bytes, **kw)


PROFILES: Dict[str, ClusterProfile] = {
    "dcn_default": dcn_profile(),
    "ici_pod": ici_profile(),
    "dcn_straggler": dcn_profile(name="dcn_straggler",
                                 slow_workers={3: 4.0}),
    "dcn_transient": dcn_profile(name="dcn_transient", straggle_prob=0.02,
                                 straggle_factor=20.0),
}


def get_profile(name: str) -> ClusterProfile:
    if name not in PROFILES:
        raise KeyError(
            f"unknown cluster profile {name!r}; known: {sorted(PROFILES)}")
    return PROFILES[name]
