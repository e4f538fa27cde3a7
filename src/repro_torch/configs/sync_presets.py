"""Named model-synchronization schedules (the sync analog of ``--arch``),
copied from ``repro.configs.sync_presets``: the same ids and fields.

One place that pins the combinations the experiments sweep, so launch
scripts and benchmarks reference a preset id instead of re-assembling
``SyncConfig`` fields. ``--set sync.topology=ring``-style dotted overrides
still compose on top.

The gossip presets pair a sparse topology with ``overlap="delayed"`` by
default: gossip already removed the global barrier, delayed overlap
additionally takes the two ppermutes off the block's critical path — the
full straggler-decoupled schedule the ROADMAP's gossip item asks for.

The port's trainer refuses the ``hierarchical`` presets: their data-axis
sync runs across cards (ROADMAP §1 item 9).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.config.base import SyncConfig

SYNC_PRESETS: Dict[str, SyncConfig] = {
    # the paper's DMS: blocking global average every H steps
    "paper_blocking": SyncConfig(strategy="periodic", period=64),
    # the overlap engine on the global collective
    "overlap_delayed": SyncConfig(strategy="periodic", period=64,
                                  overlap="delayed"),
    # gossip: no global barrier at all
    "gossip_ring": SyncConfig(strategy="periodic", period=64,
                              topology="ring", overlap="delayed"),
    "gossip_pairwise": SyncConfig(strategy="periodic", period=64,
                                  topology="pairwise", overlap="delayed"),
    # gossip + compressed point-to-point wire (int16 needs no psum headroom
    # on the neighbor exchange — full range per sender)
    "gossip_ring_int16": SyncConfig(strategy="periodic", period=64,
                                    topology="ring", overlap="delayed",
                                    compression="int16"),
    # asynchronous (unsynchronized-round) gossip: double-buffered
    # ppermute exchange — each replica mixes with the last *received*
    # neighbor snapshot (bounded staleness = 1 round), so a transient
    # straggler delays only itself. overlap stays "none": the exchange is
    # already a full block off the critical path by construction.
    "gossip_ring_async": SyncConfig(strategy="periodic", period=64,
                                    topology="ring", gossip_async=True),
    "gossip_pairwise_async": SyncConfig(strategy="periodic", period=64,
                                        topology="pairwise",
                                        gossip_async=True),
    # hierarchical flavor: every-step data-axis sync, gossip across pods
    "hierarchical_gossip_ring": SyncConfig(strategy="hierarchical",
                                           period=64, topology="ring",
                                           overlap="delayed"),
    # adaptive MSF: the controller re-solves H online from
    # measured T_step/T_sync every adapt_every blocks — `period` is only
    # the starting point. DCN flavor starts low and grows into the fabric;
    # the gossip flavor keeps the spectral-gap cap in the loop.
    "adaptive_dcn": SyncConfig(strategy="hierarchical", period=8,
                               overlap="delayed", adaptive=True,
                               adapt_every=16),
    "adaptive_gossip_ring": SyncConfig(strategy="periodic", period=8,
                                       topology="ring", overlap="delayed",
                                       adaptive=True, adapt_every=16),
    # mid-run adaptive MSF via the pre-compiled H-ladder: the
    # trainer warms every rung of the geometric ladder
    # {1,2,…,adapt_h_max} at launch and the controller moves between them
    # live — an H change is a flush + switch, zero recompiles. Rung
    # hysteresis replaces the relative-band knob (geometric spacing
    # already absorbs sub-2x noise).
    "adaptive_ladder_dcn": SyncConfig(strategy="hierarchical", period=8,
                                      overlap="delayed", adaptive=True,
                                      adapt_every=8, adapt_h_max=64),
    "adaptive_ladder_gossip_ring": SyncConfig(strategy="periodic", period=8,
                                              topology="ring",
                                              overlap="delayed",
                                              adaptive=True, adapt_every=8,
                                              adapt_h_max=64),
}


def get_sync_preset(name: str) -> SyncConfig:
    if name not in SYNC_PRESETS:
        raise KeyError(
            f"unknown sync preset {name!r}; known: {sorted(SYNC_PRESETS)}")
    return SYNC_PRESETS[name]
