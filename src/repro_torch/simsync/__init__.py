"""repro_torch.simsync — cluster simulator of the sync schedule, the port of
``repro.simsync`` (numpy only; held bitwise to the reference on the CPU).

* :mod:`repro_torch.simsync.profiles` — cluster hardware models (per-worker
  compute distributions incl. stragglers, one link's α–β).
* :mod:`repro_torch.simsync.engine` — the discrete-event replay of a full
  sync schedule (topology × overlap × compression × H) on a profile, over
  :mod:`repro_torch.core.costmodel`'s wire bytes; plus the closed-loop
  driver for :class:`repro_torch.core.autotune.AdaptiveController` and the
  schedule-level ``oracle_h`` it is graded against.
* :mod:`repro_torch.simsync.trace` — Chrome-trace export of the timelines.
"""
from repro_torch.simsync.engine import (BlockStats, ClusterSim,  # noqa: F401
                                        SimResult, oracle_h, simulate,
                                        simulate_adaptive, sync_wire_time_s)
from repro_torch.simsync.profiles import (PROFILES,  # noqa: F401
                                          ClusterProfile, LinkProfile,
                                          WorkerProfile, dcn_profile,
                                          get_profile, ici_profile,
                                          uniform_profile)
from repro_torch.simsync.trace import (chrome_trace,  # noqa: F401
                                       save_chrome_trace)
