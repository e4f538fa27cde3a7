"""Chrome-trace export of simulated timelines, the port of
``repro.simsync.trace`` (a copy; a test holds its JSON to the reference's).

Produces the ``chrome://tracing`` / Perfetto JSON array-of-events format
(``ph="X"`` complete events, µs timestamps): one ``tid`` lane per worker,
compute/sync/stall slices colored by category. Open the file in
``chrome://tracing`` or https://ui.perfetto.dev to *see* the schedule —
the all-reduce barrier inheriting a straggler vs gossip's one-hop-per-round
propagation is immediately visible, which no CSV row shows.
"""
from __future__ import annotations

import json
from typing import Iterable, List

from repro_torch.simsync.engine import Slice, SimResult

_CATEGORY = {"compute": "compute", "sync": "comm", "stall": "stall"}
# chrome://tracing's fixed color-name palette
_COLOR = {"compute": "thread_state_running",
          "sync": "rail_response",
          "stall": "terrible"}


def chrome_trace_events(timeline: Iterable[Slice], *, pid: int = 0,
                        label: str = "simsync") -> List[dict]:
    timeline = list(timeline)      # iterated twice; accept generators
    events: List[dict] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": label},
    }]
    workers = sorted({s.worker for s in timeline})
    for w in workers:
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": w, "args": {"name": f"worker {w}"}})
    for s in timeline:
        events.append({
            "name": f"{s.kind} b{s.block}",
            "cat": _CATEGORY.get(s.kind, s.kind),
            "ph": "X",
            "ts": s.start * 1e6,          # chrome traces are in µs
            "dur": max(0.0, (s.end - s.start) * 1e6),
            "pid": pid,
            "tid": s.worker,
            "cname": _COLOR.get(s.kind, ""),
            "args": {"block": s.block},
        })
    return events


def chrome_trace(result: SimResult) -> dict:
    """Full trace document for one simulation run."""
    return {
        "traceEvents": chrome_trace_events(
            result.timeline, label=f"{result.profile} {result.sync_label}"),
        "displayTimeUnit": "ms",
        "otherData": result.summary(),
    }


def save_chrome_trace(path: str, result: SimResult) -> str:
    with open(path, "w") as f:
        json.dump(chrome_trace(result), f)
    return path
