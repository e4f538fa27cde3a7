#!/usr/bin/env python3
"""The trainer's idle share as each profiler mode reads it, against the
unprofiled block, in turns.

    python3 scripts/profile_modes.py [--rounds 6]

The trainer of ``chip_smoke.py``'s phase 8: smollm-360m at full width,
K = 4 replicas, H = 4, the int8 sync on the quant kernel, AdamW, 8 × 2,048
tokens a microbatch, built through ``build_trainer`` and run 2 blocks to
warm up. Then ``rounds`` rounds of three blocks on the same batch, in a
rotating order:

* ``unprofiled``: the block alone;
* ``device``: under ``torch.profiler`` recording the device's activities
  alone, as ``chip_smoke.device_busy`` does;
* ``device+host``: recording the host's operators too, as
  ``chip_smoke.py`` did before.

Each block starts after a ``gc.collect()``, so no block pays for the
garbage of the one before it. Its span is a CUDA event before it to one
after it, its wall the host clock to a ``torch.cuda.synchronize()``; a
profiled block also gives its device busy time (its kernels', copies' and
fills' durations summed, from the profiler's raw records in both modes,
so only the recording differs), its idle share over its span, and the
seconds the profiler took to stop. For each unprofiled block it prints 1 − busy / span with the
median busy of the ``device`` blocks. The card's name and power limit
(``nvidia-smi``) come first.
"""
from __future__ import annotations

import argparse
import gc
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

MODES = ("unprofiled", "device", "device+host")


def _block(torch, fn, mode):
    """(wall s, span s, busy s or None, device activities, stop s)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def run():
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    gc.collect()
    torch.cuda.synchronize()
    if mode == "unprofiled":
        wall = run()
        return wall, start.elapsed_time(end) * 1e-3, None, 0, 0.0
    activities = [ProfilerActivity.CUDA]
    if mode == "device+host":
        activities.insert(0, ProfilerActivity.CPU)
    prof = profile(activities=activities)
    prof.__enter__()
    wall = run()
    t0 = time.perf_counter()
    prof.__exit__(None, None, None)
    stop = time.perf_counter() - t0
    device = [e.duration_ns() * 1e-9
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    return (wall, start.elapsed_time(end) * 1e-3, sum(device), len(device),
            stop)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=6)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_modes: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as C
    from repro_torch.config import SyncConfig, get_arch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(f"card: {smi.stdout.strip().splitlines()[0]}", flush=True)
    dev = torch.device("cuda", 0)
    sync_cfg = SyncConfig(strategy="periodic", period=C.TRAIN_H,
                          compression="int8")
    cfg = C._train_cfg(get_arch("smollm-360m"), sync_cfg, C.TRAIN_SEQ,
                       C.TRAIN_BATCH, C.TRAIN_K)
    state, step, batches, _, walls, _, _ = C._run_blocks(
        torch, cfg, dev, "kernel", 2)
    print(f"warm-up blocks: {walls} s", flush=True)
    holder = {"state": state}
    del state

    def fn():
        holder["state"], _ = step(holder["state"], batches[-1])

    rows = []
    for r in range(args.rounds):
        for i in range(len(MODES)):
            mode = MODES[(r + i) % len(MODES)]
            wall, span, busy, count, stop = _block(torch, fn, mode)
            rows.append((mode, wall, span, busy))
            line = (f"round {r} {mode}: wall {wall:.4f} s, span "
                    f"{span * 1e3:.3f} ms")
            if busy is not None:
                line += (f", device busy {busy * 1e3:.3f} ms, idle share "
                         f"{100 * (1 - busy / span):.1f}%, {count} device "
                         f"activities, the profiler's stop {stop:.1f} s")
            print(line, flush=True)
    busy = float(np.median([b for m, _, _, b in rows if m == "device"]))
    for mode in MODES:
        spans = [s for m, _, s, _ in rows if m == mode]
        walls = [w for m, w, _, _ in rows if m == mode]
        idle = [100 * (1 - busy / s) for s in spans]
        print(f"{mode}: walls {walls} s, spans {spans} s; 1 − busy / span "
              f"with the device blocks' median busy {busy * 1e3:.3f} ms: "
              f"{idle} %, median {np.median(idle):.1f}%", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
