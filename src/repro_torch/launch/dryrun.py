"""Dry run of every (arch × shape) cell on one card and on the reference's
two meshes: one card's call built on the meta device, its work counted as
it runs, its memory and roofline recorded. The port of
``repro.launch.dryrun``, on H100 terms.

Nothing is drawn or computed: the call runs on the meta device under
:class:`repro_torch.launch.roofline.WorkCounter`, so it needs no card and
runs on the CPU. Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
        --shape train_4k --mesh 16x16
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--workers 4]

Each cell's record (one JSON file a cell under ``--out``) has the
reference's fields, with these changes: ``status`` is ``ok``, ``skip``
(with the reference's reason) or ``error``; ``state_bytes_per_card`` and
``activation_peak_bytes`` (the most bytes the call's ops allocated and held
at once, counted on the meta device) in place of XLA's memory analysis, and
``fits_80g`` in place of ``fits_16g``; ``flops`` (products by dtype) and
``hbm_bytes`` counted, and ``roofline`` from
:func:`repro_torch.launch.roofline.compute_terms` at H100 rates. A cell
counts the one-card call. A train cell's ``state_bytes_per_card`` is the
state as a rank of its mesh holds it (every leaf, its moments and sync
state at their shard shapes: :mod:`repro_torch.launch.specs`); a serving
cell's weights are whole.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import time
import traceback
from typing import List

from repro_torch.config import SyncConfig, get_arch, list_archs
from repro_torch.launch.roofline import compute_terms
from repro_torch.launch.specs import (MESHES, SHAPE_CELLS, build_cell,
                                      cell_runnable)

CARD_BYTES = 80e9      # an H100's memory


def run_cell(arch: str, shape: str, mesh: str = "1", *,
             verbose: bool = True) -> dict:
    """Build and count one cell in the reference's flavour (DDP, or on the
    replica mesh hierarchical sync with H = 8; remat full); returns its
    record (never raises: a failed cell is a data point)."""
    mesh_cfg = MESHES[mesh]
    kind = SHAPE_CELLS[shape].kind
    rec = {"arch": arch, "shape": shape, "mesh": mesh, "kind": kind,
           "status": "ok"}
    ok, reason = cell_runnable(get_arch(arch), shape)
    if not ok:
        rec.update(status="skip", reason=reason)
        return rec
    sync = None
    if mesh_cfg.replica_axis and kind == "train":
        # the reference's multi-pod train flavor: periodic (hierarchical)
        # sync across the pod axis, H = 8 local steps
        sync = SyncConfig(strategy="hierarchical", period=8)
    t0 = time.perf_counter()
    try:
        built = build_cell(arch, shape, mesh_cfg, sync=sync, remat="full")
        counter = built.count()
    except Exception as e:  # noqa: BLE001 — a failed cell is a data point
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        return rec
    count_s = time.perf_counter() - t0
    model_flops = built.model_flops * built.opt_steps
    terms = compute_terms(counter.cost(**built.wire,
                                       collectives=built.collectives),
                          total_devices=mesh_cfg.num_devices,
                          model_flops=model_flops)
    resident = built.state_bytes + counter.peak_bytes
    rec.update(
        sync=dataclasses.asdict(sync) if sync else None,
        opt_steps_per_call=built.opt_steps,
        count_s=round(count_s, 1),
        params=built.param_count,
        active_params=built.active_param_count,
        batch_per_card=built.batch_per_card,
        state_bytes_per_card=built.state_bytes,
        activation_peak_bytes=counter.peak_bytes,
        resident_bytes_per_card=resident,
        fits_80g=resident < CARD_BYTES,
        flops=dict(counter.flops),
        hbm_bytes=counter.bytes,
        aten_ops=counter.ops,
        kernel_records=dict(counter.kernels),
        roofline=dataclasses.asdict(terms),
        notes=built.notes,
    )
    if verbose:
        print(f"[{mesh}] {arch} × {shape}: counted in {count_s:.1f} s | "
              f"{resident / 1e9:.2f} GB a card (fits 80G={rec['fits_80g']})"
              f" | compute {terms.compute_s * 1e3:.2f} ms memory "
              f"{terms.memory_s * 1e3:.2f} ms collective "
              f"{terms.collective_s * 1e3:.2f} ms → {terms.dominant}-bound "
              f"| useful {terms.useful_ratio:.3f}", flush=True)
    return rec


def _run(job) -> dict:
    return run_cell(*job)


def run_all(jobs: List[tuple], workers: int = 1) -> List[dict]:
    """Records of ``jobs`` ((arch, shape, mesh) each), in order; across
    ``workers`` processes (the spawn start method) when more than one."""
    if workers <= 1:
        return [_run(j) for j in jobs]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers) as pool:
        return pool.map(_run, jobs, chunksize=1)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None, choices=list(SHAPE_CELLS))
    p.add_argument("--mesh", default=None, choices=list(MESHES),
                   help="one mesh (default: all three)")
    p.add_argument("--all", action="store_true", help="run every cell")
    p.add_argument("--workers", type=int, default=1,
                   help="processes counting cells at once")
    p.add_argument("--out", default="experiments/dryrun_torch")
    args = p.parse_args(argv)
    if not (args.all or args.arch):
        p.error("pass --arch or --all")
    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPE_CELLS)
    meshes = [args.mesh] if args.mesh else list(MESHES)
    jobs = [(a, s, m) for m in meshes for a in archs for s in shapes]
    # the longest first, so the workers end together: the train cells, the
    # local-SGD blocks of the replica mesh before them
    jobs.sort(key=lambda job: (SHAPE_CELLS[job[1]].kind != "train",
                               not MESHES[job[2]].replica_axis))
    records = run_all(jobs, args.workers)
    os.makedirs(args.out, exist_ok=True)
    for rec in records:
        name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
        with open(os.path.join(args.out, name.replace("/", "_")), "w") as f:
            json.dump(rec, f, indent=1)
        if rec["status"] == "error":
            print(f"[{rec['mesh']}] {rec['arch']} × {rec['shape']}: ERROR "
                  f"{rec['error'][:300]}")
        elif rec["status"] == "skip":
            print(f"[{rec['mesh']}] {rec['arch']} × {rec['shape']}: SKIP "
                  f"({rec['reason']})")
    counts = {st: sum(r["status"] == st for r in records)
              for st in ("ok", "skip", "error")}
    print(f"\ndry-run summary: {counts['ok']} ok / {counts['skip']} skip / "
          f"{counts['error']} error")
    if counts["error"]:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
