#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written hinge kernel from ``src/repro_torch/kernels/hinge/csrc``
with nvcc, holds it against its plain PyTorch version on the card, then
drives the paper's SVM path through the port's entry points at the published
dataset sizes and holds every run to its plain-version twin:

1. device, versions, kernel build time and the compiler's register report;
2. the kernel against the plain version at the ``TestHinge`` shapes and the
   main path's batched shapes (rtol 1e-4 / atol 1e-5, two launches bitwise
   equal), with its time, the plain version's and the bound;
3. the main path: ``dms`` with 32 workers, block 64, 2 epochs on the epsilon
   stand-in (400,000 × 2,000), kernel launches counted;
4. every ``dms`` mode on the webspam stand-in (350,000 × 254, K=8, block 64,
   one epoch), ``srdms`` and ``seq_sgd`` on the ijcnn1 stand-in (n=4,000).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero without that line. Without CUDA it exits 1 at once. It imports
no JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12      # H100 SXM float32, outside the tensor cores
L2_BYTES = 50 * 2 ** 20
RTOL, ATOL = 1e-4, 1e-5       # tests/test_kernels.py::TestHinge
W_REL_L2, ACC_DIFF = 1e-3, 0.005
HINGE_SHAPES = [(8, 8), (100, 22), (257, 254), (512, 2000), (64, 128), (33, 7)]
DMS_MODES = [("none", "all", False), ("delayed", "all", False),
             ("chunked", "all", False), ("none", "ring", False),
             ("none", "pairwise", False), ("none", "ring", True),
             ("none", "pairwise", True)]


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def device_ms(torch, fn, arg_sets, runs: int = 21) -> float:
    """Device time of one ``fn(*args)`` call: a CUDA graph of one call per
    argument set (distinct buffers, more bytes than L2 holds where the shape
    allows, so every call reads cold data, as the training loop does) is
    replayed ``runs`` times after warm-up; the median run over its calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for args in arg_sets:
            fn(*args)
    for _ in range(3):
        graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(runs):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / len(arg_sets))
    return float(np.median(times))


def hinge_inputs(torch, dev, seed, x_shape, w_shape, copies=1):
    """``copies`` independent (w, x, y) sets, made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(copies):
        x = rng.normal(size=x_shape).astype(np.float32)
        y = np.where(rng.random(x_shape[:-1]) > 0.5, 1.0, -1.0
                     ).astype(np.float32)
        w = rng.normal(size=w_shape).astype(np.float32)
        out.append(tuple(torch.from_numpy(a).to(dev) for a in (w, x, y)))
    return out


def hinge_bound(x_shape, w_shape):
    """(bound_ms, bound_by): bytes read once and written once over HBM rate,
    or the flops (two GEMVs) over the float32 rate, whichever is larger."""
    k = x_shape[0] if len(x_shape) == 3 else 1
    n, d = x_shape[-2:]
    nbytes = 4 * (k * n * d + k * n + int(np.prod(w_shape)) + k * d)
    flops = 4 * k * n * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.hinge import ops
    t0 = time.perf_counter()
    lib = nvcc.build("hinge", [ops.SOURCE])
    ops.load_library()
    log(f"hinge kernel build+load: {time.perf_counter() - t0:.2f} s "
        f"({os.path.relpath(lib, REPO)})")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")
    return card


def phase_kernel(torch, dev):
    """The kernel against the plain version; returns the main path's row."""
    from repro_torch.kernels.hinge import ops, ref
    cases = [((n, d), (d,), 1.0, f"n={n},d={d},C=1") for n, d in HINGE_SHAPES]
    cases += [((64, 16), (16,), c, f"n=64,d=16,C={c}") for c in (0.1, 1.0, 10.0)]
    cases += [((32, 64, 2000), (2000,), 1.0, "K=32,n=64,d=2000,shared w"),
              ((32, 64, 2000), (32, 2000), 1.0, "K=32,n=64,d=2000,per-worker w"),
              ((8, 512, 254), (254,), 1.0, "K=8,n=512,d=254,shared w")]
    main_row = None
    for i, (x_shape, w_shape, c, label) in enumerate(cases):
        per_set = 4 * int(np.prod(x_shape))
        copies = int(min(64, max(2, -(-2 * L2_BYTES // per_set))))
        sets = hinge_inputs(torch, dev, 100 + i, x_shape, w_shape, copies)
        w, x, y = sets[0]
        got = ops.hinge_block_grad(w, x, y, c)
        again = ops.hinge_block_grad(w, x, y, c)
        want = ref.hinge_block_grad(w, x, y, c)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.equal(got, again), f"{label}: two launches differ")
        check(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
              f"{label}: kernel vs plain max abs err {err}")
        ms = device_ms(torch, lambda a, b, e: ops.hinge_block_grad(a, b, e, c),
                       sets)
        plain_ms = device_ms(
            torch, lambda a, b, e: ref.hinge_block_grad(a, b, e, c), sets)
        bound_ms, bound_by = hinge_bound(x_shape, w_shape)
        log(f"hinge {label}: max_abs_err {err:.3e} bitwise-repeatable "
            f"kernel {ms * 1e3:.4f} us plain {plain_ms * 1e3:.4f} us "
            f"bound {bound_ms * 1e3:.4f} us ({bound_by}) "
            f"[{copies} input sets]")
        if label == "K=32,n=64,d=2000,shared w":
            main_row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
    return main_row


def async_growth(workers: int, topology: str) -> float:
    """Spectral radius of ``M − αI`` at α = 1 (epoch 0): the async gossip
    recurrence is ``w ← (M − αI)·w + α·g``, so above 1 a mode grows by this
    factor every block, in the reference as in the port."""
    from repro_torch.core import costmodel
    return max(float(np.abs(np.linalg.eigvals(m - np.eye(workers))).max())
               for m in costmodel.mixing_matrices(workers, topology))


def _dms_pair(torch, dev, ds, label, expect_launches, **kw):
    """``dms`` on the kernel path (launches counted) and on the plain path;
    holds the two to the relative-L2 and accuracy bounds. Where the async
    recurrence grows in epoch 0, the reference itself overflows over a long
    epoch (``tests/test_torch_svm.py::test_async_ring_diverges_like_reference``):
    there both paths must end non-finite, as the reference does."""
    from repro_torch.core import svm
    from repro_torch.kernels.hinge import ops
    x, y, xt, yt = ds
    w0 = torch.zeros(x.shape[1], device=dev)
    out = {}
    for impl in ("kernel", "torch"):
        torch.cuda.synchronize()
        ops.LAUNCHES = 0
        t0 = time.perf_counter()
        w = svm.dms(w0, x, y, grad_impl=impl, device=dev, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.LAUNCHES
        check(w.shape == w0.shape, f"{label} {impl}: model shape {w.shape}")
        acc = float(svm.accuracy(w, xt, yt))
        out[impl] = (w, acc, wall, launches)
    wk, acck, wallk, launches = out["kernel"]
    wt, acct, wallt, launches_t = out["torch"]
    growth = (async_growth(kw["workers"], kw["topology"])
              if kw.get("gossip_async") else 0.0)
    if growth > 1.0:
        finite = [bool(torch.isfinite(v).all()) for v in (wk, wt)]
        log(f"dms {label}: async growth {growth:.4f} per block at alpha=1 "
            f"over {expect_launches} blocks; model finite kernel {finite[0]} "
            f"plain {finite[1]} (the reference overflows here too); kernel "
            f"launches {launches} (expected {expect_launches}), plain-path "
            f"launches {launches_t}; wall kernel {wallk:.3f} s plain "
            f"{wallt:.3f} s")
        check(finite == [False, False],
              f"{label}: expected both paths to overflow as the reference "
              f"does, got finite={finite}")
        check(launches == expect_launches and launches_t == 0,
              f"{label}: launches {launches}/{launches_t}")
        return wk, acck, wallk, launches
    for impl, v in (("kernel", wk), ("torch", wt)):
        check(bool(torch.isfinite(v).all()), f"{label} {impl}: not finite")
    rel = float((wk - wt).norm() / wt.norm())
    log(f"dms {label}: kernel launches {launches} (expected "
        f"{expect_launches}), plain-path launches {launches_t}; test acc "
        f"kernel {acck:.4f} plain {acct:.4f}; rel L2(w) {rel:.3e}; wall "
        f"kernel {wallk:.3f} s plain {wallt:.3f} s")
    check(launches == expect_launches,
          f"{label}: {launches} kernel launches, expected {expect_launches}")
    check(launches_t == 0, f"{label}: the plain path launched the kernel")
    check(rel <= W_REL_L2, f"{label}: rel L2 {rel} > {W_REL_L2}")
    check(abs(acck - acct) <= ACC_DIFF,
          f"{label}: accuracy {acck} vs {acct}")
    return wk, acck, wallk, launches


def _load(torch, dev, name, **kw):
    from repro_torch.data import make_svm_dataset
    t0 = time.perf_counter()
    ds = make_svm_dataset(name, seed=0, **kw)
    gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    arrays = tuple(torch.from_numpy(a).to(dev) for a in
                   (ds.x_train, ds.y_train, ds.x_test, ds.y_test))
    torch.cuda.synchronize()
    log(f"data {name}: train {tuple(ds.x_train.shape)} test "
        f"{tuple(ds.x_test.shape)}; generated in {gen:.1f} s, to the card in "
        f"{time.perf_counter() - t0:.2f} s")
    return arrays


def phase_main(torch, dev, n_override=None):
    """dms(K=32, block 64, 2 epochs) on epsilon: the paper's main path."""
    from repro_torch.core import svm
    k, bs, epochs = 32, 64, 2
    if n_override:
        log(f"epsilon cut to n={n_override} (published 400,000)")
    ds = _load(torch, dev, "epsilon", n_override=n_override)
    n_local = ds[0].shape[0] // k
    blocks = n_local // bs
    w, acc, wall, launches = _dms_pair(
        torch, dev, ds, "epsilon K=32 block=64 epochs=2",
        epochs * blocks, workers=k, epochs=epochs, block_size=bs)
    obj = float(svm.hinge_objective(w, ds[0], ds[1]))
    check(np.isfinite(obj), "epsilon objective not finite")
    log(f"main path: epsilon test acc {acc:.4f} objective {obj:.6e} "
        f"wall {wall:.4f} s ({1e6 * wall / (epochs * blocks):.1f} us a block) "
        f"launches {launches} ({epochs} epochs x {blocks} blocks)")
    return launches


def phase_modes(torch, dev, n_override=None, ijcnn_n=4000):
    from repro_torch.core import svm
    from repro_torch.kernels.hinge import ops
    ds = _load(torch, dev, "webspam", n_override=n_override)
    k, bs = 8, 64
    blocks = (ds[0].shape[0] // k) // bs
    for overlap, topology, gossip_async in DMS_MODES:
        label = f"webspam {overlap}/{topology}{'/async' if gossip_async else ''}"
        _dms_pair(torch, dev, ds, label, blocks, workers=k, epochs=1,
                  block_size=bs, overlap=overlap, topology=topology,
                  gossip_async=gossip_async)

    x, y, xt, yt = _load(torch, dev, "ijcnn1", n_override=ijcnn_n)
    w0 = torch.zeros(x.shape[1], device=dev)
    epochs, bs = 5, 512
    res = {}
    for impl in ("kernel", "torch"):
        ops.LAUNCHES = 0
        res[impl] = svm.srdms(w0, x, y, epochs=epochs, block_size=bs,
                              grad_impl=impl, device=dev)
        res[impl + "_launches"] = ops.LAUNCHES
    rel = float((res["kernel"] - res["torch"]).norm() / res["torch"].norm())
    expect = epochs * (x.shape[0] // bs)
    log(f"srdms ijcnn1 block=512 epochs=5: launches {res['kernel_launches']} "
        f"(expected {expect}); rel L2(w) vs plain {rel:.3e}; test acc "
        f"{float(svm.accuracy(res['kernel'], xt, yt)):.4f}")
    check(res["kernel_launches"] == expect and res["torch_launches"] == 0,
          "srdms launch count")
    check(rel <= W_REL_L2, f"srdms rel L2 {rel}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w_seq = svm.seq_sgd(w0, x, y, epochs=1, device=dev)
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    w_cpu = svm.seq_sgd(w0.cpu(), x.cpu(), y.cpu(), epochs=1, device="cpu")
    err = float((w_seq.cpu() - w_cpu).abs().max())
    log(f"seq_sgd ijcnn1 n={x.shape[0]} epochs=1: {seq_s:.2f} s on the card; "
        f"max abs diff vs the CPU run {err:.3e}; test acc "
        f"{float(svm.accuracy(w_seq, xt, yt)):.4f}")
    # per-point updates reset w at α=1: a flipped kink is one point's step
    check(err <= 1e-4, f"seq_sgd card vs CPU {err}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs on a CUDA card", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    # the plain version's products run in full float32 on the card, never TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = phase_device(torch)
    row = phase_kernel(torch, dev)
    launches = phase_main(torch, dev)
    phase_modes(torch, dev)
    log(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "hinge_block_grad", "route": "cuda",
        "source": "src/repro_torch/kernels/hinge/csrc/hinge.cu",
        "replaces": "src/repro/kernels/hinge/kernel.py:27",
        "launches": launches, "max_abs_err": row["max_abs_err"],
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
