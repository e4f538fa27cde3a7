#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``src/repro_torch/kernels/*/csrc`` with
nvcc (one compiler per source, all started together), holds each against its
plain PyTorch version on the card, then drives the port's two paths through
their entry points and holds every run to its plain-version twin:

1. device, versions, kernel build times and the compiler's register report;
2. the hinge kernel against its plain version at the ``TestHinge`` shapes
   and the SVM path's batched shapes (rtol 1e-4 / atol 1e-5, two launches
   bitwise equal), with its time, the plain version's and the bound;
3. the SVM path: ``dms`` with 32 workers, block 64, 2 epochs on the epsilon
   stand-in (400,000 × 2,000), kernel launches counted;
4. every ``dms`` mode on the webspam stand-in (350,000 × 254, K=8, block 64,
   one epoch), ``srdms`` and ``seq_sgd`` on the ijcnn1 stand-in (n=4,000);
5. the flash-attention kernel against its plain version at the
   ``TestFlashAttention`` shapes (f32: rtol 1e-4 / atol 2e-5) and the
   serving path's prefill shape (bf16: rtol 2**-7 / atol 1e-4, one bf16
   ulp, a limit SDPA must fail), with its time, the plain version's,
   SDPA's as a yardstick, and the bound;
6. the serving path: ``ServeEngine.generate`` on smollm-360m at full width
   (32 layers, bf16, seeded random weights), 4 prompts of 1,920 tokens and
   128 new tokens each, flash launches counted (one per layer per prefill),
   and the kernel path against the plain path (``attn_impl="torch"``).

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
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12      # H100 SXM float32, outside the tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
L2_BYTES = 50 * 2 ** 20
RTOL, ATOL = 1e-4, 1e-5       # tests/test_kernels.py::TestHinge
W_REL_L2, ACC_DIFF = 1e-3, 0.005
HINGE_SHAPES = [(8, 8), (100, 22), (257, 254), (512, 2000), (64, 128), (33, 7)]
# tests/test_kernels.py::TestFlashAttention: (b, sq, sk, h, kv, dh, causal,
# prefix), f32 at rtol 1e-4 / atol 2e-5, and its bf16 case
FLASH_SHAPES = [(1, 128, 128, 4, 2, 64, True, 0),
                (2, 256, 256, 8, 8, 128, True, 0),
                (1, 200, 200, 6, 2, 64, True, 0),
                (1, 128, 128, 4, 1, 64, True, 32),
                (2, 64, 300, 4, 4, 64, False, 0),
                (1, 512, 512, 2, 2, 32, True, 0)]
FLASH_BF16 = (1, 128, 128, 4, 2, 64, True, 0)
# the serving path's prefill: smollm-360m, 4 prompts of 1,920 tokens
FLASH_MAIN = (4, 1920, 1920, 15, 5, 64, True, 0)
# bf16: the kernel and the plain version both compute in f32 and round only
# the output, so they differ by a rounding flip, at most one bf16 ulp
# (rtol 2**-7 is at least one ulp of any value), and near zero by the two
# f32 sums' difference (~1e-7). A version that rounds the probabilities to
# bf16, as SDPA does, fails this limit at the main shape, and must.
BF16_RTOL, BF16_ATOL = 2 ** -7, 1e-4
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 4, 1920, 128
# kernel path against plain path, relative L2 of the logits: the plain path
# rounds scores and probabilities to bf16 in every layer, the kernel keeps
# them in f32; on the CPU at full width and 32 layers (256 tokens) the two
# are 0.037 apart, and a wrong mask or softmax is O(1)
LOGITS_REL_L2 = 0.1
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


def device_busy(torch, fn):
    """Run ``fn()`` once under ``torch.profiler`` and return (device busy
    s, span s, device activities, top kernels), all of that one run: busy is
    the sum of the durations of the device's kernels, copies and fills (one
    stream, so they do not overlap); span is the device time from a CUDA
    event recorded before ``fn`` to one recorded after it, so busy/span is
    the share of that window the device worked. The profiler slows the
    host, so the idle share it gives is an upper bound of the unprofiled
    run's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    span = start.elapsed_time(end) * 1e-3
    by_name = {}
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(bool(device), "the profiler recorded no device activity")
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return sum(by_name.values()), span, len(device), top


def log_busy(label, busy, span, count, top):
    """One line: the device's busy and idle share of one profiled run's
    span, unclamped (a busy time above the span would show as a negative
    idle share), and where the device time went."""
    names = "; ".join(f"{n[:48]} {1e3 * t:.3f} ms" for n, t in top)
    log(f"{label}: device busy {1e3 * busy:.3f} ms of a {1e3 * span:.3f} ms "
        f"span (one profiled run), idle share {100 * (1 - busy / span):.1f}%; "
        f"{count} device activities; top: {names}")


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
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.hinge import ops as hinge_ops
    kernels = {"hinge": hinge_ops, "flash_attention": flash_ops}

    def build(name):
        t0 = time.perf_counter()
        lib = nvcc.build(name, [kernels[name].SOURCE])
        return lib, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        built = dict(zip(kernels, pool.map(build, kernels)))
    log(f"kernels built in parallel: {time.perf_counter() - t0:.2f} s")
    for name, (lib, secs) in built.items():
        kernels[name].load_library()
        log(f"{name} kernel build: {secs:.2f} s "
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
    w0 = torch.zeros(ds[0].shape[1], device=dev)
    log_busy("dms epsilon", *device_busy(torch, lambda: svm.dms(
        w0, ds[0], ds[1], workers=k, epochs=epochs, block_size=bs,
        device=dev)))
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


def flash_inputs(torch, dev, seed, shape, dtype, copies=1):
    """``copies`` independent (q, k, v) sets, made with numpy from ``seed``."""
    b, sq, sk, h, kv, dh = shape[:6]
    rng = np.random.default_rng(seed)
    return [tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32))
                  .to(dev, dtype)
                  for s in ((b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh)))
            for _ in range(copies)]


def flash_bound(shape, itemsize):
    """(bound_ms, bound_by): q, k, v read once and o written once over the
    HBM rate, or 4·dh flops for every visible (row, key) pair over the
    tensor-core rate of the inputs' type (float32 on the CUDA cores)."""
    b, sq, sk, h, kv, dh, causal, prefix = shape
    rows = np.arange(sq)
    if causal:
        seen = np.minimum(sk, np.maximum(rows + 1, prefix))
    else:
        seen = np.full(sq, min(sk, prefix) if prefix else sk)
    flops = 4 * dh * b * h * int(seen.sum())
    nbytes = itemsize * dh * (2 * b * sq * h + 2 * b * sk * kv)
    rate = BF16_FLOPS_PER_S if itemsize == 2 else FP32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def phase_flash(torch, dev):
    """The flash kernel against its plain version; returns the main row."""
    from repro_torch.kernels.flash_attention import ops, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = [(shape, torch.float32, 1e-4, 2e-5) for shape in FLASH_SHAPES]
    cases += [(shape, torch.bfloat16, BF16_RTOL, BF16_ATOL)
              for shape in (FLASH_BF16, FLASH_MAIN)]
    main_row = None
    for i, (shape, dtype, rtol, atol) in enumerate(cases):
        causal, prefix = shape[6], shape[7]
        itemsize = torch.finfo(dtype).bits // 8
        b, sq, sk, h, kv, dh = shape[:6]
        per_set = itemsize * dh * (2 * b * sq * h + 2 * b * sk * kv)
        copies = int(min(64, max(2, -(-2 * L2_BYTES // per_set))))
        sets = flash_inputs(torch, dev, 200 + i, shape, dtype, copies)
        q, k, v = sets[0]
        got = ops.flash_attention(q, k, v, causal=causal, prefix_len=prefix)
        again = ops.flash_attention(q, k, v, causal=causal, prefix_len=prefix)
        want = ref.flash_attention(q, k, v, causal=causal, prefix_len=prefix)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        label = (f"b={b},sq={sq},sk={sk},h={h},kv={kv},dh={dh},"
                 f"causal={causal},prefix={prefix},{str(dtype)[6:]}")
        check(got.shape == q.shape and got.dtype == dtype,
              f"flash {label}: output {tuple(got.shape)} {got.dtype}")
        check(torch.equal(got, again), f"flash {label}: two launches differ")
        check(torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol),
              f"flash {label}: kernel vs plain max abs err {err}")

        def kernel(q, k, v):
            return ops.flash_attention(q, k, v, causal=causal,
                                       prefix_len=prefix)

        def plain(q, k, v):
            return ref.flash_attention(q, k, v, causal=causal,
                                       prefix_len=prefix)

        ms = device_ms(torch, kernel, sets)
        plain_ms = device_ms(torch, plain, sets)
        bound_ms, bound_by = flash_bound(shape, itemsize)
        log(f"flash {label}: max_abs_err {err:.3e} bitwise-repeatable "
            f"kernel {ms * 1e3:.4f} us plain {plain_ms * 1e3:.4f} us "
            f"bound {bound_ms * 1e3:.4f} us ({bound_by}) "
            f"[{copies} input sets]")
        if shape == FLASH_MAIN:
            # the yardstick: one PyTorch call for the same function (heads
            # first, as it takes them); the port never calls it
            def library(q, k, v):
                return sdpa(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), is_causal=True,
                            enable_gqa=True)
            lib_out = library(q, k, v).transpose(1, 2)
            lib_err = float((lib_out.float() - want.float()).abs().max())
            library_ms = device_ms(torch, library, sets)
            # elements over the limit, and over one of atol 8e-3 (about
            # two ulps at the outputs' scale) for comparison
            over = {(name, a): int((o.float() - want.float()).abs().gt(
                        a + rtol * want.float().abs()).sum())
                    for name, o in (("kernel", got), ("SDPA", lib_out))
                    for a in (atol, 8e-3)}
            log(f"flash main shape: SDPA {library_ms * 1e3:.4f} us "
                f"(max abs diff vs plain {lib_err:.3e}); elements of "
                f"{want.numel()} over rtol {rtol:g} / atol {atol:g}: kernel "
                f"{over['kernel', atol]}, SDPA {over['SDPA', atol]}; over "
                f"atol 8e-3: kernel {over['kernel', 8e-3]}, SDPA "
                f"{over['SDPA', 8e-3]}; kernel at "
                f"{100 * bound_ms / ms:.2f}% of its bound")
            check(over["SDPA", atol] > 0, "the main shape's limit passes "
                  "SDPA's bf16 probabilities: it cannot tell them from f32")
            main_row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=library_ms)
    return main_row


def rel_l2(torch, a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def phase_serve(torch, dev, cfg, batch, prompt_len, gen):
    """``ServeEngine.generate`` through the kernel path (flash launches
    counted), then the kernel path against the plain path: prefill logits,
    layer 0's cache (computed before any attention: bitwise equal) and every
    decode step's logits teacher-forced on the kernel path's tokens."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.launch.serve import ServeEngine
    max_len = prompt_len + gen + 1
    t0 = time.perf_counter()
    engines = {impl: ServeEngine(cfg, dev, max_len=max_len, attn_impl=impl)
               for impl in ("kernel", "torch")}
    torch.cuda.synchronize()
    log(f"serve {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, vocab {cfg.vocab_size}, "
        f"bf16; two engines built in {time.perf_counter() - t0:.2f} s")
    pk, pt = (e.params.state_dict() for e in engines.values())
    check(all(torch.equal(pk[n], pt[n]) for n in pk),
          "the two engines' seeded weights differ")
    del pk, pt
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, size=(batch, prompt_len))).to(dev)

    # the main path, as a user calls it
    engine = engines["kernel"]
    torch.cuda.synchronize()
    ops.LAUNCHES = 0
    t0 = time.perf_counter()
    tokens = engine.generate(prompts, gen)
    wall = time.perf_counter() - t0
    launches = ops.LAUNCHES
    check(tokens.shape == (batch, gen), f"tokens {tokens.shape}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          "generated token ids out of range")
    check(launches == cfg.n_layers,
          f"{launches} flash launches in one prefill, expected "
          f"{cfg.n_layers}")
    log(f"serve generate: {batch} x {prompt_len} prompt tokens, {gen} new "
        f"tokens each: wall {wall:.4f} s, {tokens.size / wall:.1f} new "
        f"tokens/s; flash launches {launches} (one per layer)")

    # kernel path and plain path, step by step on the kernel path's tokens
    forced = torch.from_numpy(tokens).to(dev).long()
    runs = {}
    for impl, eng in engines.items():
        torch.cuda.synchronize()
        ops.LAUNCHES = 0
        t0 = time.perf_counter()
        logits, cache = eng.prefill(prompts)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_launches = ops.LAUNCHES
        steps = []
        t0 = time.perf_counter()
        for i in range(gen):
            steps.append(eng.decode(forced[:, i:i + 1], cache,
                                    prompt_len + i))
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            eng.prefill(prompts)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        runs[impl] = dict(logits=logits, cache=cache, steps=steps,
                          prefill_first_s=prefill_s,
                          prefill_s=float(np.median(times)),
                          decode_ms=1e3 * decode_s / gen,
                          launches=prefill_launches)
        log(f"serve {impl} path: prefill {runs[impl]['prefill_s']:.4f} s "
            f"(median of 3; first {prefill_s:.4f} s), decode "
            f"{runs[impl]['decode_ms']:.3f} ms a step ({batch} tokens), "
            f"{1e3 * batch / runs[impl]['decode_ms']:.1f} tokens/s in "
            f"decode; flash launches in prefill {prefill_launches}")
    n_prof = min(16, gen)
    log_busy("serve kernel-path prefill",
             *device_busy(torch, lambda: engine.prefill(prompts)))
    _, cache = engine.prefill(prompts)
    log_busy(f"serve decode, {n_prof} steps", *device_busy(torch, lambda: [
        engine.decode(forced[:, i:i + 1], cache, prompt_len + i)
        for i in range(n_prof)]))
    kr, tr = runs["kernel"], runs["torch"]
    check(kr["launches"] == cfg.n_layers and tr["launches"] == 0,
          f"prefill flash launches {kr['launches']} / {tr['launches']}")
    greedy = torch.stack([torch.argmax(s, dim=-1) for s in
                          [kr["logits"]] + kr["steps"][:-1]], dim=1)
    check(torch.equal(greedy, forced),
          "the kernel path's logits do not reproduce its generated tokens")
    for name in ("k", "v"):
        check(torch.equal(kr["cache"][name][0], tr["cache"][name][0]),
              f"layer 0 cache {name} differs between the paths")
    for t in [kr["logits"]] + kr["steps"]:
        check(bool(torch.isfinite(t).all()), "kernel path logits not finite")
    prefill_rel = rel_l2(torch, kr["logits"], tr["logits"])
    step_rel = [rel_l2(torch, a, b) for a, b in zip(kr["steps"], tr["steps"])]
    agree = float((torch.argmax(kr["logits"], -1)
                   == torch.argmax(tr["logits"], -1)).float().mean())
    log(f"serve kernel vs plain: prefill logits rel L2 {prefill_rel:.4e}, "
        f"decode steps rel L2 max {max(step_rel):.4e} median "
        f"{float(np.median(step_rel)):.4e} (bound {LOGITS_REL_L2}); "
        f"first-token agreement {agree:.2f}; layer 0 cache bitwise equal")
    check(prefill_rel <= LOGITS_REL_L2,
          f"prefill logits rel L2 {prefill_rel} > {LOGITS_REL_L2}")
    check(max(step_rel) <= LOGITS_REL_L2,
          f"decode logits rel L2 {max(step_rel)} > {LOGITS_REL_L2}")
    return launches


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
    flash_row = phase_flash(torch, dev)
    from repro_torch.config import get_arch
    flash_launches = phase_serve(torch, dev, get_arch("smollm-360m"),
                                 SERVE_BATCH, SERVE_PROMPT, SERVE_GEN)
    log(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "hinge_block_grad", "route": "cuda",
        "source": "src/repro_torch/kernels/hinge/csrc/hinge.cu",
        "replaces": "src/repro/kernels/hinge/kernel.py:27",
        "launches": launches, "max_abs_err": row["max_abs_err"],
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:32",
        "launches": flash_launches, **flash_row}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
