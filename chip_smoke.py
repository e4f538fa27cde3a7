#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``src/repro_torch/kernels/*/csrc`` with
nvcc (one compiler per source, all started together), holds each against its
plain PyTorch version on the card, then drives the port's paths (SVM
training, LM serving of three model families, LM training) through their
entry points and holds every run to its plain-version twin:

1. device, versions, kernel build times and the compiler's register report;
2. the hinge kernels against their plain version at the ``TestHinge``
   shapes and the blocks the SVM paths give them, as worker-major views
   (epsilon's (32, 64, 2,000) with a shared, a per-worker and a stride-0 w,
   webspam's (8, 64, 254), srdms's ijcnn1 (512, 22)), rtol 1e-4 / atol
   1e-5, two launches bitwise equal, each case's route checked (the cluster
   kernel for 16-byte rows of up to 2,048 columns, ``hinge.cu`` for the
   rest); with the time of each, the plain version's and the bound, and
   wherever the cluster kernel runs ``hinge.cu``'s time on the same inputs;
3. the SVM path: ``dms`` with 32 workers, block 64, 2 epochs on the epsilon
   stand-in (400,000 × 2,000), kernel launches counted, every one on the
   cluster kernel, and the device activities of one profiled run a block;
   then (b) the SVM block ladder on the same data: ``dms_block_ladder``
   rungs (32, 64, 128), epoch 1 at 64, ``dms_ladder_switch``, epoch 2 at
   128, held to the plain-gradient chain (accuracy within 0.005, relative
   L2 1e-3), two kernel runs bitwise equal, the hinge launches exactly the
   blocks on the kernel ``kernel_for`` names; without a switch bitwise
   ``dms``; walls and idle shares of the ladder and of ``dms``; then
   ``dms_timed_steps`` at 64 into a ``BlockTelemetry`` and an
   ``AdaptiveController`` over the rungs (its T_step, T_sync and pick);
4. every ``dms`` mode on the webspam stand-in (350,000 × 254, K=8, block 64,
   one epoch), ``srdms`` and ``seq_sgd`` on the ijcnn1 stand-in (n=4,000),
   the hinge launches all on ``hinge.cu`` (254 and 22 columns: rows no bulk
   copy can move);
5. the flash-attention kernels against their plain version: the f32
   CUDA-core kernel at the ``TestFlashAttention`` shapes (rtol 1e-4 / atol
   2e-5); the bf16 tensor-core kernel (wgmma, TMA) at ragged, GQA, prefix
   and dh 32–256 cases and the serving paths' prefill shapes, smollm-360m's
   and zamba2-1.2b's (rtol 2**-7 / atol 1e-4, one bf16 ulp, a limit SDPA
   must fail at smollm's); each launch counted on the kernel it must take,
   with its time, the plain version's, the bound, and at both serving
   shapes (and at every f32 check shape) SDPA's as a yardstick, the
   achieved TFLOP/s and the share of the bound;
6. the serving path: ``ServeEngine.generate`` on smollm-360m at full width
   (32 layers, bf16, seeded random weights), 4 prompts of 1,920 tokens and
   128 new tokens each, flash launches counted (one per layer per prefill,
   all on the tensor-core kernel), and the kernel path against the plain
   path (``attn_impl="torch"``);
7. the int8 quant kernels against their plain version at the ``TestQuant``
   shapes, a K-batched (4, 1,000,003) case and the trainer's largest leaf
   (4, 78,643,200): int8 payload, scale, residual and dequantized values
   bitwise equal, round-trip error at most scale/2, two launches bitwise
   equal; with their time, the plain version's, ``torch.quantize_per_channel``
   / ``torch.dequantize``'s as a yardstick, and the bound; then leaves
   holding a NaN, +inf or −inf (alone, or one bad row among good ones),
   with and without the residual: bitwise the plain version's (NaN as NaN),
   scale NaN or inf, q 0, dequantized NaN, as the reference gives;
8. the LM trainer: local SGD on smollm-360m at full width (32 layers, bf16
   compute, f32 master params), K = 4 replicas, H = 4, int8 sync with error
   feedback, AdamW, 2 sequences of 2,048 tokens per replica a step: 2 blocks
   on the kernel path (quant launches counted: one quantize and one
   dequantize per leaf per sync) and 2 on the plain path from the same state
   and batches, held to each other (losses relative 1e-3, params relative L2
   1e-3) and the first sync's int8 payloads bitwise; then one profiled
   block, and 4 ``make_ddp_step`` steps (MSF = 1) at the same global batch;
   then (a) the adaptive trainer on the same model: ``sync.adaptive`` over
   the ladder (1, 2, 4) from H = 4, one forced switch after block 1 held
   bitwise to ``ladder_switch_state`` of the pre-switch snapshot and the
   next block bitwise to a fresh ``make_train_step`` from the switched
   snapshot, then 8 blocks through ``StepRunner`` (checkpoints off): the H
   trajectory, walls and trained tokens/s per rung, the telemetry's
   T_step / T_sync, no compile after the ladder's warmup, 22 quant
   launches a block, peak memory under 75 GB and one profiled block; and
   (c) fault and restart at smoke width (int8 on the quant kernel, a
   scripted move 2 → 1, checkpoints every 3 blocks): a fault after the
   checkpoint and one before it both replay bitwise the run without one;
9. every other sync mode (delayed, chunked, ring, pairwise, async ring,
   int16) at smoke width, kernel path against plain path;
10. the SSD chunk-scan kernels: the CUDA-core one (``ssd.cu``) against the
    exact recurrence at the ``TestSSD`` shapes in f32 (rtol 1e-3 / atol
    2e-4); the tensor-core one (``ssd_tc.cu``) at the same shapes in bf16
    against the exact recurrence on the same inputs (state rtol 1e-3 / atol
    2e-4, y rtol 2**-7 / atol 2e-4) and at the two serving prefill shapes
    against the plain chunked scan (y within rtol 2**-7 / atol 2e-4, the
    f32 state within the f32 bound); each launch counted on the kernel it
    must take, two launches bitwise equal; with the time of each, the
    chunked scan's and the bound, and at the serving shapes the CUDA-core
    kernel's time on the same bf16 inputs;
11. the SSM serving path: ``ServeEngine.generate`` on mamba2-2.7b at full
    width (64 layers, bf16, seeded random weights), 4 prompts of 1,920
    tokens and 128 new tokens each, SSD launches counted (one per layer per
    prefill, all on the tensor-core kernel in bf16 and none of them in f32;
    decode runs the plain recurrence step), and the kernel path against
    the plain path (``ssd_impl="torch"``): in bf16 layer 0's cache held
    (conv tails bitwise, the SSM state within the SSD bound); in f32,
    prefill and 16 teacher-forced decode steps' logits within relative L2
    1e-2; and the bf16 kernel path's logits (prefill and those 16 steps)
    within 1.5× the bf16 plain path's own relative L2 to the f32 plain
    path;
12. the hybrid serving path: the same on zamba2-1.2b at full width (38
    Mamba2 layers, the shared attention block after every 6: 38 SSD and 6
    flash launches per prefill, on the tensor-core kernels in bf16 and the
    CUDA-core ones in f32).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failed check raises, and the script
exits non-zero without that line. Without CUDA it exits 1 at once. It imports
no JAX and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
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
# tests/test_kernels.py::TestQuant's shapes (one scale each), then stacked
# rows (one scale each): a ragged K-batched case and the trainer's largest
# leaf, mlp.w_up of smollm-360m (32 · 960 · 2,560) for K = 4 replicas
QUANT_SHAPES = [((100,), False), ((33, 7), False), ((2, 3, 5), False),
                ((4096,), False), ((128, 128), False),
                ((4, 1_000_003), True)]
QUANT_MAIN = ((4, 32 * 960 * 2560), True)
# trainer, kernel path against plain path: the two differ only where CUDA's
# embedding backward (atomics) makes a rounding flip in a gradient and a
# later int8 value moves one step; a wrong scale or sync is O(1)
TRAIN_LOSS_REL, TRAIN_PARAMS_REL_L2 = 1e-3, 1e-3
TRAIN_K, TRAIN_H, TRAIN_SEQ, TRAIN_BATCH = 4, 4, 2048, 8
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
# bf16 on the tensor-core kernel besides the serving shapes: ragged S/T,
# GQA groups 1, 3 and 4, causal ∪ prefix, non-causal prefix, dh 32 to 256
FLASH_TC_SHAPES = [(1, 200, 300, 4, 2, 64, False, 0),
                   (1, 1000, 1000, 6, 2, 64, True, 0),
                   (1, 300, 300, 9, 3, 64, True, 0),
                   (1, 256, 256, 4, 1, 64, True, 40),
                   (1, 192, 320, 4, 2, 64, False, 100),
                   (1, 512, 512, 2, 2, 32, True, 0),
                   (1, 70, 100, 3, 3, 96, False, 0),
                   (2, 256, 256, 8, 8, 128, True, 0),
                   (1, 300, 300, 4, 1, 256, True, 0)]
# the serving path's prefill: smollm-360m, 4 prompts of 1,920 tokens; and
# zamba2-1.2b's shared attention block on the same prompts
FLASH_MAIN = (4, 1920, 1920, 15, 5, 64, True, 0)
FLASH_HYBRID = (4, 1920, 1920, 32, 32, 64, True, 0)
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
# tests/test_kernels.py::TestSSD: (b, l, h, p, n, chunk), f32 against the
# exact recurrence at its bound rtol 1e-3 / atol 2e-4 (the chunked form sums
# and exponentiates in another order than the recurrence)
SSD_SHAPES = [(1, 128, 2, 64, 128, 64), (2, 256, 4, 64, 128, 128),
              (1, 200, 2, 64, 64, 128), (1, 512, 1, 128, 128, 256),
              (2, 64, 3, 32, 16, 32)]
SSD_F32_TOL = dict(rtol=1e-3, atol=2e-4)
# the serving prefills, bf16 x/B/C: mamba2-2.7b (the main path) and
# zamba2-1.2b, 4 prompts of 1,920 tokens, chunk 256, against the plain
# chunked scan on the same inputs: both compute in f32 and round only y, so
# y differs by a rounding flip (rtol 2**-7, one bf16 ulp) and near zero by
# the f32 sums' difference; the f32 state within the f32 bound
SSD_MAIN = (4, 1920, 80, 64, 128, 256)
SSD_PREFILLS = [SSD_MAIN, (4, 1920, 64, 64, 64, 256)]
SSD_BF16_Y_TOL = dict(rtol=2 ** -7, atol=2e-4)
# kernel path against plain path of the SSM and hybrid serving, relative L2
# of the logits. The two differ by the SSD's f32 sum order. In bf16 that
# flips roundings of y in every layer, and a deep random-weight model
# amplifies the flips: on the CPU at full width the two paths (the kernel
# path is the exact recurrence there) were 0.026–0.043 apart over 8 mamba2
# layers and 0.080–0.101 over 24, growing with depth, so the bf16 paths are
# not held to each other. In f32 the same comparison was 7.6e-6–2.5e-5
# apart over 8 mamba2 layers, 4.9e-5–1.0e-4 over 24 and 5.7e-5–1.3e-4 over
# 12 zamba2 layers, so f32 logits are held to 1e-2; a wrong mask or decay is
# O(1).
SSM_F32_LOGITS_REL_L2 = 1e-2
# each bf16 path against the f32 plain path on the same weights (prefill
# and the f32 run's teacher-forced decode steps, relative L2 over all their
# logits): the kernel path within this factor of the plain path's own
# distance. Both round every activation to bf16 and differ from f32 by
# like amounts: on an H100 80GB HBM3 (700 W) the kernel and plain paths
# were 0.525 and 0.509 from f32 at mamba2-2.7b (1.03x) and 0.389 and 0.377
# at zamba2-1.2b (1.03x). A subtly wrong kernel lands O(1) away (unrelated
# logits of equal norm are ~1.4 apart), above 1.5 x 0.509 = 0.76.
SSM_BF16_VS_F32_FACTOR = 1.5
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
    """``copies`` independent (w, x, y) sets, made with numpy from ``seed``.
    A batched x (K, n, d) is block i of one (K, copies·n, d) array, the
    worker-major view ``xb[:, i]`` that ``dms`` hands the kernel; a w shape
    ``(K, 0)`` stands for the stride-0 ``w.expand(K, d)`` of K equal rows
    that ``dms``'s carry holds under the blocking mean and the delayed mode
    starts from."""
    rng = np.random.default_rng(seed)
    batched = len(x_shape) == 3
    if batched:
        k, n, d = x_shape
        xs = torch.from_numpy(rng.normal(size=(k, copies * n, d)).astype(
            np.float32)).to(dev)
        ys = torch.from_numpy(np.where(rng.random((k, copies * n)) > 0.5,
                                       1.0, -1.0).astype(np.float32)).to(dev)
    out = []
    for i in range(copies):
        if batched:
            x, y = xs[:, i * n:(i + 1) * n], ys[:, i * n:(i + 1) * n]
        else:
            x = torch.from_numpy(rng.normal(size=x_shape).astype(
                np.float32)).to(dev)
            y = torch.from_numpy(np.where(rng.random(x_shape[:-1]) > 0.5,
                                          1.0, -1.0).astype(np.float32)
                                 ).to(dev)
        stride0 = w_shape[-1] == 0
        w = torch.from_numpy(rng.normal(
            size=x_shape[-1:] if stride0 else w_shape).astype(np.float32)
        ).to(dev)
        out.append((w.expand(x_shape[0], -1) if stride0 else w, x, y))
    return out


def hinge_bound(x_shape, w_shape):
    """(bound_ms, bound_by): bytes read once and written once over HBM rate,
    or the flops (two GEMVs) over the float32 rate, whichever is larger. A
    stride-0 w (``w_shape`` (K, 0)) is one row read once."""
    k = x_shape[0] if len(x_shape) == 3 else 1
    n, d = x_shape[-2:]
    w_elems = d if w_shape[-1] == 0 else int(np.prod(w_shape))
    nbytes = 4 * (k * n * d + k * n + w_elems + k * d)
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
    from repro_torch.kernels.quant import ops as quant_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    kernels = {"hinge": hinge_ops, "flash_attention": flash_ops,
               "quant": quant_ops, "ssd": ssd_ops}
    # one library for each source, named by its stem as its wrapper loads it
    sources = {src.stem: src for ops in kernels.values()
               for src in getattr(ops, "SOURCES", (ops.SOURCE,))}

    def build(name):
        t0 = time.perf_counter()
        lib = nvcc.build(name, [sources[name]])
        return lib, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(build, sources)))
    log(f"kernels built in parallel: {time.perf_counter() - t0:.2f} s")
    for ops in kernels.values():
        ops.load_library()
    flash_ops.load_tc_library()
    ssd_ops.load_tc_library()
    g, rows, stage_rows, slots = hinge_ops.cluster_plan(64, 2000)
    plan = (2000, g, stage_rows, slots)
    cluster_lib = hinge_ops.load_cluster_library()
    active = cluster_lib.hinge_cluster_max_active(*plan)
    check(active > 0, f"hinge cluster occupancy query failed: {active}")
    log(f"hinge cluster kernel at epsilon's block (32 clusters of {g} CTAs "
        f"of {rows} rows; stages of {stage_rows} rows, {slots} in the "
        f"ring): {cluster_lib.hinge_cluster_smem_bytes(*plan)} bytes of "
        f"dynamic shared memory a CTA; {active} clusters fit on the card "
        f"at once")
    for name, (lib, secs) in built.items():
        log(f"{name} kernel build: {secs:.2f} s "
            f"({os.path.relpath(lib, REPO)})")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas: {line.strip()}")
    return card


# dms hands the kernel the carry of K equal rows, a stride-0 view
HINGE_MAIN = "K=32,n=64,d=2000,stride-0 w"


def phase_kernel(torch, dev):
    """The kernels against the plain version; returns the main path's row.
    Every case's route is checked; where the cluster kernel runs,
    ``hinge.cu`` is also run and timed on the same inputs through
    ``run_kernel("simt", ...)``."""
    from repro_torch.kernels.hinge import ops, ref
    # (x shape, w shape, C, label, route): 16-byte rows of at most 2,048
    # columns take the cluster kernel, other rows hinge.cu
    cases = [((n, d), (d,), 1.0, f"n={n},d={d},C=1",
              "simt" if d % 4 else "cluster") for n, d in HINGE_SHAPES]
    cases += [((64, 16), (16,), c, f"n=64,d=16,C={c}", "cluster")
              for c in (0.1, 1.0, 10.0)]
    cases += [((32, 64, 2000), (32, 0), 1.0, HINGE_MAIN, "cluster"),
              ((32, 64, 2000), (2000,), 1.0, "K=32,n=64,d=2000,shared w",
               "cluster"),
              ((32, 64, 2000), (32, 2000), 1.0,
               "K=32,n=64,d=2000,per-worker w", "cluster"),
              ((8, 64, 254), (254,), 1.0, "K=8,n=64,d=254,shared w", "simt"),
              ((8, 64, 254), (8, 254), 1.0, "K=8,n=64,d=254,per-worker w",
               "simt"),
              ((512, 22), (22,), 1.0, "n=512,d=22 (srdms ijcnn1)", "simt"),
              ((2, 40, 5000), (5000,), 1.0, "K=2,n=40,d=5000 (wide)",
               "simt")]
    main_row = None
    for i, (x_shape, w_shape, c, label, expect) in enumerate(cases):
        per_set = 4 * int(np.prod(x_shape))
        copies = int(min(64, max(2, -(-2 * L2_BYTES // per_set))))
        sets = hinge_inputs(torch, dev, 100 + i, x_shape, w_shape, copies)
        w, x, y = sets[0]
        route = ops.kernel_for(w, x, y)
        check(route == expect, f"{label}: route {route}, expected {expect}")
        before = ops.LAUNCHES, ops.CLUSTER_LAUNCHES
        got = ops.hinge_block_grad(w, x, y, c)
        again = ops.hinge_block_grad(w, x, y, c)
        want = ref.hinge_block_grad(w, x, y, c)
        torch.cuda.synchronize()
        cluster = 2 * (route == "cluster")
        check((ops.LAUNCHES, ops.CLUSTER_LAUNCHES) ==
              (before[0] + 2, before[1] + cluster),
              f"{label}: launches counted {ops.LAUNCHES - before[0]} / "
              f"{ops.CLUSTER_LAUNCHES - before[1]}")
        err = float((got - want).abs().max())
        check(torch.equal(got, again), f"{label}: two launches differ")
        check(torch.allclose(got, want, rtol=RTOL, atol=ATOL),
              f"{label}: kernel vs plain max abs err {err}")
        ms = device_ms(torch, lambda a, b, e: ops.hinge_block_grad(a, b, e, c),
                       sets)
        plain_ms = device_ms(
            torch, lambda a, b, e: ref.hinge_block_grad(a, b, e, c), sets)
        bound_ms, bound_by = hinge_bound(x_shape, w_shape)
        simt = ""
        if route == "cluster":
            got_simt = ops.run_kernel("simt", w, x, y, c)
            torch.cuda.synchronize()
            err_simt = float((got_simt - want).abs().max())
            check(torch.allclose(got_simt, want, rtol=RTOL, atol=ATOL),
                  f"{label}: hinge.cu vs plain max abs err {err_simt}")
            simt_ms = device_ms(
                torch, lambda a, b, e: ops.run_kernel("simt", a, b, e, c),
                sets)
            simt = (f" hinge.cu {simt_ms * 1e3:.4f} us (max_abs_err "
                    f"{err_simt:.3e}, {simt_ms / ms:.2f}x the kernel's time)")
        if label == HINGE_MAIN:
            main_row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by)
        log(f"hinge {label} [{route}]: max_abs_err {err:.3e} "
            f"bitwise-repeatable kernel {ms * 1e3:.4f} us plain "
            f"{plain_ms * 1e3:.4f} us bound {bound_ms * 1e3:.4f} us "
            f"({bound_by}, {100 * bound_ms / ms:.1f}% of it){simt} "
            f"[{copies} input sets]")
    return main_row


def async_growth(workers: int, topology: str) -> float:
    """Spectral radius of ``M − αI`` at α = 1 (epoch 0): the async gossip
    recurrence is ``w ← (M − αI)·w + α·g``, so above 1 a mode grows by this
    factor every block, in the reference as in the port."""
    from repro_torch.core import costmodel
    return max(float(np.abs(np.linalg.eigvals(m - np.eye(workers))).max())
               for m in costmodel.mixing_matrices(workers, topology))


def _dms_pair(torch, dev, ds, label, expect_launches, route, **kw):
    """``dms`` on the kernel path (launches counted, every one on the kernel
    ``route`` names) and on the plain path; holds the two to the
    relative-L2 and accuracy bounds. Where the async
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
        ops.LAUNCHES = ops.CLUSTER_LAUNCHES = 0
        t0 = time.perf_counter()
        w = svm.dms(w0, x, y, grad_impl=impl, device=dev, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.LAUNCHES
        check(ops.CLUSTER_LAUNCHES == (launches if route == "cluster" else 0),
              f"{label} {impl}: {ops.CLUSTER_LAUNCHES} of {launches} hinge "
              f"launches on the cluster kernel, expected all on {route}")
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
        f"{expect_launches}, all on {route}), plain-path "
        f"launches {launches_t}; test acc "
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
        epochs * blocks, "cluster", workers=k, epochs=epochs, block_size=bs)
    obj = float(svm.hinge_objective(w, ds[0], ds[1]))
    check(np.isfinite(obj), "epsilon objective not finite")
    w0 = torch.zeros(ds[0].shape[1], device=dev)
    busy = device_busy(torch, lambda: svm.dms(
        w0, ds[0], ds[1], workers=k, epochs=epochs, block_size=bs,
        device=dev))
    log_busy("dms epsilon", *busy)
    log(f"dms epsilon: {busy[2] / (epochs * blocks):.2f} device activities "
        f"a block over {epochs * blocks} blocks")
    log(f"main path: epsilon test acc {acc:.4f} objective {obj:.6e} "
        f"wall {wall:.4f} s ({1e6 * wall / (epochs * blocks):.1f} us a block) "
        f"launches {launches} ({epochs} epochs x {blocks} blocks)")
    return launches, ds


def phase_modes(torch, dev, n_override=None, ijcnn_n=4000):
    from repro_torch.core import svm
    from repro_torch.kernels.hinge import ops
    ds = _load(torch, dev, "webspam", n_override=n_override)
    k, bs = 8, 64
    blocks = (ds[0].shape[0] // k) // bs
    for overlap, topology, gossip_async in DMS_MODES:
        label = f"webspam {overlap}/{topology}{'/async' if gossip_async else ''}"
        # 254 columns: rows no bulk copy can move, so hinge.cu
        _dms_pair(torch, dev, ds, label, blocks, "simt", workers=k, epochs=1,
                  block_size=bs, overlap=overlap, topology=topology,
                  gossip_async=gossip_async)

    x, y, xt, yt = _load(torch, dev, "ijcnn1", n_override=ijcnn_n)
    w0 = torch.zeros(x.shape[1], device=dev)
    epochs, bs = 5, 512
    res = {}
    for impl in ("kernel", "torch"):
        ops.LAUNCHES = ops.CLUSTER_LAUNCHES = 0
        res[impl] = svm.srdms(w0, x, y, epochs=epochs, block_size=bs,
                              grad_impl=impl, device=dev)
        res[impl + "_launches"] = ops.LAUNCHES
        check(ops.CLUSTER_LAUNCHES == 0,
              f"srdms {impl}: {ops.CLUSTER_LAUNCHES} hinge launches on the "
              f"cluster kernel; 22 columns take hinge.cu")
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
    b, sq, sk, h, kv, dh = shape[:6]
    flops = flash_flops(shape)
    nbytes = itemsize * dh * (2 * b * sq * h + 2 * b * sk * kv)
    rate = BF16_FLOPS_PER_S if itemsize == 2 else FP32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def flash_flops(shape):
    """4·dh flops for every visible (row, key) pair: the function's
    products, Q·Kᵀ and P·V."""
    b, sq, sk, h, kv, dh, causal, prefix = shape
    rows = np.arange(sq)
    if causal:
        seen = np.minimum(sk, np.maximum(rows + 1, prefix))
    else:
        seen = np.full(sq, min(sk, prefix) if prefix else sk)
    return 4 * dh * b * h * int(seen.sum())


def phase_flash(torch, dev):
    """The flash kernels against their plain version (f32 cases on the
    CUDA-core kernel, bf16 on the tensor-core one, each launch counted on
    the kernel it must take); returns the main row."""
    from repro_torch.kernels.flash_attention import ops, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = [(shape, torch.float32, 1e-4, 2e-5) for shape in FLASH_SHAPES]
    cases += [(shape, torch.bfloat16, BF16_RTOL, BF16_ATOL)
              for shape in [FLASH_BF16] + FLASH_TC_SHAPES +
              [FLASH_MAIN, FLASH_HYBRID]]
    main_row = None
    for i, (shape, dtype, rtol, atol) in enumerate(cases):
        causal, prefix = shape[6], shape[7]
        itemsize = torch.finfo(dtype).bits // 8
        b, sq, sk, h, kv, dh = shape[:6]
        per_set = itemsize * dh * (2 * b * sq * h + 2 * b * sk * kv)
        copies = int(min(64, max(2, -(-2 * L2_BYTES // per_set))))
        sets = flash_inputs(torch, dev, 200 + i, shape, dtype, copies)
        q, k, v = sets[0]
        kind = "tc" if dtype == torch.bfloat16 else "simt"
        launches, tc_launches = ops.LAUNCHES, ops.TC_LAUNCHES
        got = ops.flash_attention(q, k, v, causal=causal, prefix_len=prefix)
        again = ops.flash_attention(q, k, v, causal=causal, prefix_len=prefix)
        want = ref.flash_attention(q, k, v, causal=causal, prefix_len=prefix)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        label = (f"b={b},sq={sq},sk={sk},h={h},kv={kv},dh={dh},"
                 f"causal={causal},prefix={prefix},{str(dtype)[6:]}")
        check(ops.kernel_for(q, k, v) == kind and
              ops.LAUNCHES == launches + 2 and
              ops.TC_LAUNCHES == tc_launches + 2 * (kind == "tc"),
              f"flash {label}: expected two launches of the {kind} kernel")
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
        log(f"flash {label}: {kind} kernel, max_abs_err {err:.3e} "
            f"bitwise-repeatable, kernel {ms * 1e3:.4f} us plain "
            f"{plain_ms * 1e3:.4f} us bound {bound_ms * 1e3:.4f} us "
            f"({bound_by}) [{copies} input sets]")
        if dtype == torch.float32:
            # the yardstick at the f32 check shapes: SDPA on the same f32
            # inputs, the mask given where a prefix widens the causal one
            # (columns below the prefix seen by every row)
            mask = None
            if prefix:
                rows = torch.arange(sq, device=dev)[:, None]
                cols = torch.arange(sk, device=dev)[None]
                mask = (cols <= rows) | (cols < prefix)

            def library(q, k, v):
                return sdpa(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), attn_mask=mask,
                            is_causal=causal and mask is None,
                            enable_gqa=True)
            lib_err = float((library(q, k, v).transpose(1, 2) - want)
                            .abs().max())
            library_ms = device_ms(torch, library, sets)
            log(f"flash {label}: SDPA f32 {library_ms * 1e3:.4f} us (max abs "
                f"diff vs plain {lib_err:.3e}); the simt kernel "
                f"{ms / library_ms:.2f}x SDPA's time, "
                f"{100 * bound_ms / ms:.2f}% of its bound "
                f"({bound_ms * 1e3:.4f} us, {bound_by}); SDPA "
                f"{100 * bound_ms / library_ms:.2f}% of it")
        if shape in (FLASH_MAIN, FLASH_HYBRID):
            # the yardstick: one PyTorch call for the same function (heads
            # first, as it takes them); the port never calls it
            def library(q, k, v):
                return sdpa(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), is_causal=True,
                            enable_gqa=True)
            lib_out = library(q, k, v).transpose(1, 2)
            lib_err = float((lib_out.float() - want.float()).abs().max())
            library_ms = device_ms(torch, library, sets)
            flops = flash_flops(shape)
            log(f"flash {label}: SDPA {library_ms * 1e3:.4f} us; kernel "
                f"{flops / ms * 1e-9:.1f} TFLOP/s of the function's "
                f"{flops / 1e9:.2f} GFLOP ({1.5 * flops / ms * 1e-9:.1f} "
                f"TFLOP/s counting the split P·V it computes), "
                f"{100 * bound_ms / ms:.2f}% of its bound; SDPA "
                f"{flops / library_ms * 1e-9:.1f} TFLOP/s")
        if shape == FLASH_MAIN:
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


def serve_launches(cfg, bf16=True):
    """Kernel launches one prefill makes on the kernel path: the flash
    kernels once per attention application, the SSD kernels once per Mamba2
    layer (all on the tensor-core kernels in bf16, none of them in f32)."""
    if cfg.family == "ssm":
        flash, ssd = 0, cfg.n_layers
    elif cfg.family == "hybrid":
        flash, ssd = cfg.n_layers // cfg.shared_block_every, cfg.n_layers
    else:
        flash, ssd = cfg.n_layers, 0
    return {"flash_attention": flash,
            "flash_attention_tc": flash if bf16 else 0, "ssd": ssd,
            "ssd_tc": ssd if bf16 else 0}


def reset(counters):
    for ops, attr in counters.values():
        setattr(ops, attr, 0)


def read(counters):
    return {name: getattr(ops, attr) for name, (ops, attr) in
            counters.items()}


def layer0(cfg, cache):
    """Layer 0's cache leaves, copied, each with whether the kernel path
    must give the plain path's bits: the attention k, v and the conv tails
    are computed before any kernel; the SSM state comes out of the SSD
    kernel."""
    if cfg.family == "dense":
        return {k: (cache[k][0].clone(), True) for k in ("k", "v")}
    mamba = cache["mamba"] if cfg.family == "hybrid" else cache
    return {k: (v[0].clone(), k != "ssm") for k, v in mamba.items()}


def _serve_paths(torch, engines, prompts, forced, counters, timed):
    """Prefill then decode teacher-forced on ``forced`` through each engine
    (the kernel path and the plain path); per path the logits of the
    prefill and of every step, layer 0's cache after the prefill, the
    prefill's launches and, if ``timed``, the prefill (median of 3 more)
    and decode times."""
    runs = {}
    prompt_len, gen = prompts.shape[1], forced.shape[1]
    for impl, eng in engines.items():
        torch.cuda.synchronize()
        reset(counters)
        t0 = time.perf_counter()
        logits, cache = eng.prefill(prompts)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        launches = read(counters)
        first = layer0(eng.cfg, cache)
        steps = []
        t0 = time.perf_counter()
        for i in range(gen):
            steps.append(eng.decode(forced[:, i:i + 1], cache,
                                    prompt_len + i))
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        del cache
        runs[impl] = dict(logits=logits, layer0=first, steps=steps,
                          launches=launches)
        if not timed:
            continue
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            eng.prefill(prompts)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        runs[impl].update(prefill_s=float(np.median(times)),
                          decode_ms=1e3 * decode_s / gen)
        b = prompts.shape[0]
        log(f"serve {eng.cfg.name} {impl} path: prefill "
            f"{runs[impl]['prefill_s']:.4f} s (median of 3; first "
            f"{prefill_s:.4f} s), decode {runs[impl]['decode_ms']:.3f} ms a "
            f"step ({b} tokens), {1e3 * b / runs[impl]['decode_ms']:.1f} "
            f"tokens/s in decode; launches in prefill {launches}")
    return runs["kernel"], runs["torch"]


def _hold_paths(torch, cfg, kr, tr, label, rel_bound):
    """The kernel path against the plain path: layer 0's cache after the
    prefill (bitwise where no kernel ran yet, the SSM state within the SSD
    bound), and the logits' relative L2 (checked where ``rel_bound`` is
    given). Returns (prefill rel L2, max step rel L2)."""
    notes = []
    for name, (got, exact) in kr["layer0"].items():
        want = tr["layer0"][name][0]
        if exact:
            check(torch.equal(got, want),
                  f"{label}: layer 0 cache {name} differs between the paths")
            notes.append(f"{name} bitwise")
        else:
            err = float((got - want).abs().max())
            check(torch.allclose(got, want, **SSD_F32_TOL),
                  f"{label}: layer 0 SSM state max abs err {err} over the "
                  f"SSD bound")
            notes.append(f"{name} max abs err {err:.3e} (max "
                         f"{float(want.abs().max()):.3e})")
    for t in [kr["logits"]] + kr["steps"]:
        check(bool(torch.isfinite(t).all()),
              f"{label}: kernel path logits not finite")
    prefill_rel = rel_l2(torch, kr["logits"], tr["logits"])
    step_rel = [rel_l2(torch, a, b) for a, b in zip(kr["steps"], tr["steps"])]
    agree = float((torch.argmax(kr["logits"], -1)
                   == torch.argmax(tr["logits"], -1)).float().mean())
    bound = (rel_bound if rel_bound is not None
             else "none: each bf16 path is held to f32 below")
    log(f"{label} kernel vs plain: prefill logits rel L2 {prefill_rel:.4e}, "
        f"{len(step_rel)} decode steps rel L2 max {max(step_rel):.4e} median "
        f"{float(np.median(step_rel)):.4e} (bound {bound}); "
        f"first-token agreement {agree:.2f}; layer 0 after the prefill: "
        f"{', '.join(notes)}")
    if rel_bound is not None:
        check(prefill_rel <= rel_bound,
              f"{label}: prefill logits rel L2 {prefill_rel} > {rel_bound}")
        check(max(step_rel) <= rel_bound,
              f"{label}: decode logits rel L2 {max(step_rel)} > {rel_bound}")
    return prefill_rel, max(step_rel)


def phase_serve(torch, dev, cfg, batch, prompt_len, gen, bf16_rel_l2,
                f32_rel_l2=None, f32_steps=16, bf16_factor=None):
    """``ServeEngine.generate`` through the kernel path (flash and SSD
    launches counted), then the kernel path against the plain path
    (``attn_impl="torch"``, ``ssd_impl="torch"``) in bf16, on the kernel
    path's tokens: prefill logits, layer 0's cache after the prefill, every
    decode step's logits teacher-forced (held to ``bf16_rel_l2`` where it is
    given). With ``f32_rel_l2``, the same comparison once more with both
    engines in f32 over ``f32_steps`` decode steps, held to that bound; with
    ``bf16_factor`` too, each bf16 path's logits (prefill and those steps)
    against the f32 plain path's: the kernel path's relative L2 within
    ``bf16_factor`` times the plain path's. Returns the launches of the
    generate run."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch.serve import ServeEngine
    counters = {"flash_attention": (flash_ops, "LAUNCHES"),
                "flash_attention_tc": (flash_ops, "TC_LAUNCHES"),
                "ssd": (ssd_ops, "LAUNCHES"),
                "ssd_tc": (ssd_ops, "TC_LAUNCHES")}
    expect = serve_launches(cfg)
    none = {name: 0 for name in counters}
    max_len = prompt_len + gen + 1

    def build(dtype):
        """Both engines, params and activations in ``dtype``."""
        c = dataclasses.replace(cfg, dtype=str(dtype).split(".")[-1])
        return {impl: ServeEngine(c, dev, max_len=max_len, dtype=dtype,
                                  attn_impl=impl, ssd_impl=impl)
                for impl in ("kernel", "torch")}

    t0 = time.perf_counter()
    engines = build(torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in engines["kernel"].params.parameters())
    log(f"serve {cfg.name} ({cfg.family}): {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, {n_params / 1e9:.3f} B "
        f"params, bf16; two engines built in {time.perf_counter() - t0:.2f} s")
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
    torch.cuda.reset_peak_memory_stats()
    reset(counters)
    t0 = time.perf_counter()
    tokens = engine.generate(prompts, gen)
    wall = time.perf_counter() - t0
    launches = read(counters)
    peak = torch.cuda.max_memory_allocated()
    check(tokens.shape == (batch, gen), f"tokens {tokens.shape}")
    check(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
          "generated token ids out of range")
    check(launches == expect, f"{cfg.name}: launches in one generate "
          f"{launches}, expected {expect} (one prefill; decode runs none)")
    log(f"serve {cfg.name} generate: {batch} x {prompt_len} prompt tokens, "
        f"{gen} new tokens each: wall {wall:.4f} s, {tokens.size / wall:.1f} "
        f"new tokens/s; launches {launches} (one prefill); peak memory "
        f"{peak / 2**30:.2f} GiB")

    # kernel path and plain path, step by step on the kernel path's tokens
    forced = torch.from_numpy(tokens).to(dev).long()
    kr, tr = _serve_paths(torch, engines, prompts, forced, counters, True)
    check(kr["launches"] == expect and tr["launches"] == none,
          f"prefill launches {kr['launches']} / {tr['launches']}")
    greedy = torch.stack([torch.argmax(s, dim=-1) for s in
                          [kr["logits"]] + kr["steps"][:-1]], dim=1)
    check(torch.equal(greedy, forced),
          "the kernel path's logits do not reproduce its generated tokens")
    _hold_paths(torch, cfg, kr, tr, f"serve {cfg.name} bf16", bf16_rel_l2)
    bf16_logits = {impl: [r["logits"]] + r["steps"][:f32_steps]
                   for impl, r in (("kernel", kr), ("torch", tr))}
    n_prof = min(16, gen)
    log_busy(f"serve {cfg.name} kernel-path prefill",
             *device_busy(torch, lambda: engine.prefill(prompts)))
    _, cache = engine.prefill(prompts)
    log_busy(f"serve {cfg.name} decode, {n_prof} steps",
             *device_busy(torch, lambda: [
                 engine.decode(forced[:, i:i + 1], cache, prompt_len + i)
                 for i in range(n_prof)]))
    del cache, engines, engine, kr, tr
    torch.cuda.empty_cache()

    if f32_rel_l2 is not None:
        engines = build(torch.float32)
        kr, tr = _serve_paths(torch, engines, prompts, forced[:, :f32_steps],
                              counters, False)
        expect = serve_launches(cfg, bf16=False)
        check(kr["launches"] == expect and tr["launches"] == none,
              f"f32 prefill launches {kr['launches']} / {tr['launches']}")
        _hold_paths(torch, cfg, kr, tr, f"serve {cfg.name} f32", f32_rel_l2)
        if bf16_factor is not None:
            hold_bf16_to_f32(torch, cfg, bf16_logits,
                             [tr["logits"]] + tr["steps"], bf16_factor)
        del engines, kr, tr
        torch.cuda.empty_cache()
    return launches


def hold_bf16_to_f32(torch, cfg, bf16_logits, f32_logits, factor):
    """Each bf16 path's logits (prefill, then the teacher-forced steps)
    against the f32 plain path's on the same weights and tokens: the kernel
    path's relative L2 at most ``factor`` times the plain path's own."""
    want = torch.stack([t.float() for t in f32_logits])
    dist, agree = {}, {}
    for impl, logits in bf16_logits.items():
        got = torch.stack([t.float() for t in logits[:len(f32_logits)]])
        dist[impl] = rel_l2(torch, got, want)
        agree[impl] = float((torch.argmax(got[0], -1)
                             == torch.argmax(want[0], -1)).float().mean())
    log(f"serve {cfg.name} bf16 vs the f32 plain path ({len(f32_logits)} "
        f"logit rows: prefill + {len(f32_logits) - 1} decode steps): rel L2 "
        f"kernel path {dist['kernel']:.4e}, plain path {dist['torch']:.4e} "
        f"(ratio {dist['kernel'] / dist['torch']:.3f}, bound {factor}); "
        f"first-token agreement with f32: kernel path {agree['kernel']:.2f}, "
        f"plain path {agree['torch']:.2f}")
    check(dist["kernel"] <= factor * dist["torch"],
          f"serve {cfg.name}: the bf16 kernel path is {dist['kernel']} from "
          f"f32, over {factor} x the bf16 plain path's {dist['torch']}")


def ssd_inputs(torch, dev, seed, shape, dtype, copies=1):
    """``copies`` independent (x, dt, a, B, C) sets, TestSSD's draws made
    with numpy from ``seed``: x, B, C in ``dtype``, Δ and A float32."""
    b, l, h, p, n = shape[:5]
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)
    return [(t(rng.normal(size=(b, l, h, p)), dtype),
             t(rng.uniform(0.001, 0.1, size=(b, l, h))),
             t(-rng.uniform(0.5, 2.0, size=(h,))),
             t(rng.normal(size=(b, l, n)), dtype),
             t(rng.normal(size=(b, l, n)), dtype)) for _ in range(copies)]


def ssd_bound(shape, itemsize):
    """(bound_ms, bound_by): x, B, C read once, Δ and A read once, y and
    the f32 state written once, over the HBM rate; or the chunked
    algorithm's products over the tensor-core rate of the inputs' type
    (float32 on the CUDA cores): per chunk of q rows the causal triangle of
    the scores (C Bᵀ, once per batch and chunk: no head in it) and of their
    product with x, the inter-chunk C·S and the state's Bᵀ·x."""
    b, l, h, p, n, chunk = shape
    nbytes = (itemsize * (2 * b * l * h * p + 2 * b * l * n)
              + 4 * (b * l * h + h + b * h * n * p))
    flops = 0
    for c0 in range(0, l, chunk):
        q = min(chunk, l - c0)
        tri = q * (q + 1) // 2
        flops += b * 2 * tri * n + b * h * (2 * tri * p + 4 * q * n * p)
    rate = BF16_FLOPS_PER_S if itemsize == 2 else FP32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def phase_ssd(torch, dev):
    """The SSD kernels against their plain versions: the CUDA-core kernel at
    the TestSSD shapes in f32 and the tensor-core kernel at the same shapes
    in bf16, both against the exact recurrence; the tensor-core kernel at
    the serving prefill shapes against the plain chunked scan, timed beside
    the CUDA-core kernel on the same inputs. Returns the main row
    (mamba2-2.7b's prefill), timed against the chunked scan, the plain path
    the model takes."""
    from repro_torch.kernels.ssd import ops, ref
    from repro_torch.models.ssm import ssd_chunked
    cases = [(shape, torch.float32) for shape in SSD_SHAPES]
    cases += [(shape, torch.bfloat16) for shape in SSD_SHAPES + SSD_PREFILLS]
    main_row = None
    for i, (shape, dtype) in enumerate(cases):
        b, l, h, p, n, chunk = shape
        itemsize = torch.finfo(dtype).bits // 8
        per_set = itemsize * (2 * b * l * h * p + 2 * b * l * n)
        copies = int(min(64, max(2, -(-2 * L2_BYTES // per_set))))
        sets = ssd_inputs(torch, dev, 400 + i, shape, dtype, copies)
        args = sets[0]
        kind = "tc" if dtype == torch.bfloat16 else "simt"
        serving = shape in SSD_PREFILLS
        launches, tc_launches = ops.LAUNCHES, ops.TC_LAUNCHES
        y, s = ops.ssd_scan(*args, chunk=chunk)
        y2, s2 = ops.ssd_scan(*args, chunk=chunk)
        check(ops.kernel_for(args[0], args[3], args[4]) == kind and
              ops.LAUNCHES == launches + 2 and
              ops.TC_LAUNCHES == tc_launches + 2 * (kind == "tc"),
              f"ssd {shape} {dtype}: expected two launches of the {kind} "
              f"kernel")
        if serving:
            yr, sr = ssd_chunked(*args, chunk)
            y_tol, versus = SSD_BF16_Y_TOL, "chunked scan"
        else:
            yr, sr = ref.ssd_scan(*args)
            y_tol = SSD_F32_TOL if kind == "simt" else SSD_BF16_Y_TOL
            versus = "recurrence"
        torch.cuda.synchronize()
        label = f"b={b},l={l},h={h},p={p},n={n},chunk={chunk},{str(dtype)[6:]}"
        check(y.shape == yr.shape and y.dtype == dtype
              and s.shape == (b, h, n, p) and s.dtype == torch.float32,
              f"ssd {label}: outputs {tuple(y.shape)} {y.dtype}, "
              f"{tuple(s.shape)} {s.dtype}")
        check(torch.equal(y, y2) and torch.equal(s, s2),
              f"ssd {label}: two launches differ")
        err = float((y.float() - yr.float()).abs().max())
        s_err = float((s - sr).abs().max())
        check(torch.allclose(y.float(), yr.float(), **y_tol),
              f"ssd {label}: y max abs err {err} vs the plain {versus}")
        check(torch.allclose(s, sr, **SSD_F32_TOL),
              f"ssd {label}: state max abs err {s_err} vs the plain "
              f"{versus}")
        del y, s, y2, s2, yr, sr

        def kernel(*a):
            return ops.ssd_scan(*a, chunk=chunk)

        def plain(*a):
            return ssd_chunked(*a, chunk)

        ms = device_ms(torch, kernel, sets)
        plain_ms = device_ms(torch, plain, sets)
        bound_ms, bound_by = ssd_bound(shape, itemsize)
        log(f"ssd {label}: {kind} kernel vs the plain {versus} y max_abs_err "
            f"{err:.3e}, state {s_err:.3e}; bitwise-repeatable; kernel "
            f"{ms * 1e3:.4f} us, plain chunked scan {plain_ms * 1e3:.4f} us, "
            f"bound {bound_ms * 1e3:.4f} us ({bound_by}), kernel at "
            f"{100 * bound_ms / ms:.2f}% of it [{copies} input sets]")
        if serving:
            # the CUDA-core kernel that served these inputs before, timed on
            # the same inputs in the same run
            def simt(*a):
                return ops.run_kernel("simt", *a, chunk)
            simt_ms = device_ms(torch, simt, sets)
            log(f"ssd {label}: tensor-core kernel {ms * 1e3:.4f} us "
                f"({100 * bound_ms / ms:.2f}% of the bound), CUDA-core "
                f"kernel on the same inputs {simt_ms * 1e3:.4f} us "
                f"({100 * bound_ms / simt_ms:.2f}%), {simt_ms / ms:.1f}x")
        if shape == SSD_MAIN:
            recurrence_ms = device_ms(torch, ref.ssd_scan, sets[:1], runs=3)
            log(f"ssd main shape: the exact recurrence {recurrence_ms:.3f} "
                f"ms a call (the CPU path's plain version, {l:,} steps)")
            main_row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=None)
        del sets, args
        torch.cuda.empty_cache()
    return main_row


def event_ms(torch, fn, args, runs: int = 11) -> float:
    """Device time of one ``fn(*args)`` call from CUDA events around each of
    ``runs`` calls after one warm-up call (no CUDA graph, for a library call
    that may not be capturable); the median."""
    fn(*args)
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def quant_bound(numel: int, residual: bool):
    """(bound_ms, bound_by) of one quantize call (4 bytes read, 1 written an
    element, 4 more written with the residual) and of one dequantize call
    (1 read, 4 written): bytes over the HBM rate."""
    q_bytes = numel * (4 + 1 + (4 if residual else 0))
    return 1e3 * q_bytes / HBM_BYTES_PER_S, 1e3 * 5 * numel / HBM_BYTES_PER_S


def phase_quant(torch, dev):
    """The quant kernels against their plain version; returns the main
    row: one quantize (with the residual, as the sync calls it) and one
    dequantize of the trainer's largest leaf."""
    import warnings
    from repro_torch.kernels.quant import ops, ref
    main_row = None
    for i, (shape, rows) in enumerate(QUANT_SHAPES + [QUANT_MAIN]):
        numel = int(np.prod(shape))
        copies = int(min(16, max(1, -(-2 * L2_BYTES // (4 * numel)))))
        rng = np.random.default_rng(300 + i)
        sets = [(torch.from_numpy((rng.normal(size=shape) * 0.01)
                                  .astype(np.float32)).to(dev),)
                for _ in range(copies)]
        x = sets[0][0]
        q, s, res = ops.quantize(x, rows=rows, residual=True)
        q2, s2, res2 = ops.quantize(x, rows=rows, residual=True)
        deq = ops.dequantize(q, s)
        qr, sr = ref.quantize(x, rows=rows)
        deqr = ref.dequantize(qr, sr)
        torch.cuda.synchronize()
        label = f"{'rows ' if rows else ''}{shape}"
        for name, a, b in (("int8", q, qr), ("scale", s, sr),
                           ("dequantized", deq, deqr),
                           ("residual", res, x - deqr)):
            check(torch.equal(a, b), f"quant {label}: {name} differs from the "
                  f"plain version")
        check(torch.equal(q, q2) and torch.equal(s, s2)
              and torch.equal(res, res2), f"quant {label}: two launches differ")
        half = s.reshape(s.shape + (1,) * (x.dim() - s.dim())) / 2
        check(bool(((deq - x).abs() <= half + 1e-6).all()),
              f"quant {label}: round-trip error above scale/2")
        err = float((deq - deqr).abs().max())
        del q, s, res, q2, s2, res2, deq, qr, sr, deqr

        def kernel_q(t):
            return ops.quantize(t, rows=rows, residual=True)

        def plain_q(t):
            qq, ss = ref.quantize(t, rows=rows)
            return qq, ss, t - ref.dequantize(qq, ss)

        ms_q = device_ms(torch, kernel_q, sets)
        plain_q_ms = device_ms(torch, plain_q, sets)
        qs = [ops.quantize(t, rows=rows) for (t,) in sets]
        ms_d = device_ms(torch, ops.dequantize, qs)
        plain_d_ms = device_ms(torch, ref.dequantize, qs)
        bound_q, bound_d = quant_bound(numel, True)
        log(f"quant {label}: bitwise equal to the plain version, "
            f"bitwise-repeatable; quantize+residual kernel {ms_q * 1e3:.4f} "
            f"us plain {plain_q_ms * 1e3:.4f} us bound {bound_q * 1e3:.4f} "
            f"us; dequantize kernel {ms_d * 1e3:.4f} us plain "
            f"{plain_d_ms * 1e3:.4f} us bound {bound_d * 1e3:.4f} us (bytes) "
            f"[{copies} input sets]")
        if (shape, rows) == QUANT_MAIN:
            # the yardstick: PyTorch's own int8 quantization given the scale
            # (it multiplies by the inverse scale, so it need not be bitwise
            # equal); the port never calls it
            s_main = ops.quantize(x, rows=True)[1].double()
            zeros = torch.zeros(shape[0], dtype=torch.long, device=dev)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                try:
                    lib_q = event_ms(torch, lambda t: torch.quantize_per_channel(
                        t, s_main, zeros, 0, torch.qint8), (x,))
                    qx = torch.quantize_per_channel(x, s_main, zeros, 0,
                                                    torch.qint8)
                    lib_d = event_ms(torch, torch.dequantize, (qx,))
                    library_ms = lib_q + lib_d
                    lib_note = (f"quantize_per_channel {lib_q * 1e3:.4f} us, "
                                f"dequantize {lib_d * 1e3:.4f} us")
                    del qx
                except (RuntimeError, NotImplementedError) as exc:
                    library_ms = None
                    lib_note = f"not available on this card: {exc}"
            log(f"quant main leaf {shape}: PyTorch {lib_note}; kernel pair at "
                f"{100 * (bound_q + bound_d) / (ms_q + ms_d):.2f}% of its "
                f"bound")
            main_row = dict(max_abs_err=err, ms=ms_q + ms_d,
                            plain_ms=plain_q_ms + plain_d_ms,
                            bound_ms=bound_q + bound_d, bound_by="bytes",
                            library_ms=library_ms)
        del sets, qs, x
        torch.cuda.empty_cache()
    quant_nonfinite(torch, dev)
    return main_row


def same_or_nan(torch, a, b) -> bool:
    """Bitwise equal where not NaN, NaN where the other is NaN."""
    nan = torch.isnan(a)
    return (a.shape == b.shape and torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan], b[~nan]))


def quant_nonfinite(torch, dev):
    """A leaf holding a NaN, +inf or −inf (alone, or one bad row among
    good ones): the kernel's q, scale, residual and dequantized values are
    the plain version's (NaN as NaN), with and without the residual, and
    the bad leaf or row has scale NaN or inf, q 0 and dequantizes to NaN,
    as the reference (``repro.core.compression.quantize``) gives."""
    from repro_torch.kernels.quant import ops, ref
    cases = [((4096,), False), ((1_000_003,), False), ((4, 1_000_003), True),
             ((5, 6), True)]
    for i, (shape, rows) in enumerate(cases):
        for bad in (float("nan"), float("inf"), float("-inf")):
            rng = np.random.default_rng(500 + i)
            x = torch.from_numpy((rng.normal(size=shape) * 0.01).astype(
                np.float32)).to(dev)
            flat = (x[1] if rows else x).view(-1)
            flat[min(7, flat.numel() - 1)] = bad
            q, s, res = ops.quantize(x, rows=rows, residual=True)
            q2, s2 = ops.quantize(x, rows=rows)
            deq = ops.dequantize(q, s)
            qr, sr = ref.quantize(x, rows=rows)
            deqr = ref.dequantize(qr, sr)
            torch.cuda.synchronize()
            label = f"quant {'rows ' if rows else ''}{shape} holding {bad}"
            check(torch.equal(q, qr) and torch.equal(q2, qr),
                  f"{label}: int8 differs from the plain version")
            check(same_or_nan(torch, s, sr) and same_or_nan(torch, s2, sr),
                  f"{label}: scale differs from the plain version")
            check(same_or_nan(torch, deq, deqr)
                  and same_or_nan(torch, res, x - deqr),
                  f"{label}: dequantized or residual differs")
            bq, bs, bd = (q[1], s[1], deq[1]) if rows else (q, s, deq)
            check(bool((bq == 0).all()) and not bool(torch.isfinite(bs))
                  and bool(torch.isnan(bd).all()),
                  f"{label}: the bad leaf is not scale NaN/inf, q 0, NaN")
            if rows:
                good = [r for r in range(shape[0]) if r != 1]
                check(bool(torch.isfinite(s[good]).all())
                      and bool(torch.isfinite(deq[good]).all()),
                      f"{label}: a good row was touched")
    log(f"quant non-finite leaves: NaN, +inf, -inf in {len(cases)} cases "
        f"(per tensor and one bad row among good ones), with and without "
        f"the residual: bitwise the plain version's (NaN as NaN); the bad "
        f"leaf or row scale NaN/inf, q 0, dequantized NaN")


def _tree_rel_l2(torch, got, want) -> float:
    from repro_torch import tree as T
    num = sum(float((a.float() - b.float()).square().sum())
              for a, b in zip(T.leaves(got), T.leaves(want)))
    den = sum(float(b.float().square().sum()) for b in T.leaves(want))
    return (num / den) ** 0.5


def _train_cfg(model_cfg, sync, seq_len, global_batch, replicas):
    from repro_torch.config import (DataConfig, MeshConfig, OptimizerConfig,
                                    TrainConfig)
    return TrainConfig(
        model=model_cfg,
        mesh=MeshConfig(shape=(replicas,), axis_names=("pod",),
                        replica_axis="pod"),
        sync=sync,
        optimizer=OptimizerConfig(name="adamw", learning_rate=1e-3,
                                  schedule="cosine", total_steps=1000),
        data=DataConfig(seq_len=seq_len, global_batch=global_batch))


def _run_blocks(torch, cfg, dev, impl, blocks, on_block=None):
    """``blocks`` train steps through ``build_trainer`` on path ``impl``
    from the seeded state; returns (state, losses, walls, sync_ms,
    launches)."""
    from repro_torch.core import sync
    from repro_torch.kernels.quant import ops
    from repro_torch.launch.train import build_trainer
    step, state, make_pipeline, _, _, _ = build_trainer(cfg, dev,
                                                        quant_impl=impl)
    pipe = make_pipeline(0)
    batches = [next(pipe) for _ in range(blocks)]
    inner, events = sync.sync_point, []

    def timed_sync(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*args, **kw)
        end.record()
        events.append((start, end))
        return out

    losses, walls = [], []
    sync.sync_point = timed_sync
    try:
        torch.cuda.synchronize()
        ops.LAUNCHES = 0
        for b in range(blocks):
            t0 = time.perf_counter()
            state, metrics = step(state, batches[b])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(float(metrics["loss"]))
            if on_block is not None:
                on_block(b)
        launches = ops.LAUNCHES
    finally:
        sync.sync_point = inner
    sync_ms = [a.elapsed_time(b) for a, b in events]
    return state, step, batches, losses, walls, sync_ms, launches


def phase_train(torch, dev, model_cfg, seq_len, global_batch, replicas, h):
    """The trainer's main path: local SGD with the int8 sync on the kernel
    path, then the plain path from the same state and batches."""
    from repro_torch import tree as T
    from repro_torch.config import SyncConfig
    from repro_torch.core import compression, local_sgd
    from repro_torch.kernels.quant import ops, ref
    blocks = 2
    sync_cfg = SyncConfig(strategy="periodic", period=h, compression="int8")
    cfg = _train_cfg(model_cfg, sync_cfg, seq_len, global_batch, replicas)
    tokens = h * global_batch * seq_len
    log(f"train {model_cfg.name}: {model_cfg.n_layers} layers, d_model "
        f"{model_cfg.d_model}, vocab {model_cfg.vocab_size}, "
        f"{model_cfg.dtype} compute, f32 master params; K={replicas} "
        f"replicas, H={h}, {sync_cfg.msf_label}; AdamW lr 1e-3 cosine; "
        f"{global_batch} x {seq_len} tokens a microbatch "
        f"({global_batch // replicas} sequences a replica)")

    # the first sync's int8 payloads: the kernel path's delta + ef of every
    # leaf, quantized by the kernel and by the plain version afterwards
    captured = []
    inner = compression.compress_tree

    def capture(delta, ef, **kw):
        if not captured:
            captured.extend(d.float() + e for d, e in
                            zip(T.leaves(delta), T.leaves(ef)))
        return inner(delta, ef, **kw)

    torch.cuda.reset_peak_memory_stats()
    compression.compress_tree = capture
    try:
        state, step, batches, losses_k, walls_k, sync_k, launches = \
            _run_blocks(torch, cfg, dev, "kernel", blocks)
    finally:
        compression.compress_tree = inner
    peak = torch.cuda.max_memory_allocated()
    n_leaves = len(T.leaves(state["params"]))
    expect = 2 * blocks * n_leaves
    log(f"train kernel path: losses {losses_k} (first beside ln "
        f"{model_cfg.vocab_size} = {np.log(model_cfg.vocab_size):.4f}); "
        f"block wall {walls_k} s, sync {sync_k} ms, "
        f"{tokens / walls_k[-1]:.1f} trained tokens/s in block {blocks}; "
        f"quant launches {launches} (expected {expect}: one quantize and one "
        f"dequantize per leaf per sync); peak memory {peak / 2**30:.2f} GiB")
    check(launches == expect, f"train: {launches} quant launches, expected "
          f"{expect}")
    check(all(np.isfinite(losses_k)), f"train: losses {losses_k}")
    check(losses_k[1] < losses_k[0], f"train: block 2's loss {losses_k[1]} "
          f"is not below block 1's {losses_k[0]}")
    params = state["params"]
    for leaf in T.leaves(params):
        check(torch.equal(leaf[0], leaf[-1]), "train: replicas differ after "
              "a blocking sync")
    kept = T.map(lambda x: x[0].clone(), params)

    check(len(captured) == n_leaves, f"train: captured {len(captured)} leaves")
    before = ops.LAUNCHES
    for v in captured:
        qk, sk = ops.quantize(v, rows=True)
        qp, sp = ref.quantize(v, rows=True)
        check(torch.equal(qk, qp) and torch.equal(sk, sp),
              "train: the first sync's int8 payload differs between the "
              "kernel and the plain version")
    ops.LAUNCHES = before
    log(f"train first sync: the int8 payloads and scales of all {n_leaves} "
        f"leaves (K={replicas} rows each) bitwise equal, kernel and plain")
    del captured[:]

    # one profiled block on the kernel path
    busy = device_busy(torch, lambda: step(state, batches[-1]))
    log_busy(f"train block (kernel path, {h} x {replicas} replica steps)",
             *busy)
    del state, params, step
    torch.cuda.empty_cache()

    state_p, _, _, losses_p, walls_p, sync_p, launches_p = _run_blocks(
        torch, cfg, dev, "torch", blocks)
    check(launches_p == 0, "train: the plain path launched the quant kernel")
    rel_loss = max(abs(a - b) / abs(b) for a, b in zip(losses_k, losses_p))
    rel = _tree_rel_l2(torch, kept, T.map(lambda x: x[0],
                                          state_p["params"]))
    log(f"train plain path: losses {losses_p}; block wall {walls_p} s, sync "
        f"{sync_p} ms; kernel vs plain: losses rel {rel_loss:.3e} (bound "
        f"{TRAIN_LOSS_REL}), params rel L2 {rel:.3e} (bound "
        f"{TRAIN_PARAMS_REL_L2})")
    check(rel_loss <= TRAIN_LOSS_REL, f"train losses rel {rel_loss}")
    check(rel <= TRAIN_PARAMS_REL_L2, f"train params rel L2 {rel}")
    del state_p, kept
    torch.cuda.empty_cache()

    # MSF = 1: every step synchronized, the same global batch, the gradient
    # over 4 slices of it
    from repro_torch.launch.train import build_trainer
    ddp_cfg = _train_cfg(model_cfg, SyncConfig(), seq_len, global_batch,
                         replicas)
    _, state, make_pipeline, model, _, _ = build_trainer(ddp_cfg, dev)
    ddp = local_sgd.make_ddp_step(model, ddp_cfg, grad_accum=replicas)
    pipe = make_pipeline(0)
    ddp_batches = [next(pipe) for _ in range(h)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ddp_losses = []
    for batch in ddp_batches:
        state, metrics = ddp(state, batch)
        ddp_losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    ddp_wall = time.perf_counter() - t0
    log(f"train make_ddp_step (MSF=1), {h} steps of {global_batch} x "
        f"{seq_len} tokens: losses {ddp_losses}; wall {ddp_wall:.4f} s, "
        f"{tokens / ddp_wall:.1f} trained tokens/s (local SGD block "
        f"{walls_k[-1]:.4f} s)")
    check(all(np.isfinite(ddp_losses)), f"ddp losses {ddp_losses}")
    del state
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the adaptive-MSF path: the SVM block ladder, the adaptive trainer, restarts
# ---------------------------------------------------------------------------

SVM_RUNGS = (32, 64, 128)


def _svm_chain(torch, dev, ds, sizes, impl, k, rungs=SVM_RUNGS):
    """``dms``'s blocking path as the block-size ladder: epoch t on the rung
    ``sizes[t]``, ``dms_ladder_switch`` where the size changes. Returns (the
    final carry's w, wall s, hinge launches, cluster launches, switches)."""
    from repro_torch.core import svm
    from repro_torch.kernels.hinge import ops
    x, y = ds[0], ds[1]
    d = x.shape[1]
    xs, ys = svm._shard_data(x, y, k)
    w0 = torch.zeros(d, device=dev)
    ladder = svm.dms_block_ladder(d=d, workers=k, block_sizes=rungs,
                                  grad_impl=impl, device=dev)
    carry = svm.dms_stepper_init(w0, k)
    switches = 0
    torch.cuda.synchronize()
    ops.LAUNCHES = ops.CLUSTER_LAUNCHES = 0
    t0 = time.perf_counter()
    for t, bs in enumerate(sizes):
        if t and bs != sizes[t - 1]:
            carry = svm.dms_ladder_switch(carry, d=d)
            switches += 1
        nb = xs.shape[1] // bs
        xb = xs[:, :nb * bs].reshape(k, nb, bs, d)
        yb = ys[:, :nb * bs].reshape(k, nb, bs)
        alpha = svm._alpha(t, w0.dtype)
        for i in range(nb):
            carry = ladder[bs](carry, xb[:, i], yb[:, i], alpha)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    w = carry["w"]
    check(torch.equal(w, w[:1].expand(w.shape)),
          f"svm ladder {impl} {sizes}: the workers' models differ after a "
          f"blocking sync")
    return w[0], wall, ops.LAUNCHES, ops.CLUSTER_LAUNCHES, switches


def phase_svm_ladder(torch, dev, ds, k=32):
    """(b) The SVM block ladder on epsilon: epoch 1 at block 64, the switch,
    epoch 2 at 128; held to the plain-gradient chain, bitwise repeatable,
    bitwise ``dms`` without a switch; then ``dms_timed_steps`` at 64 feeds
    a ``BlockTelemetry`` and an ``AdaptiveController`` over the rungs."""
    from repro_torch.config import SyncConfig
    from repro_torch.core import autotune, svm
    from repro_torch.core.telemetry import BlockTelemetry
    from repro_torch.kernels.hinge import ops
    x, y, xt, yt = ds
    d = x.shape[1]
    n_local = x.shape[0] // k
    sizes = (64, 128)
    expect = sum(n_local // bs for bs in sizes)
    xs, ys = svm._shard_data(x, y, k)
    routes = {bs: ops.kernel_for(torch.zeros((k, d), device=dev),
                                 xs[:, :bs], ys[:, :bs]) for bs in sizes}
    wk, wall_k, n, n_cluster, switches = _svm_chain(torch, dev, ds, sizes,
                                                    "kernel", k)
    wk2, _, n2, _, _ = _svm_chain(torch, dev, ds, sizes, "kernel", k)
    wt, wall_t, n_t, _, _ = _svm_chain(torch, dev, ds, sizes, "torch", k)
    check(bool(torch.isfinite(wk).all()), "svm ladder: model not finite")
    acc_k = float(svm.accuracy(wk, xt, yt))
    acc_t = float(svm.accuracy(wt, xt, yt))
    rel = float((wk - wt).norm() / wt.norm())
    log(f"svm ladder epsilon K={k} rungs {SVM_RUNGS}: epoch 1 at 64, "
        f"{switches} switch, epoch 2 at 128; hinge launches {n} (expected "
        f"{expect}: the blocks), {n_cluster} on the cluster kernel (routes "
        f"{routes}); plain-path launches {n_t}; test acc kernel {acc_k:.4f} "
        f"plain {acc_t:.4f}; rel L2(w) {rel:.3e}; wall kernel {wall_k:.4f} s "
        f"plain {wall_t:.4f} s")
    check(switches == 1, f"svm ladder: {switches} switches")
    check(n == n2 == expect and n_t == 0,
          f"svm ladder: launches {n}/{n2}/{n_t}, expected {expect}")
    check(n_cluster == (n if set(routes.values()) == {"cluster"} else
                        sum(n_local // bs for bs in sizes
                            if routes[bs] == "cluster")),
          f"svm ladder: {n_cluster} of {n} launches on the cluster kernel, "
          f"routes {routes}")
    check(torch.equal(wk, wk2), "svm ladder: two kernel runs differ")
    check(rel <= W_REL_L2, f"svm ladder: rel L2 {rel} > {W_REL_L2}")
    check(abs(acc_k - acc_t) <= ACC_DIFF,
          f"svm ladder: accuracy {acc_k} vs {acc_t}")

    # without a switch the ladder is dms: the same blocks, sync and alpha
    w64, wall64, n64, _, _ = _svm_chain(torch, dev, ds, (64, 64), "kernel", k)
    w0 = torch.zeros(d, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wd = svm.dms(w0, x, y, workers=k, epochs=2, block_size=64, device=dev)
    torch.cuda.synchronize()
    wall_d = time.perf_counter() - t0
    same = torch.equal(w64, wd)
    log(f"svm ladder at 64 without a switch vs dms(block 64, 2 epochs): "
        f"bitwise {same}, max abs diff {float((w64 - wd).abs().max()):.3e}; "
        f"{n64} launches; wall ladder {wall64:.4f} s dms {wall_d:.4f} s")
    check(same, "svm ladder at 64 differs from dms(backend='vmap')")

    busy = device_busy(torch, lambda: _svm_chain(torch, dev, ds, sizes,
                                                 "kernel", k))
    log_busy("svm ladder (64, switch, 128)", *busy)
    busy = device_busy(torch, lambda: svm.dms(
        w0, x, y, workers=k, epochs=2, block_size=64, device=dev))
    log_busy("dms epsilon (block 64, 2 epochs)", *busy)

    # the paper's Figs 10-12 method: compute and sync timed apart, feeding
    # the telemetry and a controller over the rungs
    tel = BlockTelemetry()
    compute, sync = svm.dms_timed_steps(block_size=64, telemetry=tel)
    ctrl = autotune.AdaptiveController(
        SyncConfig(strategy="periodic", period=64), param_bytes_per_chip=4 * d,
        replicas=k, telemetry=tel, ladder=SVM_RUNGS, h0=64)
    nb = n_local // 64
    xb = xs[:, :nb * 64].reshape(k, nb, 64, d)
    yb = ys[:, :nb * 64].reshape(k, nb, 64)
    ops.LAUNCHES = 0
    w = w0
    for i in range(nb):
        w = sync(compute(w, xb[:, i], yb[:, i], svm._alpha(0, w0.dtype)))
        ctrl.observe_block()
    t_step, t_sync = tel.estimates()
    log(f"svm timed steps at 64 ({nb} blocks, {ops.LAUNCHES} hinge "
        f"launches): T_step {1e6 * t_step:.4f} us a point, T_sync "
        f"{1e6 * t_sync:.4f} us a block (host clock, each call waited for); "
        f"the controller over {SVM_RUNGS} picks block size {ctrl.h} "
        f"(history {ctrl.history})")
    check(ops.LAUNCHES == nb, f"svm timed steps: {ops.LAUNCHES} launches")
    check(ctrl.h in SVM_RUNGS, f"svm controller picked {ctrl.h}")
    return n


def _host(torch, tree):
    """A copy of ``tree`` in page-locked host memory (a full-width state is
    ~23 GB: a pageable copy runs at ~1 GB/s)."""
    from repro_torch import tree as T

    def copy(x):
        if not isinstance(x, torch.Tensor):
            return x
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=x.is_cuda)
        return h.copy_(x)
    return T.map(copy, tree)


def _device(torch, tree, dev):
    from repro_torch import tree as T
    return T.map(lambda x: x.to(dev) if isinstance(x, torch.Tensor) else x,
                 tree)


def _same(torch, got, want, what):
    """Bitwise: every leaf of ``got`` equals ``want``'s (either may lie on
    the host or the card; compared a leaf at a time where ``want``'s
    lies)."""
    from repro_torch import tree as T
    a, b = T.leaves(got), T.leaves(want)
    check(len(a) == len(b), f"{what}: {len(a)} leaves against {len(b)}")
    for x, z in zip(a, b):
        if isinstance(x, torch.Tensor):
            check(torch.equal(x.to(z.device), z), f"{what}: a leaf differs")
        else:
            check(x == z, f"{what}: {x} != {z}")


def _rung_walls(runner, ladder):
    """{H: [wall s of each block run at H]} from the runner's log and the
    ladder's trajectory."""
    walls = {}
    for m in runner.metrics_log:
        h = [h for b, h in ladder.trajectory if b <= m["step"]][-1]
        walls.setdefault(h, []).append(m["elapsed"])
    return walls


def phase_adaptive_train(torch, dev, model_cfg, seq_len, global_batch,
                         replicas, blocks=8):
    """(a) The adaptive trainer at full width: a forced switch at the first
    block boundary held bitwise to ``ladder_switch_state`` and to a fresh
    ``make_train_step``, then ``blocks`` blocks through ``StepRunner`` with
    the live controller over the ladder (1, 2, 4)."""
    from repro_torch import tree as T
    from repro_torch.config import FaultToleranceConfig, SyncConfig
    from repro_torch.core import local_sgd
    from repro_torch.kernels.quant import ops
    from repro_torch.launch.train import build_trainer
    from repro_torch.runtime import StepRunner
    sync_cfg = SyncConfig(strategy="periodic", period=4, compression="int8",
                          adaptive=True, adapt_ladder=(1, 2, 4),
                          adapt_every=2)
    cfg = _train_cfg(model_cfg, sync_cfg, seq_len, global_batch, replicas)
    log(f"adaptive train {model_cfg.name}: K={replicas}, "
        f"{sync_cfg.msf_label}, ladder {sync_cfg.ladder_rungs()}, re-solve "
        f"every {sync_cfg.adapt_every} blocks; {global_batch} x {seq_len} "
        f"tokens a microbatch")

    # the forced switch at the first block boundary: the pre-switch
    # snapshot on the card, the switched one on the host (the next block
    # needs the card's memory)
    t0 = time.perf_counter()
    step, state, make_pipeline, model, _, ladder = build_trainer(cfg, dev)
    pipe = make_pipeline(0)
    state, _ = ladder.rungs[4](state, next(pipe))
    pre = T.map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
                state)
    switched = ladder.switch_fn(state)
    del state
    want = local_sgd.ladder_switch_state(pre, cfg)
    _same(torch, switched, want, "forced switch vs ladder_switch_state")
    del want, pre
    sw = _host(torch, switched)
    batch = next(ttrain_blocked(cfg, 2, pipe.state()["step"], dev))
    got, m_rung = ladder.rungs[2](switched, batch)
    loss_rung = float(m_rung["loss"])
    got = _host(torch, got)
    del switched
    torch.cuda.empty_cache()
    fresh = local_sgd.make_train_step(model, cfg)
    ref_state, m_fresh = fresh(_device(torch, sw, dev), batch)
    _same(torch, got, ref_state, "rung 2 after the switch vs a fresh "
          "make_train_step")
    check(loss_rung == float(m_fresh["loss"]), "forced switch: losses differ")
    log(f"adaptive train forced switch 4 -> 2 after block 1: the switched "
        f"state bitwise ladder_switch_state of the pre-switch snapshot; the "
        f"next block on rung 2 bitwise a fresh make_train_step from the "
        f"switched snapshot (loss {loss_rung}); "
        f"{time.perf_counter() - t0:.1f} s")
    del ref_state, got, sw, step, ladder, fresh, m_rung, m_fresh
    torch.cuda.empty_cache()

    # the live run: StepRunner over the ladder, checkpoints off. The quant
    # library is dropped first, as in a fresh process, so that the ladder's
    # warmup must load it and the compile counter has a load to hear
    torch.cuda.reset_peak_memory_stats()
    ops._LIB = None
    step, state, make_pipeline, _, telemetry, ladder = build_trainer(cfg, dev)
    n_leaves = len(T.leaves(state["params"]))
    runner = StepRunner(step, None, FaultToleranceConfig(max_restarts=0), 1,
                        make_pipeline, ladder=ladder)
    torch.cuda.synchronize()
    ops.LAUNCHES = 0
    t0 = time.perf_counter()
    state, end = runner.run(state, 0, blocks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    ad = ladder.to_dict()
    walls = _rung_walls(runner, ladder)
    per_rung = "; ".join(
        f"H={h}: {len(w)} blocks, wall {w} s, "
        f"{h * global_batch * seq_len / min(w):.1f} trained tokens/s "
        f"(fastest block)" for h, w in sorted(walls.items()))
    est = telemetry.estimates()
    log(f"adaptive train: {end} blocks in {wall:.3f} s; H trajectory "
        f"{ad['h_trajectory']}, {ad['switches']} switches, controller "
        f"history {ladder.controller.history}; {per_rung}")
    log(f"adaptive train telemetry: T_step {est[0]:.6f} s a replica-set "
        f"step, T_sync {1e3 * est[1]:.3f} ms a sync (CUDA events around "
        f"sync_point); {telemetry.to_dict()}; compiles total "
        f"{ad['compiles_total']}, after warmup {ad['compiles_after_warmup']}; "
        f"quant launches {launches} ({launches / end:.1f} a block, expected "
        f"{2 * n_leaves}); peak memory {peak / 2**30:.2f} GiB")
    check(peak <= 75e9, f"adaptive train: peak memory {peak / 1e9:.2f} GB "
          f"over 75 GB")
    check(ad["compiles_total"] > 0,
          "adaptive train: the compile counter heard no load in the warmup")
    check(ad["compiles_after_warmup"] == 0,
          f"adaptive train: {ad['compiles_after_warmup']} compiles after "
          f"warmup")
    check(all(h in ad["ladder"] for _, h in ad["h_trajectory"]),
          f"adaptive train: a rung outside the ladder {ad['h_trajectory']}")
    check(end == blocks and launches == 2 * n_leaves * blocks,
          f"adaptive train: {launches} quant launches over {end} blocks, "
          f"expected {2 * n_leaves} a block")
    losses = [m["loss"] for m in runner.metrics_log]
    check(all(np.isfinite(losses)), f"adaptive train: losses {losses}")
    check(losses[-1] < losses[0], f"adaptive train: losses {losses}")
    log(f"adaptive train losses: {losses}")

    pipe = make_pipeline(runner.metrics_log[-1]["step"] + 1)
    batch = next(pipe)
    busy = device_busy(torch, lambda: ladder.step_fn(state, batch))
    log_busy(f"adaptive train block (rung H={ladder.h}, {ladder.h} x "
             f"{replicas} replica steps)", *busy)
    del state, step, ladder, runner, batch
    torch.cuda.empty_cache()
    return launches


def ttrain_blocked(cfg, h, start, dev):
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch.train import _Blocked
    return _Blocked(DataPipeline(cfg.data, cfg.model, device=dev,
                                 start_step=start), h)


class ScriptedController:
    """A controller whose moves are a script {block: H}, so that runs with
    and without a fault take the same rungs (the live controller moves on
    measured times)."""

    def __init__(self, h0, script):
        self.h = h0
        self.script = dict(script)
        self._blocks = 0
        self.history = [(0, h0)]

    def observe_block(self, **_kw):
        self._blocks += 1
        if self._blocks in self.script:
            self.h = self.script[self._blocks]
            self.history.append((self._blocks, self.h))
        return self.h


def phase_fault_restart(torch, dev, model_cfg, replicas=4, steps=6):
    """(c) Fault and restart on the card at smoke width, int8 on the quant
    kernel: ``StepRunner`` over a ladder that moves 2 -> 1 after block 2
    and back 1 -> 2 after block 3, on the checkpoint every 3 blocks; a
    fault after that checkpoint (step 4) and one before it (step 2, after
    the first move) both replay bitwise the run without one, the rung
    restored."""
    import tempfile

    from repro_torch import tree as T
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import (CheckpointConfig, FaultToleranceConfig,
                                    SyncConfig, config_fingerprint)
    from repro_torch.kernels.quant import ops
    from repro_torch.launch.train import build_trainer
    from repro_torch.runtime import LadderRuntime, StepRunner
    sync_cfg = SyncConfig(strategy="periodic", period=2, compression="int8",
                          adaptive=True, adapt_ladder=(1, 2))
    cfg = _train_cfg(model_cfg, sync_cfg, 64, 2 * replicas, replicas)
    finals = {}
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        for fail_at in (-1, 4, 2):
            step, state, make_pipeline, _, tel, live = build_trainer(cfg, dev)
            ladder = LadderRuntime(live.rungs, live.switch_fn,
                                   ScriptedController(2, {2: 1, 3: 2}),
                                   telemetry=tel, device=dev,
                                   compile_counter=live.compile_counter)

            def blocked(start, ladder=ladder):
                return ttrain_blocked(cfg, ladder.h, start, dev)

            ckpt_cfg = CheckpointConfig(directory=os.path.join(
                tmp, f"f{fail_at}"), interval_steps=3)
            fault = FaultToleranceConfig(inject_failure_at=fail_at)
            runner = StepRunner(step, CheckpointManager(ckpt_cfg), fault,
                                ckpt_cfg.interval_steps, blocked,
                                fingerprint=config_fingerprint(cfg),
                                ladder=ladder)
            ops.LAUNCHES = 0
            state, end = runner.run(state, 0, steps)
            torch.cuda.synchronize()
            launches = ops.LAUNCHES
            ckpts = runner.ckpt.all_steps()
            finals[fail_at] = _host(torch, state)
            log(f"fault/restart (fault at step {fail_at}): {end} steps, "
                f"{runner.restarts} restarts, checkpoints {ckpts}, H "
                f"trajectory {ladder.trajectory}, rung at the end "
                f"{ladder.h}, quant launches {launches}, compiles after "
                f"warmup {ladder.to_dict()['compiles_after_warmup']}")
            check(end == steps and runner.restarts == (fail_at >= 0),
                  f"fault at {fail_at}: {end} steps, {runner.restarts} "
                  f"restarts")
            check(ladder.h == 2, f"fault at {fail_at}: rung {ladder.h}")
            check(launches > 0, f"fault at {fail_at}: no quant launch")
            if fail_at < 0:
                n_leaves = len(T.leaves(finals[fail_at]["params"]))
                check(launches == 2 * n_leaves * steps,
                      f"fault/restart: {launches} quant launches, expected "
                      f"{2 * n_leaves} a block")
            del state, step, ladder, live, runner
    for fail_at in (4, 2):
        _same(torch, finals[fail_at], finals[-1],
              f"fault at step {fail_at}: the replay vs the run without one")
    log("fault/restart: a fault after the step-3 checkpoint (which holds the "
        "move taken at that step) and one before it both replay bitwise the "
        "run without a fault (params, opt, sync, step)")


TRAIN_MODES = [dict(overlap="delayed", compression="int8"),
               dict(overlap="chunked", compression="int8"),
               dict(topology="ring", compression="int8"),
               dict(topology="pairwise", compression="int8"),
               dict(topology="ring", gossip_async=True, compression="int8"),
               dict(compression="int16")]


def phase_train_modes(torch, dev, model_cfg, replicas=4, h=2, blocks=3):
    """Every other sync mode at smoke width: kernel path against plain
    path from the same state and batches."""
    from repro_torch.config import SyncConfig
    for mode in TRAIN_MODES:
        sync_cfg = SyncConfig(strategy="periodic", period=h, chunks=3, **mode)
        cfg = _train_cfg(model_cfg, sync_cfg, 64, 2 * replicas, replicas)
        runs = {impl: _run_blocks(torch, cfg, dev, impl, blocks)
                for impl in ("kernel", "torch")}
        (sk, _, _, lk, _, _, nk), (sp, _, _, lp, _, _, np_) = (
            runs["kernel"], runs["torch"])
        rel_loss = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
        rel = _tree_rel_l2(torch, sk["params"], sp["params"])
        log(f"train mode {sync_cfg.msf_label}: losses kernel {lk} plain {lp}; "
            f"rel {rel_loss:.3e}, params rel L2 {rel:.3e}; quant launches "
            f"kernel {nk} plain {np_}")
        check(all(np.isfinite(lk)) and all(np.isfinite(lp)),
              f"{sync_cfg.msf_label}: losses not finite")
        check(rel_loss <= TRAIN_LOSS_REL and rel <= TRAIN_PARAMS_REL_L2,
              f"{sync_cfg.msf_label}: kernel vs plain rel {rel_loss} / {rel}")
        int8 = sync_cfg.compression == "int8"
        check(np_ == 0 and (nk > 0) == int8,
              f"{sync_cfg.msf_label}: quant launches {nk} / {np_}")
        del runs, sk, sp
    torch.cuda.empty_cache()


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
    launches, eps = phase_main(torch, dev)
    phase_svm_ladder(torch, dev, eps)
    del eps
    torch.cuda.empty_cache()
    phase_modes(torch, dev)
    flash_row = phase_flash(torch, dev)
    from repro_torch.config import get_arch
    flash_launches = phase_serve(
        torch, dev, get_arch("smollm-360m"), SERVE_BATCH, SERVE_PROMPT,
        SERVE_GEN, LOGITS_REL_L2)["flash_attention_tc"]
    quant_row = phase_quant(torch, dev)
    from repro_torch.config import get_smoke
    quant_launches = phase_train(torch, dev, get_arch("smollm-360m"),
                                 TRAIN_SEQ, TRAIN_BATCH, TRAIN_K, TRAIN_H)
    phase_adaptive_train(torch, dev, get_arch("smollm-360m"), TRAIN_SEQ,
                         TRAIN_BATCH, TRAIN_K)
    phase_fault_restart(torch, dev, get_smoke("smollm-360m"))
    phase_train_modes(torch, dev, get_smoke("smollm-360m"))
    ssd_row = phase_ssd(torch, dev)
    ssd_launches = phase_serve(
        torch, dev, get_arch("mamba2-2.7b"), SERVE_BATCH, SERVE_PROMPT,
        SERVE_GEN, None, SSM_F32_LOGITS_REL_L2,
        bf16_factor=SSM_BF16_VS_F32_FACTOR)["ssd_tc"]
    phase_serve(torch, dev, get_arch("zamba2-1.2b"), SERVE_BATCH,
                SERVE_PROMPT, SERVE_GEN, None, SSM_F32_LOGITS_REL_L2,
                bf16_factor=SSM_BF16_VS_F32_FACTOR)
    log(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "hinge_block_grad", "route": "cuda",
        "source": "src/repro_torch/kernels/hinge/csrc/hinge_cluster.cu",
        "replaces": "src/repro/kernels/hinge/kernel.py:27",
        "launches": launches, "max_abs_err": row["max_abs_err"],
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
        "library_ms": None}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_tc.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:32",
        "launches": flash_launches, **flash_row}, {
        "name": "quant", "route": "cuda",
        "source": "src/repro_torch/kernels/quant/csrc/quant.cu",
        "replaces": "src/repro/kernels/quant/kernel.py:18",
        "launches": quant_launches, **quant_row}, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd/csrc/ssd_tc.cu",
        "replaces": "src/repro/kernels/ssd/kernel.py:32",
        "launches": ssd_launches, **ssd_row}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
