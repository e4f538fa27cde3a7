#!/usr/bin/env python3
"""Time variants of the cluster hinge kernel on one card.

    python3 scripts/hinge_variants.py [VARIANT,...]

Each variant is ``csrc/hinge_cluster.cu`` with one part of the work cut
out, or the wrapper's plan changed, built with the same ``nvcc`` flags into
``kernels/_build/variants/`` and called through the same C interface;
``simt`` is ``csrc/hinge.cu`` and ``plain`` the plain version on the same
inputs.

* ``kernel``: the source and plan as they are.
* ``rows1``, ``rows2``, ``rows4``: 1, 2 or 4 rows a stage in place of the
  plan's, the ring holding as many stages as the run needs, up to 4.
* ``slots1`` … ``slots4``: a ring of 1 to 4 stages (applied after a
  ``rows`` change).
* ``g4``: clusters of 4 CTAs of 16 rows (128 CTAs) in place of 8 of 8.

Cuts, whose outputs are wrong and whose times say where the time goes:

* ``y_serial``: each row's y read from device memory once the stage has
  landed, in place of copied in with it;
* ``no_products``: no shared-memory read of X and neither product;
* ``no_copy``: no copy of X, the products on stale shared memory;
* ``no_shfl``: no warp shuffle tree in the margins;
* ``local_push``: each CTA stores its column sums into its own shared
  memory in place of the owning ranks' (no distributed shared memory);
* ``no_cluster``: ``local_push`` and no cluster barrier;
* ``no_stages``: no copy and no stage: launch, set-up and the cluster sum;
* ``empty``: every CTA leaves at once: the launch alone.

``timeline`` (joined to any of the above) has thread 0 of every CTA record
``%globaltimer`` at entry, after set-up (the first copies issued), when the
first stage has landed, after the last stage, after the cluster barrier's
first phase, after its second and at exit, into a buffer past the output;
for the last of the input sets it prints each mark's median and maximum
over the CTAs, in µs from the first CTA's entry.

Names join with ``+``. At the epsilon main path's block (K=32, n=64,
d=2,000, worker-major views of one (K, 7·64, d) array, so more bytes than L2
holds are read across a turn) every variant that computes the function is
held to the plain version (rtol 1e-4 / atol 1e-5); then all are timed in
turns, three times: a CUDA graph of one call on each of 7 input sets,
replayed 21 times after warm-up, the median per call. Each variant's
launches are also timed one by one under ``torch.profiler`` (the kernel's
own duration, without the gaps between launches). Compare variants only
inside one run.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))
sys.path.insert(0, REPO)

K, N, D, COPIES = 32, 64, 2000, 7
CUTS = ("y_serial", "no_products", "no_copy", "no_shfl", "local_push",
        "no_cluster", "no_stages", "empty")
# plan changes: (CTAs a cluster, rows a CTA, rows a stage, ring slots)
PLANS = {"rows1": lambda g, r, s, k: (g, r, 1, min(4, r)),
         "rows2": lambda g, r, s, k: (g, r, 2, min(4, -(-r // 2))),
         "rows4": lambda g, r, s, k: (g, r, 4, min(4, -(-r // 4))),
         "slots1": lambda g, r, s, k: (g, r, s, 1),
         "slots2": lambda g, r, s, k: (g, r, s, 2),
         "slots3": lambda g, r, s, k: (g, r, s, 3),
         "slots4": lambda g, r, s, k: (g, r, s, 4),
         "g4": lambda g, r, s, k: (4, 16, s, k)}


def _swap(src: str, old: str, new: str) -> str:
    if old not in src:
        raise ValueError(f"variant does not apply: {old!r} not in source")
    return src.replace(old, new)


def variant_source(src: str, name: str) -> str:
    """The kernel's source with the cuts ``name`` lists (``a+b``)."""
    for part in name.split("+"):
        if part == "y_serial":
            src = _swap(src, "yr[r] = yst[r];",
                        "yr[r] = yk[i * a.stage_rows + r];")
        elif part == "no_products":
            src = _swap(src, "xr[r][j] = q < d4 ? xs[r * d4 + q] : zero;\n"
                        "        p = dot4(xr[r][j], wr[j], p);",
                        "xr[r][j] = zero;")
            src = _swap(src, "for (int j = 0; j < kMaxQuads; ++j) axpy4(coef, "
                        "xr[r][j], acc[j]);", "acc[0].x += coef;")
        elif part == "no_copy":
            src = _swap(src, "mbar_expect_tx(bar, bytes);\n    if (bytes)",
                        "mbar_expect_tx(bar, 0);\n    if (false)")
        elif part == "no_shfl":
            src = _swap(src, "p += __shfl_xor_sync(0xffffffffu, p, off);",
                        "p += 0.0f;")
        elif part in ("local_push", "no_cluster"):
            src = _swap(src, "cluster.map_shared_rank(recv, g)[", "recv[")
            if part == "no_cluster":
                src = _swap(src, '  asm volatile("barrier.cluster.wait.'
                            'aligned;\\n" ::: "memory");', "")
                src = _swap(src, '  asm volatile("barrier.cluster.arrive.'
                            'relaxed.aligned;\\n" ::: "memory");', "")
                src = _swap(src, "  cluster.sync();", "  __syncthreads();")
        elif part == "no_stages":
            src = _swap(src, "for (int i = 0; i < first; ++i) bulk_rows(i);",
                        ";")
            src = _swap(src, "for (int i = 0; i < first; ++i) "
                        "copy_y(i);", "")
            src = _swap(src, "for (int i = 0; i < nstages; ++i) {",
                        "for (int i = 0; i < 0; ++i) {")
        elif part == "empty":
            src = _swap(src, 'relaxed.aligned;\\n" ::: "memory");',
                        'relaxed.aligned;\\n" ::: "memory");\n  return;')
        elif part == "timeline":
            src = _timeline(src)
        elif part not in ("kernel", *PLANS):
            raise ValueError(f"unknown variant {part!r}")
    return src


MARKS = ("entry", "set-up", "stage 0", "stages", "phase 1", "phase 2",
         "exit")


def _timeline(src: str) -> str:
    """Records MARKS into ``out + K·d`` (8 u64 a CTA)."""
    src = _swap(src, 'relaxed.aligned;\\n" ::: "memory");',
                'relaxed.aligned;\\n" ::: "memory");\n'
                '  uint64_t tm[8] = {global_ns()};')
    src = _swap(src, "  __syncthreads();\n  for (int i = 0; i < first;",
                "  __syncthreads();\n  tm[1] = global_ns();\n"
                "  for (int i = 0; i < first;")
    src = _swap(src, "mbar_wait(smem_u32(bars + s), (i / a.slots) & 1);",
                "mbar_wait(smem_u32(bars + s), (i / a.slots) & 1);\n"
                "    if (i == 0) tm[2] = global_ns();")
    src = _swap(src, '  asm volatile("barrier.cluster.wait.aligned;\\n" ::: '
                '"memory");', '  tm[3] = global_ns();\n  asm volatile('
                '"barrier.cluster.wait.aligned;\\n" ::: "memory");\n'
                '  tm[4] = global_ns();')
    src = _swap(src, "  cluster.sync();\n", "  cluster.sync();\n"
                "  tm[5] = global_ns();\n")
    return _swap(src, "  }\n}\n\nsize_t smem_bytes(",
                 "  }\n  tm[6] = global_ns();\n  if (tid == 0) {\n"
                 "    uint64_t* t = reinterpret_cast<uint64_t*>(a.out + "
                 "static_cast<long long>(gridDim.y) * a.d) + 8 * (k * a.g + "
                 "rank);\n    for (int i = 0; i < 7; ++i) t[i] = tm[i];\n"
                 "  }\n}\n\nsize_t smem_bytes(")


def build(name: str):
    """Build variant ``name``; return (library path, ptxas report)."""
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.hinge import ops
    src = variant_source(ops.CLUSTER_SOURCE.read_text(), name)
    out = nvcc.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f"hinge_{name.replace('+', '_')}.cu"
    cu.write_text(src)
    lib = cu.with_suffix(".so")
    proc = subprocess.run([nvcc.nvcc_path(), *nvcc.FLAGS, "-o", str(lib),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr}")
    return lib, proc.stderr


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("hinge_variants: needs a CUDA card", file=sys.stderr)
        return 1
    from chip_smoke import device_ms, hinge_inputs
    from repro_torch.kernels.hinge import ops, ref
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = (sys.argv[1].split(",") if len(sys.argv) > 1 else
             ["kernel", "rows2+slots2", "g4", *CUTS])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(build, names)))
    dev = torch.device("cuda", 0)
    sets = hinge_inputs(torch, dev, 7, (K, N, D), (D,), COPIES)
    plan = ops.cluster_plan(N, D)
    fns, stamps = {}, {}
    for name, (lib_path, report) in built.items():
        lib = ctypes.CDLL(str(lib_path))
        fn = lib.hinge_cluster_f32
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [ptr, i64, ptr, i64, ptr, i64, ptr, i32, i32, i32,
                       i32, i32, i32, i32, ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        g, rows, stage_rows, slots = plan
        for part in sorted(name.split("+"), key=lambda p: p.startswith("slots")):
            if part in PLANS:
                g, rows, stage_rows, slots = PLANS[part](g, rows, stage_rows,
                                                         slots)

        extra = 2 * 8 * K * g if "timeline" in name.split("+") else 0

        def call(w, x, y, fn=fn, lib=lib, p=(g, rows, stage_rows, slots),
                 extra=extra, name=name):
            out = torch.empty(K * D + extra, device=dev)
            err = fn(x.data_ptr(), x.stride(0), y.data_ptr(), y.stride(0),
                     w.data_ptr(), 0, out.data_ptr(), K, N, D, *p,
                     1.0, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")
            if extra:
                stamps[name] = out[K * D:]
            return out[:K * D].view(K, D)
        fns[name] = call
        lib.hinge_cluster_max_active.argtypes = [i32] * 4
        active = lib.hinge_cluster_max_active(D, g, stage_rows, slots)
        regs = [ln.split("info    : ")[-1] for ln in report.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"{name}: plan g={g} rows={rows} stage_rows={stage_rows} "
              f"slots={slots}, "
              f"{active} clusters fit at once; ptxas {regs}", flush=True)
    fns["simt"] = lambda w, x, y: ops.run_kernel("simt", w, x, y, 1.0)
    fns["plain"] = lambda w, x, y: ref.hinge_block_grad(w, x, y, 1.0)

    want = ref.hinge_block_grad(*sets[0], 1.0)
    for name, fn in fns.items():
        if any(p in CUTS or p == "timeline" for p in name.split("+")):
            continue
        got = fn(*sets[0])
        again = fn(*sets[0])
        torch.cuda.synchronize()
        check = torch.allclose(got, want, rtol=1e-4, atol=1e-5)
        print(f"{name}: max abs err {float((got - want).abs().max()):.3e} "
              f"within bound {check}, bitwise repeatable "
              f"{torch.equal(got, again)}", flush=True)
        if not check:
            return 1

    times = {name: [] for name in fns}
    for turn in range(3):
        order = list(fns) if turn % 2 == 0 else list(fns)[::-1]
        for name in order:
            times[name].append(device_ms(torch, fns[name], sets) * 1e3)
    for name in fns:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for args in sets:
                fns[name](*args)
            torch.cuda.synchronize()
        per = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                per.setdefault(e.name[:40], []).append(
                    e.time_range.elapsed_us())
        launches = "; ".join(f"{k} median {np.median(v):.3f} us x{len(v)}"
                             for k, v in per.items())
        print(f"{name}: graph replay us per call {[f'{t:.4f}' for t in times[name]]}"
              f" min {min(times[name]):.4f}; profiler: {launches}",
              flush=True)
    for name, fn in fns.items():
        if "timeline" not in name.split("+"):
            continue
        for args in sets:
            fn(*args)
        torch.cuda.synchronize()
        t = stamps[name].view(torch.int64).view(-1, 8)[:, :7].cpu().numpy()
        t = (t - t[:, 0].min()) * 1e-3
        print(f"{name} timeline (us from the first CTA's entry, median / max "
              f"over {t.shape[0]} CTAs): " + "; ".join(
                  f"{m} {np.median(t[:, i]):.3f} / {t[:, i].max():.3f}"
                  for i, m in enumerate(MARKS)), flush=True)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
