#!/usr/bin/env python3
"""Time variants of the tensor-core SSD chunk-scan kernel on one card.

    python3 scripts/ssd_tc_variants.py [VARIANT,...]

Each variant is ``csrc/ssd_tc.cu`` with one design choice changed, or one
part of the work cut out, built with the same ``nvcc`` flags into
``kernels/_build/variants/`` and called through the same C interface;
``simt`` is the CUDA-core kernel (``csrc/ssd.cu``) on the same inputs.

* ``kernel``: the source as it is.
* ``hpw2``: 2 heads a warpgroup in the chunk scan, in place of 4 (C Bᵀ
  shared by half as many heads, twice the CTAs).

Cuts, whose outputs are wrong and whose times say where the time goes:

* ``no_state``, ``no_pass``, ``no_scan``: one of the three launches left
  out;
* ``no_lo``: every product with a lo part left out (of B ∘ w, G, S_in);
* ``no_g``: C Bᵀ in place of G (no decay, no mask);
* ``no_inter``: no C S_in term and no S_in loads in the chunk scan;
* ``no_mma``: no product of the chunk scan's heads;
* ``no_ystore``: no y written (where P is a multiple of 8);
* ``no_bfrag``: the chunk-state launch's A fragments from w alone, no B
  read.

Names join with ``+``. Each variant's launches are also timed one by one
under ``torch.profiler``.

Per shape (the mamba2-2.7b and zamba2-1.2b prefills, bf16, chunk 256) each
variant that computes the function is held to the plain chunked scan (y
rtol 2**-7 / atol 2e-4, the state rtol 1e-3 / atol 2e-4), then all are
timed in turns, forward then backward, three times: CUDA events over one
call on each of 4 input sets (more bytes than L2 holds), the median of 5
runs; the minimum is printed beside every turn. Compare variants only
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

SHAPES = [(4, 1920, 80, 64, 128, 256), (4, 1920, 64, 64, 64, 256)]
CUTS = ("no_state", "no_pass", "no_scan", "no_lo", "no_g", "no_inter",
        "no_bfrag", "no_mma", "no_ystore")
LAUNCH = {"no_state": "  ssd_tc_state<NT, PT><<<",
          "no_pass": "  ssd_tc_pass<<<",
          "no_scan": "  ssd_tc_scan<NT, PT><<<"}


def _swap(src: str, old: str, new: str) -> str:
    if old not in src:
        raise ValueError(f"variant does not apply: {old!r} not in source")
    return src.replace(old, new)


def variant_source(src: str, name: str) -> str:
    """The kernel's source with the changes ``name`` lists (``a+b``)."""
    for part in name.split("+"):
        if part == "kernel":
            continue
        elif part == "hpw2":
            src = _swap(src, "kHeadsPerWg = 4;",
                        f"kHeadsPerWg = {part[-1]};")
        elif part in LAUNCH:
            # the launch statement runs to its ");": drop it
            start = src.index(LAUNCH[part])
            end = src.index(");", start) + 2
            src = src[:start] + src[end:]
        elif part == "no_g":
            src = _swap(src, "split2(g0, g1, hi[kk][r], lo[kk][r]);",
                        "split2(cbj[e * 128], cbj[(e + 1) * 128], "
                        "hi[kk][r], lo[kk][r]);")
        elif part == "no_inter":
            src = _swap(src, "if (nh > 0 && c > 0) issue_s(heads[0]);", "")
            src = _swap(src, "    if (c > 0) {\n      // C S_in",
                        "    if (false) {\n      // C S_in")
        elif part == "no_bfrag":
            src = _swap(src, "const float v0 = __bfloat162float(bt[s * NT + m]) "
                        "* w[s];", "const float v0 = w[s];")
            src = _swap(src, "const float v1 = __bfloat162float(bt[(s + 1) * NT "
                        "+ m]) * w[s + 1];", "const float v1 = w[s + 1];")
        elif part == "no_mma":
            # every product of the chunk scan's heads (C S_in and G X)
            src = _swap(src, "          wgmma_rs(acc[pc], hi[kk], dx);\n"
                        "          wgmma_rs(acc[pc], lo[kk], dx);\n"
                        "        }\n      wg_commit();\n      if (j < rt)",
                        "        }\n      wg_commit();\n      if (j < rt)")
            src = _swap(src, "wgmma_ss_tb(acc[pc], dc, desc(s_hi + so));", "")
            src = _swap(src, "wgmma_ss_tb(acc[pc], dc, desc(s_lo + so));", "")
        elif part == "no_ystore":
            src = _swap(src, "        *reinterpret_cast<uint4*>(yp + row * "
                        "y_sl + 8 * k) =\n            *reinterpret_cast<"
                        "const uint4*>(y_stg + row * T::LDY + 8 * k);", "")
        elif part == "no_lo":
            src = _swap(src, "wgmma_rs(acc[pc], lo[kk], dx);", "")
            src = _swap(src, "wgmma_ss_tb(acc[pc], dc, desc(s_lo + so));",
                        "")
        else:
            raise ValueError(f"unknown variant part {part!r}")
    return src


def main() -> int:
    import torch
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.ssd import ops
    from repro_torch.models.ssm import ssd_chunked
    if not torch.cuda.is_available():
        print("ssd_tc_variants: needs a CUDA card", file=sys.stderr)
        return 1
    names = (sys.argv[1] if len(sys.argv) > 1 else
             "kernel,hpw2,no_lo,no_state,no_pass,no_scan,simt"
             ).split(",")
    out_dir = nvcc.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = ops.TC_SOURCE.read_text()

    def build(name):
        if name == "simt":
            return None, []
        path = out_dir / f"ssd_{name.replace('+', '_')}.cu"
        path.write_text(variant_source(src, name))
        lib = path.with_suffix(".so")
        proc = subprocess.run([nvcc.nvcc_path(), *nvcc.FLAGS, "-o", str(lib),
                               str(path)], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr}")
        report = [ln.strip() for ln in proc.stderr.splitlines()
                  if "Used" in ln or "spill" in ln or "C7515" in ln]
        fn = ctypes.CDLL(str(lib)).ssd_tc_fwd
        fn.argtypes = ops.load_tc_library().ssd_tc_fwd.argtypes
        fn.restype = ctypes.c_int
        return fn, report

    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(build, names)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    for name, (_, report) in built.items():
        if report:
            print(f"{name}: ptxas: " + "; ".join(report))

    def call(name, x, dt, a, bm, cm, chunk):
        fn = built[name][0]
        if fn is None:
            return ops.run_kernel("simt", x, dt, a, bm, cm, chunk)
        b, l, h, p = x.shape
        n = bm.shape[-1]
        nc, pp = -(-l // chunk), -(-p // 8) * 8
        y = torch.empty_like(x)
        state = torch.empty((b, h, n, p), dtype=torch.float32,
                            device=x.device)
        cum = torch.empty((b, nc, h, chunk), dtype=torch.float32,
                          device=x.device)
        sc = torch.empty((b, nc, h, n, p), dtype=torch.float32,
                         device=x.device)
        sin = torch.empty((b, nc, h, 2, n, pp), dtype=torch.bfloat16,
                          device=x.device)
        xs, ds, bs, cs = x.stride(), dt.stride(), bm.stride(), cm.stride()
        err = fn(x.data_ptr(), *xs[:3], dt.data_ptr(), *ds, a.data_ptr(),
                 bm.data_ptr(), *bs[:2], cm.data_ptr(), *cs[:2],
                 y.data_ptr(), state.data_ptr(), cum.data_ptr(),
                 sc.data_ptr(), sin.data_ptr(), b, l, h, p, n, chunk,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: launch failed: error {err}")
        return y, state

    def timed(name, sets, chunk, runs=5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(runs):
            start.record()
            for args in sets:
                call(name, *args, chunk)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e3 / len(sets))
        return float(np.median(times))

    for shape in SHAPES:
        b, l, h, p, n, chunk = shape
        rng = np.random.default_rng(0)

        def t(z, dtype=torch.bfloat16):
            return torch.from_numpy(np.asarray(z, np.float32)).cuda().to(
                dtype)
        sets = [(t(rng.normal(size=(b, l, h, p))),
                 t(rng.uniform(0.001, 0.1, size=(b, l, h)), torch.float32),
                 t(-rng.uniform(0.5, 2.0, size=(h,)), torch.float32),
                 t(rng.normal(size=(b, l, n))), t(rng.normal(size=(b, l, n))))
                for _ in range(4)]
        yc, sc = ssd_chunked(*sets[0], chunk)
        for name in names:
            if any(cut in name for cut in CUTS):
                continue
            y, s = call(name, *sets[0], chunk)
            torch.cuda.synchronize()
            ok = (torch.allclose(y.float(), yc.float(), rtol=2 ** -7,
                                 atol=2e-4)
                  and torch.allclose(s, sc, rtol=1e-3, atol=2e-4))
            print(f"{shape} {name}: within the bounds of the chunked scan: "
                  f"{ok}")
            if not ok:
                return 1
        from torch.profiler import ProfilerActivity, profile
        for name in names:
            if name == "simt":
                continue
            # each variant's launches, one by one, from the profiler
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for args in sets:
                    call(name, *args, chunk)
                torch.cuda.synchronize()
            times = [f"{ev.key.split('<')[0].split('::')[-1]} "
                     f"{ev.device_time_total / ev.count:.1f}"
                     for ev in prof.key_averages() if "ssd_tc" in ev.key]
            print(f"{shape} {name}: us a launch: " + ", ".join(times))
        turns = {name: [] for name in names}
        for _ in range(3):
            for name in names + names[::-1]:
                turns[name].append(timed(name, sets, chunk))
        for name, ts in turns.items():
            print(f"{shape} {name}: us " + " ".join(f"{t:.1f}" for t in ts)
                  + f" min {min(ts):.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
