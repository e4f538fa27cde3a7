#!/usr/bin/env python3
"""Time variants of the tensor-core flash-attention kernel on one card.

    python3 scripts/flash_tc_variants.py [VARIANT,...]

Each variant is ``csrc/flash_attention_tc.cu`` with one design choice
undone, or one part of the work cut out, built with the same ``nvcc`` flags
into ``kernels/_build/variants/`` and called through the same C interface.
Design choices: ``kernel`` (the source as it is), ``bk128`` (128-key tiles
and one CTA an SM at dh ≤ 64, the first design), ``stages3`` (a K/V ring of
three stages). Cuts,
whose outputs are wrong and whose times say where the time goes: ``no_pv``
(no P·V products), ``no_lo`` (P_hi·V only, no split), ``no_s`` (no Q·Kᵀ
product), ``no_loads`` (K and V loaded for the first stages only). Names
join with ``+``.

Per shape (the smollm-360m and zamba2-1.2b prefills, bf16, causal) each
variant that computes the function is held to the plain version at the
bf16 limit (rtol 2**-7 / atol 1e-4), then all are timed in turns, forward
then backward, three times: CUDA events over one launch on each of 6 input
sets (more bytes than L2 holds), the median of 5 runs; the minimum is
printed beside every turn. Compare variants only inside one run.
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

SHAPES = [(4, 1920, 1920, 15, 5, 64), (4, 1920, 1920, 32, 32, 64)]
CUTS = ("no_pv", "no_lo", "no_s", "no_loads")


def _swap(src: str, old: str, new: str) -> str:
    if old not in src:
        raise ValueError(f"variant does not apply: {old!r} not in source")
    return src.replace(old, new)


def variant_source(src: str, name: str) -> str:
    """The kernel's source with the changes ``name`` lists (``a+b``)."""
    for part in name.split("+"):
        if part == "kernel":
            continue
        elif part == "bk128":
            src = _swap(src, "CTAS = DC == 1 ? 2 : 1;", "CTAS = 1;")
            src = _swap(src, "BK = DC == 2 ? 128 : 64;",
                        "BK = DC <= 2 ? 128 : 64;")
        elif part == "stages3":
            src = _swap(src, "kStages = 2;", "kStages = 3;")
        elif part == "no_pv":
            src = _swap(src, "wgmma_rs_n64(o[c], p_hi[kk], dv);", "")
            src = _swap(src, "wgmma_rs_n64(o[c], p_lo[kk], dv);", "")
        elif part == "no_lo":
            src = _swap(src, "wgmma_rs_n64(o[c], p_lo[kk], dv);", "")
        elif part == "no_s":
            src = _swap(src, "float s[BK / 2];", "float s[BK / 2] = {};")
            src = _swap(src, """      if constexpr (BK == 128)
        wgmma_ss_n128(s, da, db, kk > 0);
      else
        wgmma_ss_n64(s, da, db, kk > 0);""", "")
        elif part == "no_loads":
            load = "        mbar_expect_tx(full_k(st), T::KV_BYTES);"
            src = _swap(src, load, """        if (kt >= kStages) {
          mbar_arrive(full_k(st));
          mbar_arrive(full_v(st));
          continue;
        }
""" + load)
        else:
            raise ValueError(f"unknown variant part {part!r}")
    return src


def main() -> int:
    import torch
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.flash_attention import ops, ref
    if not torch.cuda.is_available():
        print("flash_tc_variants: needs a CUDA card", file=sys.stderr)
        return 1
    names = (sys.argv[1] if len(sys.argv) > 1 else
             "kernel,bk128,stages3").split(",")
    out_dir = nvcc.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = ops.TC_SOURCE.read_text()

    def build(name):
        path = out_dir / f"{name.replace('+', '_')}.cu"
        path.write_text(variant_source(src, name))
        lib = path.with_suffix(".so")
        proc = subprocess.run([nvcc.nvcc_path(), *nvcc.FLAGS, "-o", str(lib),
                               str(path)], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr}")
        report = [ln.strip() for ln in proc.stderr.splitlines()
                  if "registers" in ln or "spill" in ln or "C7512" in ln]
        fn = ctypes.CDLL(str(lib)).flash_attention_tc_fwd
        fn.argtypes = ops._ARGS + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        return fn, report

    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(build, names)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    for name, (_, report) in built.items():
        print(f"{name}: ptxas (dh ≤ 256, ≤ 128, ≤ 64): " + "; ".join(report))

    def call(fn, q, k, v):
        b, s, h, dh = q.shape
        out = torch.empty_like(q)
        qs, ks, vs = q.stride(), k.stride(), v.stride()
        err = fn(q.data_ptr(), *qs[:3], k.data_ptr(), *ks[:3],
                 v.data_ptr(), *vs[:3], out.data_ptr(), b, s, k.shape[1], h,
                 k.shape[2], dh, 1, 0, 1.0 / dh ** 0.5,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: error {err}")
        return out

    def timed(fn, sets, runs=5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(runs):
            start.record()
            for q, k, v in sets:
                call(fn, q, k, v)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e3 / len(sets))
        return float(np.median(times))

    for shape in SHAPES:
        b, sq, sk, h, kv, dh = shape
        rng = np.random.default_rng(0)
        sets = [tuple(torch.from_numpy(rng.normal(size=z).astype(np.float32))
                      .cuda().bfloat16()
                      for z in ((b, sq, h, dh), (b, sk, kv, dh),
                                (b, sk, kv, dh))) for _ in range(6)]
        q, k, v = sets[0]
        want = ref.flash_attention(q, k, v).float()
        for name, (fn, _) in built.items():
            if any(cut in name for cut in CUTS):
                continue
            got = call(fn, q, k, v).float()
            over = int(((got - want).abs() > 1e-4 + 2 ** -7 * want.abs()
                        ).sum())
            print(f"{shape} {name}: {over} elements over the bf16 limit")
            if over:
                return 1
        turns = {name: [] for name in built}
        for _ in range(3):
            for name in names + names[::-1]:
                turns[name].append(timed(built[name][0], sets))
        for name, ts in turns.items():
            print(f"{shape} {name}: us " + " ".join(f"{t:.1f}" for t in ts)
                  + f" min {min(ts):.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
