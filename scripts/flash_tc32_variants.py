#!/usr/bin/env python3
"""Probe the TF32 tensor cores, then time variants of the split-TF32 flash
kernel on one card.

    python3 scripts/flash_tc32_variants.py [VARIANT,...] [--check-only]
        [--time-checks] [--diagnose] [--sass VARIANT,...]

First a probe: one wgmma (m64n8k8, TF32) multiplies operands that hold one
value x by ones, with x in the A fragment (registers) and then in B (shared
memory), for values whose low 13 mantissa bits truncate, round to nearest
with ties away, or round to nearest even to different TF32 values. It
prints what the hardware read, which is what the header of
``csrc/flash_attention_tc32.cu`` states (it truncates).

Then each variant is ``csrc/flash_attention_tc32.cu`` with one design
choice undone, or one part of the work cut out, built with the same
``nvcc`` flags into ``kernels/_build/variants/`` and called through the same
C interface. Design choices: ``kernel`` (the source as it is), ``nwg2``
(two consumer warpgroups, not three, for a GQA group of 3), ``bk64``
(64-key tiles everywhere, as wide as D at dh 64, in a ring of two
stages), ``pvhalf`` (P·V as two wgmmas of D/2 columns), ``serial`` (a wait
after every wgmma), ``serial_s`` and ``serial_pv`` (the same in one of the
two products), ``unpinned`` (the A fragments, Q_lo and P_hi/P_lo, not
pinned to the wgmma fences: the compiler may then write them between a
fence and the wgmma that reads them), ``zeros`` (S's accumulators zeroed
before its first wgmma), ``nobreak`` (S's k-steps always run to D: right
where dh fills its 32-column chunks), ``stages2`` (a ring of two prepared
stages, not four, at dh ≤ 64), ``raw1`` (one raw V buffer, not two),
``no_setmaxnreg`` (no register hand-over between the warpgroups). Cuts,
whose outputs are wrong and whose times say where the time goes:
``no_lo`` (one TF32 product for each of Q·Kᵀ and P·V, no split),
``prep_only`` (the consumers compute nothing: the TMA loads and the prep
warps' K_lo, Vᵀ transpose and split), ``loads_only`` (the loads alone;
``prep_only`` less ``loads_only`` is the prep pass). Names join with
``+``.

Every variant that computes the function is held to the plain version at
the f32 limit (rtol 1e-4 / atol 2e-5) at the f32 check shapes of
``chip_smoke.py`` and the three full-width f32 prefills; then, at the
full-width shapes (at every shape with ``--time-checks``), all are timed in
turns, forward then backward, three times: a CUDA graph of one launch on
each input set (2 at full width, more bytes than L2 holds; 16 at a check
shape) replayed, the median of 5 replays; the minimum is printed beside
every turn. Compare variants only inside one run. ``--check-only`` stops after
the checks.

``--diagnose`` emulates, for a variant that misses the limit at a check
shape, the kernel's arithmetic with each one term of the split products
left out, and prints how far each lies from what the card gave.

``--sass`` disassembles the named variants (``cuobjdump -sass``) into
``kernels/_build/variants/<name>.sass`` and prints, for each, every
instruction that touches a wgmma's registers while it is in flight (a
write to its A fragment or its accumulators, or a read of its
accumulators, between the wgmma, ``HGMMA``, and the wait that retires it,
``WARPGROUP.DEPBAR.LE gsb0, 0x0``) and every A fragment that a loop reads
on each trip but overwrites later in the trip without a reload
(:func:`loop_clobbers`: what broke ``bk64``).
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

# (b, sq, sk, h, kv, dh, causal, prefix): chip_smoke.py's f32 check shapes,
# then zamba2-1.2b's, smollm-360m's and llama32-3b's f32 prefills
CHECKS = [(1, 128, 128, 4, 2, 64, True, 0), (2, 256, 256, 8, 8, 128, True, 0),
          (1, 200, 200, 6, 2, 64, True, 0), (1, 128, 128, 4, 1, 64, True, 32),
          (2, 64, 300, 4, 4, 64, False, 0), (1, 512, 512, 2, 2, 32, True, 0),
          (1, 64, 256, 4, 2, 64, False, 50), (1, 100, 70, 6, 2, 40, True, 0)]
FULL = [(4, 1920, 1920, 32, 32, 64, True, 0),
        (4, 1920, 1920, 15, 5, 64, True, 0),
        (4, 1920, 1920, 24, 8, 128, True, 0)]
CUTS = ("no_lo", "prep_only", "loads_only")

PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

// one m64n8k8 TF32 product of A (every element `a`) by B (every element
// `b`): each accumulator is 8 · tf32(a) · tf32(b), exactly
__global__ void tf32_probe(const float* x, float* out) {
  __shared__ __align__(1024) float buf[2][256];
  const float val = x[blockIdx.x];
  for (int i = threadIdx.x; i < 256; i += 128) {
    buf[0][i] = 1.0f;
    buf[1][i] = val;
  }
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint32_t one = __float_as_uint(1.0f), xv = __float_as_uint(val);
  float d[2][4] = {};
  for (int k = 0; k < 2; ++k) {
    const uint32_t a = k == 0 ? xv : one;
    const uint32_t addr = static_cast<uint32_t>(
        __cvta_generic_to_shared(k == 0 ? buf[0] : buf[1]));
    // no swizzle: 8 × 16-byte core matrices, 128 bytes apart along k
    const uint64_t desc = static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
                          (static_cast<uint64_t>(128 >> 4) << 16) |
                          (static_cast<uint64_t>(256 >> 4) << 32);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[k][0]), "+f"(d[k][1]), "+f"(d[k][2]), "+f"(d[k][3])
        : "r"(a), "r"(a), "r"(a), "r"(a), "l"(desc), "r"(0));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    for (int e = 0; e < 4; ++e)
      asm volatile("" : "+f"(d[k][e]) :: "memory");
  }
  for (int k = 0; k < 2; ++k)
    for (int e = 0; e < 4; ++e)
      out[(blockIdx.x * 2 + k) * 512 + threadIdx.x * 4 + e] = d[k][e] / 8.0f;
}

extern "C" int run_tf32_probe(const float* x, float* out, int n,
                              void* stream) {
  tf32_probe<<<n, 128, 0, static_cast<cudaStream_t>(stream)>>>(x, out);
  return static_cast<int>(cudaGetLastError());
}
"""

# f32 bit patterns, and what each rounding gives: truncation, round to
# nearest ties away (cvt.rna), round to nearest even
PROBE_VALUES = [
    (0x3F801FFF, 0x3F800000, 0x3F802000, 0x3F802000),  # just below a tie
    (0x3F801000, 0x3F800000, 0x3F802000, 0x3F800000),  # tie, even hi
    (0x3F803000, 0x3F802000, 0x3F804000, 0x3F804000),  # tie, odd hi
    (0xBF801FFF, 0xBF800000, 0xBF802000, 0xBF802000),  # negative
]


def _swap(src: str, old: str, new: str) -> str:
    if old not in src:
        raise ValueError(f"variant does not apply: {old!r} not in source")
    return src.replace(old, new)


def variant_source(src: str, name: str) -> str:
    """The kernel's source with the changes ``name`` lists (``a+b``)."""
    for part in name.split("+"):
        if part == "kernel":
            continue
        elif part == "bk64":
            # two prepared stages: four of 64 keys overflow shared memory
            src = _swap(src, "BK = D == 32 ? 64 : 32;",
                        "BK = D == 128 ? 32 : 64;")
            src = _swap(src, "STAGES = D == 128 ? 2 : 4;", "STAGES = 2;")
        elif part == "stages2":
            src = _swap(src, "STAGES = D == 128 ? 2 : 4;", "STAGES = 2;")
        elif part == "raw1":
            src = _swap(src, "RAW = 2;", "RAW = 1;")
        elif part == "pvhalf":
            src = _swap(src, """      mma_rs<D>(o, p_hi[j], desc(vt_hi + off));
      mma_rs<D>(o, p_hi[j], desc(vt_lo + off));
      mma_rs<D>(o, p_lo[j], desc(vt_hi + off));""", """      if constexpr (D >= 64) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float (&oh)[D / 4] =
              *reinterpret_cast<float (*)[D / 4]>(&o[hf * (D / 4)]);
          const uint32_t ho = off + hf * (D / 2) * kRow;
          mma_rs<D / 2>(oh, p_hi[j], desc(vt_hi + ho));
          mma_rs<D / 2>(oh, p_hi[j], desc(vt_lo + ho));
          mma_rs<D / 2>(oh, p_lo[j], desc(vt_hi + ho));
        }
      } else {
        mma_rs<D>(o, p_hi[j], desc(vt_hi + off));
        mma_rs<D>(o, p_hi[j], desc(vt_lo + off));
        mma_rs<D>(o, p_lo[j], desc(vt_hi + off));
      }""")
        elif part in ("serial", "serial_s", "serial_pv"):
            calls = ("mma_ss<BK>(s, dq, dk, kk > 0);",
                     "mma_ss<BK>(s, dq, dkl, 1);",
                     "mma_rs<BK>(s, q_lo[kk], dk);",
                     "mma_rs<D>(o, p_hi[j], desc(vt_hi + off));",
                     "mma_rs<D>(o, p_hi[j], desc(vt_lo + off));",
                     "mma_rs<D>(o, p_lo[j], desc(vt_hi + off));")
            if part != "serial":
                calls = calls[:3] if part == "serial_s" else calls[3:]
            for call in calls:
                src = _swap(src, call, call + " wg_commit(); wg_wait_all();")
        elif part == "unpinned":
            src = _swap(src, PIN_Q_BEFORE, "    wg_fence();\n")
            src = _swap(src, PIN_Q_AFTER, "    pin(s);\n")
            src = _swap(src, PIN_P_BEFORE, "    pin(o);\n    wg_fence();\n")
        elif part == "zeros":
            src = _swap(src, "    float s[BK / 2];\n",
                        "    float s[BK / 2];\n#pragma unroll\n"
                        "    for (int i = 0; i < BK / 2; ++i) s[i] = 0.0f;\n"
                        "    pin(s);\n")
        elif part in ("serial_s1", "serial_s2", "serial_s3"):
            call = ("mma_ss<BK>(s, dq, dk, kk > 0);",
                    "mma_ss<BK>(s, dq, dkl, 1);",
                    "mma_rs<BK>(s, q_lo[kk], dk);")[int(part[-1]) - 1]
            src = _swap(src, call, call + " wg_commit(); wg_wait_all();")
        elif part == "rs_first":
            src = _swap(src, """      mma_ss<BK>(s, dq, dk, kk > 0);
      mma_ss<BK>(s, dq, dkl, 1);
      mma_rs<BK>(s, q_lo[kk], dk);""", """      if (kk == 0) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) s[i] = 0.0f;
        pin(s);
        wg_fence();
      }
      mma_rs<BK>(s, q_lo[kk], dk);
      mma_ss<BK>(s, dq, dk, 1);
      mma_ss<BK>(s, dq, dkl, 1);""")
        elif part == "consumer_fence":
            src = _swap(src, "    mbar_wait(prepared(st), (kt / kStages) & 1);\n",
                        "    mbar_wait(prepared(st), (kt / kStages) & 1);\n"
                        "    fence_async_smem();\n")
        elif part == "nobreak":
            src = _swap(src, "      if (kk >= n_k8) break;\n", "")
        elif part == "no_setmaxnreg":
            src = _swap(src, """    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\\n"
                 :: "n"(T::PREP_REGS));""", "")
            src = _swap(src, '  asm volatile("setmaxnreg.inc.sync.aligned.u32 '
                        '%0;\\n" :: "n"(T::MMA_REGS));', "")
        elif part == "nwg2":
            src = _swap(src, "const bool three = (h / kvh) % 3 == 0;",
                        "const bool three = false;")
        elif part == "no_lo":
            src = _swap(src, "      mma_ss<BK>(s, dq, dkl, 1);\n", "")
            src = _swap(src, "      mma_rs<BK>(s, q_lo[kk], dk);\n", "")
            src = _swap(src, "      mma_rs<D>(o, p_hi[j], "
                        "desc(vt_lo + off));\n", "")
            src = _swap(src, "      mma_rs<D>(o, p_lo[j], "
                        "desc(vt_hi + off));\n", "")
        elif part in ("prep_only", "loads_only"):
            src = _swap(src, "    if (kt >= n_wg) {", "    if (true) {")
            if part == "loads_only":
                src = _swap(src, "i < n_dq * (BK / 8); i += kPrep",
                            "i < 0; i += kPrep")
                src = _swap(src, "i < n_ch * BK * kRow / 16; i += kPrep",
                            "i < 0; i += kPrep")
        else:
            raise ValueError(f"unknown variant part {part!r}")
    return src


# the pins of the A fragments to the wgmma fences, as the kernel has them
PIN_Q_BEFORE = "    pin(q_lo);\n    wg_fence();\n"
PIN_Q_AFTER = "    pin(s);\n    pin(q_lo);\n"
PIN_P_BEFORE = "    pin(o);\n    pin(p_hi);\n    pin(p_lo);\n    wg_fence();\n"

_SASS_LINE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
_REG = re.compile(r"\bR(\d+)\b")
# opcodes whose first operand is not a register they write
_NO_DEST = ("ST", "RED", "BRA", "BSSY", "BSYNC", "BAR", "SYNCS", "UTMA",
            "WARPSYNC", "EXIT", "RET", "CALL", "NOP", "DEPBAR", "WARPGROUP",
            "MEMBAR", "FENCE", "ERRBAR", "CCTL", "YIELD", "NANOSLEEP", "@")


def _width(op: str) -> int:
    return 4 if ".128" in op else 2 if (".64" in op or ".WIDE" in op) else 1


def wgmma_hazards(sass: str):
    """(function, wgmma line, offending line, what) for every instruction
    that touches an in-flight wgmma's registers, in program order (a
    linear scan: a branch inside a pipeline stage is scanned straight
    through), and the count of wgmmas seen."""
    found, n_mma = [], 0
    func, flight = "?", []   # flight: (line, A regs, accumulator regs)
    for raw in sass.splitlines():
        if "Function :" in raw:
            func, flight = raw.split("Function :")[1].strip(), []
            continue
        m = _SASS_LINE.search(raw)
        if not m:
            continue
        text = re.sub(r"^@!?U?P\w+\s+", "", m.group(1))
        op, _, rest = text.partition(" ")
        args = [a.strip() for a in rest.split(",")]
        if op.startswith("HGMMA"):
            n_mma += 1
            n = int(op.split(".")[1].split("x")[1])
            d = _REG.match(args[0])   # RZ: a wgmma that writes nothing
            acc = set(range(int(d.group(1)), int(d.group(1)) + n // 2)) \
                if d else set()
            a_regs = set()
            if _REG.match(args[1]):
                a0 = int(_REG.match(args[1]).group(1))
                a_regs = set(range(a0, a0 + 4))
            flight.append((text, a_regs, acc))
            continue
        if op.startswith("WARPGROUP.DEPBAR") and args[-1] == "0x0":
            flight = []
            continue
        if not flight:
            continue
        writes = set()
        if args and _REG.fullmatch(args[0]) and not op.startswith(_NO_DEST):
            r0 = int(_REG.fullmatch(args[0]).group(1))
            writes = set(range(r0, r0 + _width(op)))
        reads = {int(x) for a in (args if not writes else args[1:])
                 for x in _REG.findall(a)}
        for line, a_regs, acc in flight:
            if writes & a_regs:
                found.append((func, line, text, "writes an A fragment"))
            if writes & acc:
                found.append((func, line, text, "writes an accumulator"))
            if reads & acc:
                found.append((func, line, text, "reads an accumulator"))
    return found, n_mma


def _instructions(sass: str):
    """{function: [(address, opcode, operands)]} of a ``cuobjdump -sass``
    listing, predicates dropped."""
    funcs, func = {}, None
    for raw in sass.splitlines():
        if "Function :" in raw:
            func = raw.split("Function :")[1].strip()
            funcs[func] = []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", raw)
        if not m or func is None:
            continue
        text = re.sub(r"^@!?U?P\w+\s+", "", m.group(2))
        op, _, rest = text.partition(" ")
        funcs[func].append((int(m.group(1), 16), op,
                            [a.strip() for a in rest.split(",")]))
    return funcs


def _writes(op, args):
    if args and _REG.fullmatch(args[0]) and not op.startswith(_NO_DEST):
        r0 = int(_REG.fullmatch(args[0]).group(1))
        return set(range(r0, r0 + _width(op)))
    return set()


def loop_clobbers(sass: str):
    """(function, wgmma address, A registers, address of the write) for
    every wgmma inside a loop whose A fragment (registers) is read in each
    trip, written nowhere in the loop before that read and written after
    it by anything but a reload from local memory (a spilled value put
    back): the next trip reads what the later write left there, not the
    fragment the program holds. A linear scan of each loop's address range
    (a backward branch's target to the branch)."""
    found = []
    for func, insts in _instructions(sass).items():
        loops = [(int(args[0], 16), addr) for addr, op, args in insts
                 if op.startswith("BRA") and args and
                 re.fullmatch(r"0x[0-9a-f]+", args[0]) and
                 int(args[0], 16) < addr]
        for lo, hi in loops:
            body = [i for i in insts if lo <= i[0] <= hi]
            for addr, op, args in body:
                if not op.startswith("HGMMA") or len(args) < 2 or \
                        not _REG.fullmatch(args[1]):
                    continue
                a0 = int(_REG.fullmatch(args[1]).group(1))
                a_regs = set(range(a0, a0 + 4))
                before = any(_writes(o, g) & a_regs
                             for x, o, g in body if x < addr)
                after = [(x, o) for x, o, g in body
                         if x > addr and _writes(o, g) & a_regs]
                if after and not before and not after[-1][1].startswith(
                        "LDL"):
                    found.append((func, addr, f"R{a0}", after[0][0]))
    return found


def _nvcc(path, lib):
    from repro_torch.kernels import nvcc
    proc = subprocess.run([nvcc.nvcc_path(), *nvcc.FLAGS, "-o", str(lib),
                           str(path)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{path.name}: nvcc failed\n{proc.stderr}")
    return [ln.strip() for ln in proc.stderr.splitlines()
            if "registers" in ln or "spill" in ln or "C7512" in ln]


def probe(torch, out_dir) -> str:
    """What the tensor cores read of an f32 operand: "truncates",
    "rounds to nearest, ties away", "rounds to nearest even" or "other"."""
    path = out_dir / "tf32_probe.cu"
    path.write_text(PROBE)
    lib = path.with_suffix(".so")
    _nvcc(path, lib)
    fn = ctypes.CDLL(str(lib)).run_tf32_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bits = np.array([v[0] for v in PROBE_VALUES], np.uint32)
    x = torch.from_numpy(bits.view(np.float32)).cuda()
    out = torch.empty(len(bits) * 2 * 512, device="cuda")
    err = fn(x.data_ptr(), out.data_ptr(), len(bits),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"probe launch failed: error {err}")
    got = out.view(len(bits), 2, 512).cpu().numpy()
    modes_seen = []
    for (x_bits, trunc, rna, rne), read in zip(PROBE_VALUES, got):
        for where, vals in zip(("A in registers", "B in shared memory"),
                               read):
            if not (vals == vals[0]).all():
                raise RuntimeError(f"probe: accumulators differ: {vals}")
            r = int(np.float32(vals[0]).view(np.uint32))
            modes = {m for m, want in (("truncates", trunc),
                                       ("rounds to nearest, ties away", rna),
                                       ("rounds to nearest even", rne))
                     if r == want}
            print(f"probe: x = {x_bits:#010x} as {where}: read {r:#010x} "
                  f"({', '.join(sorted(modes)) or 'none of the three'})")
            modes_seen.append(modes)
    common = set.intersection(*modes_seen)
    return common.pop() if len(common) == 1 else "other"


def main() -> int:
    import torch
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.flash_attention import ops, ref
    if not torch.cuda.is_available():
        print("flash_tc32_variants: needs a CUDA card", file=sys.stderr)
        return 1
    argv = sys.argv[1:]
    sass_names = []
    if "--sass" in argv:
        at = argv.index("--sass")
        sass_names = argv[at + 1].split(",")
        del argv[at:at + 2]
    args = [a for a in argv if not a.startswith("--")]
    check_only = "--check-only" in argv
    names = (args[0] if args else "kernel,nwg2,no_lo,prep_only,loads_only"
             ).split(",")
    names += [n for n in sass_names if n not in names]
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = nvcc.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    verdict = probe(torch, out_dir)
    print(f"probe: the TF32 tensor cores {verdict}")
    src = ops.TC32_SOURCE.read_text()

    def build(name):
        path = out_dir / f"tc32_{name.replace('+', '_')}.cu"
        path.write_text(variant_source(src, name))
        lib = path.with_suffix(".so")
        report = _nvcc(path, lib)
        fn = ctypes.CDLL(str(lib)).flash_attention_tc32_fwd
        fn.argtypes = ops._ARGS + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        return fn, report

    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(build, names)))
    for name, (_, report) in built.items():
        print(f"{name}: ptxas: " + "; ".join(report))
    for name in sass_names:
        lib = out_dir / f"tc32_{name.replace('+', '_')}.so"
        sass = subprocess.run(
            [str(Path(nvcc.nvcc_path()).parent / "cuobjdump"), "-sass",
             str(lib)], capture_output=True, text=True, check=True).stdout
        lib.with_suffix(".sass").write_text(sass)
        found, n_mma = wgmma_hazards(sass)
        clobbers = loop_clobbers(sass)
        print(f"{name}: sass: {n_mma} wgmmas, {len(found)} in-flight "
              f"register accesses, {len(clobbers)} A fragments clobbered "
              f"across a loop's trips")
        for func, line, text, what in found[:40]:
            print(f"  {func[-40:]}: {text!r} {what} of {line!r}")
        for func, addr, reg, at in clobbers[:40]:
            print(f"  {func[-40:]}: the wgmma at {addr:#x} reads {reg}.., "
                  f"written at {at:#x} later in the loop and not before")

    def call(fn, q, k, v, causal, prefix):
        b, s, h, dh = q.shape
        out = torch.empty_like(q)
        qs, ks, vs = q.stride(), k.stride(), v.stride()
        err = fn(q.data_ptr(), *qs[:3], k.data_ptr(), *ks[:3],
                 v.data_ptr(), *vs[:3], out.data_ptr(), b, s, k.shape[1], h,
                 k.shape[2], dh, int(causal), prefix, 1.0 / dh ** 0.5,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: error {err}")
        return out

    def timed(fn, sets, causal, prefix, runs=5):
        """Device time of one call: a CUDA graph of one call per input set,
        replayed; the median of ``runs`` replays over its calls."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for q, k, v in sets:
                call(fn, q, k, v, causal, prefix)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for q, k, v in sets:
                call(fn, q, k, v, causal, prefix)
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(runs):
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e3 / len(sets))
        return float(np.median(times))

    failed = 0
    for i, shape in enumerate(CHECKS + FULL):
        b, sq, sk, h, kv, dh, causal, prefix = shape
        rng = np.random.default_rng(i)
        copies = 2 if shape in FULL else 16
        sets = [tuple(torch.from_numpy(rng.normal(size=z).astype(np.float32))
                      .cuda() for z in ((b, sq, h, dh), (b, sk, kv, dh),
                                        (b, sk, kv, dh)))
                for _ in range(copies)]
        q, k, v = sets[0]
        want = ref.flash_attention(q, k, v, causal=causal, prefix_len=prefix)
        for name, (fn, _) in built.items():
            if any(cut in name for cut in CUTS):
                continue
            got = call(fn, q, k, v, causal, prefix)
            again = call(fn, q, k, v, causal, prefix)
            torch.cuda.synchronize()
            over = int(((got - want).abs() > 2e-5 + 1e-4 * want.abs()).sum())
            err = float((got - want).abs().max())
            print(f"{shape} {name}: max abs err {err:.3e}, {over} of "
                  f"{want.numel()} elements over the f32 limit, "
                  f"bitwise repeatable {torch.equal(got, again)}")
            if over:
                print(f"  where: {failure_pattern(torch, got, want)}")
                if "--diagnose" in argv and shape not in FULL:
                    bk = ops.tc32_tiles(dh)[1] if "bk64" not in name \
                        else (32 if dh > 64 else 64)
                    for drop, tiles, dist in diagnose(torch, ref, got, q, k,
                                                      v, causal, prefix, bk):
                        print(f"  emulated without {drop} on tiles "
                              f"{tiles}: max abs distance {dist:.3e}")
            failed += over > 0 or not torch.equal(got, again)
        if (shape not in FULL and "--time-checks" not in sys.argv) or \
                check_only:
            continue
        turns = {name: [] for name in built}
        for _ in range(3):
            for name in names + names[::-1]:
                turns[name].append(timed(built[name][0], sets, causal,
                                         prefix))
        for name, ts in turns.items():
            print(f"{shape} {name}: us " + " ".join(f"{t:.1f}" for t in ts)
                  + f" min {min(ts):.1f}")
    print(f"probe: the TF32 tensor cores {verdict}")
    return 1 if failed else 0


# the terms of the two split products, each of which a fault may drop
TERMS = ("Q_hi·K_lo", "Q_lo·K_hi", "P_hi·V_lo", "P_lo·V_hi")


def diagnose(torch, ref, got, q, k, v, causal, prefix, bk):
    """The kernel's arithmetic emulated (f32, TF32 operands truncated, KV
    tiles of ``bk`` keys) with each one of the split products' terms left
    out, on every tile or on all tiles but the first; yields (term, tiles,
    max abs distance from ``got``). The hypothesis that matches ``got``
    lies orders of magnitude closer than the others."""
    def tf32(x):
        return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)

    def product(a, b, skip):
        a_hi, b_hi = tf32(a), tf32(b)
        a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
        terms = {"hi": a_hi @ b_hi, 0: a_hi @ b_lo, 1: a_lo @ b_hi}
        return sum(t for key, t in terms.items() if key != skip)

    b, s, h, dh = q.shape
    t, group = k.shape[1], h // k.shape[2]
    qf = q.transpose(1, 2)
    kf = k.transpose(1, 2).repeat_interleave(group, 1)
    vf = v.transpose(1, 2).repeat_interleave(group, 1)
    vis = ref.visible(s, t, causal, prefix).to(q.device)
    for drop in (None,) + TERMS:
        for first in (True, False):
            if drop is None and not first:
                continue
            m = torch.full((b, h, s, 1), ref.NEG_INF, device=q.device)
            l = torch.zeros(b, h, s, 1, device=q.device)
            o = torch.zeros(b, h, s, dh, device=q.device)
            for i, k0 in enumerate(range(0, t, bk)):
                skip = None if drop is None or (i == 0 and not first) \
                    else TERMS.index(drop)
                sc = product(qf, kf[:, :, k0:k0 + bk].transpose(-1, -2),
                             skip if skip in (0, 1) else None)
                sc = torch.where(vis[:, k0:k0 + bk],
                                 sc * (1.4426950408889634 / dh ** 0.5),
                                 torch.tensor(ref.NEG_INF, device=q.device))
                m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
                corr = torch.exp2(m - m_new)
                m = m_new
                p = torch.exp2(sc - m)
                l = l * corr + p.sum(-1, keepdim=True)
                o = o * corr + product(p, vf[:, :, k0:k0 + bk],
                                       skip - 2 if skip in (2, 3) else None)
            emu = (o / l.clamp_min(1e-30)).transpose(1, 2)
            yield (drop or "nothing", "all" if first else "after the first",
                   float((emu - got).abs().max()))


def failure_pattern(torch, got, want):
    """The share of elements over the f32 limit by row block of 64, by row
    within the 16 of a warp, by head and by output column (chunk of 32 and
    position in 8)."""
    bad = ((got - want).abs() > 2e-5 + 1e-4 * want.abs()).float()
    b, s, h, dh = bad.shape
    rows = torch.arange(s, device=bad.device)
    by = {}
    per_row = bad.mean(dim=(0, 2, 3))
    by["row//64"] = [round(float(per_row[rows // 64 == i].mean()), 3)
                     for i in range((s + 63) // 64)][:8]
    by["row%16"] = [round(float(per_row[rows % 16 == i].mean()), 3)
                    for i in range(16)]
    by["head"] = [round(float(x), 3) for x in bad.mean(dim=(0, 1, 3))][:8]
    cols = bad.mean(dim=(0, 1, 2))
    c = torch.arange(dh, device=bad.device)
    by["col//32"] = [round(float(cols[c // 32 == i].mean()), 3)
                     for i in range((dh + 31) // 32)]
    by["col%8"] = [round(float(cols[c % 8 == i].mean()), 3)
                   for i in range(min(8, dh))]
    return by


if __name__ == "__main__":
    sys.exit(main())
