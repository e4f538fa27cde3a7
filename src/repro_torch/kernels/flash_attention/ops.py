"""Wrapper of the CUDA flash-attention kernels: checks, dispatch and launch
counts.

A CPU tensor goes to the plain version
(:func:`repro_torch.kernels.flash_attention.ref.flash_attention`); a CUDA
tensor goes to one of three kernels, or the call raises. :func:`kernel_for`
chooses, before any launch:

* ``"tc"`` (``csrc/flash_attention_tc.cu``): bfloat16 q, k and v that TMA
  can describe — every batch, sequence and head stride a multiple of 16
  bytes and every base 16-byte aligned. Both products on the tensor cores
  (wgmma), loads by TMA.
* ``"tc32"`` (``csrc/flash_attention_tc32.cu``): float32 q, k and v that
  TMA can describe, head_dim ≤ 128. Both products on the tensor cores in
  split TF32 (three TF32 products each, f32 accumulators), loads by TMA;
  its tiles as :func:`tc32_tiles` states them.
* ``"simt"`` (``csrc/flash_attention.cu``): every input TMA cannot
  describe, in either type, and float32 with head_dim > 128 (the split's
  operand tiles leave no room for two K/V stages there). f32 arithmetic on
  the CUDA cores.

There is no fallback from one kernel to the other, or to the plain version:
a refused launch raises. Each kernel is built and loaded at its first launch
(:mod:`repro_torch.kernels.nvcc`), so this module imports without ``nvcc``.

The kernels are forward only (the TPU kernel has no backward either) and write
their output through ctypes, outside autograd: a CUDA input that requires grad,
with grad mode on, is refused rather than given an output that silently has
no gradient. Training takes the plain attention, as the reference does.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import nvcc, work
from repro_torch.kernels.flash_attention import ref

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_attention.cu"         # "simt": f32 on the CUDA cores
TC_SOURCE = CSRC / "flash_attention_tc.cu"   # "tc": bf16 wgmma, TMA loads
TC32_SOURCE = CSRC / "flash_attention_tc32.cu"  # "tc32": split-TF32 wgmma
SOURCES = (SOURCE, TC_SOURCE, TC32_SOURCE)
KINDS = ("simt", "tc", "tc32")
MAX_HEAD_DIM = 256  # the TPU kernel's limit, and the kernels' largest tile
TC32_MAX_HEAD_DIM = 128
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TMA_ALIGN = 16      # bytes: TMA's rule for every stride and base address

# kernel launches so far, one per call on CUDA tensors, none for the CPU
# path: LAUNCHES counts all three kernels, TC_LAUNCHES the bf16 tensor-core
# one, TC32_LAUNCHES the f32 one. A run sets them to 0 and reads them after.
LAUNCHES = 0
TC_LAUNCHES = 0
TC32_LAUNCHES = 0

_LIB: Optional[ctypes.CDLL] = None
_TC_LIB: Optional[ctypes.CDLL] = None
_TC32_LIB: Optional[ctypes.CDLL] = None

_PTR, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGS = [_PTR, _I64, _I64, _I64, _PTR, _I64, _I64, _I64,
         _PTR, _I64, _I64, _I64, _PTR, _I32, _I32, _I32, _I32, _I32, _I32,
         _I32, _I32]


def load_library() -> ctypes.CDLL:
    """Build (at the first call) and load the "simt" kernel's library."""
    global _LIB
    if _LIB is None:
        lib = nvcc.load("flash_attention", [SOURCE])
        lib.flash_attention_fwd.argtypes = _ARGS + [_I32, ctypes.c_float,
                                                    _PTR]
        lib.flash_attention_fwd.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def load_tc_library() -> ctypes.CDLL:
    """Build (at the first call) and load the "tc" kernel's library."""
    global _TC_LIB
    if _TC_LIB is None:
        lib = nvcc.load("flash_attention_tc", [TC_SOURCE])
        lib.flash_attention_tc_fwd.argtypes = _ARGS + [ctypes.c_float, _PTR]
        lib.flash_attention_tc_fwd.restype = ctypes.c_int
        _TC_LIB = lib
    return _TC_LIB


def load_tc32_library() -> ctypes.CDLL:
    """Build (at the first call) and load the "tc32" kernel's library."""
    global _TC32_LIB
    if _TC32_LIB is None:
        lib = nvcc.load("flash_attention_tc32", [TC32_SOURCE])
        lib.flash_attention_tc32_fwd.argtypes = _ARGS + [ctypes.c_float,
                                                         _PTR]
        lib.flash_attention_tc32_fwd.restype = ctypes.c_int
        _TC32_LIB = lib
    return _TC32_LIB


def kernel_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel that takes (q, k, v) on a card. Inputs whose batch,
    sequence and head strides are all multiples of 16 bytes on 16-byte
    aligned bases (what a TMA map can describe) go to ``"tc"`` in bfloat16
    and to ``"tc32"`` in float32 with head_dim ≤ 128; everything else to
    ``"simt"``. A rule of dtypes, shapes, strides and addresses only, so it
    answers for CPU tensors too."""
    for t in (q, k, v):
        size = t.element_size()
        if t.data_ptr() % TMA_ALIGN or any(
                (st * size) % TMA_ALIGN for st in t.stride()[:3]):
            return "simt"
    if q.dtype == torch.bfloat16:
        return "tc"
    return "tc32" if q.shape[-1] <= TC32_MAX_HEAD_DIM else "simt"


def tc32_tiles(dh: int) -> tuple[int, int]:
    """(width, keys) of the "tc32" kernel's tiles at head_dim ``dh``: the
    width its operand tiles pad dh to (32, 64 or 128) and the keys of one
    KV tile, 64 at width 32 and 32 otherwise (``Tile::BK`` in
    ``csrc/flash_attention_tc32.cu``, which this mirrors). A KV tile is
    never as wide as the operand tiles: that layout gave wrong results on
    the card (the kernel's header says why)."""
    width = 32 if dh <= 32 else 64 if dh <= 64 else 128
    return width, 64 if width == 32 else 32


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           prefix_len: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be (B, S, H, dh), (B, T, KV, dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    b, s, h, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} in batch or head_dim")
    if k.shape[2] == 0 or h % k.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of "
                         f"{k.shape[2]} kv heads")
    if not 0 < dh <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {dh} outside 1..{MAX_HEAD_DIM}")
    if s == 0 or k.shape[1] == 0:
        raise ValueError("empty sequence: q and k need at least one row")
    if prefix_len < 0:
        raise ValueError(f"prefix_len {prefix_len} < 0")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or all bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit last stride, got "
                             f"{t.stride()}")


def _sum_min(lo: int, hi: int, cap: int) -> int:
    """Σ min(cap, v) for v in [lo, hi]."""
    if hi < lo:
        return 0
    top = min(hi, cap)
    below = (lo + top) * (top - lo + 1) // 2 if top >= lo else 0
    return below + cap * (hi - max(lo - 1, top))


def visible_pairs(sq: int, sk: int, causal: bool, prefix: int) -> int:
    """(row, key) pairs the masks leave visible a (batch, head): row r sees
    keys below ``max(r + 1, prefix)`` causally (all ``sk`` otherwise, or the
    first ``prefix`` under a non-causal prefix), never past ``sk``."""
    if not causal:
        return sq * (min(sk, prefix) if prefix else sk)
    rows_in_prefix = min(sq, prefix)
    return (rows_in_prefix * min(sk, prefix)
            + _sum_min(prefix + 1, sq, sk))


def flash_work(b: int, sq: int, sk: int, h: int, kv: int, dh: int,
               causal: bool, prefix: int,
               dtype: torch.dtype = torch.bfloat16,
               tf32: bool = False) -> work.Work:
    """The work of one call: q, k, v read once and o written once; 4·dh
    operations for every visible (row, key) pair (the two products, Q·Kᵀ
    and P·V), in the inputs' dtype, or on the TF32 tensor cores (``tf32``:
    the ``"tc32"`` route's float32, counted once)."""
    size = dtype.itemsize
    return work.Work(
        "flash_attention",
        {"tf32" if tf32 else work.dtype_name(dtype):
         4 * dh * b * h * visible_pairs(sq, sk, causal, prefix)},
        size * dh * (2 * b * sq * h + 2 * b * sk * kv))


def _work_of(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, prefix: int) -> work.Work:
    """:func:`flash_work` of a call, on the route :func:`kernel_for` gives
    the inputs on a card."""
    b, s, h, dh = q.shape
    return flash_work(b, s, k.shape[1], h, k.shape[2], dh, causal, prefix,
                      q.dtype, tf32=kernel_for(q, k, v) == "tc32")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, prefix_len: int = 0) -> torch.Tensor:
    """q: (B, S, H, dh) · k/v: (B, T, KV, dh) → (B, S, H, dh), in q's dtype.

    The counterpart of ``repro.kernels.flash_attention.ops.flash_attention``.
    Masks as :mod:`repro_torch.kernels.flash_attention.ref` states them;
    keys at or beyond T are never attended. On CUDA tensors it launches the
    kernel that :func:`kernel_for` names: float32 or bfloat16 (all three
    alike), unit last stride, any other strides (q, k and v are read in
    place). Under a work counter the call is recorded as :func:`flash_work`
    (:mod:`repro_torch.kernels.work`).
    """
    _check(q, k, v, prefix_len)
    devices = {q.device, k.device, v.device}
    with work.call(_work_of, q, k, v, causal, prefix_len) as counted:
        if devices == {work.META}:
            work.on_meta(counted, "flash_attention")
            return torch.empty(q.shape, dtype=q.dtype, device=work.META)
        if devices == {torch.device("cpu")}:
            return ref.flash_attention(q, k, v, causal=causal,
                                       prefix_len=prefix_len)
        if len(devices) != 1 or not q.is_cuda:
            raise ValueError(f"q, k and v must lie on one CUDA device or all "
                             f"on the CPU; got {sorted(map(str, devices))}")
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            raise RuntimeError("the CUDA flash-attention kernel is forward "
                               "only: its output would have no gradient. "
                               "Train with attn_impl='torch' (the reference "
                               "trains with its plain attention), or run "
                               "under torch.no_grad()")
        return run_kernel(kernel_for(q, k, v), q, k, v, causal=causal,
                          prefix_len=prefix_len)


def run_kernel(kind: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               *, causal: bool = True, prefix_len: int = 0) -> torch.Tensor:
    """Launch kernel ``kind`` on CUDA inputs that :func:`flash_attention`
    has checked, counting the launch. :func:`flash_attention` calls it with
    :func:`kernel_for`'s choice; a caller may name ``"simt"`` for inputs a
    tensor-core kernel would take (to time two kernels on the same inputs),
    never a tensor-core kernel for inputs :func:`kernel_for` does not give
    it."""
    if kind not in KINDS:
        raise ValueError(f"no flash-attention kernel {kind!r}")
    if kind != "simt" and kernel_for(q, k, v) != kind:
        raise ValueError(f"the {kind} kernel does not take these inputs "
                         f"({q.dtype}, head_dim {q.shape[-1]}, strides "
                         f"{q.stride()}, {k.stride()}, {v.stride()})")
    b, s, h, dh = q.shape
    t, kvh = k.shape[1], k.shape[2]
    out = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    args = (q.data_ptr(), qs[0], qs[1], qs[2],
            k.data_ptr(), ks[0], ks[1], ks[2],
            v.data_ptr(), vs[0], vs[1], vs[2], out.data_ptr(),
            b, s, t, h, kvh, dh, int(causal), int(prefix_len))
    scale = 1.0 / dh ** 0.5
    if kind == "tc":
        err = load_tc_library().flash_attention_tc_fwd(*args, scale, stream)
    elif kind == "tc32":
        err = load_tc32_library().flash_attention_tc32_fwd(*args, scale,
                                                           stream)
    else:
        err = load_library().flash_attention_fwd(*args, DTYPES[q.dtype],
                                                 scale, stream)
    if err != 0:
        raise RuntimeError(f"flash-attention kernel ({kind}) launch failed: "
                           f"error {err}")
    global LAUNCHES, TC_LAUNCHES, TC32_LAUNCHES
    LAUNCHES += 1
    TC_LAUNCHES += kind == "tc"
    TC32_LAUNCHES += kind == "tc32"
    return out
