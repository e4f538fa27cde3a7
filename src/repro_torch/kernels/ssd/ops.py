"""Wrapper of the CUDA SSD chunk-scan kernels: checks, dispatch and launch
counts.

A CPU tensor goes to the plain version (:func:`repro_torch.kernels.ssd.ref.
ssd_scan`, the exact recurrence); a CUDA tensor goes to one of two kernels,
or the call raises. :func:`kernel_for` chooses, before any launch:

* ``"tc"`` (``csrc/ssd_tc.cu``): bfloat16 x, B and C that TMA can describe —
  the batch, sequence and head strides multiples of 8 elements (16 bytes)
  and every base 16-byte aligned. Chunk states, state passing and the chunk
  scan as three launches, the products on the tensor cores (wgmma), C Bᵀ
  shared by a group of heads, loads by TMA.
* ``"simt"`` (``csrc/ssd.cu``): float32, and bfloat16 with any other
  strides. One CTA per (head, batch) walks the chunks, f32 on the CUDA
  cores.

There is no fallback from one kernel to the other, or to the plain version:
a refused launch raises. Each kernel is built and loaded at its first launch
(:mod:`repro_torch.kernels.nvcc`), so this module imports without ``nvcc``.

The kernel is forward only (the TPU kernel has no backward either) and writes
its outputs through ctypes, outside autograd: a CUDA input that requires
grad, with grad mode on, is refused rather than given outputs that silently
have no gradient. The reference trains its SSM through the plain chunked scan
(``repro.models.ssm.ssd_chunked``), and so would the port.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import nvcc, work
from repro_torch.kernels.ssd import ref

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "ssd.cu"         # "simt": f32 on the CUDA cores
TC_SOURCE = CSRC / "ssd_tc.cu"   # "tc": bf16 wgmma, TMA loads
SOURCES = (SOURCE, TC_SOURCE)
MAX_HEAD_DIM = 128    # P: the kernel's widest state tile
MAX_STATE_DIM = 128   # N
MAX_CHUNK = 256       # Q: one row of the chunk a thread
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TMA_ALIGN = 16        # bytes: TMA's rule for every stride and base address

# kernel launches so far, one per call on CUDA tensors (the "tc" kernel's
# three launches count as one call), none for the CPU path: LAUNCHES counts
# both kernels, TC_LAUNCHES the tensor-core one. A run sets them to 0 and
# reads them after.
LAUNCHES = 0
TC_LAUNCHES = 0

_LIB: Optional[ctypes.CDLL] = None
_TC_LIB: Optional[ctypes.CDLL] = None


def load_library() -> ctypes.CDLL:
    """Build (at the first call) and load the kernel's library."""
    global _LIB
    if _LIB is None:
        lib = nvcc.load("ssd", [SOURCE])
        fn = lib.ssd_scan_fwd
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [ptr, i64, i64, i64, ptr, i64, i64, i64, ptr,
                       ptr, i64, i64, ptr, i64, i64, ptr, ptr,
                       i32, i32, i32, i32, i32, i32, i32, ptr]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def load_tc_library() -> ctypes.CDLL:
    """Build (at the first call) and load the "tc" kernel's library."""
    global _TC_LIB
    if _TC_LIB is None:
        lib = nvcc.load("ssd_tc", [TC_SOURCE])
        fn = lib.ssd_tc_fwd
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [ptr, i64, i64, i64, ptr, i64, i64, i64, ptr,
                       ptr, i64, i64, ptr, i64, i64, ptr, ptr, ptr, ptr, ptr,
                       i32, i32, i32, i32, i32, i32, ptr]
        fn.restype = ctypes.c_int
        _TC_LIB = lib
    return _TC_LIB


def kernel_for(x: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor) -> str:
    """The kernel that takes (x, B, C) on a card: ``"tc"`` for bfloat16
    inputs whose batch, sequence (and for x head) strides are all multiples
    of 16 bytes on 16-byte aligned bases (what a TMA map can describe), else
    ``"simt"``. A rule of dtypes, strides and addresses only, so it answers
    for CPU tensors too."""
    if any(t.dtype != torch.bfloat16 for t in (x, bm, cm)):
        return "simt"
    for t, dims in ((x, 3), (bm, 2), (cm, 2)):
        size = t.element_size()
        if t.data_ptr() % TMA_ALIGN or any(
                (st * size) % TMA_ALIGN for st in t.stride()[:dims]):
            return "simt"
    return "tc"


def _check(x, dt, a, bm, cm, chunk: int) -> None:
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or bm.dim() != 3 \
            or cm.dim() != 3:
        raise ValueError(f"x, dt, a, bm, cm must be (B, L, H, P), (B, L, H), "
                         f"(H,), (B, L, N), (B, L, N); got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(a.shape)}, "
                         f"{tuple(bm.shape)}, {tuple(cm.shape)}")
    b, l, h, p = x.shape
    n = bm.shape[-1]
    if tuple(dt.shape) != (b, l, h) or tuple(a.shape) != (h,) \
            or tuple(bm.shape) != (b, l, n) or tuple(cm.shape) != (b, l, n):
        raise ValueError(f"shapes do not agree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, a {tuple(a.shape)}, bm "
                         f"{tuple(bm.shape)}, cm {tuple(cm.shape)}")
    if b == 0 or l == 0 or h == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")
    if not 0 < p <= MAX_HEAD_DIM or not 0 < n <= MAX_STATE_DIM:
        raise ValueError(f"head_dim {p} / state_dim {n} outside "
                         f"1..{MAX_HEAD_DIM} / 1..{MAX_STATE_DIM}")
    if not 0 < chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} outside 1..{MAX_CHUNK}")
    if x.dtype not in DTYPES or bm.dtype != x.dtype or cm.dtype != x.dtype:
        raise TypeError(f"x, bm, cm must all be float32 or all bfloat16; got "
                        f"{x.dtype}, {bm.dtype}, {cm.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"dt and a must be float32; got {dt.dtype}, "
                        f"{a.dtype}")
    for name, t in (("x", x), ("bm", bm), ("cm", cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit last stride, got "
                             f"{t.stride()}")


def ssd_work(b: int, l: int, h: int, p: int, n: int, chunk: int,
             dtype: torch.dtype = torch.bfloat16) -> work.Work:
    """The work of one call: x, B, C (in ``dtype``), Δ and A (f32) read
    once, y and the f32 state written once; the chunked algorithm's
    products in ``dtype``: per chunk of q rows the causal triangle of the
    scores (C Bᵀ, once per batch and chunk: no head in it) and of their
    product with x, the inter-chunk C·S and the state's Bᵀ·x."""
    size = dtype.itemsize
    flops = 0
    for c0 in range(0, l, chunk):
        q = min(chunk, l - c0)
        tri = q * (q + 1) // 2
        flops += b * 2 * tri * n + b * h * (2 * tri * p + 4 * q * n * p)
    return work.Work("ssd_scan", {work.dtype_name(dtype): flops},
                     size * (2 * b * l * h * p + 2 * b * l * n)
                     + 4 * (b * l * h + h + b * h * n * p))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bm: torch.Tensor, cm: torch.Tensor, *, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, L, H, P) · dt: (B, L, H) · a: (H,) · bm/cm: (B, L, N) →
    (y (B, L, H, P) in x's dtype, final state (B, H, N, P) f32), from a zero
    state.

    The counterpart of ``repro.kernels.ssd.ops.ssd_scan``. On CUDA tensors it
    launches the kernel that :func:`kernel_for` names, with chunks of
    ``chunk`` steps (L need not be a multiple: the rows past L are masked as
    Δ = 0 steps): x, bm, cm float32 or bfloat16 alike with a unit last
    stride, any other strides (read in place); dt and a float32. On CPU
    tensors it runs the plain recurrence, whatever ``chunk``. Under a work
    counter the call is recorded as :func:`ssd_work`
    (:mod:`repro_torch.kernels.work`).
    """
    _check(x, dt, a, bm, cm, chunk)
    devices = {t.device for t in (x, dt, a, bm, cm)}
    b, l, h, p = x.shape
    n = bm.shape[-1]
    with work.call(ssd_work, b, l, h, p, n, chunk, x.dtype) as counted:
        if devices == {work.META}:
            work.on_meta(counted, "ssd_scan")
            return (torch.empty(x.shape, dtype=x.dtype, device=work.META),
                    torch.empty((b, h, n, p), dtype=torch.float32,
                                device=work.META))
        if devices == {torch.device("cpu")}:
            return ref.ssd_scan(x, dt, a, bm, cm)
        if len(devices) != 1 or not x.is_cuda:
            raise ValueError(f"x, dt, a, bm and cm must lie on one CUDA "
                             f"device or all on the CPU; got "
                             f"{sorted(map(str, devices))}")
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (x, dt, a, bm, cm)):
            raise RuntimeError("the CUDA SSD kernel is forward only: its "
                               "outputs would have no gradient. Train with "
                               "ssd_impl='torch' (the reference trains "
                               "through its plain chunked scan), or run "
                               "under torch.no_grad()")
        return run_kernel(kernel_for(x, bm, cm), x, dt, a, bm, cm, chunk)


def run_kernel(kind: str, x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
               bm: torch.Tensor, cm: torch.Tensor, chunk: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel ``kind`` (``"tc"`` or ``"simt"``) on CUDA inputs that
    :func:`ssd_scan` has checked, counting the launch. :func:`ssd_scan`
    calls it with :func:`kernel_for`'s choice; a caller may name
    ``"simt"`` for inputs that ``"tc"`` would take (to time the two kernels
    on the same inputs), never ``"tc"`` for inputs it refuses."""
    b, l, h, p = x.shape
    n = bm.shape[-1]
    a = a.contiguous()
    y = torch.empty((b, l, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, n, p), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
    xs, ds, bs, cs = x.stride(), dt.stride(), bm.stride(), cm.stride()
    args = (x.data_ptr(), xs[0], xs[1], xs[2], dt.data_ptr(), ds[0], ds[1],
            ds[2], a.data_ptr(), bm.data_ptr(), bs[0], bs[1], cm.data_ptr(),
            cs[0], cs[1], y.data_ptr(), state.data_ptr())
    if kind == "tc":
        if kernel_for(x, bm, cm) != "tc":
            raise ValueError("the tensor-core SSD kernel takes bfloat16 "
                             "inputs with 16-byte strides and bases only")
        # scratch: cum, the chunk states, S_in as bf16 hi and lo planes
        nc = -(-l // chunk)
        pp = -(-p // 8) * 8
        f32 = dict(dtype=torch.float32, device=x.device)
        cum = torch.empty((b, nc, h, chunk), **f32)
        sc = torch.empty((b, nc, h, n, p), **f32)
        sin = torch.empty((b, nc, h, 2, n, pp), dtype=torch.bfloat16,
                          device=x.device)
        err = load_tc_library().ssd_tc_fwd(
            *args, cum.data_ptr(), sc.data_ptr(), sin.data_ptr(),
            b, l, h, p, n, chunk, stream)
    elif kind == "simt":
        err = load_library().ssd_scan_fwd(*args, b, l, h, p, n, chunk,
                                          DTYPES[x.dtype], stream)
    else:
        raise ValueError(f"unknown SSD kernel {kind!r} (tc | simt)")
    if err != 0:
        raise RuntimeError(f"SSD kernel ({kind}) launch failed: error {err}")
    global LAUNCHES, TC_LAUNCHES
    LAUNCHES += 1
    TC_LAUNCHES += kind == "tc"
    return y, state
