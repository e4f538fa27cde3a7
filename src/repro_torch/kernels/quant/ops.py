"""Wrapper of the CUDA int8 quant kernels (``csrc/quant.cu``): checks,
dispatch and launch count.

A CPU tensor goes to the plain version (:mod:`repro_torch.kernels.quant.ref`);
a CUDA tensor goes to the kernel, or the call raises. There is no fallback from
the kernel to the plain version. The kernels are built and loaded at their
first launch (:mod:`repro_torch.kernels.nvcc`), so this module imports without
``nvcc``.

The kernels' outputs are written through ctypes, outside autograd: a CUDA
input that requires grad, with grad mode on, is refused rather than given an
output that silently has no gradient. The sync engine calls them on detached
tensors only.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import nvcc, work
from repro_torch.kernels.quant import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "quant.cu"

# kernel launches so far: one per quantize call, quantize_given_amax call
# and dequantize call on CUDA tensors (a quantize call runs three CUDA
# kernels: amax, scale, pack), none for the CPU path. A run sets it to 0 and
# reads it after.
LAUNCHES = 0
# launches of the shard path's entry points alone: amax calls, and the
# quantize_given_amax calls (also in LAUNCHES)
AMAX_LAUNCHES = 0
GIVEN_LAUNCHES = 0

_LIB: Optional[ctypes.CDLL] = None

# rows a call takes: the kernels' grids put the rows on gridDim.y, whose
# limit this is. Sizes, strides and indices within a row are 64-bit on both
# sides of the C interface (``long long``), so a row or a leaf of 2³¹ values
# or more is indexed whole.
MAX_ROWS = 65535

_PTR, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
# the C entry points' arguments (csrc/quant.cu's extern "C" signatures)
ARGTYPES = {
    "quant_amax_blocks": [_I64, _I32],                 # n, rows
    # x, x_rs, q, q_rs, res, res_rs, scale, partial, rows, n, stream
    "quant_int8_f32": [_PTR, _I64, _PTR, _I64, _PTR, _I64, _PTR, _PTR, _I32,
                       _I64, _PTR],
    # q, q_rs, scale, out, out_rs, rows, n, stream
    "dequant_int8_f32": [_PTR, _I64, _PTR, _PTR, _I64, _I32, _I64, _PTR],
    # x, x_rs, amax, partial, rows, n, stream
    "quant_amax_f32": [_PTR, _I64, _PTR, _PTR, _I32, _I64, _PTR],
    # x, x_rs, q, q_rs, res, res_rs, amax, scale, rows, n, stream
    "quant_int8_given_amax_f32": [_PTR, _I64, _PTR, _I64, _PTR, _I64, _PTR,
                                  _PTR, _I32, _I64, _PTR],
}


def load_library() -> ctypes.CDLL:
    """Build (at the first call) and load the kernels' library."""
    global _LIB
    if _LIB is None:
        lib = nvcc.load("quant", [SOURCE])
        for name, argtypes in ARGTYPES.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _rows_of(t: torch.Tensor, rows: bool) -> Tuple[int, int, int]:
    """(R, n, row stride) of ``t`` read as R rows of n contiguous elements;
    raises where a row is not contiguous."""
    if t.numel() == 0:
        raise ValueError(f"empty tensor {tuple(t.shape)}: nothing to quantize")
    if rows:
        if t.dim() < 1:
            raise ValueError("rows=True needs a leading row dim")
        r = t.shape[0]
        if not t[0].is_contiguous():
            raise ValueError(f"each row must be contiguous; strides "
                             f"{t.stride()} for shape {tuple(t.shape)}")
        return r, t.numel() // r, t.stride(0)
    if not t.is_contiguous():
        raise ValueError(f"x must be contiguous; strides {t.stride()}")
    return 1, t.numel(), t.numel()


def _check_rows(r: int) -> None:
    if r > MAX_ROWS:
        raise ValueError(f"{r} rows: the CUDA quant kernels take at most "
                         f"{MAX_ROWS} (the grid's y dim)")


def _check_cuda(name: str, t: torch.Tensor) -> None:
    if torch.is_grad_enabled() and t.requires_grad:
        raise RuntimeError(f"{name} requires grad: the CUDA quant kernel "
                           f"writes outside autograd, so its output would "
                           f"have no gradient; pass a detached tensor or "
                           f"run under torch.no_grad()")


def _stream(t: torch.Tensor) -> int:
    with torch.cuda.device(t.device):
        return torch.cuda.current_stream().cuda_stream


def quantize_work(numel: int, residual: bool, size: int = 4) -> work.Work:
    """The work of one quantize call on ``numel`` values of ``size`` bytes:
    x read once, the int8 payload (and the f32 residual) written once; no
    products."""
    return work.Work("quantize", {},
                     numel * (size + 1 + (4 if residual else 0)))


def _quantize_work_of(x: torch.Tensor, residual: bool) -> work.Work:
    return quantize_work(x.numel(), residual, x.element_size())


def dequantize_work(numel: int) -> work.Work:
    """The work of one dequantize call: the int8 payload read once, the f32
    values written once."""
    return work.Work("dequantize", {}, 5 * numel)


def quantize(x: torch.Tensor, *, rows: bool = False, residual: bool = False
             ) -> Union[Tuple[torch.Tensor, torch.Tensor],
                        Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """x → (q int8, scale f32[, x − q·scale]).

    One scale over all of x (0-dim), or with ``rows`` one per row of the
    leading dim (``(R,)``, each row as ``repro.core.compression.quantize``
    would quantize it alone). ``residual`` also returns the quantization
    error ``x − dequantize(q, scale)`` (error feedback), written by the same
    pass on the card. On CUDA tensors: float32 only; rows contiguous, the row
    stride free (a row slice of a stacked leaf is read in place).
    """
    r, n, stride = _rows_of(x, rows)
    with work.call(_quantize_work_of, x, residual) as counted:
        return _quantize(x, rows, residual, r, n, stride, counted)


def _quantize(x, rows, residual, r, n, stride, counted):
    if x.device == work.META:
        work.on_meta(counted, "quantize")
        outs = (torch.empty(x.shape, dtype=torch.int8, device=work.META),
                torch.empty((r,) if rows else (), dtype=torch.float32,
                            device=work.META))
        return outs + ((torch.empty(x.shape, dtype=torch.float32,
                                    device=work.META),) if residual else ())
    if not x.is_cuda:
        q, scale = ref.quantize(x, rows=rows)
        if residual:
            return q, scale, x.float() - ref.dequantize(q, scale)
        return q, scale
    _check_cuda("x", x)
    _check_rows(r)
    if x.dtype != torch.float32:
        raise TypeError(f"the CUDA quant kernel takes float32; x is "
                        f"{x.dtype}")
    lib = load_library()
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty((r,), dtype=torch.float32, device=x.device)
    res = (torch.empty(x.shape, dtype=torch.float32, device=x.device)
           if residual else None)
    partial = torch.empty((r * lib.quant_amax_blocks(n, r),),
                          dtype=torch.float32, device=x.device)
    err = lib.quant_int8_f32(
        x.data_ptr(), stride, q.data_ptr(), n,
        res.data_ptr() if residual else None, n, scale.data_ptr(),
        partial.data_ptr(), r, n, _stream(x))
    if err != 0:
        raise RuntimeError(f"quant kernel launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    if not rows:
        scale = scale[0]
    return (q, scale, res) if residual else (q, scale)


def amax_work(numel: int) -> work.Work:
    """The work of one amax call: x read once; no products."""
    return work.Work("amax", {}, 4 * numel)


def amax(x: torch.Tensor, *, rows: bool = False) -> torch.Tensor:
    """max |x| in f32 (NaN kept, no floor): 0-dim, or with ``rows`` one per
    row of the leading dim (``(R,)``), a shard's part of the whole leaf's
    scale. On CUDA tensors: float32, rows contiguous (the row stride
    free)."""
    r, n, stride = _rows_of(x, rows)
    with work.call(amax_work, x.numel()) as counted:
        if x.device == work.META:
            work.on_meta(counted, "amax")
            return torch.empty((r,) if rows else (), dtype=torch.float32,
                               device=work.META)
        if not x.is_cuda:
            return ref.amax(x, rows)
        _check_cuda("x", x)
        _check_rows(r)
        if x.dtype != torch.float32:
            raise TypeError(f"the CUDA amax kernel takes float32; x is "
                            f"{x.dtype}")
        lib = load_library()
        out = torch.empty((r,), dtype=torch.float32, device=x.device)
        partial = torch.empty((r * lib.quant_amax_blocks(n, r),),
                              dtype=torch.float32, device=x.device)
        err = lib.quant_amax_f32(x.data_ptr(), stride, out.data_ptr(),
                                 partial.data_ptr(), r, n, _stream(x))
        if err != 0:
            raise RuntimeError(f"amax kernel launch failed: CUDA error {err}")
        global AMAX_LAUNCHES
        AMAX_LAUNCHES += 1
        return out if rows else out[0]


def quantize_given_amax(x: torch.Tensor, amax_: torch.Tensor, *,
                        rows: bool = False, residual: bool = False):
    """:func:`quantize` with each scale's amax given (0-dim, or ``(R,)``
    with ``rows``): the scale ``max(amax, 1e-12) / 127``, computed as the
    whole-tensor path computes it, then the pack (and the residual). A
    shard packed with its whole leaf's amax (the max over every shard's
    :func:`amax`) is its block of the whole leaf's payload, bitwise."""
    r, n, stride = _rows_of(x, rows)
    if tuple(amax_.shape) != ((r,) if rows else ()):
        raise ValueError(f"amax {tuple(amax_.shape)} must be one per row "
                         f"({r}) with rows, else 0-dim")
    with work.call(_quantize_work_of, x, residual) as counted:
        if x.device == work.META:
            return _quantize(x, rows, residual, r, n, stride, counted)
        if not x.is_cuda:
            q, scale = ref.quantize_given_amax(x, amax_)
            if residual:
                return q, scale, x.float() - ref.dequantize(q, scale)
            return q, scale
        _check_cuda("x", x)
        _check_rows(r)
        if x.dtype != torch.float32 or amax_.dtype != torch.float32 \
                or amax_.device != x.device:
            raise TypeError(f"the CUDA quant kernel takes float32 x and amax "
                            f"on one device; got {x.dtype} on {x.device}, "
                            f"{amax_.dtype} on {amax_.device}")
        lib = load_library()
        q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
        scale = torch.empty((r,), dtype=torch.float32, device=x.device)
        res = (torch.empty(x.shape, dtype=torch.float32, device=x.device)
               if residual else None)
        am = amax_.reshape(r).contiguous()
        err = lib.quant_int8_given_amax_f32(
            x.data_ptr(), stride, q.data_ptr(), n,
            res.data_ptr() if residual else None, n, am.data_ptr(),
            scale.data_ptr(), r, n, _stream(x))
        if err != 0:
            raise RuntimeError(f"quant kernel launch failed: CUDA error "
                               f"{err}")
        global LAUNCHES, GIVEN_LAUNCHES
        LAUNCHES += 1
        GIVEN_LAUNCHES += 1
        if not rows:
            scale = scale[0]
        return (q, scale, res) if residual else (q, scale)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``q · scale`` in f32: a 0-dim scale over all of q, or a ``(R,)`` scale
    row by row over q's leading dim. On CUDA tensors q is int8 with rows
    contiguous (the row stride free), and the scale float32."""
    rows = scale.dim() == 1
    if scale.dim() > 1 or (rows and (q.dim() < 1
                                     or scale.shape[0] != q.shape[0])):
        raise ValueError(f"scale {tuple(scale.shape)} must be 0-dim or one "
                         f"per row of q {tuple(q.shape)}")
    r, n, stride = _rows_of(q, rows)
    with work.call(dequantize_work, q.numel()) as counted:
        return _dequantize(q, scale, r, n, stride, counted)


def _dequantize(q, scale, r, n, stride, counted):
    devices = {q.device, scale.device}
    if devices == {work.META}:
        work.on_meta(counted, "dequantize")
        return torch.empty(q.shape, dtype=torch.float32, device=work.META)
    if devices == {torch.device("cpu")}:
        return ref.dequantize(q, scale)
    if len(devices) != 1 or not q.is_cuda:
        raise ValueError(f"q and scale must lie on one CUDA device or both on "
                         f"the CPU; got {sorted(map(str, devices))}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"the CUDA dequant kernel takes int8 q and a float32 "
                        f"scale; got {q.dtype}, {scale.dtype}")
    _check_cuda("scale", scale)
    _check_rows(r)
    lib = load_library()
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    scale = scale.reshape(r).contiguous()
    err = lib.dequant_int8_f32(q.data_ptr(), stride, scale.data_ptr(),
                               out.data_ptr(), n, r, n, _stream(q))
    if err != 0:
        raise RuntimeError(f"dequant kernel launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out
