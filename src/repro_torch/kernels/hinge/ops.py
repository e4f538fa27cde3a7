"""Wrapper of the CUDA hinge kernel (``csrc/hinge.cu``): checks, dispatch and
launch count.

A CPU tensor goes to the plain version (:mod:`repro_torch.kernels.hinge.ref`);
a CUDA tensor goes to the kernel, or the call raises. There is no fallback from
the kernel to the plain version. The kernel is built and loaded at its first
launch (:mod:`repro_torch.kernels.nvcc`), so this module imports without
``nvcc``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.hinge import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "hinge.cu"
# rows of X one CTA of the first stage takes (one warp a row): 8 rows make
# 256 CTAs at the main path's K=32, n=64, enough to fill the card's 132 SMs
ROWS_PER_TILE = 8

# kernel launches so far: one per call on CUDA tensors (a call runs both
# stages), none for the CPU path. A run sets it to 0 and reads it after.
LAUNCHES = 0

_LIB: Optional[ctypes.CDLL] = None


def load_library() -> ctypes.CDLL:
    """Build (at the first call) and load the kernel's library."""
    global _LIB
    if _LIB is None:
        lib = nvcc.load("hinge", [SOURCE])
        fn = lib.hinge_block_grad_f32
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn.argtypes = [ptr, i64, ptr, i64, ptr, i64, ptr, ptr,
                       i32, i32, i32, i32, ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check_shapes(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> None:
    if x.dim() not in (2, 3):
        raise ValueError(f"x must be (n, d) or (K, n, d), got {tuple(x.shape)}")
    if tuple(y.shape) != tuple(x.shape[:-1]):
        raise ValueError(f"y {tuple(y.shape)} does not match x "
                         f"{tuple(x.shape)}")
    d = x.shape[-1]
    shapes = [(d,)] + ([(x.shape[0], d)] if x.dim() == 3 else [])
    if tuple(w.shape) not in shapes:
        raise ValueError(f"w {tuple(w.shape)} must be one of {shapes} for x "
                         f"{tuple(x.shape)}")
    if x.shape[-2] == 0:
        raise ValueError("empty block: x has no rows")


def hinge_block_grad(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                     c: float = 1.0) -> torch.Tensor:
    """Drop-in for :func:`repro_torch.kernels.hinge.ref.hinge_block_grad`.

    On CUDA tensors it launches the kernel: float32 only; rows of x
    contiguous (unit column stride, row stride d); y and w with unit last
    stride. The worker strides are free, so a worker-major view such as
    ``xb[:, i]`` of ``(K, nb, bs, d)`` data needs no copy, nor does a
    ``w[:, :d]`` slice of a wider carry.
    """
    _check_shapes(w, x, y)
    devices = {w.device, x.device, y.device}
    if devices == {torch.device("cpu")}:
        return ref.hinge_block_grad(w, x, y, c)
    if len(devices) != 1 or not x.is_cuda:
        raise ValueError(f"w, x and y must lie on one CUDA device or all on "
                         f"the CPU; got {sorted(map(str, devices))}")
    for name, t in (("w", w), ("x", x), ("y", y)):
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA hinge kernel takes float32; {name} is "
                            f"{t.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a unit last stride, got "
                             f"{t.stride()}")
    batched = x.dim() == 3
    k = x.shape[0] if batched else 1
    n, d = x.shape[-2], x.shape[-1]
    if n > 1 and x.stride(-2) != d:
        raise ValueError(f"rows of x must be contiguous (row stride {d}), "
                         f"got strides {x.stride()}")
    x_ws = x.stride(0) if batched else 0
    y_ws = y.stride(0) if batched else 0
    w_ws = w.stride(0) if w.dim() == 2 else 0

    lib = load_library()
    tiles = -(-n // ROWS_PER_TILE)
    partial = torch.empty((k, tiles, d), dtype=torch.float32, device=x.device)
    out = torch.empty((k, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib.hinge_block_grad_f32(
        x.data_ptr(), x_ws, y.data_ptr(), y_ws, w.data_ptr(), w_ws,
        partial.data_ptr(), out.data_ptr(), k, n, d, ROWS_PER_TILE, float(c),
        stream)
    if err != 0:
        raise RuntimeError(f"hinge kernel launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out if batched else out[0]
