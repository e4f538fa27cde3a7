"""Wrapper of the CUDA hinge kernels: checks, dispatch and launch counts.

A CPU tensor goes to the plain version (:mod:`repro_torch.kernels.hinge.ref`);
a CUDA tensor goes to one of two kernels, or the call raises.
:func:`kernel_for` chooses, before any launch:

* ``"cluster"`` (``csrc/hinge_cluster.cu``): float32 rows of at most
  :data:`MAX_CLUSTER_COLS` columns that a bulk async copy can move: d a
  multiple of 4, and x's and w's bases and worker strides multiples of 16
  bytes. One launch a call, one thread block cluster of up to 8 CTAs a
  worker; X streamed once through a ring of shared-memory stages by 1-D
  bulk copies; the worker's row sum taken across the cluster in
  distributed shared memory.
* ``"simt"`` (``csrc/hinge.cu``): any other rows. Two launches a call, the
  partial column sums through device memory.

There is no fallback from one kernel to the other, or to the plain version:
a refused launch raises. Each kernel is built and loaded at its first launch
(:mod:`repro_torch.kernels.nvcc`), so this module imports without ``nvcc``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import nvcc, work
from repro_torch.kernels.hinge import ref

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "hinge.cu"                   # "simt": two launches, any d
CLUSTER_SOURCE = CSRC / "hinge_cluster.cu"   # "cluster": one launch
SOURCES = (SOURCE, CLUSTER_SOURCE)
# "simt": rows of X one CTA of the first stage takes (one warp a row)
ROWS_PER_TILE = 8
# "cluster": CTAs a worker (the portable cluster limit); the bytes of X a
# CTA has in flight (its ring; at least one row), the most rows a stage
# holds and the most stages the ring holds (the kernel's kMaxStageRows and
# kStages). A thread holds its 2 float4 columns of a stage's rows, of w and
# of the column sums in registers, so rows have at most 256 · 2 · 4 columns.
CLUSTER = 8
RING_BYTES = 32768
MAX_STAGE_ROWS = 4
MAX_SLOTS = 4
MAX_CLUSTER_COLS = 2048
COPY_ALIGN = 16       # bytes: the bulk copy's rule for addresses and sizes

# kernel launches so far, one per call on CUDA tensors, none for the CPU
# path: LAUNCHES counts both kernels, CLUSTER_LAUNCHES the cluster one. A
# run sets them to 0 and reads them after. A CUDA graph's capture counts its
# launches once; its replays launch without this module and count none.
LAUNCHES = 0
CLUSTER_LAUNCHES = 0

_LIB: Optional[ctypes.CDLL] = None
_CLUSTER_LIB: Optional[ctypes.CDLL] = None


def load_library() -> ctypes.CDLL:
    """Build (at the first call) and load the "simt" kernel's library."""
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


def load_cluster_library() -> ctypes.CDLL:
    """Build (at the first call) and load the "cluster" kernel's library."""
    global _CLUSTER_LIB
    if _CLUSTER_LIB is None:
        lib = nvcc.load("hinge_cluster", [CLUSTER_SOURCE])
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fn = lib.hinge_cluster_f32
        fn.argtypes = [ptr, i64, ptr, i64, ptr, i64, ptr, i32, i32, i32,
                       i32, i32, i32, i32, ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
        for name in ("hinge_cluster_max_active", "hinge_cluster_smem_bytes"):
            getattr(lib, name).argtypes = [i32, i32, i32, i32]
            getattr(lib, name).restype = ctypes.c_int
        _CLUSTER_LIB = lib
    return _CLUSTER_LIB


def kernel_for(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> str:
    """The kernel that takes (w, x, y) on a card: ``"cluster"`` for float32
    rows of at most :data:`MAX_CLUSTER_COLS` columns (a thread's share of a
    stage's rows and of the column sums fits its registers) that a bulk
    async copy can move: every row, x's and w's worker strides and both
    bases multiples of 16 bytes (rows of x are contiguous, so a stage of
    rows is one run of memory). Else ``"simt"``. A rule of dtype, strides,
    addresses and d only, so it answers for CPU tensors too."""
    d = x.shape[-1]
    if x.dtype != torch.float32 or w.dtype != torch.float32 \
            or d > MAX_CLUSTER_COLS:
        return "simt"
    strides = [d] + ([x.stride(0)] if x.dim() == 3 else []) \
        + ([w.stride(0)] if w.dim() == 2 else [])
    if any((4 * s) % COPY_ALIGN for s in strides) \
            or x.data_ptr() % COPY_ALIGN or w.data_ptr() % COPY_ALIGN:
        return "simt"
    return "cluster"


def cluster_plan(n: int, d: int) -> Tuple[int, int, int, int]:
    """(CTAs a cluster, rows a CTA, rows a stage, stages in the ring) for a
    block of n rows of d columns: up to :data:`CLUSTER` CTAs a worker, each
    a contiguous run of ``rows`` rows (the last run may be shorter, none is
    empty); stages of up to :data:`MAX_STAGE_ROWS` rows, as many as
    :data:`RING_BYTES` holds (at least one row); a ring of as many such
    stages as :data:`RING_BYTES` holds, up to :data:`MAX_SLOTS` and no more
    than the run needs. Fewer, larger stages cost fewer of the stage's
    barrier rounds, and more bytes in flight a CTA measured slower
    (``scripts/hinge_variants.py``). At the epsilon main path's n = 64,
    d = 2,000: 8 CTAs of 8 rows, 2 stages of 4 rows (32 KB), one in flight
    at a time."""
    rows = -(-n // min(CLUSTER, n))
    stage_rows = max(1, min(rows, MAX_STAGE_ROWS, RING_BYTES // (4 * d)))
    slots = min(MAX_SLOTS, -(-rows // stage_rows),
                RING_BYTES // (4 * d * stage_rows))
    return -(-n // rows), rows, stage_rows, max(1, slots)


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


def hinge_work(k: int, n: int, d: int, w_rows: int,
               dtype: torch.dtype = torch.float32) -> work.Work:
    """The work of one call on K workers' blocks of n rows of d columns:
    X, y and the ``w_rows`` distinct rows of w (1 for a shared or stride-0
    w, K for one a worker) read once and the (K, d) result written once;
    4·K·n·d operations (the margins' GEMV and the masked row sum's)."""
    size = dtype.itemsize
    return work.Work("hinge_block_grad", {work.dtype_name(dtype): 4 * k * n * d},
                     size * (k * n * d + k * n + w_rows * d + k * d))


def _work_of(w: torch.Tensor, x: torch.Tensor) -> work.Work:
    k = x.shape[0] if x.dim() == 3 else 1
    w_rows = k if w.dim() == 2 and w.stride(0) != 0 else 1
    return hinge_work(k, x.shape[-2], x.shape[-1], w_rows, x.dtype)


def hinge_block_grad(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                     c: float = 1.0) -> torch.Tensor:
    """Drop-in for :func:`repro_torch.kernels.hinge.ref.hinge_block_grad`.

    On CUDA tensors it launches the kernel that :func:`kernel_for` names:
    float32 only; rows of x contiguous (unit column stride, row stride d); y
    and w with unit last stride. The worker strides are free (0 for w shares
    one w), so a worker-major view such as ``xb[:, i]`` of ``(K, nb, bs, d)``
    data needs no copy, nor does a ``w[:, :d]`` slice of a wider carry.
    Under a work counter the call is recorded as :func:`hinge_work`
    (:mod:`repro_torch.kernels.work`).
    """
    _check_shapes(w, x, y)
    devices = {w.device, x.device, y.device}
    with work.call(_work_of, w, x) as counted:
        if devices == {work.META}:
            work.on_meta(counted, "hinge_block_grad")
            return torch.empty(x.shape[:-2] + x.shape[-1:], dtype=x.dtype,
                               device=work.META)
        if devices == {torch.device("cpu")}:
            return ref.hinge_block_grad(w, x, y, c)
        if len(devices) != 1 or not x.is_cuda:
            raise ValueError(f"w, x and y must lie on one CUDA device or all "
                             f"on the CPU; got {sorted(map(str, devices))}")
        for name, t in (("w", w), ("x", x), ("y", y)):
            if t.dtype != torch.float32:
                raise TypeError(f"the CUDA hinge kernel takes float32; {name} "
                                f"is {t.dtype}")
            if t.stride(-1) != 1:
                raise ValueError(f"{name} needs a unit last stride, got "
                                 f"{t.stride()}")
        n, d = x.shape[-2], x.shape[-1]
        if n > 1 and x.stride(-2) != d:
            raise ValueError(f"rows of x must be contiguous (row stride {d}), "
                             f"got strides {x.stride()}")
        return run_kernel(kernel_for(w, x, y), w, x, y, c)


def run_kernel(kind: str, w: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
               c: float = 1.0) -> torch.Tensor:
    """Launch kernel ``kind`` (``"cluster"`` or ``"simt"``) on CUDA inputs
    that :func:`hinge_block_grad` has checked, counting the launch.
    :func:`hinge_block_grad` calls it with :func:`kernel_for`'s choice; a
    caller may name ``"simt"`` for inputs that ``"cluster"`` would take (to
    time the two kernels on the same inputs), never ``"cluster"`` for rows
    it does not take."""
    batched = x.dim() == 3
    k = x.shape[0] if batched else 1
    n, d = x.shape[-2], x.shape[-1]
    x_ws = x.stride(0) if batched else 0
    y_ws = y.stride(0) if batched else 0
    w_ws = w.stride(0) if w.dim() == 2 else 0
    out = torch.empty((k, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
    args = (x.data_ptr(), x_ws, y.data_ptr(), y_ws, w.data_ptr(), w_ws)
    if kind == "cluster":
        if kernel_for(w, x, y) != "cluster":
            raise ValueError(f"the cluster hinge kernel takes rows of at most "
                             f"{MAX_CLUSTER_COLS} columns with 16-byte rows, "
                             f"bases and worker strides; got d={d}, x "
                             f"strides {x.stride()}, w strides {w.stride()}")
        err = load_cluster_library().hinge_cluster_f32(
            *args, out.data_ptr(), k, n, d, *cluster_plan(n, d), float(c),
            stream)
    elif kind == "simt":
        tiles = -(-n // ROWS_PER_TILE)
        partial = torch.empty((k, tiles, d), dtype=torch.float32,
                              device=x.device)
        err = load_library().hinge_block_grad_f32(
            *args, partial.data_ptr(), out.data_ptr(), k, n, d,
            ROWS_PER_TILE, float(c), stream)
    else:
        raise ValueError(f"unknown hinge kernel {kind!r} (cluster | simt)")
    if err != 0:
        raise RuntimeError(f"hinge kernel ({kind}) launch failed: CUDA error "
                           f"{err}")
    global LAUNCHES, CLUSTER_LAUNCHES
    LAUNCHES += 1
    CLUSTER_LAUNCHES += kind == "cluster"
    return out if batched else out[0]
