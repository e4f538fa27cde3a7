"""CUDA graphs: the port's counterpart of ``jax.jit`` for a loop body of
fixed shapes.

The reference compiles every loop it runs: ``jax.jit`` over a ``lax.scan``
of SVM blocks, ``jax.jit(decode)`` with the decode index traced. On the card
the port captures such a body once as a CUDA graph and replays it, so the
loop no longer waits on Python between kernels. A body is a function of
static device buffers: it reads and writes the same tensors at every call,
and anything that changes from call to call (a decode index, the SVM step
size) is a device tensor among them, filled before the replay.

:class:`Compiled` runs a body either way: ``graph=True`` captures it (a
failed capture raises; nothing falls back to eager, since an eager fallback
would hide the path), ``graph=False`` calls it eagerly, the comparison path
on the card and the only path on the CPU, where there is no graph.
:func:`use_graphs` resolves a caller's ``graphs`` option against the device.

:data:`CAPTURES` is the process's tally of captures, as
:data:`repro_torch.kernels.nvcc.EVENTS` is of kernel builds and loads. The
kernel wrappers count a launch where they make it: a capture records each of
its launches once and counts it once, and a replay runs them without the
wrappers and counts none. The launches a replay executes are the device's
to count (``torch.profiler``).
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import torch

from repro_torch import tree as T

# graph captures so far in this process
CAPTURES = 0
# the side stream every capture on a card runs on, by device index: cuBLAS
# keeps a workspace for each stream it has run on, so a new stream a capture
# would leave one more allocated for the life of the process
_CAPTURE_STREAMS: Dict[int, torch.cuda.Stream] = {}


def use_graphs(graphs: Optional[bool], device: torch.device) -> bool:
    """A caller's ``graphs`` option on ``device``: None is True on a card
    and False on the CPU; True on the CPU raises (there is no graph there,
    and running eagerly instead would not be what was asked)."""
    if graphs is None:
        return device.type == "cuda"
    if graphs and device.type != "cuda":
        raise ValueError(f"graphs=True needs a CUDA device, not {device}; "
                         f"on the CPU the loop runs eagerly (graphs=False)")
    return bool(graphs)


class Compiled:
    """``fn(*args)`` over static buffers, run as one CUDA graph replay per
    call (``graph=True``) or eagerly (``graph=False``).

    ``args`` are tensors, or trees of them (:mod:`repro_torch.tree`), whose
    storage the body reads and writes at every call. The capture runs on a
    side stream (one kept a card) into a private memory pool, with no
    warm-up call before it, so it never runs the body on the live buffers.
    A graph reads and writes its buffers by address: after the capture
    ``fn`` and ``args`` are dropped, and the caller keeps alive every
    buffer it replays on. A call returns the body's output: under a graph,
    tensors of its pool that the next replay overwrites, so copy what must
    outlive it inside the body.
    ``capture_s`` is the host time of the capture, ``end_s`` the part of it
    that ended the capture (PyTorch instantiates the graph there)."""

    def __init__(self, fn: Callable, *args, graph: bool):
        self.fn = fn
        self.args = args
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.output = None
        self.capture_s: Optional[float] = None
        self.end_s: Optional[float] = None
        if graph:
            self._capture()

    def _capture(self) -> None:
        global CAPTURES
        tensors = [t for t in T.leaves(list(self.args))
                   if isinstance(t, torch.Tensor)]
        devices = {t.device for t in tensors}
        if len(devices) != 1 or next(iter(devices)).type != "cuda":
            raise ValueError(f"a CUDA graph takes buffers on one card; got "
                             f"{sorted(map(str, devices))}")
        dev = next(iter(devices))
        t0 = time.perf_counter()
        with torch.cuda.device(dev):
            side = _CAPTURE_STREAMS.get(dev.index)
            if side is None:
                side = _CAPTURE_STREAMS[dev.index] = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                # cuBLAS makes its handle at its first product, and cannot
                # inside a capture: make it (and the stream's workspace) here
                torch.cuda.current_blas_handle()
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin(pool=torch.cuda.graph_pool_handle())
                try:
                    output = self.fn(*self.args)
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass    # the capture is void; the body's error says why
                    raise
                t1 = time.perf_counter()
                graph.capture_end()
            torch.cuda.current_stream().wait_stream(side)
        self.capture_s = time.perf_counter() - t0
        self.end_s = time.perf_counter() - t1
        self.graph, self.output = graph, output
        self.fn = self.args = None
        CAPTURES += 1

    def __call__(self):
        if self.graph is None:
            return self.fn(*self.args)
        self.graph.replay()
        return self.output
