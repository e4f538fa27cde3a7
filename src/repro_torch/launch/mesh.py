"""Process meshes, the port of ``repro.launch.mesh``.

The reference lays its devices out as a named ``jax.sharding.Mesh``
(``make_test_mesh``: ``("data", "model")``; the local-SGD replica axis is
``"pod"``) and runs a collective over one named axis inside
``jax.shard_map``. Here one process is one point of the mesh:
:class:`Mesh` is a ``torch.distributed.device_mesh.DeviceMesh`` over the
ranks of this process's world with the reference's axis names, so that a
reference ``axis="pod"`` is the port's ``mesh.group("pod")``, plus the device
this rank computes on and the backend its collectives take.

The caller names the backend: ``"nccl"`` (one card a rank) or ``"gloo"``
(ranks that share a card, or the CPU); nothing picks it. A gloo mesh is a
``"cpu"`` DeviceMesh whatever its ranks compute on, so that no NCCL group is
made for ranks that share one card; its collectives on CUDA tensors go
through the host where gloo cannot run them
(:mod:`repro_torch.core.collectives`).

Two ways to start ranks:

* :func:`spawn` starts ``world`` processes over ``127.0.0.1`` and returns
  each rank's result, or raises the first rank's exception (the port's
  ``tests/conftest.py::run_with_devices``);
* :func:`init_from_env` joins a world that ``torchrun`` started.

Either way the rank's device is explicit: ``cuda:{local_rank % cards}`` by
default, or the device the caller names (``"cpu"``); :func:`rank_device`
returns it.
"""
from __future__ import annotations

import os
import pickle
import queue as _queue
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.config.base import MeshConfig

BACKENDS = ("gloo", "nccl")

# the device of this process's rank, set when it joins its world
_DEVICE: Optional[torch.device] = None


def rank_device() -> torch.device:
    """The device this rank computes on (set by :func:`spawn` or
    :func:`init_from_env`)."""
    if _DEVICE is None:
        raise RuntimeError("this process has joined no world: start it with "
                           "repro_torch.launch.mesh.spawn or init_from_env")
    return _DEVICE


def _default_device(local_rank: int, device) -> torch.device:
    if device is not None:
        dev = torch.device(device)
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run the ranks on the CPU")
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to "
                               "run the ranks on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        # before any group is made: DeviceMesh and NCCL take the current
        # device, and ranks that share a card must not pick another
        torch.cuda.set_device(dev)
    return dev


def _check_backend(backend: str, device: torch.device) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} ({' | '.join(BACKENDS)})")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("backend='nccl' needs CUDA ranks; use 'gloo' on the "
                         "CPU")


def _join(backend: str, device: torch.device, rank: int, world: int,
          timeout_s: float, **init) -> None:
    """Join the world: ``init`` is ``init_method=`` or ``store=``."""
    global _DEVICE
    _check_backend(backend, device)
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s), **init)
    _DEVICE = device


def init_from_env(backend: str, device=None,
                  timeout_s: float = 1800.0) -> torch.device:
    """Join the world ``torchrun`` started (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``); returns the rank's
    device. A process that has joined its world already (a rank that
    :func:`spawn` started) stays in it: its device is returned, and
    ``backend`` and ``device``'s type must be its own."""
    if dist.is_initialized():
        dev = rank_device()
        if dist.get_backend() != backend or (
                device is not None and torch.device(device).type != dev.type):
            raise ValueError(f"this rank joined its world with "
                             f"{dist.get_backend()} on {dev}, not {backend} "
                             f"on {device}")
        return dev
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = _default_device(int(os.environ.get("LOCAL_RANK", rank)), device)
    _join(backend, dev, rank, world, timeout_s, init_method="env://")
    return dev


class Mesh:
    """A named mesh of this world's ranks (row-major: the last axis varies
    fastest, as ``jax.make_mesh`` lays devices out), its groups one per
    axis, this rank's device and the backend."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        from torch.distributed.device_mesh import DeviceMesh
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes):
            raise ValueError(f"shape {shape} and axes {axes} differ in length")
        world = dist.get_world_size()
        if int(torch.tensor(shape).prod()) != world:
            raise ValueError(f"a mesh of shape {shape} needs "
                             f"{int(torch.tensor(shape).prod())} ranks; this "
                             f"world has {world}")
        self.shape, self.axes = shape, axes
        self.backend = dist.get_backend()
        self.device = rank_device()
        kind = "cuda" if self.backend == "nccl" else "cpu"
        self.device_mesh = DeviceMesh(
            kind, torch.arange(world).reshape(shape), mesh_dim_names=axes)

    def size(self, axis: Optional[str] = None) -> int:
        """Ranks along ``axis``, or in the whole mesh."""
        if axis is None:
            return dist.get_world_size()
        return self.shape[self._dim(axis)]

    def rank(self, axis: Optional[str] = None) -> int:
        """This rank's index along ``axis``, or in the whole mesh."""
        if axis is None:
            return dist.get_rank()
        return dist.get_rank(self.group(axis))

    def group(self, axis: str):
        """The process group of ``axis`` that holds this rank."""
        self._dim(axis)
        return self.device_mesh.get_group(axis)

    def _dim(self, axis: str) -> int:
        if axis not in self.axes:
            raise ValueError(f"the mesh has no axis {axis!r}; its axes are "
                             f"{self.axes}")
        return self.axes.index(axis)

    def __repr__(self) -> str:
        dims = ", ".join(f"{a}={s}" for a, s in zip(self.axes, self.shape))
        return f"Mesh({dims}, {self.backend}, rank {self.rank()} on {self.device})"


def make_mesh(shape: Tuple[int, ...] = (1,),
              axes: Tuple[str, ...] = ("data",)) -> Mesh:
    """The counterpart of ``make_test_mesh``: a mesh over this world's
    ranks (its size must be the world's)."""
    return Mesh(shape, axes)


def mesh_config(shape: Tuple[int, ...] = (1,),
                axes: Tuple[str, ...] = ("data",)) -> MeshConfig:
    """The counterpart of ``test_mesh_config``: ``replica_axis`` is
    ``"pod"`` where the mesh has one."""
    return MeshConfig(shape=tuple(shape), axis_names=tuple(axes),
                      replica_axis="pod" if "pod" in axes else "")


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

class RankError(RuntimeError):
    """A rank's exception, raised in the caller of :func:`spawn` (with the
    rank's traceback as its text) where the exception itself does not
    pickle."""


def _rank_main(rank: int, world: int, backend: str, device, port: int,
               timeout_s: float, fn: Callable, args, results) -> None:
    try:
        dev = _default_device(rank, device)
        store = dist.TCPStore("127.0.0.1", port, is_master=False,
                              timeout=timedelta(seconds=timeout_s))
        _join(backend, dev, rank, world, timeout_s, store=store)
        # pickled by value here: the queue's own pickler would send a
        # tensor's storage as a handle into this process, which exits
        out = ("ok", pickle.dumps(fn(*args)))
    except BaseException as exc:          # noqa: BLE001 — sent to the caller
        text = traceback.format_exc()
        try:
            pickle.dumps(exc)
            err = exc
        except Exception:                 # noqa: BLE001
            err = RankError(f"{type(exc).__name__}: {exc}")
        out = ("error", (err, text))
    results.put((rank,) + out)
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, *, backend: str,
          device: Union[str, torch.device, None] = None, args: tuple = (),
          timeout_s: float = 900.0) -> List[Any]:
    """Run ``fn(*args)`` on ``world`` new ranks of one world over
    ``127.0.0.1`` and return their results in rank order.

    Each rank joins the world with ``backend`` and computes on ``device``
    (default ``cuda:{rank % cards}``; ``"cpu"`` for CPU ranks), then calls
    ``fn``; build a :class:`Mesh` inside it. ``fn`` and ``args`` are
    pickled (the ``spawn`` start method: CUDA forbids a fork), so ``fn`` is
    a module-level function; a result is pickled by value (a CPU tensor's
    data is copied, a CUDA tensor comes back on the same card). If a rank raises, the others are stopped and
    its exception is raised here, the rank's traceback its cause; so is a
    rank that dies without a result, and a world that takes longer than
    ``timeout_s``."""
    import torch.multiprocessing as mp
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    _check_backend(backend, torch.device(device) if device is not None
                   else torch.device("cuda"))
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    # the world's store, served from here on a port the system picks and
    # held until the ranks are done, so that two worlds started at once
    # never race for one port
    store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                          wait_for_workers=False,
                          timeout=timedelta(seconds=timeout_s))
    port = store.port
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, backend, device, port, timeout_s,
                               fn, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    got: dict = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(got) < world:
            try:
                rank, status, value = results.get(timeout=1.0)
            except _queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    raise RankError(f"rank {dead[0]} exited with code "
                                    f"{procs[dead[0]].exitcode} and no "
                                    f"result")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks took over "
                                       f"{timeout_s} s")
                continue
            if status == "error":
                err, text = value
                raise err from RankError(f"rank {rank} of {world}:\n{text}")
            got[rank] = pickle.loads(value)
    finally:
        if len(got) < world:
            for p in procs:
                if p.is_alive():
                    p.terminate()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]
