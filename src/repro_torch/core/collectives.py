"""The replica axis's collectives: the port's ``lax.pmean``, ``psum``,
``pmax``, ``ppermute`` and ``all_gather``.

One interface, two kinds of replica axis:

* :class:`Stacked` — one process holds all K replicas as the leading dim of
  every tensor (the layout of ``init_state(…, replicas=K)`` and
  ``dms(backend="vmap")``, K workers on one card); a collective is an
  operation over that dim, kept as a ``(1, …)`` dim that broadcasts back to
  every replica. These are the one-card sync's own expressions.
* :class:`Group` — one replica a process, over the ``torch.distributed``
  group of a mesh axis (:class:`repro_torch.launch.mesh.Mesh`); every
  tensor's leading dim is 1, as the reference's is inside ``shard_map``. A
  collective is that group's.

:func:`replicas` picks: no mesh, :class:`Stacked`; a mesh and an axis, that
axis's :class:`Group`.

The transport. NCCL runs every op here on CUDA tensors. Gloo runs
``all_reduce`` on CUDA tensors, but not ``all_gather`` nor ``send``/``recv``
(the backend table of the ``torch.distributed`` docs). So on a CUDA tensor
under gloo those two are staged through the host: the tensor is copied to
a host buffer, the op runs there, and the result is copied back.
Every staged call is counted in :data:`STAGED` under its op's name; nothing
retries an op elsewhere after a failure.

Decisions that every rank must take alike (the ladder's next H, a restart
after a fault on one rank) go through :func:`agree`, one small all-reduce
that raises where the ranks differ; times go through :func:`max_over`.

``async_op=True`` issues a collective and returns a :class:`Deferred`, whose
``wait()`` finishes it (the reference lets XLA schedule a collective whose
output feeds only carried state under the next block's compute; here the
caller waits at the next boundary).
"""
from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# staged calls on this process so far, by op ("all_gather", "send/recv")
STAGED: Counter = Counter()


class Deferred:
    """A collective in flight: :meth:`wait` waits for it and returns its
    value (once; later calls return the same value)."""

    def __init__(self, works: Sequence, finish: Callable[[], torch.Tensor]):
        self._works: Optional[Sequence] = works
        self._finish = finish
        self._value: Optional[torch.Tensor] = None

    def wait(self) -> torch.Tensor:
        if self._works is not None:
            for work in self._works:
                work.wait()
            self._value = self._finish()
            self._works = None
        return self._value

    def then(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Deferred":
        """A Deferred of ``fn`` of this one's value, computed at its wait."""
        return Deferred((self,), lambda: fn(self.wait()))


def done(value: torch.Tensor) -> Deferred:
    """A Deferred whose value is ready."""
    return Deferred((), lambda: value)


def resolve(value):
    """``value``, or the value of a :class:`Deferred` once it is done."""
    return value.wait() if isinstance(value, Deferred) else value


def _div_exact(a: torch.Tensor, n) -> torch.Tensor:
    """``a / n`` as an IEEE division (PyTorch applies a Python-scalar
    divisor on CUDA as a reciprocal product)."""
    return a / torch.full_like(a, n)


def _sources(perm, k: int) -> List[int]:
    """For each destination replica, the replica it receives from."""
    src = [0] * k
    for s, d in perm:
        src[d] = s
    return src


class Stacked:
    """The K replicas as the leading dim of each tensor, on one process."""

    def size(self, x: torch.Tensor) -> int:
        return x.shape[0]

    def mean(self, x: torch.Tensor, async_op: bool = False):
        out = x.mean(dim=0, keepdim=True)
        return done(out) if async_op else out

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return x.sum(dim=0, keepdim=True)

    def amax(self, x: torch.Tensor) -> torch.Tensor:
        """The largest element of every replica's x (a 0-dim tensor)."""
        return x.amax()

    def permute(self, x: torch.Tensor, perm, tag: int = 0,
                async_op: bool = False):
        """Replica ``dest`` receives replica ``src``'s row for every (src,
        dest) pair of ``perm``, a permutation of the replicas. The rows are
        gathered as slices, never through an index tensor made on the host:
        that would be a copy to the card, which a CUDA graph cannot hold."""
        out = torch.cat([x[i:i + 1] for i in _sources(perm, x.shape[0])])
        return done(out) if async_op else out

    def gather(self, x: torch.Tensor, async_op: bool = False):
        """Every replica's x stacked on the leading dim: x itself."""
        return done(x) if async_op else x


class Group:
    """One replica a process: the ranks of ``group``, each tensor's leading
    dim this rank's one replica."""

    def __init__(self, group, device: torch.device, backend: str):
        self.group = group
        self.k = dist.get_world_size(group)
        self.index = dist.get_rank(group)
        self.staged = backend == "gloo" and device.type == "cuda"

    def size(self, x: torch.Tensor) -> int:
        return self.k

    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        buf = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(buf, op=op, group=self.group)
        return buf

    def mean(self, x: torch.Tensor, async_op: bool = False):
        """``lax.pmean``: every rank's x gathered in rank order and averaged
        over the leading dim as one process averages its stacked replicas,
        so the mean is the same on every rank, bitwise, and the same as the
        one-card mean of the same rows (an all-reduce would sum in the
        order of its ring). The price: each rank takes in (K − 1) copies of
        x, where the reference's ``psum`` all-reduce takes in 2(K − 1)/K,
        and holds K of them (ROADMAP §1 item 9)."""
        pending = self.gather(x, async_op=True)
        out = pending.then(lambda g: g.mean(dim=0, keepdim=True))
        return out if async_op else out.wait()

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.psum``."""
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def amax(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.pmax`` of this rank's largest element."""
        return self._all_reduce(x.amax(), dist.ReduceOp.MAX)

    def _host(self, x: torch.Tensor, op: str) -> torch.Tensor:
        if not self.staged:
            return x.contiguous()
        STAGED[op] += 1
        return x.to("cpu", copy=True)

    def permute(self, x: torch.Tensor, perm, tag: int = 0,
                async_op: bool = False):
        """``lax.ppermute``: a ``batch_isend_irecv`` of this rank's pairs of
        ``perm`` (group ranks); send and receive through host buffers
        under gloo on the card."""
        me = self.index
        dst = [d for s, d in perm if s == me]
        src = _sources(perm, self.k)[me]
        if dst == [me] and src == me:
            out = x.clone()
            return done(out) if async_op else out
        sent = self._host(x, "send/recv")
        buf = torch.empty_like(sent)
        ops = [dist.P2POp(dist.isend, sent,
                          dist.get_global_rank(self.group, d), self.group, tag)
               for d in dst]
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(self.group, src),
                              self.group, tag))
        works = dist.batch_isend_irecv(ops)

        def finish():
            return buf.to(x.device) if self.staged else buf
        pending = Deferred(works, finish)
        return pending if async_op else pending.wait()

    def gather(self, x: torch.Tensor, async_op: bool = False):
        """``lax.all_gather``: every rank's x, stacked in rank order on the
        leading dim (each x's leading dim is 1)."""
        local = self._host(x, "all_gather")
        parts = [torch.empty_like(local) for _ in range(self.k)]
        work = dist.all_gather(parts, local, group=self.group,
                               async_op=async_op)

        def finish():
            out = torch.cat(parts)
            return out.to(x.device) if self.staged else out
        pending = Deferred((work,) if async_op else (), finish)
        return pending if async_op else pending.wait()


STACKED = Stacked()


def replicas(mesh=None, axis: Optional[str] = None):
    """The replica axis: :data:`STACKED` without a mesh, else the
    :class:`Group` of ``mesh``'s ``axis``."""
    if mesh is None:
        return STACKED
    if axis is None:
        raise ValueError("a mesh needs the name of its replica axis")
    return Group(mesh.group(axis), mesh.device, mesh.backend)


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group, k: int
                     ) -> None:
    """Each tensor in place ← its mean over ``group`` (of ``k`` ranks): the
    gradient all-reduce of data parallelism."""
    for t in tensors:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        t.copy_(_div_exact(t, k))


def max_over(values: Sequence[float], group=None) -> Tuple[float, ...]:
    """Each host value's max over ``group`` (the world by default), as one
    all-reduce of a float64 CPU tensor (gloo) or CUDA tensor (nccl)."""
    dev = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    t = torch.tensor(list(values), dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return tuple(t.tolist())


class Disagreement(RuntimeError):
    """Ranks that must take one decision hold different values."""


def agree(values: Dict[str, float], group=None,
          maxes: Sequence[float] = ()) -> Tuple[float, ...]:
    """Check that every rank of ``group`` (the world by default) holds the
    same ``values`` (a few host numbers by name: a decision all ranks must
    take alike) and return ``maxes``' max over the ranks. One all-reduce
    (MAX of the values, of their negations and of ``maxes``) gives each
    value's max and min; where they differ it raises
    :class:`Disagreement` on every rank, naming the values."""
    names = list(values)
    vals = [float(values[n]) for n in names]
    got = max_over(vals + [-v for v in vals] + [float(m) for m in maxes],
                   group)
    n = len(vals)
    split = {name: (-got[n + i], got[i]) for i, name in enumerate(names)
             if got[i] != -got[n + i]}
    if split:
        raise Disagreement(
            "the ranks disagree: " + ", ".join(
                f"{name} ranges from {lo:g} to {hi:g}"
                for name, (lo, hi) in split.items()))
    return got[2 * n:]
