"""The replica axis's collectives: the port's ``lax.pmean``, ``psum``,
``pmax``, ``ppermute`` and ``all_gather``; and, for the mesh paths of the
models, ``all_to_all``, the tiled ``all_gather`` and ``psum_scatter`` along a
dim.

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
Every staged call is counted in :data:`STAGED` under its op's name, its
bytes in :data:`STAGED_BYTES`; nothing retries an op elsewhere after a
failure. The mesh paths' ops, ``all_to_all_single``,
``all_gather_into_tensor`` and ``reduce_scatter_tensor``, are marked
unsupported on CUDA under gloo in that table, but gloo runs all three on
CUDA tensors in the card's PyTorch (2.11, a probe of each on two ranks
against its CPU result), copying through the host itself; so the port
hands them the CUDA tensors and stages none of them. Their bf16 payloads
travel as their bytes (no arithmetic on the way; gloo has no bf16 or
int16 collectives); the sums take f32.

The mesh ops are differentiable, each backward its transpose: the
all-to-all's is the reverse all-to-all (the same op), the tiled gather's
the sum-scatter and the sum-scatter's the gather, ``sum``'s (where x needs a
gradient) the sum. Under these, the gradients of a sum over the ranks of
per-rank losses reach every rank's shard, so each rank's loss is its share:
the loss of what it holds, divided by the number of ranks that hold the
same.

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

# staged calls on this process so far, by op ("all_gather", "send/recv"),
# and the bytes they copied to the host
STAGED: Counter = Counter()
STAGED_BYTES: Counter = Counter()


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
        """``lax.psum``; differentiable where x needs a gradient."""
        if x.requires_grad:
            return _Sum.apply(self, x)
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def sum_(self, x: torch.Tensor) -> None:
        """``x`` in place ← its sum over the group (contiguous ``x``)."""
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)

    def amax(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.pmax`` of this rank's largest element."""
        return self._all_reduce(x.amax(), dist.ReduceOp.MAX)

    def maximum(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.pmax`` elementwise."""
        return self._all_reduce(x, dist.ReduceOp.MAX)

    def _host(self, x: torch.Tensor, op: str) -> torch.Tensor:
        if not self.staged:
            return x.contiguous()
        STAGED[op] += 1
        STAGED_BYTES[op] += x.numel() * x.element_size()
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


    # ------------------------------------------------- the mesh paths' ops
    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``lax.all_to_all(x, axis, 0, 0, tiled=True)``: dim 0 split into
        ``k`` chunks, chunk j sent to group rank j, the chunks received
        concatenated in source order (``all_to_all_single``).
        Differentiable: the backward is the same all-to-all."""
        return _AllToAll.apply(self, x)

    def gather_dim(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``lax.all_gather(x, axis, axis=dim, tiled=True)``: every rank's
        x concatenated along ``dim`` in rank order. Differentiable: the
        backward is :meth:`sum_scatter_dim`."""
        return _GatherDim.apply(self, x, dim)

    def sum_scatter_dim(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)``:
        the sum of every rank's x, of which this rank keeps block ``index``
        of ``k`` along ``dim``. Differentiable: the backward is
        :meth:`gather_dim`."""
        return _SumScatterDim.apply(self, x, dim)

    def _all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % self.k:
            raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} does "
                             f"not split into {self.k} chunks")
        src = _bits(x.contiguous())
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self.group)
        return _unbits(out, x.dtype)

    def _gather_dim(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        src = _bits(x.movedim(dim, 0).contiguous())
        out = src.new_empty((self.k * src.shape[0],) + src.shape[1:])
        dist.all_gather_into_tensor(out, src, group=self.group)
        return _unbits(out, x.dtype).movedim(0, dim)

    def _sum_scatter_dim(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        src = x.movedim(dim, 0).contiguous()
        if src.shape[0] % self.k:
            raise ValueError(f"sum_scatter_dim: dim {dim} of "
                             f"{tuple(x.shape)} does not split into "
                             f"{self.k} blocks")
        out = src.new_empty((src.shape[0] // self.k,) + src.shape[1:])
        dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM,
                                   group=self.group)
        return out.movedim(0, dim)


# payloads that ops which only move data carry as their bytes (gloo has no
# bfloat16 or int16 collectives)
_AS_BYTES = (torch.bfloat16, torch.float16, torch.int16)


def _bits(x: torch.Tensor) -> torch.Tensor:
    """A 16-bit payload (contiguous) as its bytes, the last dim doubled."""
    return x.view(torch.uint8) if x.dtype in _AS_BYTES else x


def _unbits(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.view(dtype) if dtype in _AS_BYTES else x


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return group._all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.group._all_to_all(g)


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x, dim):
        ctx.group, ctx.dim = group, dim
        return group._gather_dim(x, dim)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.group._sum_scatter_dim(g, ctx.dim), None


class _SumScatterDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x, dim):
        ctx.group, ctx.dim = group, dim
        return group._sum_scatter_dim(x, dim)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.group._gather_dim(g, ctx.dim), None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, x):
        ctx.group = group
        return group._all_reduce(x, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.group._all_reduce(g, dist.ReduceOp.SUM)


STACKED = Stacked()


def replicas(mesh=None, axis: Optional[str] = None):
    """The replica axis: :data:`STACKED` without a mesh, else the
    :class:`Group` of ``mesh``'s ``axis``."""
    if mesh is None:
        return STACKED
    if axis is None:
        raise ValueError("a mesh needs the name of its replica axis")
    return Group(mesh.group(axis), mesh.device, mesh.backend)


def mesh_groups(rules) -> Tuple[Group, Group]:
    """The (data, model) groups of ``rules``' mesh: the mesh axes of its
    data and model roles (``rules.roles``), where the logical ``batch``
    maps to the data axis alone (the layout the models' mesh paths
    take)."""
    mesh = rules.mesh
    data, model = rules.roles["data"], rules.roles["model"]
    if rules.mesh_axes_for("batch") != (data,) or model not in mesh.axes:
        raise ValueError(f"the mesh paths take one data and one model axis; "
                         f"these rules map batch to "
                         f"{rules.mesh_axes_for('batch')} on {mesh!r} (data "
                         f"{data!r}, model {model!r})")
    return (Group(mesh.group(data), mesh.device, mesh.backend),
            Group(mesh.group(model), mesh.device, mesh.backend))


class Shards:
    """How the ranks of one replica hold a leaf on a mesh with a model
    axis: split over the groups ``split`` (each rank its block along the
    leaf's spec), repeated alike on the ranks of ``copies`` (the
    within-replica axes the spec does not use). :data:`WHOLE` is a leaf
    that one process holds whole (no mesh, or a mesh without a model
    axis)."""

    def __init__(self, split: Sequence[Group] = (),
                 copies: Sequence[Group] = ()):
        self.split, self.copies = tuple(split), tuple(copies)

    @property
    def count(self) -> int:
        """The blocks the leaf is split into."""
        n = 1
        for g in self.split:
            n *= g.k
        return n

    def whole_max(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise max over the ranks that hold the leaf's other blocks
        (a shard's amax → the whole leaf's; exact)."""
        for g in self.split:
            x = g.maximum(x)
        return x

    def sum_split(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks that hold the leaf's other blocks (a shard's
        squares → the whole leaf's)."""
        for g in self.split:
            x = g._all_reduce(x, dist.ReduceOp.SUM)
        return x

    def sum_copies_(self, x: torch.Tensor) -> None:
        """``x`` in place ← its sum over the ranks that hold the same block
        (a gradient's parts on the ranks that computed alike)."""
        for g in self.copies:
            g.sum_(x)


WHOLE = Shards()


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
