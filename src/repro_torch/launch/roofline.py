"""Roofline terms on an NVIDIA H100: the work of one call of the port's own
program, counted op by op as it runs, and the time that work takes at the
card's rates.

The bound this gives is that of the eager program: each aten op's traffic
and products priced as if it ran at the card's peak. It is not the least
time the card could take for the function, since a fused program moves fewer
bytes, and it shrinks with any fusion; ``mfu`` (model FLOPs over the wall)
is the number that stays comparable across versions of the program.

The counterpart of ``repro.launch.roofline``, which parses XLA's compiled
HLO. The port has no compiled program to parse, so :class:`WorkCounter`, a
``TorchDispatchMode``, counts the aten ops of the call as they run (on the
card, or on the meta device, where nothing is computed):

1. products: ``mm``/``bmm``/``addmm``/``baddbmm``/convolution FLOPs
   (``2·M·N·K``, ``torch.utils.flop_counter``'s formulas), kept by dtype so
   that each is priced at its own peak. Elementwise operations are not
   counted, as the reference does not count them (a known undercount of a
   few percent);
2. bytes: each op's tensor inputs read once and its outputs written once,
   each tensor at the elements it spans (a broadcast dim, stride 0, is read
   once), views and metadata ops skipped (the eager analogue of the
   reference's ``_SKIP_BYTES_OPS``);
3. the hand-written kernels, which a dispatch mode cannot see (ctypes
   launches): each wrapper records its call's work from its shapes
   (:mod:`repro_torch.kernels.work`) and the ops inside it are not counted
   again, so a kernel's work reads the same whatever implements it;
4. the peak of the bytes the call's ops allocate and keep alive
   (activations, gradients, temporaries), read from the storages they make.

Collectives are not ops of a one-card call: their wire bytes come from
:func:`repro_torch.core.costmodel.wire_bytes_per_sync`, priced on the link
of the mesh axis they cross (:func:`link_for_axis`), as the dry run adds
them (:mod:`repro_torch.launch.dryrun`).

The H100 terms, named once here (nominal rates from NVIDIA's H100 SXM data
sheets: dense tensor-core rates, no sparsity; the links a direction a
card). A card may run below them (a lower power limit), so every measured
share is printed beside ``nvidia-smi``'s name and power limit.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import weakref
from typing import Dict, Iterator, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import work as W

HBM_BW = 3.35e12             # bytes/s, HBM3
BF16_FLOPS = 989e12          # FLOP/s, bf16 (and fp16) tensor cores
TF32_FLOPS = 494.7e12        # FLOP/s, TF32 tensor cores
F32_FLOPS = 67e12            # FLOP/s, float32 outside the tensor cores
NVLINK_BW = 450e9            # bytes/s, NVLink 4, a card within a node
IB_BW = 50e9                 # bytes/s, 400 Gb/s InfiniBand NDR, a card
NODE_CARDS = 8               # cards an NVLink domain holds

# the peak each unit's products are priced at (any other at the float32
# one): a dtype's name, or "tf32" for a kernel that runs float32 on the TF32
# tensor cores (kernels/work.py). An aten product in float32 runs with TF32
# off (the port's plain versions, and chip_smoke.py, keep it off), so it
# takes the CUDA cores' rate
PEAKS: Dict[str, float] = {"bfloat16": BF16_FLOPS, "float16": BF16_FLOPS,
                           "tf32": TF32_FLOPS, "float32": F32_FLOPS}

_aten = torch.ops.aten
# metadata and allocation ops: no bytes move (views are skipped by is_view;
# _unsafe_view is a view that is not marked as one)
_SKIP_BYTES = {_aten.empty, _aten.empty_like, _aten.empty_strided,
               _aten._unsafe_view,
               _aten.new_empty, _aten.new_empty_strided, _aten.detach,
               _aten.alias, _aten.lift_fresh, _aten._local_scalar_dense,
               _aten.resize_, _aten.set_, _aten.is_same_size,
               _aten.sym_size, _aten.sym_stride, _aten.sym_numel,
               _aten.sym_storage_offset, _aten.is_nonzero}


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(t: torch.Tensor) -> int:
    """The bytes of the elements ``t`` spans: a dim of stride 0 (an
    expanded view) adds none."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n


class WorkCounter(TorchDispatchMode):
    """Counts the work of everything run inside ``with WorkCounter() as c``.

    ``flops`` (products, by dtype), ``bytes``, ``ops`` (aten ops counted),
    ``kernels`` (records of the hand-written kernels, by wrapper name),
    ``kernel_flops``/``kernel_bytes`` (their share of the totals), and
    ``peak_bytes``: the most bytes that ops run inside allocated and held at
    once (the inputs the caller holds are not among them)."""

    def __init__(self):
        super().__init__()
        self.flops: Dict[str, float] = collections.defaultdict(float)
        self.bytes = 0.0
        self.ops = 0
        self.kernels: collections.Counter = collections.Counter()
        self.kernel_flops = 0.0
        self.kernel_bytes = 0.0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._quiet = 0
        self._fresh: Dict = {}

    def __enter__(self):
        W.COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        W.COUNTERS.remove(self)
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def kernel(self, work: W.Work):
        """Record one kernel call's work; count no op run inside."""
        self.kernels[work.name] += 1
        for dtype, n in work.flops.items():
            self.flops[dtype] += n
            self.kernel_flops += n
        self.bytes += work.bytes
        self.kernel_bytes += work.bytes
        self._quiet += 1
        try:
            yield True
        finally:
            self._quiet -= 1

    def _fresh_outputs(self, func):
        """Per return of ``func``: whether it is a new tensor (no alias)."""
        got = self._fresh.get(func)
        if got is None:
            got = tuple(r.alias_info is None for r in func._schema.returns)
            self._fresh[func] = got
        return got

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def _track(self, func, out) -> None:
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for fresh, t in zip(self._fresh_outputs(func), outs):
            if fresh and isinstance(t, torch.Tensor):
                storage = t.untyped_storage()
                n = storage.nbytes()
                self.live_bytes += n
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
                weakref.finalize(storage, self._free, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._track(func, out)
        if self._quiet:
            return out
        packet = func.overloadpacket
        self.ops += 1
        if packet in flop_registry:
            first = next(_tensors(out))
            self.flops[W.dtype_name(first.dtype)] += flop_registry[packet](
                *args, **kwargs, out_val=out)
        if not func.is_view and packet not in _SKIP_BYTES:
            self.bytes += (sum(_nbytes(t) for t in _tensors((args, kwargs)))
                           + sum(_nbytes(t) for t in _tensors(out)))
        return out

    def add(self, other: "WorkCounter", times: int = 1) -> None:
        """Add ``times`` runs of what ``other`` counted (the peak is the
        larger of the two: the runs follow one another)."""
        for dtype, n in other.flops.items():
            self.flops[dtype] += times * n
        self.bytes += times * other.bytes
        self.ops += times * other.ops
        for name, n in other.kernels.items():
            self.kernels[name] += times * n
        self.kernel_flops += times * other.kernel_flops
        self.kernel_bytes += times * other.kernel_bytes
        self.peak_bytes = max(self.peak_bytes, other.peak_bytes)

    @property
    def product_flops(self) -> float:
        return float(sum(self.flops.values()))

    def cost(self, **wire) -> "StepCost":
        """The counted work as a :class:`StepCost`, with collective wire
        bytes by link (``nvlink=``, ``ib=``)."""
        return StepCost(flops=dict(self.flops), hbm_bytes=self.bytes,
                        **wire)


def link_for_axis(sizes: Dict[str, int], axis: str) -> str:
    """``"nvlink"`` where a group along ``axis`` stays within one node of
    :data:`NODE_CARDS` cards (row-major: the axes after it vary faster),
    else ``"ib"``."""
    names = list(sizes)
    span = sizes[axis]
    for a in names[names.index(axis) + 1:]:
        span *= sizes[a]
    return "nvlink" if span <= NODE_CARDS else "ib"


@dataclasses.dataclass
class StepCost:
    flops: Dict[str, float]
    hbm_bytes: float
    nvlink: float = 0.0        # wire bytes a card over NVLink
    ib: float = 0.0            # wire bytes a card over InfiniBand
    collectives: Dict[str, dict] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class RooflineTerms:
    """The reference's fields on H100 terms: its ``ici_wire_bytes`` /
    ``dcn_wire_bytes`` are the wires within a node (NVLink) and across
    nodes (InfiniBand) here."""

    flops: float               # products a card, all dtypes
    hbm_bytes: float           # bytes a card
    nvlink_wire_bytes: float
    ib_wire_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float        # model FLOPs / (counted FLOPs × cards)
    mfu_bound: float           # model FLOPs/(cards · bf16 peak) / the bound
    collectives: Dict[str, dict]
    flops_by_dtype: Dict[str, float]

    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)


def compute_s(flops: Dict[str, float]) -> float:
    """Products over the peak of their unit (:data:`PEAKS`): the one place
    a product's rate is decided."""
    return sum(n / PEAKS.get(d, F32_FLOPS) for d, n in flops.items())


def work_bound(work: W.Work) -> Tuple[float, str]:
    """(seconds, ``"bytes"`` or ``"operations"``) of a kernel call's work:
    its bytes over the HBM rate or its operations over their units' peaks,
    whichever is larger."""
    t_bytes, t_ops = work.bytes / HBM_BW, compute_s(work.flops)
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def compute_terms(cost: StepCost, *, total_devices: int, model_flops: float
                  ) -> RooflineTerms:
    """The bound of one card's call: products at their dtypes' peaks, bytes
    at the HBM rate and wire bytes at their links' rates, and which of the
    three sets it."""
    total = float(sum(cost.flops.values()))
    c_s = compute_s(cost.flops)
    m_s = cost.hbm_bytes / HBM_BW
    k_s = cost.nvlink / NVLINK_BW + cost.ib / IB_BW
    dominant = max((("compute", c_s), ("memory", m_s),
                    ("collective", k_s)), key=lambda kv: kv[1])[0]
    ideal = model_flops / (total_devices * BF16_FLOPS)
    return RooflineTerms(
        flops=total, hbm_bytes=cost.hbm_bytes, nvlink_wire_bytes=cost.nvlink,
        ib_wire_bytes=cost.ib, compute_s=c_s, memory_s=m_s,
        collective_s=k_s, dominant=dominant, model_flops=model_flops,
        useful_ratio=model_flops / max(1.0, total * total_devices),
        mfu_bound=ideal / max(1e-12, max(c_s, m_s, k_s)),
        collectives=cost.collectives, flops_by_dtype=dict(cost.flops))


def mfu(model_flops: float, wall_s: float, peak: float = BF16_FLOPS,
        devices: int = 1) -> float:
    """Model FLOPs over what ``devices`` cards at ``peak`` could do in
    ``wall_s``."""
    return model_flops / (wall_s * peak * devices)


def count(fn, *args, **kwargs):
    """(fn's result, the :class:`WorkCounter` of its call)."""
    counter = WorkCounter()
    with counter:
        out = fn(*args, **kwargs)
    return out, counter
