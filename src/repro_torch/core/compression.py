"""Error-feedback int8 compression for the sync exchange, the port of
``repro.core.compression``.

At an MSF sync point the replicas exchange a parameter *delta* (the local
drift since the last sync). Quantizing that delta to int8 with per-tensor
scales cuts the wire bytes 4× against f32; the quantization error is carried
forward in an error-feedback buffer so it is re-submitted at the next sync.

Wire format per leaf: ``(q int8[shape], scale f32)``. ``quantize`` and
``dequantize`` go to :mod:`repro_torch.kernels.quant.ops` (``impl="kernel"``,
the default: the CUDA kernel on CUDA tensors, its plain version on CPU
tensors) or to the plain version itself (``impl="torch"``, the comparison
run). Both give the reference's int8 payload bit for bit.

On one card the K replicas are a leading dim of every leaf, so the functions
take ``rows=True`` for a stacked ``(K, …)`` leaf: each replica's row gets its
own scale, as each replica quantizes its own leaf in the reference. Across
processes each rank holds one replica, a ``(1, …)`` leaf, and quantizes it
alone (through the quant kernel on the card); the payloads meet in
:func:`allgather_mean_dequant`.

On a mesh with a model axis a rank holds only its block of most leaves
(:func:`repro_torch.sharding.train_specs`). Such
a leaf is quantized with the whole leaf's scale, as the reference's
per-tensor ``amax`` over a sharded leaf is global: the block's amax
(:func:`repro_torch.kernels.quant.ops.amax`), its max over the ranks that
hold the other blocks (``shards``, a tree of
:class:`repro_torch.core.collectives.Shards`; exact), then the pack with it
(``quantize_given_amax``). The blocks' payloads put back together are
bitwise the whole leaf's quantization.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import tree as T
from repro_torch.core import collectives as CL
from repro_torch.kernels.quant import ops as quant_ops
from repro_torch.kernels.quant import ref as quant_ref

IMPLS = ("kernel", "torch")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown quant impl {impl!r} ({' | '.join(IMPLS)})")


def quantize(x: torch.Tensor, *, rows: bool = False, impl: str = "kernel"
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (float) → (q int8, scale f32). Symmetric per tensor, or per row of
    the leading dim with ``rows``."""
    _check_impl(impl)
    x32 = x.float()
    if impl == "torch":
        return quant_ref.quantize(x32, rows=rows)
    return quant_ops.quantize(x32.contiguous(), rows=rows)


def dequantize(q: torch.Tensor, scale: torch.Tensor, *,
               impl: str = "kernel") -> torch.Tensor:
    _check_impl(impl)
    if impl == "torch":
        return quant_ref.dequantize(q, scale)
    return quant_ops.dequantize(q, scale)


def init_error_feedback(params) -> Any:
    return T.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device), params)


def quantize_shard(x: torch.Tensor, shards: "CL.Shards", *,
                   rows: bool = False, impl: str = "kernel",
                   residual: bool = False):
    """:func:`quantize` of this rank's block of a leaf held split as
    ``shards`` says, with the whole leaf's scale (the module docstring);
    ``residual`` adds ``x − dequantize(q, scale)``. A leaf held whole
    (``shards.split`` empty) takes :func:`quantize` itself."""
    _check_impl(impl)
    x32 = x.float().contiguous()
    if not shards.split:
        if impl == "torch":
            q, s = quant_ref.quantize(x32, rows=rows)
            return (q, s, x32 - quant_ref.dequantize(q, s)) if residual \
                else (q, s)
        return quant_ops.quantize(x32, rows=rows, residual=residual)
    if impl == "torch":
        q, s = quant_ref.quantize_given_amax(
            x32, shards.whole_max(quant_ref.amax(x32, rows)))
        return (q, s, x32 - quant_ref.dequantize(q, s)) if residual \
            else (q, s)
    whole = shards.whole_max(quant_ops.amax(x32, rows=rows))
    return quant_ops.quantize_given_amax(x32, whole, rows=rows,
                                         residual=residual)


def compress_tree(delta, ef, *, rows: bool = False, impl: str = "kernel",
                  shards=None):
    """(delta, ef) → (q_tree, scale_tree, new_ef). delta+ef is quantized
    (on the kernel path the residual is written by the quantize pass
    itself, bitwise the same); ``shards`` (a tree like delta's, or None:
    every leaf whole) how the ranks of a replica hold each leaf."""
    _check_impl(impl)
    flat, unflatten = T.flatten(delta)
    held = T.leaves(shards) if shards is not None else [CL.WHOLE] * len(flat)
    out = [quantize_shard(d.float() + e, sh, rows=rows, impl=impl,
                          residual=True)
           for d, e, sh in zip(flat, T.leaves(ef), held)]
    return tuple(unflatten([o[i] for o in out]) for i in range(3))


def allgather_mean_dequant(q_tree, s_tree, *, impl: str = "kernel",
                           rep=CL.STACKED):
    """The replica mean of the dequantized int8 payloads.

    In the reference every replica all-gathers the others' ``(q, scale)``
    over the replica mesh axis and averages their dequantized values. On one
    card (``rep`` the stacked axis) the K replicas' payloads already lie
    stacked in ``(K, …)`` leaves with ``(K,)`` scales, so the gather is the
    stacked leaf itself. Across processes (``rep`` a
    :class:`repro_torch.core.collectives.Group`) the int8 payloads and the
    f32 scales are all-gathered in rank order. Either way each leaf is
    dequantized row by row, all K in that fixed order, and averaged over
    dim 0, kept as a ``(1, …)`` dim that broadcasts to every replica.
    """
    return T.map(lambda q, s: mean_dequant(q, s, impl=impl, rep=rep),
                 q_tree, s_tree)


def mean_dequant(q: torch.Tensor, scale: torch.Tensor, *,
                 impl: str = "kernel", rep=CL.STACKED) -> torch.Tensor:
    """One leaf of :func:`allgather_mean_dequant`."""
    return dequantize(rep.gather(q), rep.gather(scale),
                      impl=impl).mean(dim=0, keepdim=True)
