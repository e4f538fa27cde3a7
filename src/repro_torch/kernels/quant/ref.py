"""Plain PyTorch version of the int8 quant kernels.

The counterpart of ``repro.kernels.quant.ref`` (the oracle, which divides by
the scale), with an optional leading row dim whose rows each get their own
scale. It is the CPU path of :mod:`repro_torch.kernels.quant.ops` and the
comparison the CUDA kernel is held to on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch

QMAX = 127


def _row_view(scale: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-row scale ``(R,)`` shaped to broadcast over ``(R, ...)``; a
    per-tensor (0-dim) scale as it is."""
    return scale.reshape(scale.shape + (1,) * (ndim - scale.dim()))


def amax(x: torch.Tensor, rows: bool = False) -> torch.Tensor:
    """max |x| in f32: over all of x (0-dim), or with ``rows`` over each row
    of the leading dim (``(R,)``); a NaN propagates."""
    x32 = x.float()
    if rows:
        return x32.abs().reshape(x32.shape[0], -1).amax(dim=1)
    return x32.abs().amax()


def quantize(x: torch.Tensor, rows: bool = False
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (float) → (q int8 of x's shape, scale f32): one scale over all of x
    (0-dim), or with ``rows`` one per row of the leading dim (``(R,)``).

    A NaN propagates to the scale (``amax`` and ``clamp`` keep it) and an
    infinity makes it infinite; the q of such a tensor or row are all 0, so
    it dequantizes to NaN, as the oracle's does."""
    return quantize_given_amax(x, amax(x, rows))


def quantize_given_amax(x: torch.Tensor, amax_: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`quantize` with the amax given (0-dim, or ``(R,)`` a row): the
    scale ``max(amax, 1e-12) / 127`` and the pack. With the whole leaf's
    amax (the max of its shards' :func:`amax`) a shard packs to its block of
    the whole leaf's payload, bit for bit."""
    x32 = x.float()
    # divide by a tensor: on CUDA, PyTorch applies a Python-scalar divisor
    # as a product with its reciprocal, one ulp off the oracle's division
    scale = torch.clamp(amax_, min=1e-12) / torch.full_like(amax_, QMAX)
    r = torch.clamp(torch.round(x32 / _row_view(scale, x32.dim())),
                    -QMAX, QMAX)
    # a NaN quotient (a NaN x, or any x over a NaN or an infinite scale)
    # packs to 0, as the oracle's cast gives on the CPU; PyTorch's cast of a
    # NaN to int8 is not defined, so it is not left to it
    q = torch.where(torch.isnan(r), torch.zeros_like(r), r).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``q · scale`` in f32; a ``(R,)`` scale applies row by row."""
    return q.float() * _row_view(scale, q.dim())
