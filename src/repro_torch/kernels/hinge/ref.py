"""Plain PyTorch version of the hinge block-subgradient kernel.

The counterpart of ``repro.kernels.hinge.ref``, with an optional leading
worker dim. It is the CPU path of :func:`repro_torch.kernels.hinge.ops.hinge_block_grad`
and the comparison the CUDA kernel is held to on the card.
"""
from __future__ import annotations

import torch


def hinge_block_grad(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                     c: float) -> torch.Tensor:
    """Mean subgradient ``w − C·mean_i(violᵢ·yᵢ·xᵢ)`` of a block.

    x ``(n, d)`` · y ``(n,)`` · w ``(d,)`` → ``(d,)``; or, batched over K
    workers, x ``(K, n, d)`` · y ``(K, n)`` · w ``(d,)`` (shared) or
    ``(K, d)`` (per worker) → ``(K, d)``.
    """
    # the comparison on the card is a full-fp32 product, never TF32; a
    # caller's lower precision is restored for its later products
    precision = torch.get_float32_matmul_precision()
    if precision != "highest":
        torch.set_float32_matmul_precision("highest")
    try:
        margins = 1.0 - y * (x @ w.unsqueeze(-1)).squeeze(-1)
        viol = (margins > 0).to(w.dtype)
        acc = ((viol * y).unsqueeze(-2) @ x).squeeze(-2)
    finally:
        if precision != "highest":
            torch.set_float32_matmul_precision(precision)
    return w - c * acc / x.shape[-2]
