"""Cross-entropy with optional sequence chunking, the port of
``repro.models.losses``.

Full logits at LM scale are the single biggest activation. ``ce_loss`` with
``chunk`` > 0 loops over ``chunk``-sized slices of the sequence, computing
logits and log-softmax per slice under activation checkpointing (the
reference's ``jax.checkpoint`` inside its ``lax.scan``), so the backward
recomputes each slice instead of keeping all of them live: peak logits
memory drops S/chunk ×, for one extra logits product.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint


def _ce_block(x: torch.Tensor, table: torch.Tensor, targets: torch.Tensor,
              valid: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, C, D) · table: (V, D) · targets: (B, C) → (sum_nll, n_valid).
    Logits in the activations' dtype, then f32 (the reference's order)."""
    logits = (x @ table.to(x.dtype).T).float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = (lse - tgt) * valid
    return torch.sum(nll), torch.sum(valid)


def ce_loss(x: torch.Tensor, table: torch.Tensor, targets: torch.Tensor,
            mask: Optional[torch.Tensor] = None, chunk: int = 0
            ) -> torch.Tensor:
    """Mean next-token NLL. x: (B, S, D) final hidden · table: (V, D).

    ``mask`` (B, S) ∈ {0,1} selects positions contributing to the loss.
    ``chunk`` > 0 loops over the seq dim in slices of that size (it must
    divide S; otherwise, or if S ≤ chunk, the loss is taken unchunked, as in
    the reference).
    """
    b, s, _ = x.shape
    valid = (torch.ones((b, s), dtype=torch.float32, device=x.device)
             if mask is None else mask.float())

    if chunk <= 0 or s <= chunk or s % chunk != 0:
        total, count = _ce_block(x, table, targets, valid)
        return total / torch.clamp(count, min=1.0)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        t, c = checkpoint(_ce_block, x[:, sl], table, targets[:, sl],
                          valid[:, sl], use_reentrant=False)
        total = total + t
        count = count + c
    return total / torch.clamp(count, min=1.0)
