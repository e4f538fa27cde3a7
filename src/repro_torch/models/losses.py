"""Cross-entropy with optional sequence chunking, the port of
``repro.models.losses``.

Full logits at LM scale are the single biggest activation. ``ce_loss`` with
``chunk`` > 0 loops over ``chunk``-sized slices of the sequence, computing
logits and log-softmax per slice under activation checkpointing (the
reference's ``jax.checkpoint`` inside its ``lax.scan``), so the backward
recomputes each slice instead of keeping all of them live: peak logits
memory drops S/chunk ×, for one extra logits product.

Under mesh rules (:func:`repro_torch.sharding.use_rules`) the loss is
vocab-parallel, as the reference's is where it constrains its logits to
``("batch", "seq", "vocab")``: ``x`` is the rank's rows of the final
hidden, whole along the sequence, and ``table`` its (V/M, D/Dn) shard. The
table's d_model slice is gathered over data once, before the chunks (1/M of
the table a rank; the gather's transpose, a sum-scatter, carries the
table's gradient back to the slice), where partial logits summed over data
would move B·S·V/M f32 values a chunk. Each chunk's logits are those of the
rank's vocab shard, in the activations' dtype, then f32; the shift is their
maximum over the model axis, which carries no gradient; the sums of the
exponentials and the targets' logits (each picked on the shard that owns
it, zero elsewhere) are summed over model in one f32 all-reduce, whose
transpose is the same all-reduce. Where the rules hold the vocab whole
(an odd vocab) the loss is the plain one on the gathered table.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import layers as L
from repro_torch.sharding import current_rules


def _ce_block(x: torch.Tensor, table: torch.Tensor, targets: torch.Tensor,
              valid: torch.Tensor, model=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, C, D) · table: (V, D), or with ``model`` (a group) this
    rank's (V/M, D) vocab shard · targets: (B, C) → (sum_nll, n_valid).
    Logits in the activations' dtype, then f32 (the reference's order)."""
    logits = (x @ table.to(x.dtype).T).float()
    if model is None:
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    else:
        v_loc = logits.shape[-1]
        shift = model.maximum(logits.detach().amax(dim=-1))
        ids = targets.long() - model.index * v_loc
        mine = (ids >= 0) & (ids < v_loc)
        picked = torch.gather(logits, -1, ids.clamp(0, v_loc - 1)[..., None])
        sums = model.sum(torch.stack(
            [torch.exp(logits - shift[..., None]).sum(dim=-1),
             torch.where(mine, picked[..., 0], 0.0)], dim=-1))
        lse = shift + torch.log(sums[..., 0])
        tgt = sums[..., 1]
    nll = (lse - tgt) * valid
    return torch.sum(nll), torch.sum(valid)


def ce_loss(x: torch.Tensor, table: torch.Tensor, targets: torch.Tensor,
            mask: Optional[torch.Tensor] = None, chunk: int = 0
            ) -> torch.Tensor:
    """Mean next-token NLL. x: (B, S, D) final hidden · table: (V, D), or
    under mesh rules the rank's shard of it (the module docstring).

    ``mask`` (B, S) ∈ {0,1} selects positions contributing to the loss.
    ``chunk`` > 0 loops over the seq dim in slices of that size (it must
    divide S; otherwise, or if S ≤ chunk, the loss is taken unchunked, as in
    the reference).
    """
    b, s, d = x.shape
    valid = (torch.ones((b, s), dtype=torch.float32, device=x.device)
             if mask is None else mask.float())
    model = None
    if current_rules() is not None:
        table = L.fsdp(table, 1, d)
        model = L.tp_group("vocab")

    if chunk <= 0 or s <= chunk or s % chunk != 0:
        total, count = _ce_block(x, table, targets, valid, model)
        return total / torch.clamp(count, min=1.0)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        t, c = checkpoint(_ce_block, x[:, sl], table, targets[:, sl],
                          valid[:, sl], model, use_reentrant=False)
        total = total + t
        count = count + c
    return total / torch.clamp(count, min=1.0)
