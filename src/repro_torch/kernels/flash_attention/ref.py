"""Plain PyTorch version of the flash-attention kernel.

The twin of ``repro.kernels.flash_attention.ref.attention`` (grouped-query
attention with an f32 softmax), with the full mask semantics of the TPU
kernel ``_fa_kernel``: ``causal`` attends to ``col ≤ row ∨ col < prefix_len``;
``causal=False`` with ``prefix_len > 0`` to the keys below ``prefix_len``
only; ``causal=False, prefix_len=0`` to every key. It is the CPU path of
:func:`repro_torch.kernels.flash_attention.ops.flash_attention` and the
comparison the CUDA kernel is held to on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def visible(sq: int, sk: int, causal: bool, prefix_len: int,
            device=None) -> torch.Tensor:
    """Boolean (sq, sk) mask of the (row, col) pairs that attend."""
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    if causal:
        return (cols <= rows) | (cols < prefix_len)
    if prefix_len:
        return (cols < prefix_len).expand(sq, sk)
    return torch.ones(sq, sk, dtype=torch.bool, device=device)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, prefix_len: int = 0) -> torch.Tensor:
    """q: (B, H, Sq, dh) · k/v: (B, KV, Sk, dh) → (B, H, Sq, dh), the
    reference's layout. Scores, softmax and the product are in f32; the
    output is in q's dtype."""
    b, h, sq, dh = q.shape
    kv, sk = k.shape[1], k.shape[2]
    qg = q.reshape(b, kv, h // kv, sq, dh).float()
    s = torch.einsum("bkgqd,bktd->bkgqt", qg, k.float()) / (dh ** 0.5)
    mask = visible(sq, sk, causal, prefix_len, q.device)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,bktd->bkgqd", p, v.float())
    return o.reshape(b, h, sq, dh).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, prefix_len: int = 0) -> torch.Tensor:
    """q: (B, S, H, dh) · k/v: (B, T, KV, dh) → (B, S, H, dh): the kernel's
    layout, through :func:`attention`."""
    out = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    causal=causal, prefix_len=prefix_len)
    return out.transpose(1, 2)
