"""Plain PyTorch version of the SSD chunk-scan kernel: the exact recurrence.

The twin of ``repro.kernels.ssd.ref.ssd_scan``. Selective state space per
head, diagonal A, one B/C group shared by all heads (as in Mamba2):

    S_t = exp(Δ_t·A) · S_{t−1} + Δ_t · B_t x_tᵀ        S ∈ ℝ^{N×P}
    y_t = C_t · S_t                                     y ∈ ℝ^{P}

x: (B, L, H, P) · dt: (B, L, H) · a: (H,) (negative) · bm/cm: (B, L, N).
Returns (y (B, L, H, P) in x's dtype, final state (B, H, N, P) f32); all the
arithmetic is f32. It is the CPU path of
:func:`repro_torch.kernels.ssd.ops.ssd_scan` and the comparison the CUDA
kernel is held to on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             bm: torch.Tensor, cm: torch.Tensor,
             init_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    b, l, h, p = x.shape
    n = bm.shape[-1]
    x32, dt32, a32 = x.float(), dt.float(), a.float()
    bm32, cm32 = bm.float(), cm.float()
    s = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    ys = []
    for t in range(l):
        dtt = dt32[:, t]                                  # (B, H)
        decay = torch.exp(dtt * a32)
        s = s * decay[:, :, None, None]
        s = s + (dtt[:, :, None, None] * bm32[:, t, None, :, None]
                 * x32[:, t, :, None, :])                 # (B, H, N, P)
        ys.append(torch.einsum("bn,bhnp->bhp", cm32[:, t], s))
    y = torch.stack(ys, dim=1) if ys else x32.new_zeros((b, 0, h, p))
    return y.to(x.dtype), s
