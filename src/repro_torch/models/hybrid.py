"""Zamba2-style hybrid: Mamba2 backbone + a *shared* attention block.

The port of ``repro.models.hybrid.HybridModel``. One set of attention+MLP
parameters is reused at every application point: the backbone is split into
groups of ``shared_block_every`` Mamba2 layers, and after each full group the
shared block runs (the trailing partial group, if any, gets none). Each
application point has its own KV cache (shared weights, distinct state):
``attn_k``/``attn_v`` of shape ``(n_groups, B, max_len, KV, hd)``, beside the
Mamba2 layers' layer-stacked cache under ``"mamba"``.

The prefill's SSD scans take ``ssd_impl`` and its shared block ``attn_impl``
(``"kernel"``: the CUDA kernels on the card, forward only); ``loss`` needs
both ``"torch"``, the reference's training path. As in the reference, the
shared block takes the current hidden state (the published model's input
concatenation and LoRA adapters are left out there too), and ``remat`` (any
value but ``"none"``) checkpoints each Mamba2 layer where a gradient is
taken, never the shared block, whose gradient sums over its
``n_layers // shared_block_every`` uses.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.transformer import (LM, layer_decode, layer_defs,
                                            layer_fwd, remat_layer)


class HybridModel(LM):
    """``param_defs``/``init``/``load``, ``loss``, ``prefill``,
    ``init_cache``, ``decode_step``, with the contract of
    :class:`repro_torch.models.transformer.LM`."""

    def __init__(self, cfg: ModelConfig, *, attn_impl: str = "kernel",
                 ssd_impl: str = "kernel", remat: str = "none"):
        if cfg.family != "hybrid" or cfg.shared_block_every <= 0:
            raise ValueError(f"HybridModel builds family 'hybrid' with "
                             f"shared_block_every > 0, not {cfg.family!r} / "
                             f"{cfg.shared_block_every}")
        if attn_impl not in A.IMPLS:
            raise ValueError(f"unknown attention impl {attn_impl!r} "
                             f"({' | '.join(A.IMPLS)})")
        if ssd_impl not in S.SSD_IMPLS:
            raise ValueError(f"unknown ssd impl {ssd_impl!r} "
                             f"({' | '.join(S.SSD_IMPLS)})")
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.ssd_impl = ssd_impl
        self.remat = remat
        self.dtype = getattr(torch, cfg.dtype)
        self.n_groups = cfg.n_layers // cfg.shared_block_every

    # ----------------------------------------------------------- parameters
    def param_defs(self) -> L.ParamDefs:
        cfg = self.cfg
        defs = {
            "embed": L.embed_defs(cfg.vocab_size, cfg.d_model),
            "layers": [S.block_defs(cfg)] * cfg.n_layers,
            "shared": layer_defs(cfg),        # ONE attention+MLP block
            "final_norm": L.norm_defs(cfg.d_model, cfg.norm_type),
        }
        defs.update(L.unembed_defs(cfg.vocab_size, cfg.d_model,
                                   cfg.tie_embeddings))
        return defs

    # ------------------------------------------------------------- forward
    def _groups(self):
        """(layer range, whether the shared block follows) per group."""
        k, n = self.cfg.shared_block_every, self.cfg.n_layers
        return [(range(lo, min(lo + k, n)), lo // k < self.n_groups)
                for lo in range(0, n, k)]

    def backbone(self, params: L.Params, x: torch.Tensor,
                 return_cache: bool = False,
                 cache: Optional[Dict[str, torch.Tensor]] = None, seq=None):
        """x: (B, S, D) embedded inputs → final hidden (+ cache). With
        ``return_cache`` the Mamba2 layers' states and conv tails and each
        application point's k, v (at ``[g, :, :S]``; under rules that shard
        the cache's sequence the positions of this rank's chunk,
        :func:`repro_torch.models.attention.write_cache`) are written into
        the given cache, or a new one of length S (its chunk) in the
        activations' dtype. On a mesh the Mamba2 layers and the shared
        block run on this rank's rows, tensor parallel over the model axis
        (the Mamba2 mixers on the rank's heads, the shared attention and
        MLP on its heads and MLP columns), with ``seq`` the residual this
        rank's act_seq chunk between them; the final hidden is whole."""
        cfg = self.cfg
        b = x.shape[0]
        s = x.shape[1] * (seq.k if seq is not None else 1)
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        shards = A.seq_shards() if return_cache else None
        if return_cache and cache is None:
            cache = self.init_cache(b, s // (shards.k if shards else 1),
                                    dtype=x.dtype, device=x.device)
        layers = L.layer_list(params["layers"])
        fwd = S.block_fwd
        if self.remat != "none" and torch.is_grad_enabled() \
                and not return_cache:
            fwd = remat_layer(S.block_fwd, "full")
        for g, (group, shared) in enumerate(self._groups()):
            for i in group:
                x = fwd(layers[i], x, cfg, self.ssd_impl,
                        cache["mamba"] if return_cache else None, i, seq)
            if not shared:
                continue
            out = layer_fwd(params["shared"], x, positions, cfg, "causal", 0,
                            self.attn_impl, return_kv=return_cache, seq=seq)
            if return_cache:
                x, k, v = out
                A.write_cache(cache["attn_k"][g], k, shards)
                A.write_cache(cache["attn_v"][g], v, shards)
            else:
                x = out
        x = L.apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
        x = L.seq_gather(x, seq)
        return (x, cache) if return_cache else x

    # --------------------------------------------------------------- train
    def loss(self, params: L.Params, batch
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {"tokens": (B,S) int, "targets": (B,S) int} → (mean
        next-token NLL over every position, {"ce": it}), differentiable in
        the params: the reference's ``HybridModel.loss``, which takes no
        ``loss_mask``.

        Raises under ``attn_impl="kernel"`` or ``ssd_impl="kernel"``: both
        kernels are forward only."""
        if "kernel" in (self.attn_impl, self.ssd_impl):
            raise ValueError("HybridModel.loss needs attn_impl='torch' and "
                             "ssd_impl='torch': the flash-attention and SSD "
                             "kernels are forward only, and the reference "
                             "trains through its plain attention and "
                             "chunked scan")
        return self._ce(params, batch)

    # ------------------------------------------------------------- serving
    def init_cache(self, batch_size: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device=None) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        kv = A.init_cache(cfg, batch_size, max_len, self.n_groups, dtype,
                          device)
        return {"mamba": S.init_mamba_cache(cfg, batch_size, cfg.n_layers,
                                            dtype, device),
                "attn_k": kv["k"], "attn_v": kv["v"]}

    def decode_step(self, params: L.Params, batch
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {"token": (B,1) int, "cache": {...}, "index": an int or
        an integer device tensor of one element}. The cache is updated in
        place and returned."""
        cfg = self.cfg
        x = L.embed(params["embed"], batch["token"], self.dtype)
        cache = batch["cache"]
        index = A.decode_index(batch["index"], x.device)
        layers = L.layer_list(params["layers"])
        for g, (group, shared) in enumerate(self._groups()):
            for i in group:
                x = S.block_decode(layers[i], x, cache["mamba"], i, cfg)
            if shared:
                x, _, _ = layer_decode(params["shared"], x,
                                       cache["attn_k"][g], cache["attn_v"][g],
                                       index, cfg)
        x = L.apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
        return self._logits_last(params, x[:, -1]), cache
