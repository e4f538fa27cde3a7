"""Whisper-style encoder-decoder backbone (audio frontend stubbed).

The port of ``repro.models.encdec.EncDecModel``. As in the reference, the
conv frontend is a stub: the encoder takes precomputed frame embeddings (B,
n_audio_frames, d_model). The encoder stack runs full (non-causal)
self-attention with RoPE; each decoder layer runs causal self-attention,
cross-attention over the encoder output (k, v projected from it, no
RoPE), then the MLP; the unembedding is the token embedding.

The decode cache is ``{"self_k", "self_v"}`` (n_layers, B, max_len, KV, hd),
which grows with the generated tokens, and ``{"cross_k", "cross_v"}``
(n_layers, B, n_audio_frames, KV, hd), written once by the prefill from the
encoder output and only read after. ``attn_impl="kernel"`` takes the flash
kernel for all three attentions of a prefill (the encoder's, the decoder's
causal one, its cross-attention over T ≠ S keys).

Under mesh rules (:class:`repro_torch.launch.serve.ServeEngine` on a
``(data, model)`` mesh) a rank runs the encoder and decoder on its rows of
the batch, tensor parallel (the self and cross attention on the rank's
heads, the MLP on its columns, each residual stream in the act_seq layout
where its length splits over model; the encoder output gathered whole for
the cross attention's k, v); its self cache is its chunk of ``max_len``
where the rules shard ``cache_seq``, and its cross cache its chunk of the
frames where ``n_audio_frames`` tiles the model axis (whole otherwise), as
the reference's decode attention decides per cache; the logits come from
the tied table through :func:`repro_torch.models.layers.unembed`.

``loss`` encodes the frames, runs the decoder over the tokens without a
cache and takes the CE on the tied embedding (plain attention only, as the
reference trains); under mesh rules (the trainer's) both stacks run tensor
and sequence parallel as the prefill's do, and the CE is vocab-parallel on
the rank's table shard (:func:`repro_torch.models.losses.ce_loss`; the
whole table's loss), the collectives' transposes carrying the gradient
back to the shards. ``remat`` other
than ``"none"`` checkpoints each layer of both stacks whole where a
gradient is taken, as the reference's ``jax.checkpoint`` of its scan bodies
does for any such value: ``"dots"`` is a full checkpoint here.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.losses import ce_loss
from repro_torch.models.transformer import LM, remat_layer


def _enc_layer_defs(cfg: ModelConfig) -> L.ParamDefs:
    return {
        "ln1": L.norm_defs(cfg.d_model, cfg.norm_type),
        "attn": A.attn_defs(cfg),
        "ln2": L.norm_defs(cfg.d_model, cfg.norm_type),
        "mlp": L.mlp_defs(cfg.d_model, cfg.d_ff),
    }


def _dec_layer_defs(cfg: ModelConfig) -> L.ParamDefs:
    return {
        "ln1": L.norm_defs(cfg.d_model, cfg.norm_type),
        "self_attn": A.attn_defs(cfg),
        "ln_x": L.norm_defs(cfg.d_model, cfg.norm_type),
        "cross_attn": A.attn_defs(cfg),
        "ln2": L.norm_defs(cfg.d_model, cfg.norm_type),
        "mlp": L.mlp_defs(cfg.d_model, cfg.d_ff),
    }


class EncDecModel(LM):
    """``param_defs``/``init``/``load``, ``loss`` and ``prefill`` (batch
    ``{"tokens", "frames"}``, and ``"targets"`` for the loss),
    ``init_cache``, ``decode_step``, with the contract of
    :class:`repro_torch.models.transformer.LM`."""

    def __init__(self, cfg: ModelConfig, *, attn_impl: str = "kernel",
                 remat: str = "none"):
        if (cfg.family != "audio" or cfg.n_encoder_layers <= 0
                or cfg.n_audio_frames <= 0):
            raise ValueError(f"EncDecModel builds family 'audio' with "
                             f"encoder layers and audio frames, not "
                             f"{cfg.family!r} / {cfg.n_encoder_layers} / "
                             f"{cfg.n_audio_frames}")
        if attn_impl not in A.IMPLS:
            raise ValueError(f"unknown attention impl {attn_impl!r} "
                             f"({' | '.join(A.IMPLS)})")
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.remat = remat
        self.dtype = getattr(torch, cfg.dtype)

    # ----------------------------------------------------------- parameters
    def param_defs(self) -> L.ParamDefs:
        cfg = self.cfg
        return {
            "embed": L.embed_defs(cfg.vocab_size, cfg.d_model),
            "enc_layers": [_enc_layer_defs(cfg)] * cfg.n_encoder_layers,
            "enc_norm": L.norm_defs(cfg.d_model, cfg.norm_type),
            "dec_layers": [_dec_layer_defs(cfg)] * cfg.n_layers,
            "final_norm": L.norm_defs(cfg.d_model, cfg.norm_type),
        }

    def _norm(self, params: L.Params, x: torch.Tensor) -> torch.Tensor:
        return L.apply_norm(params, x, self.cfg.norm_type, self.cfg.norm_eps)

    def _logits_last(self, params: L.Params, x_last: torch.Tensor
                     ) -> torch.Tensor:
        return L.unembed(params["embed"], x_last, tied=True)

    def _cross_shards(self):
        """The model group the cross cache is split over under the current
        rules, or None (whole)."""
        return A.tile_shards(self.cfg.n_audio_frames)

    def _remat(self, fn):
        """``fn`` (a layer) checkpointed whole where a gradient is taken
        and ``remat`` is not ``"none"``, else as it is."""
        if self.remat == "none" or not torch.is_grad_enabled():
            return fn
        return remat_layer(fn, "full")

    # -------------------------------------------------------------- encoder
    def _enc_layer(self, lp: L.Params, x: torch.Tensor,
                   positions: torch.Tensor, seq=None) -> torch.Tensor:
        x = x + A.full_attention(lp["attn"], self._norm(lp["ln1"], x),
                                 positions, self.cfg, mask_mode="full",
                                 impl=self.attn_impl, seq=seq)
        return x + L.mlp(lp["mlp"], self._norm(lp["ln2"], x), seq)

    def encode(self, params: L.Params, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, T, D) → the encoder output (B, T, D), in the
        activations' dtype; under mesh rules that split T the encoder's
        residual is this rank's act_seq chunk, gathered after the final
        norm."""
        x = frames.to(dtype=self.dtype)
        b, t, _ = x.shape
        seq = L.act_shards(t)
        x = L.seq_chunk(x, seq)
        positions = torch.arange(t, device=x.device)[None].expand(b, t)
        layer = self._remat(self._enc_layer)
        for lp in L.layer_list(params["enc_layers"]):
            x = layer(lp, x, positions, seq)
        return L.seq_gather(self._norm(params["enc_norm"], x), seq)

    # -------------------------------------------------------------- decoder
    def _dec_layer(self, lp: L.Params, x: torch.Tensor,
                   positions: torch.Tensor, enc_out: torch.Tensor,
                   return_kv: bool = False, seq=None):
        """One decoder layer over a full sequence (with ``seq``, this rank's
        act_seq chunk of it; ``enc_out`` whole): x, or with ``return_kv``
        (x, (self k, self v, cross k, cross v))."""
        cfg = self.cfg
        out = A.full_attention(
            lp["self_attn"], self._norm(lp["ln1"], x), positions, cfg,
            mask_mode="causal", impl=self.attn_impl, return_kv=return_kv,
            seq=seq)
        if return_kv:
            out, sk, sv = out
        x = x + out
        out = A.full_attention(
            lp["cross_attn"], self._norm(lp["ln_x"], x), positions, cfg,
            mask_mode="full", kv_x=enc_out, impl=self.attn_impl,
            return_kv=return_kv, seq=seq)
        if return_kv:
            out, ck, cv = out
        x = x + out
        x = x + L.mlp(lp["mlp"], self._norm(lp["ln2"], x), seq)
        return (x, (sk, sv, ck, cv)) if return_kv else x

    def decode_fwd(self, params: L.Params, tokens: torch.Tensor,
                   enc_out: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) over the encoder output → the decoder's final
        hidden (B, S, D), with no cache (the loss's path); under mesh rules
        that split S the residual is this rank's act_seq chunk, gathered
        after the final norm."""
        b, s = tokens.shape
        seq = L.act_shards(s)
        x = L.embed(params["embed"], tokens, self.dtype, seq)
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        layer = self._remat(self._dec_layer)
        for lp in L.layer_list(params["dec_layers"]):
            x = layer(lp, x, positions, enc_out, False, seq)
        return L.seq_gather(self._norm(params["final_norm"], x), seq)

    # --------------------------------------------------------------- train
    def loss(self, params: L.Params, batch
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {"frames": (B, T, D), "tokens": (B, S) int, "targets":
        (B, S) int} → (mean next-token NLL, {"ce": it}), differentiable in
        the params (no ``loss_mask``, as in the reference)."""
        self._check_trainable()
        enc_out = self.encode(params, batch["frames"])
        x = self.decode_fwd(params, batch["tokens"], enc_out)
        loss = ce_loss(x, params["embed"]["embedding"], batch["targets"],
                       chunk=self.cfg.ce_chunk)
        return loss, {"ce": loss}

    # ------------------------------------------------------------- serving

    def prefill(self, params: L.Params, batch,
                cache: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {"tokens": (B,S) int, "frames": (B,T,D)} → (last-position
        logits (B,V), the decode cache): each decoder layer's self k, v at
        ``[i, :, :S]`` and its cross k, v over the T frames (under mesh
        rules the positions of this rank's chunks,
        :func:`repro_torch.models.attention.write_cache`), written into the
        given cache or a new one of self length S (its chunk)."""
        enc_out = self.encode(params, batch["frames"])
        b, s = batch["tokens"].shape
        seq = L.act_shards(s)
        x = L.embed(params["embed"], batch["tokens"], self.dtype, seq)
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        shards, cross = A.seq_shards(), self._cross_shards()
        if cache is None:
            cache = self.init_cache(b, s // (shards.k if shards else 1),
                                    dtype=x.dtype, device=x.device)
        for i, lp in enumerate(L.layer_list(params["dec_layers"])):
            x, (sk, sv, ck, cv) = self._dec_layer(lp, x, positions, enc_out,
                                                  return_kv=True, seq=seq)
            A.write_cache(cache["self_k"][i], sk, shards)
            A.write_cache(cache["self_v"][i], sv, shards)
            A.write_cache(cache["cross_k"][i], ck, cross)
            A.write_cache(cache["cross_v"][i], cv, cross)
        x = L.seq_gather(self._norm(params["final_norm"], x), seq)
        return self._logits_last(params, x[:, -1]), cache

    def init_cache(self, batch_size: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device=None) -> Dict[str, torch.Tensor]:
        """Self k, v of ``max_len`` positions; cross k, v of the frames, or
        under mesh rules that split them (:func:`repro_torch.models.
        attention.tile_shards`) this rank's chunk of them."""
        cfg = self.cfg
        own = A.init_cache(cfg, batch_size, max_len, cfg.n_layers, dtype,
                           device)
        shards = self._cross_shards()
        cross = A.init_cache(cfg, batch_size, cfg.n_audio_frames
                             // (shards.k if shards else 1), cfg.n_layers,
                             dtype, device)
        return {"self_k": own["k"], "self_v": own["v"],
                "cross_k": cross["k"], "cross_v": cross["v"]}

    def decode_step(self, params: L.Params, batch
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {"token": (B,1) int, "cache": {...}, "index": an int or
        an integer device tensor of one element}. The self cache is updated
        in place and the cache returned."""
        cfg = self.cfg
        x = L.embed(params["embed"], batch["token"], self.dtype)
        cache = batch["cache"]
        index = A.decode_index(batch["index"], x.device)
        cross = self._cross_shards()
        for i, lp in enumerate(L.layer_list(params["dec_layers"])):
            out, _, _ = A.decode_step_attention(
                lp["self_attn"], self._norm(lp["ln1"], x),
                cache["self_k"][i], cache["self_v"][i], index, cfg)
            x = x + out
            out, _, _ = A.decode_step_attention(
                lp["cross_attn"], self._norm(lp["ln_x"], x),
                cache["cross_k"][i], cache["cross_v"][i], index, cfg,
                cross=True, shards=cross)
            x = x + out
            x = x + L.mlp(lp["mlp"], self._norm(lp["ln2"], x))
        x = self._norm(params["final_norm"], x)
        return self._logits_last(params, x[:, -1]), cache
