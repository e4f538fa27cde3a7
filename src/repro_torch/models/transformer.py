"""Decoder-only transformer LM (dense and MoE) and the prefix-LM VLM.

The port of ``repro.models.transformer.DecoderLM`` with the reference's
duck-typed model API, parameters passed in:

    param_defs()                          → nested dict of Param
    init(generator, dtype=None)           → ParamTree (the params)
    load(state_dict, device, dtype=None)  → ParamTree
    positions_before()                    → cache positions before a prompt
    loss(params, batch)                   → (scalar, metrics dict)
    prefill(params, batch)                → (last_logits, cache)
    decode_step(params, batch)            → (logits, cache)
    init_cache(batch, max_len, dtype, …)  → cache dict

The layer stack is a Python loop over ``params["layers"]``: an
``nn.ModuleList`` or list of per-layer params, or the reference's stacked
layout (a dict of ``(n_layers, …)`` leaves, read as per-layer views; the
reference scans it), and ``remat`` checkpoints each layer as the
reference's ``_maybe_remat`` does (:func:`remat_layer`). The MoE family's
layers take :func:`repro_torch.models.moe.moe_ffn` in place of the MLP, and
its loss adds the mean over the layers of their load-balance terms;
:class:`PrefixVLM` puts stub patch embeddings before the text under a
prefix-LM mask and takes its loss over the text positions.

Under mesh rules (the serving engine's on a ``(data, model)`` mesh,
:class:`repro_torch.launch.serve.ServeEngine`, and the trainer's,
:func:`repro_torch.sharding.training_rules`) a rank holds its data shard
of the batch (the VLM's patches too) and its shard of every weight. A
prefill or a training sequence whose length splits over the model axis
keeps the residual stream
in the act_seq layout between layers (:func:`repro_torch.models.layers.
act_shards`: the rank's chunk of the sequence, from the embedding to the
final norm, where it is gathered for the logits); the attention (the flash
kernel on the rank's heads) and the dense MLP are tensor parallel, the MoE
takes the chunk as its token shard (:func:`repro_torch.models.moe.
moe_ffn`), and the prefill writes this rank's chunk of the cache. A decode
step's one token is whole on every rank: its products are tensor parallel,
their partial sums summed over model. The loss takes the vocab-parallel CE
on the rank's table shard (:func:`repro_torch.models.losses.ce_loss`); the
collectives' transposes carry the gradient back to every shard.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.config.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.losses import ce_loss
from repro_torch.sharding import current_rules, use_rules


REMAT_POLICIES = ("none", "full", "dots")
# what "dots" keeps: the 2-D matrix products, the products with no batch
# dims of JAX's dots_with_no_batch_dims_saveable (the batched ones are bmm)
_SAVED_PRODUCTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def remat_layer(fn: Callable, remat: str) -> Callable:
    """``fn`` (a layer's forward) under the reference's ``_maybe_remat``
    policy: ``"full"`` checkpoints it (the backward keeps its inputs and
    recomputes the rest); ``"dots"`` keeps the outputs of its 2-D matrix
    products as well and recomputes everything else, the batched products
    too; any other value leaves ``fn`` as it is. Non-reentrant, as
    ``torch.autograd.grad`` needs, and bitwise the gradient of ``fn``. The
    mesh rules current at the call go with the recompute, which the
    backward may run on another thread (the card's autograd thread)."""
    rules = current_rules()
    if rules is not None and remat in ("full", "dots"):
        fn = functools.partial(_under_rules, rules, fn)
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _SAVED_PRODUCTS))
    return fn


def _under_rules(rules, fn: Callable, *args):
    with use_rules(rules):
        return fn(*args)


def layer_defs(cfg: ModelConfig) -> L.ParamDefs:
    defs: L.ParamDefs = {
        "ln1": L.norm_defs(cfg.d_model, cfg.norm_type),
        "attn": A.attn_defs(cfg),
        "ln2": L.norm_defs(cfg.d_model, cfg.norm_type),
    }
    if cfg.is_moe:
        defs["moe"] = M.moe_defs(cfg)
    else:
        defs["mlp"] = L.mlp_defs(cfg.d_model, cfg.d_ff)
    return defs


def ffn(lp: L.Params, h: torch.Tensor, cfg: ModelConfig,
        return_aux: bool = False, seq=None):
    """The block's feed-forward: the MoE layer or the dense MLP, on ``h``
    whole or (``seq``) this rank's act_seq chunk. With ``return_aux``,
    (out, the layer's f32 load-balance term: 0 for the MLP)."""
    if cfg.is_moe:
        return M.moe_ffn(lp["moe"], h, cfg, return_aux=return_aux, seq=seq)
    out = L.mlp(lp["mlp"], h, seq)
    if return_aux:
        return out, torch.zeros((), dtype=torch.float32, device=h.device)
    return out


def layer_fwd(lp: L.Params, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig, mask_mode: str, prefix_len: int,
              attn_impl: str, return_kv: bool = False,
              return_aux: bool = False, seq=None):
    """One transformer block on ``x`` (whole, or with ``seq`` this rank's
    act_seq chunk; ``positions`` whole). Returns x, or the tuple of x, the
    aux term if ``return_aux`` and k, v if ``return_kv`` (the reference's
    order)."""
    h = L.apply_norm(lp["ln1"], x, cfg.norm_type, cfg.norm_eps)
    attn_out = A.full_attention(lp["attn"], h, positions, cfg,
                                mask_mode=mask_mode, prefix_len=prefix_len,
                                impl=attn_impl, return_kv=return_kv, seq=seq)
    if return_kv:
        attn_out, k, v = attn_out
    x = x + attn_out
    h = L.apply_norm(lp["ln2"], x, cfg.norm_type, cfg.norm_eps)
    out = ffn(lp, h, cfg, return_aux, seq)
    if return_aux:
        out, aux = out
    x = x + out
    outs = (x,) + ((aux,) if return_aux else ()) + ((k, v) if return_kv
                                                     else ())
    return outs if len(outs) > 1 else x


def layer_decode(lp: L.Params, x: torch.Tensor, cache_k: torch.Tensor,
                 cache_v: torch.Tensor, index: torch.Tensor,
                 cfg: ModelConfig):
    """One block, single-token decode at ``index``, a (1,) device tensor
    (:func:`repro_torch.models.attention.decode_index`). Returns (x,
    cache_k, cache_v); the caches are updated in place."""
    h = L.apply_norm(lp["ln1"], x, cfg.norm_type, cfg.norm_eps)
    attn_out, cache_k, cache_v = A.decode_step_attention(
        lp["attn"], h, cache_k, cache_v, index, cfg)
    x = x + attn_out
    h = L.apply_norm(lp["ln2"], x, cfg.norm_type, cfg.norm_eps)
    return x + ffn(lp, h, cfg), cache_k, cache_v


class LM:
    """What the port's LMs share: params drawn or loaded against
    ``param_defs()``, and a prefill through ``backbone`` to the last
    position's logits. A subclass sets ``cfg`` and ``dtype`` and defines
    ``param_defs``, ``backbone`` (or its own ``prefill``), ``init_cache``
    and ``decode_step``."""

    cfg: ModelConfig
    dtype: torch.dtype

    def init(self, gen: torch.Generator,
             dtype: Optional[torch.dtype] = None) -> L.ParamTree:
        """Fresh params drawn from ``gen``, on its device, in ``dtype``
        (``param_dtype`` by default). Each leaf is drawn in f32 and cast
        before the next is drawn, so the values are those of a draw in f32
        cast afterwards, without an f32 copy of the whole tree."""
        return L.ParamTree(L.init_params(
            self.param_defs(), gen,
            dtype or getattr(torch, self.cfg.param_dtype)))

    def load(self, state_dict: Mapping[str, torch.Tensor], device,
             dtype: Optional[torch.dtype] = None) -> L.ParamTree:
        """Params from a state dict (keys ``embed.embedding``,
        ``layers.<i>.attn.wq``, …): every key and shape is checked against
        :meth:`param_defs`, the values are cast to ``dtype``
        (``param_dtype`` by default)."""
        params = L.ParamTree(L.empty_params(
            self.param_defs(), dtype or getattr(torch, self.cfg.param_dtype),
            device))
        params.load_state_dict(state_dict, strict=True)
        return params

    def positions_before(self) -> int:
        """Cache positions a prefill fills before the prompt's tokens (the
        VLM's image prefix); a prompt of S tokens decodes from this + S."""
        return 0

    def _embed_inputs(self, params: L.Params, batch, seq=None
                      ) -> torch.Tensor:
        """The backbone's input (B, S, D), or with ``seq`` this rank's
        act_seq chunk of it."""
        return L.embed(params["embed"], batch["tokens"], self.dtype, seq)

    def _train_seq(self, batch):
        """The act_seq split of a training sequence (the model group, or
        None): :func:`repro_torch.models.layers.act_shards` of its length,
        the positions before the tokens included."""
        return L.act_shards(self.positions_before()
                            + batch["tokens"].shape[1])

    def _ce(self, params: L.Params, batch, mask=None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(mean next-token NLL of ``batch``'s targets, {"ce": it}) through
        ``backbone``, over the positions of ``mask`` (all without one);
        under mesh rules the residual in the act_seq layout where the
        sequence splits."""
        seq = self._train_seq(batch)
        x = self.backbone(params, self._embed_inputs(params, batch, seq),
                          seq=seq)
        loss = self._nll(params, x, batch["targets"], mask)
        return loss, {"ce": loss}

    def _check_trainable(self) -> None:
        if self.attn_impl == "kernel":
            raise ValueError(f"{type(self).__name__}.loss needs "
                             f"attn_impl='torch': the flash-attention kernel "
                             f"is forward only, and the reference trains "
                             f"with its plain attention (attn_impl='jnp')")

    def _nll(self, params: L.Params, x: torch.Tensor, targets: torch.Tensor,
             mask=None) -> torch.Tensor:
        """The mean NLL of ``targets`` under final hidden ``x`` (chunked
        by ``ce_chunk``; vocab-parallel on a rank's table shard under mesh
        rules, :func:`repro_torch.models.losses.ce_loss`)."""
        table = params["embed"]["embedding"] if self.cfg.tie_embeddings \
            else params["out_embedding"]
        return ce_loss(x, table, targets, mask=mask, chunk=self.cfg.ce_chunk)

    def _logits_last(self, params: L.Params, x_last: torch.Tensor
                     ) -> torch.Tensor:
        tied = self.cfg.tie_embeddings
        return L.unembed(params["embed"] if tied else params, x_last, tied)

    def prefill(self, params: L.Params, batch,
                cache: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {"tokens": (B,S) int} → (last-position logits (B,V),
        the decode cache). Given a ``cache`` (e.g. from :meth:`init_cache`
        at ``max_len``), the prefill writes into it and returns it. Under
        mesh rules that split its length the residual runs in the act_seq
        layout (:func:`repro_torch.models.layers.act_shards`)."""
        seq = L.act_shards(self.positions_before()
                           + batch["tokens"].shape[1])
        x = self._embed_inputs(params, batch, seq)
        x, cache = self.backbone(params, x, return_cache=True, cache=cache,
                                 seq=seq)
        return self._logits_last(params, x[:, -1]), cache


class DecoderLM(LM):
    """Dense or MoE decoder-only LM. ``attn_impl``: ``"kernel"`` (the CUDA
    flash-attention kernel on the card; forward only, so serving only) or
    ``"torch"`` (the plain twins of the reference's ``"jnp"``, which the
    reference trains with). ``remat`` (``"none"``, ``"full"``, ``"dots"``)
    checkpoints each layer where a gradient is taken (:func:`remat_layer`).
    Its cache is ``{"k","v"}: (L,B,S,KV,hd)``."""

    families = ("dense", "moe")

    def __init__(self, cfg: ModelConfig, *, attn_impl: str = "kernel",
                 remat: str = "none"):
        if cfg.family not in self.families:
            raise ValueError(f"{type(self).__name__} builds families "
                             f"{self.families}, not {cfg.family!r}")
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
        defs = {
            "embed": L.embed_defs(cfg.vocab_size, cfg.d_model),
            "layers": [layer_defs(cfg)] * cfg.n_layers,
            "final_norm": L.norm_defs(cfg.d_model, cfg.norm_type),
        }
        defs.update(L.unembed_defs(cfg.vocab_size, cfg.d_model,
                                   cfg.tie_embeddings))
        return defs

    # ------------------------------------------------------------- forward
    def backbone(self, params: L.Params, x: torch.Tensor,
                 return_cache: bool = False,
                 cache: Optional[Dict[str, torch.Tensor]] = None,
                 return_aux: bool = False, seq=None):
        """x: (B, S, D) embedded inputs (with ``seq``, this rank's act_seq
        chunk of them; the final hidden is gathered whole after the final
        norm) → final hidden (+ cache), causal, or
        causal ∪ the first :meth:`positions_before` positions (the VLM's
        prefix-LM mask). With ``return_cache`` each layer's k, v is written into
        ``cache[name][i, :, :S]`` (under rules that shard the cache's
        sequence, the positions of this rank's chunk,
        :func:`repro_torch.models.attention.write_cache`): the given cache
        (e.g. of ``max_len``), or one of length S (its chunk) in the
        activations' dtype. With ``return_aux``
        (training) it returns (final hidden, the mean over the layers of
        their load-balance terms), each layer's term going through its
        checkpoint beside x.
        """
        cfg = self.cfg
        b = x.shape[0]
        s = x.shape[1] * (seq.k if seq is not None else 1)
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        prefix_len = self.positions_before()
        mask_mode = "prefix" if prefix_len else "causal"
        shards = A.seq_shards() if return_cache else None
        if return_cache and cache is None:
            cache = self.init_cache(b, s // (shards.k if shards else 1),
                                    dtype=x.dtype, device=x.device)
        fwd = (remat_layer(layer_fwd, self.remat)
               if torch.is_grad_enabled() and not return_cache else layer_fwd)
        auxes = []
        for i, lp in enumerate(L.layer_list(params["layers"])):
            out = fwd(lp, x, positions, cfg, mask_mode, prefix_len,
                      self.attn_impl, return_cache, return_aux, seq)
            if return_cache:
                x, k, v = out
                A.write_cache(cache["k"][i], k, shards)
                A.write_cache(cache["v"][i], v, shards)
            elif return_aux:
                x, aux = out
                auxes.append(aux)
            else:
                x = out
        x = L.apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
        x = L.seq_gather(x, seq)
        if return_cache:
            return x, cache
        if return_aux:
            return x, torch.stack(auxes).mean()
        return x

    # --------------------------------------------------------------- train
    def loss(self, params: L.Params, batch
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {"tokens": (B,S) int, "targets": (B,S) int[, "loss_mask"]}
        → (mean next-token NLL, {"ce": it}), differentiable in the params;
        for the MoE family (ce + ``load_balance_coef`` · aux, {"ce", "aux"}),
        aux the mean over the layers of their load-balance terms.

        Raises under ``attn_impl="kernel"``: the flash kernel has no backward
        (nor has the reference's, which trains with ``attn_impl="jnp"``), so
        its attention would get no gradient."""
        self._check_trainable()
        if not self.cfg.is_moe:
            return self._ce(params, batch, batch.get("loss_mask"))
        seq = self._train_seq(batch)
        x, aux = self.backbone(params,
                               self._embed_inputs(params, batch, seq),
                               return_aux=True, seq=seq)
        ce = self._nll(params, x, batch["targets"], batch.get("loss_mask"))
        return (ce + self.cfg.moe.load_balance_coef * aux,
                {"ce": ce, "aux": aux})


    # ------------------------------------------------------------- serving
    def init_cache(self, batch_size: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device=None) -> Dict[str, torch.Tensor]:
        return A.init_cache(self.cfg, batch_size, max_len, self.cfg.n_layers,
                            dtype, device)

    def decode_step(self, params: L.Params, batch
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {"token": (B,1) int, "cache": {...}, "index": an int or
        an integer device tensor of one element}. The cache is updated in
        place and returned."""
        cfg = self.cfg
        x = L.embed(params["embed"], batch["token"], self.dtype)
        cache = batch["cache"]
        index = A.decode_index(batch["index"], x.device)
        for i, lp in enumerate(L.layer_list(params["layers"])):
            x, _, _ = layer_decode(lp, x, cache["k"][i], cache["v"][i],
                                   index, cfg)
        x = L.apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
        return self._logits_last(params, x[:, -1]), cache


class PrefixVLM(DecoderLM):
    """PaliGemma-style VLM: stub patch embeddings (B, P, D) as a prefix
    before the text, a decoder backbone, prefix-LM attention (causal ∪ the
    P image positions: bidirectional over the prefix). A prefill of S text
    tokens fills P + S cache positions and gives the last text position's
    logits; decoding goes on from position P + S. ``batch["patches"]`` is
    cast to the activations' dtype, as in the reference. On a mesh the
    patches are this rank's rows, beside its rows of the text, and the P +
    S positions fill the seq-sharded cache's chunks across the prefix's
    end (the mask the one :func:`repro_torch.models.attention.make_mask`
    gives)."""

    families = ("vlm",)

    def positions_before(self) -> int:
        return self.cfg.num_image_tokens

    def _embed_inputs(self, params: L.Params, batch, seq=None
                      ) -> torch.Tensor:
        text = L.embed(params["embed"], batch["tokens"], self.dtype)
        patches = batch["patches"].to(device=text.device, dtype=self.dtype)
        return L.seq_chunk(torch.cat([patches, text], dim=1), seq)

    def loss(self, params: L.Params, batch
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {"tokens": (B, S_text) int, "targets": (B, S_text) int,
        "patches": (B, P, D)} → (mean NLL over the text positions, {"ce":
        it}); no ``loss_mask``, as in the reference."""
        self._check_trainable()
        seq = self._train_seq(batch)
        x = self.backbone(params, self._embed_inputs(params, batch, seq),
                          seq=seq)
        loss = self._nll(params, x[:, self.positions_before():],
                         batch["targets"])
        return loss, {"ce": loss}
