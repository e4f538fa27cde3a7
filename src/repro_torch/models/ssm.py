"""Mamba2 (state-space duality) blocks and the attention-free SSM LM.

The port of ``repro.models.ssm``. Block structure (Mamba2, arXiv:2405.21060):

    x, z, B, C, Δ = projections of the input
    x, B, C       = causal depthwise conv (width 4) + SiLU
    y             = SSD(x·heads, Δ, A, B, C) + D∘x          (chunked scan)
    out           = out_proj( RMSNorm(y ⊙ SiLU(z)) )

The prefill's scan is selected by ``ssd_impl``: ``"kernel"`` (the default)
goes through :func:`repro_torch.kernels.ssd.ops.ssd_scan`, the CUDA kernel on
CUDA tensors and the exact recurrence on CPU tensors; ``"torch"`` takes
:func:`ssd_chunked`, the twin of the reference's jnp chunked scan (the
reference's model path never calls its Pallas kernel). Decode is the exact
O(1)-per-step recurrence on a (B, H, N, P) state, as in the reference.

The cache is the reference's layer-stacked layout, ``{"ssm": (L, B, H, N,
P) f32, "conv_x"/"conv_b"/"conv_c": (L, B, W−1, C)}``; the prefill writes
into a given cache and decode updates it in place. The conv tails are the
last W−1 inputs of the causal conv's left-zero-padded input, so a prompt
shorter than W−1 leaves zeros in the oldest slots, where the conv put them
(the reference keeps the raw ``x[:, -(W−1):]`` and its serving engine pads
it at the end, which puts the zeros in the newest slots; ROADMAP §3).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.config.base import ModelConfig
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models import layers as L
from repro_torch.models.transformer import LM, remat_layer

SSD_IMPLS = ("kernel", "torch")


# ---------------------------------------------------------------------------
# chunked SSD (the plain twin of kernels/ssd)
# ---------------------------------------------------------------------------

def _chunk(state: torch.Tensor, xq: torch.Tensor, dtq: torch.Tensor,
           bq: torch.Tensor, cq: torch.Tensor, a32: torch.Tensor,
           tri: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One chunk of the scan: the carried (b,h,n,p) state and the chunk's
    inputs → (new state, y (b,Q,h,p))."""
    cum = torch.cumsum(dtq * a32, dim=1)                         # (b,Q,h)
    total = cum[:, -1]                                           # (b,h)
    # mask BEFORE exp: for s > t the raw exponent is large-positive (cum
    # decreases), and exp → inf followed by where(…, 0) still NaNs the
    # backward (inf · 0 cotangent)
    darg = cum[:, :, None, :] - cum[:, None, :, :]               # (b,t,s,h)
    ldec = torch.exp(torch.where(tri, darg, -60.0))
    ldec = torch.where(tri, ldec, 0.0)
    scores = torch.einsum("btn,bsn->bts", cq, bq)
    sc = scores[..., None] * ldec * dtq[:, None, :, :]           # (b,t,s,h)
    y = torch.einsum("btsh,bshp->bthp", sc, xq)
    c_scaled = cq[:, :, None, :] * torch.exp(cum)[..., None]     # (b,t,h,n)
    y = y + torch.einsum("bthn,bhnp->bthp", c_scaled, state)
    b_scaled = bq[:, :, None, :] * (dtq * torch.exp(
        total[:, None, :] - cum))[..., None]                     # (b,s,h,n)
    state = torch.exp(total)[:, :, None, None] * state + \
        torch.einsum("bshn,bshp->bhnp", b_scaled, xq)
    return state, y


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                bm: torch.Tensor, cm: torch.Tensor, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,L,H,P) · dt: (B,L,H) · a: (H,) · bm/cm: (B,L,N) → (y in x's
    dtype, state (B,H,N,P) f32): chunks of ``min(chunk, L)`` steps, L padded
    with Δ = 0 steps, all in f32, as the reference computes it.

    Where a gradient is being taken (grad enabled and an input that
    requires it) each chunk is checkpointed, as the reference's scan body
    is: the backward keeps only the (B,H,N,P) carry a chunk and recomputes
    the chunk's (B,Q,Q,H) decay tensors (``use_reentrant=False``, which
    ``torch.autograd.grad`` needs). Otherwise the chunks run as a plain
    loop."""
    b, l, h, p = x.shape
    n = bm.shape[-1]
    q = min(chunk, l)
    pad = (-l) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bm = F.pad(bm, (0, 0, 0, pad))
        cm = F.pad(cm, (0, 0, 0, pad))
    nc = (l + pad) // q
    x32 = x.float().reshape(b, nc, q, h, p)
    dt32 = dt.float().reshape(b, nc, q, h)
    bm32 = bm.float().reshape(b, nc, q, n)
    cm32 = cm.float().reshape(b, nc, q, n)
    a32 = a.float()
    state = (torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    idx = torch.arange(q, device=x.device)
    tri = (idx[None, :] <= idx[:, None])[None, :, :, None]      # (1,t,s,1)
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x32, dt32, bm32, cm32, a32, state))
    ys = []
    for c in range(nc):
        args = (state, x32[:, c], dt32[:, c], bm32[:, c], cm32[:, c], a32,
                tri)
        state, y = (checkpoint(_chunk, *args, use_reentrant=False) if remat
                    else _chunk(*args))
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, l + pad, h, p)[:, :l]
    return y.to(x.dtype), state


def ssd_decode_step(state: torch.Tensor, xt: torch.Tensor, dtt: torch.Tensor,
                    a: torch.Tensor, bt: torch.Tensor, ct: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact recurrence, one step. state: (B,H,N,P) · xt: (B,H,P) ·
    dtt: (B,H) · bt/ct: (B,N) → (y (B,H,P), new state)."""
    decay = torch.exp(dtt * a[None])                             # (B,H)
    state = state * decay[:, :, None, None] + (
        dtt[:, :, None, None] * bt[:, None, :, None] * xt[:, :, None, :])
    y = torch.einsum("bn,bhnp->bhp", ct, state)
    return y, state


# ---------------------------------------------------------------------------
# depthwise causal conv
# ---------------------------------------------------------------------------

def causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """x: (B, L, C) · w: (W, C) · b: (C,) → (B, L, C), left-padded causal.
    JAX's ``conv_general_dilated`` is a cross-correlation, as ``conv1d`` is:
    the weight ``(W, C)`` becomes ``(C, 1, W)``, one group per channel."""
    width = w.shape[0]
    xt = F.pad(x.transpose(1, 2), (width - 1, 0))                # (B, C, L+W−1)
    out = F.conv1d(xt, w.T[:, None, :], groups=x.shape[-1])
    # back to (B, L, C) rows in memory: the SSD kernel reads x per head with
    # a unit last stride
    return out.transpose(1, 2).contiguous() + b


def conv_tail(x: torch.Tensor, width: int) -> torch.Tensor:
    """The last ``width − 1`` rows of ``x`` (B, L, C) left-padded by
    ``width − 1`` zeros, as the causal conv pads it: the decode cache of a
    prompt of any length, zeros in front where the prompt is shorter."""
    return F.pad(x, (0, 0, width - 1, 0))[:, -(width - 1):]


def conv_decode_step(cache: torch.Tensor, xt: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """cache: (B, W−1, C) past inputs · xt: (B, C) → (yt (B, C), new cache)."""
    window = torch.cat([cache, xt[:, None]], dim=1)              # (B, W, C)
    # a cache wider than x promotes the step, as jnp's einsum does
    yt = torch.einsum("bwc,wc->bc", window, w.to(window.dtype)) + b
    return yt, window[:, 1:]


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def mamba_defs(cfg: ModelConfig, d_model: Optional[int] = None
               ) -> L.ParamDefs:
    d = d_model or cfg.d_model
    s = cfg.ssm
    d_inner = s.expand * d
    h = d_inner // s.head_dim
    n, w = s.state_dim, s.conv_width
    return {
        "in_x": L.Param((d, d_inner), ("embed", "mlp"), init="fan_in"),
        "in_z": L.Param((d, d_inner), ("embed", "mlp"), init="fan_in"),
        "in_b": L.Param((d, n), ("embed", "ssm_state"), init="fan_in"),
        "in_c": L.Param((d, n), ("embed", "ssm_state"), init="fan_in"),
        "in_dt": L.Param((d, h), ("embed", "ssm_heads"), init="fan_in"),
        "dt_bias": L.Param((h,), ("ssm_heads",), init="zeros"),
        "a_log": L.Param((h,), ("ssm_heads",), init="ssm_a"),
        "d_skip": L.Param((h,), ("ssm_heads",), init="ones"),
        "conv_x_w": L.Param((w, d_inner), ("conv", "mlp"), init="fan_in"),
        "conv_x_b": L.Param((d_inner,), ("mlp",), init="zeros"),
        "conv_b_w": L.Param((w, n), ("conv", "ssm_state"), init="fan_in"),
        "conv_b_b": L.Param((n,), ("ssm_state",), init="zeros"),
        "conv_c_w": L.Param((w, n), ("conv", "ssm_state"), init="fan_in"),
        "conv_c_b": L.Param((n,), ("ssm_state",), init="zeros"),
        "gate_norm": L.Param((d_inner,), ("mlp",), init="ones"),
        "out": L.Param((d_inner, d), ("mlp", "embed"), init="fan_in"),
    }


def _project(params: L.Params, x: torch.Tensor):
    """The input projections of x (B, S, D) on what the rank holds: its
    d_inner columns of x and z and its heads of Δ where the rules split
    ``mlp``/``ssm_heads``, B and C whole (``ssm_state``)."""
    dtype, d = x.dtype, x.shape[-1]

    def proj(name):
        return x @ L.fsdp(params[name], 0, d).to(dtype)
    xi, z, bm, cm, dt = (proj(n) for n in ("in_x", "in_z", "in_b", "in_c",
                                            "in_dt"))
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    return xi, z, bm, cm, dt


def _heads_split():
    """The model group over which the current rules split a Mamba2 mixer's
    heads (``ssm_heads``) and with them its d_inner (``mlp``: head h's
    columns [h·P, (h + 1)·P)), or None. Raises where the rules split one
    and not the other: a rank's columns would not be its heads'."""
    heads, cols = L.tp_group("ssm_heads"), L.tp_group("mlp")
    if (heads is None) != (cols is None):
        raise ValueError("a Mamba2 mixer splits its heads (ssm_heads) and "
                         "its d_inner (mlp) over the model axis together; "
                         "these rules split one of them")
    return heads


def _conv(params: L.Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.silu(causal_conv(x, params[f"conv_{name}_w"].to(x.dtype),
                              params[f"conv_{name}_b"].to(x.dtype)))


def mamba_fwd(params: L.Params, x: torch.Tensor, cfg: ModelConfig,
              return_state: bool = False, ssd_impl: str = "kernel",
              seq=None):
    """x: (B, S, D) → out, or (out, {"ssm", "conv_x", "conv_b", "conv_c"})
    with ``return_state``: the final SSM state (B, H, N, P) f32 and the
    conv tails (B, W−1, C) (:func:`conv_tail`).

    With ``seq`` x is this rank's act_seq chunk, gathered along the
    sequence for the scan, and out is its chunk. Under rules that split
    the mixer's heads (:func:`_heads_split`) the rank computes its H/M
    heads: its d_inner columns of x and z, its Δ, conv, SSD scan (the
    kernel on its heads), skip and gate-norm slices, the gated RMSNorm's sum
    of squares summed over model in f32, and ``out`` row-parallel; B and C
    are whole on every rank; the state is its heads' and the x conv tail its
    columns'."""
    if ssd_impl not in SSD_IMPLS:
        raise ValueError(f"unknown ssd impl {ssd_impl!r} "
                         f"({' | '.join(SSD_IMPLS)})")
    s = cfg.ssm
    model = _heads_split()
    x = L.seq_gather(x, seq)
    b, l, d = x.shape
    d_inner = params["in_x"].shape[1]
    h = d_inner // s.head_dim

    xi, z, bm, cm, dt = _project(params, x)
    xi_conv = _conv(params, "x", xi)
    bm_conv = _conv(params, "b", bm)
    cm_conv = _conv(params, "c", cm)

    xh = xi_conv.reshape(b, l, h, s.head_dim)                    # a view
    a = -torch.exp(params["a_log"].float())
    if ssd_impl == "kernel":
        y, state = ssd_ops.ssd_scan(xh, dt, a, bm_conv, cm_conv,
                                    chunk=min(s.chunk_size, l))
    else:
        y, state = ssd_chunked(xh, dt, a, bm_conv, cm_conv, s.chunk_size)
    y = y + params["d_skip"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(b, l, d_inner)

    y = L.rms_norm(y * F.silu(z), params["gate_norm"], cfg.norm_eps, model)
    out = L.tp_out(y @ L.fsdp(params["out"], 1, d).to(y.dtype), model, seq)
    if return_state:
        w = s.conv_width
        return out, {"ssm": state, "conv_x": conv_tail(xi, w),
                     "conv_b": conv_tail(bm, w), "conv_c": conv_tail(cm, w)}
    return out


def mamba_decode_step(params: L.Params, x: torch.Tensor,
                      cache: Mapping[str, torch.Tensor], cfg: ModelConfig
                      ) -> torch.Tensor:
    """x: (B, 1, D) one token; cache: {"ssm", "conv_x", "conv_b", "conv_c"}
    of one layer, updated in place. Returns the block's output (B, 1, D).
    Under rules that split the mixer's heads the rank steps its heads'
    state and its columns' x conv tail (:func:`mamba_fwd`), and ``out``'s
    partial sums are summed over model."""
    s = cfg.ssm
    model = _heads_split()
    b, d = x.shape[0], x.shape[-1]
    d_inner = params["in_x"].shape[1]
    h = d_inner // s.head_dim

    xi, z, bm, cm, dt = _project(params, x)
    xi, z = xi[:, 0], z[:, 0]
    bm, cm, dt = bm[:, 0], cm[:, 0], dt[:, 0]
    conv = {}
    for name, t in (("x", xi), ("b", bm), ("c", cm)):
        yt, tail = conv_decode_step(
            cache[f"conv_{name}"], t, params[f"conv_{name}_w"].to(t.dtype),
            params[f"conv_{name}_b"].to(t.dtype))
        cache[f"conv_{name}"].copy_(tail)
        conv[name] = F.silu(yt)
    xc, bc, cc = conv["x"], conv["b"], conv["c"]

    xh = xc.reshape(b, h, s.head_dim)
    a = -torch.exp(params["a_log"].float())
    y, ssm = ssd_decode_step(cache["ssm"], xh.float(), dt, a, bc.float(),
                             cc.float())
    cache["ssm"].copy_(ssm)
    y = y.to(x.dtype) + params["d_skip"].to(x.dtype)[None, :, None] * xh
    y = y.reshape(b, 1, d_inner)

    y = L.rms_norm(y * F.silu(z)[:, None], params["gate_norm"], cfg.norm_eps,
                   model)
    return L.tp_out(y @ L.fsdp(params["out"], 1, d).to(y.dtype), model, None)


def mamba_cache_defs(cfg: ModelConfig, batch: int, n_layers: int,
                     dtype: torch.dtype
                     ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) per cache leaf, layer-stacked: the f32 SSM state and
    the conv tails in ``dtype``; under rules that split the mixer's heads
    (:func:`_heads_split`) this rank's heads of the state and columns of
    the x tail, as the reference's cache axes (``ssm_heads``, ``mlp``)
    say."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    model = _heads_split()
    if model is not None:
        d_inner //= model.k
    h = d_inner // s.head_dim
    w = s.conv_width - 1
    return {
        "ssm": ((n_layers, batch, h, s.state_dim, s.head_dim), torch.float32),
        "conv_x": ((n_layers, batch, w, d_inner), dtype),
        "conv_b": ((n_layers, batch, w, s.state_dim), dtype),
        "conv_c": ((n_layers, batch, w, s.state_dim), dtype),
    }


def init_mamba_cache(cfg: ModelConfig, batch: int, n_layers: int,
                     dtype: torch.dtype, device=None
                     ) -> Dict[str, torch.Tensor]:
    """:func:`mamba_cache_defs` as zeros on ``device``."""
    return {k: torch.zeros(shape, dtype=dt, device=device)
            for k, (shape, dt) in mamba_cache_defs(cfg, batch, n_layers,
                                                   dtype).items()}


def block_defs(cfg: ModelConfig) -> L.ParamDefs:
    return {"ln": L.norm_defs(cfg.d_model, cfg.norm_type),
            "mamba": mamba_defs(cfg)}


def block_fwd(lp: L.Params, x: torch.Tensor, cfg: ModelConfig,
              ssd_impl: str, cache: Optional[Dict[str, torch.Tensor]] = None,
              layer: int = 0, seq=None) -> torch.Tensor:
    """One pre-norm residual Mamba2 block over a sequence (with ``seq``,
    this rank's act_seq chunk of it). Given a layer-stacked ``cache``, its
    final SSM state and conv tails are written into
    ``cache[leaf][layer]``."""
    h = L.apply_norm(lp["ln"], x, cfg.norm_type, cfg.norm_eps)
    if cache is None:
        return x + mamba_fwd(lp["mamba"], h, cfg, ssd_impl=ssd_impl,
                             seq=seq)
    out, tails = mamba_fwd(lp["mamba"], h, cfg, return_state=True,
                           ssd_impl=ssd_impl, seq=seq)
    for name, t in tails.items():
        cache[name][layer] = t
    return x + out


def block_decode(lp: L.Params, x: torch.Tensor,
                 cache: Dict[str, torch.Tensor], layer: int,
                 cfg: ModelConfig) -> torch.Tensor:
    """One block, one token; ``cache[leaf][layer]`` updated in place."""
    h = L.apply_norm(lp["ln"], x, cfg.norm_type, cfg.norm_eps)
    return x + mamba_decode_step(lp["mamba"], h,
                                 {k: v[layer] for k, v in cache.items()}, cfg)


# ---------------------------------------------------------------------------
# attention-free SSM LM (mamba2-2.7b)
# ---------------------------------------------------------------------------

class SSMModel(LM):
    """The attention-free Mamba2 LM: ``param_defs``/``init``/``load``,
    ``loss``, ``prefill``, ``init_cache``, ``decode_step``, with the
    contract of :class:`repro_torch.models.transformer.LM`.
    ``ssd_impl``: ``"kernel"`` (the CUDA SSD kernel on the card; forward
    only, so serving only) or ``"torch"`` (:func:`ssd_chunked`, the
    reference's model path, which it trains with). ``remat``: any value but
    ``"none"`` checkpoints each block where a gradient is taken, as the
    reference does. Under mesh rules (``ServeEngine(mesh=)``, and the
    trainer's) the prefill, decode and loss run on this rank's rows through
    the mesh embedding, the mixers on the rank's heads (:func:`mamba_fwd`)
    with the residual in the act_seq layout between them, and the logits
    (the loss's vocab-parallel CE) from the rank's shard of
    ``out_embedding``."""

    def __init__(self, cfg: ModelConfig, *, ssd_impl: str = "kernel",
                 remat: str = "none"):
        if cfg.family != "ssm":
            raise ValueError(f"SSMModel builds family 'ssm', not "
                             f"{cfg.family!r}")
        if ssd_impl not in SSD_IMPLS:
            raise ValueError(f"unknown ssd impl {ssd_impl!r} "
                             f"({' | '.join(SSD_IMPLS)})")
        self.cfg = cfg
        self.ssd_impl = ssd_impl
        self.remat = remat
        self.dtype = getattr(torch, cfg.dtype)

    # ----------------------------------------------------------- parameters
    def param_defs(self) -> L.ParamDefs:
        cfg = self.cfg
        defs = {
            "embed": L.embed_defs(cfg.vocab_size, cfg.d_model),
            "layers": [block_defs(cfg)] * cfg.n_layers,
            "final_norm": L.norm_defs(cfg.d_model, cfg.norm_type),
        }
        defs.update(L.unembed_defs(cfg.vocab_size, cfg.d_model,
                                   cfg.tie_embeddings))
        return defs

    # ------------------------------------------------------------- forward
    def backbone(self, params: L.Params, x: torch.Tensor,
                 return_cache: bool = False,
                 cache: Optional[Dict[str, torch.Tensor]] = None, seq=None):
        """x: (B, S, D) embedded inputs (with ``seq``, this rank's act_seq
        chunk of them) → final hidden (+ cache), whole. With
        ``return_cache`` each layer's state and conv tails are written into
        the given cache, or a new one in the activations' dtype."""
        cfg = self.cfg
        if return_cache and cache is None:
            cache = self.init_cache(x.shape[0], x.shape[1], dtype=x.dtype,
                                    device=x.device)
        fwd = block_fwd
        if self.remat != "none" and torch.is_grad_enabled() \
                and not return_cache:
            fwd = remat_layer(block_fwd, "full")
        for i, lp in enumerate(L.layer_list(params["layers"])):
            x = fwd(lp, x, cfg, self.ssd_impl,
                    cache if return_cache else None, i, seq)
        x = L.apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
        x = L.seq_gather(x, seq)
        return (x, cache) if return_cache else x

    # --------------------------------------------------------------- train
    def loss(self, params: L.Params, batch
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {"tokens": (B,S) int, "targets": (B,S) int} → (mean
        next-token NLL over every position, {"ce": it}), differentiable in
        the params: the reference's ``SSMModel.loss``, which takes no
        ``loss_mask``.

        Raises under ``ssd_impl="kernel"``: the SSD kernel is forward only
        (the reference's model path never calls its kernel either)."""
        if self.ssd_impl == "kernel":
            raise ValueError("SSMModel.loss needs ssd_impl='torch': the SSD "
                             "kernel is forward only, and the reference "
                             "trains through its chunked scan")
        return self._ce(params, batch)

    def init_cache(self, batch_size: int, max_len: int,
                   dtype: torch.dtype = torch.bfloat16,
                   device=None) -> Dict[str, torch.Tensor]:
        """The O(1)-in-length cache: ``max_len`` is ignored."""
        return init_mamba_cache(self.cfg, batch_size, self.cfg.n_layers,
                                dtype, device)

    def decode_step(self, params: L.Params, batch
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {"token": (B,1) int, "cache": {...}, "index": an int or
        an integer device tensor}. The cache is updated in place and
        returned; ``index`` is not needed."""
        cfg = self.cfg
        x = L.embed(params["embed"], batch["token"], self.dtype)
        cache = batch["cache"]
        for i, lp in enumerate(L.layer_list(params["layers"])):
            x = block_decode(lp, x, cache, i, cfg)
        x = L.apply_norm(params["final_norm"], x, cfg.norm_type, cfg.norm_eps)
        return self._logits_last(params, x[:, -1]), cache
