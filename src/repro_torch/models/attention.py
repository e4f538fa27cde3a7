"""Attention: GQA/MQA/MHA, RoPE, causal/prefix masks, KV-cache decode, and
the enc-dec cross-attention (``kv_x`` / ``cross=True``: no RoPE, a fixed
cache of the encoder's k, v).

The port of ``repro.models.attention``. Layouts are the reference's:
activations (B, S, H, hd), caches (B, S, KV, hd). Under mesh rules whose
``cache_seq`` maps to a mesh axis (:func:`repro_torch.sharding.use_rules`),
a rank holds its chunk of every self-attention cache's sequence (chunk r
the positions [r·Sc, (r + 1)·Sc)): the prefill writes the positions its
chunk holds (:func:`write_cache`), a decode step writes the new k, v on the
rank whose chunk holds the index, and :func:`decode_attention` merges the
ranks' flash-decode partials by log-sum-exp, as the reference's seq-sharded
decode does. A cross-attention cache is split the same way where its own
length tiles the model axis (:func:`tile_shards`), as the reference decides
per cache.

Tensor parallel under rules that split ``heads`` over the model axis
(:func:`repro_torch.models.layers.tp_group`): a rank projects straight into
its H/M query heads and, where ``kv_heads`` split too, its KV/M key and
value heads (contiguous (B, S, H/M, hd), so the flash kernel keeps its TMA
routes); where they do not (paligemma's one KV head) k and v are whole and
each rank attends with the KV heads of its query heads (the reference's
``q_group``). ``wo`` is row-parallel: its partial sums are summed over
model in f32 into the residual's layout. The prefill's head-sharded k, v go
into the sequence-sharded cache by an all-to-all over model
(:func:`write_cache`); a decode step gathers its one token's q, k, v over
model for the sequence-sharded decode attention. Where ``heads`` is held
whole (smollm's 15) the attention runs whole on every model rank.

``full_attention(impl=…)`` selects the attention of a full sequence:
``"kernel"`` (the default) goes through
:func:`repro_torch.kernels.flash_attention.ops.flash_attention`, the CUDA
kernel on CUDA tensors and its plain version on CPU tensors;
``"torch"`` takes the plain twins of the reference's ``attn_impl="jnp"``
(:func:`_sdpa`, and :func:`_sdpa_chunked` from ``_CHUNK_THRESHOLD`` rows on).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import layers as L
from repro_torch.sharding import current_rules

NEG_INF = -1e30
# seq length at/beyond which the q-chunked path replaces full-score SDPA,
# and its chunk (the reference's values)
_CHUNK_THRESHOLD = 2048
_Q_CHUNK = 512
IMPLS = ("kernel", "torch")


def attn_defs(cfg: ModelConfig) -> L.ParamDefs:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    defs: L.ParamDefs = {
        "wq": L.Param((d, cfg.n_heads, hd), ("embed", "heads", "head_dim"), init="fan_in"),
        "wk": L.Param((d, cfg.n_kv_heads, hd), ("embed", "kv_heads", "head_dim"), init="fan_in"),
        "wv": L.Param((d, cfg.n_kv_heads, hd), ("embed", "kv_heads", "head_dim"), init="fan_in"),
        "wo": L.Param((cfg.n_heads, hd, d), ("heads", "head_dim", "embed"), init="fan_in"),
    }
    if cfg.qkv_bias:
        defs["bq"] = L.Param((cfg.n_heads, hd), ("heads", "head_dim"), init="zeros")
        defs["bk"] = L.Param((cfg.n_kv_heads, hd), ("kv_heads", "head_dim"), init="zeros")
        defs["bv"] = L.Param((cfg.n_kv_heads, hd), ("kv_heads", "head_dim"), init="zeros")
    return defs


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")`` as one matrix product, on this rank's
    heads of ``w`` (its d_model dim gathered where the rank holds its FSDP
    slice)."""
    w = L.fsdp(w, 0, x.shape[-1])
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def _project_qkv(params: L.Params, x: torch.Tensor,
                 kv_x: Optional[torch.Tensor] = None):
    """q from ``x``; k and v from ``kv_x`` (cross-attention) or ``x``; each
    on the heads this rank holds."""
    src = x if kv_x is None else kv_x
    q = _proj(x, params["wq"])
    k = _proj(src, params["wk"])
    v = _proj(src, params["wv"])
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    return q, k, v


def _out_proj(out: torch.Tensor, wo: torch.Tensor, d: int) -> torch.Tensor:
    """``einsum("bshd,hdm->bsm")`` as one matrix product into d_model ``d``:
    over this rank's heads of ``wo``, a partial sum where they are split."""
    wo = L.fsdp(wo, 2, d)
    h, hd, _ = wo.shape
    return out.flatten(-2) @ wo.to(out.dtype).reshape(h * hd, d)


def _kv_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads,
            kv_heads) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k, v (B, T, KV, hd) that this rank's query heads ``q`` attend
    with. Where ``heads`` is split (its model group) and ``kv_heads`` held
    whole (None), the KV heads of the rank's H/M query heads, cut from the
    whole ones (the reference's ``q_group`` split): its heads must lie in
    one KV head's group or span whole groups, else this raises. Otherwise
    k, v as they are (both whole, or both this rank's)."""
    if heads is None or kv_heads is not None:
        return k, v
    hq, kv = q.shape[2], k.shape[2]
    g = hq * heads.k // kv                     # query heads a KV head
    if g % hq and hq % g:
        raise ValueError(f"{hq} query heads a rank do not fit the groups of "
                         f"{g} query heads of the {kv} KV heads held whole")
    lo, n = heads.index * hq // g, max(1, hq // g)
    return k.narrow(2, lo, n).contiguous(), v.narrow(2, lo, n).contiguous()


def make_mask(q_len: int, kv_len: int, mode: str, prefix_len: int = 0,
              q_offset: int = 0, device=None) -> Optional[torch.Tensor]:
    """Boolean (q_len, kv_len) mask; True = attend. ``mode``: causal|prefix|full."""
    if mode == "full":
        return None
    rows = torch.arange(q_len, device=device)[:, None] + q_offset
    cols = torch.arange(kv_len, device=device)[None, :]
    causal = cols <= rows
    if mode == "causal":
        return causal
    if mode == "prefix":
        return causal | (cols < prefix_len)
    raise ValueError(mode)


def _sdpa(q, k, v, mask) -> torch.Tensor:
    """Grouped-query scaled-dot-product attention, the twin of the
    reference's ``_sdpa_jnp``: scores in the activation dtype, then the
    scale and softmax in f32, probabilities back in the activation dtype.

    q: (B,S,H,hd) · k/v: (B,T,KV,hd) → (B,S,H,hd). H = KV·G.
    """
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, hd)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() / (hd ** 0.5)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, hd)


def _sdpa_chunked(q, k, v, mask_mode: str, prefix_len: int,
                  q_chunk: int = _Q_CHUNK) -> torch.Tensor:
    """Query-chunked SDPA: a loop over q blocks with the full softmax row
    per block (f32), so scores live at (B,KV,G,q_chunk,T) per step. The
    twin of the reference's ``_sdpa_chunked_jnp`` in its grouped layout
    (the flat-head and context-parallel layouts serve a mesh only)."""
    b, s, h, hd = q.shape
    t = k.shape[1]
    if s % q_chunk != 0:
        return _sdpa(q, k, v, make_mask(s, t, mask_mode, prefix_len,
                                        device=q.device))
    outs = []
    for iq in range(s // q_chunk):
        rows = slice(iq * q_chunk, (iq + 1) * q_chunk)
        mask = make_mask(q_chunk, t, mask_mode, prefix_len,
                         q_offset=iq * q_chunk, device=q.device)
        outs.append(_sdpa(q[:, rows], k, v, mask))
    return torch.cat(outs, dim=1)


def full_attention(params: L.Params, x: torch.Tensor,
                   positions: torch.Tensor, cfg: ModelConfig,
                   mask_mode: str = "causal", prefix_len: int = 0,
                   kv_x: Optional[torch.Tensor] = None,
                   impl: str = "kernel", return_kv: bool = False,
                   seq=None):
    """Training / prefill attention over a full sequence, or cross-attention
    from ``x`` (B, S, D) to ``kv_x`` (B, T, D): k and v projected from
    ``kv_x``, and no RoPE on q or k (the enc-dec cross-attention).

    ``return_kv=True`` also returns the (post-RoPE) k, v: the prefill path
    stores them as the decode cache. Under ``impl="kernel"`` the prefix mode
    is causal ∪ prefix, as ``make_mask`` has it (the reference's Pallas
    path attends to the prefix only there).

    With ``seq`` (:func:`repro_torch.models.layers.act_shards`) ``x`` is
    this rank's act_seq chunk of the queries, gathered along the sequence
    here, and the output is its chunk (``positions`` and ``kv_x`` whole).
    Under rules that split ``heads`` the rank computes its heads (the
    module docstring) and the returned k, v are its KV heads where
    ``kv_heads`` split, else whole.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r} "
                         f"({' | '.join(IMPLS)})")
    d = x.shape[-1]
    heads, kv_heads = L.tp_group("heads"), L.tp_group("kv_heads")
    x = L.seq_gather(x, seq)
    q, k, v = _project_qkv(params, x, kv_x)
    if kv_x is None:
        cos, sin = rotary_cos_sin(positions, cfg)
        q = L.apply_rope(q, cos, sin)
        k = L.apply_rope(k, cos, sin)
    ka, va = _kv_for(q, k, v, heads, kv_heads)
    if impl == "kernel":
        out = fa_ops.flash_attention(
            q, ka, va, causal=mask_mode != "full",
            prefix_len=prefix_len if mask_mode == "prefix" else 0)
    elif q.shape[1] >= _CHUNK_THRESHOLD:
        out = _sdpa_chunked(q, ka, va, mask_mode, prefix_len)
    else:
        mask = make_mask(q.shape[1], ka.shape[1], mask_mode, prefix_len,
                         device=q.device)
        out = _sdpa(q, ka, va, mask)
    y = L.tp_out(_out_proj(out, params["wo"], d), heads, seq)
    if return_kv:
        return y, k, v
    return y


def rotary_cos_sin(positions: torch.Tensor, cfg: ModelConfig):
    return L.rotary_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, n_layers: int,
               dtype: torch.dtype = torch.bfloat16,
               device=None) -> Dict[str, torch.Tensor]:
    shape = (n_layers, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_index(index, device) -> torch.Tensor:
    """The decode position as a (1,) int64 tensor on ``device``. The
    reference traces ``index`` as a ``jnp.int32``; here an int becomes a
    tensor at the entry, so a step never reads its position on the host and
    eager and captured steps (:mod:`repro_torch.runtime.graphs`) run the
    same operations."""
    if isinstance(index, torch.Tensor):
        return index.reshape(1).to(device=device, dtype=torch.long)
    return torch.tensor([index], dtype=torch.long, device=device)


def _decode_attn_chunk(q, k_chunk, v_chunk, index: torch.Tensor,
                       chunk_offset: int):
    """Flash-decode partial of one cache chunk: returns (o, l, m_safe,
    has), the unnormalised output, the softmax denominator, the running max
    (0 where the chunk holds no valid position) and whether it holds one,
    for the lse merge across cache shards.

    q: (B,1,KV,G,hd) · k/v_chunk: (B,Sc,KV,hd); positions chunk_offset+i
    valid iff <= index, a (1,) device tensor. A masked position's p is 0,
    and 0 · v is 0 for the cache's every value: a finite k, v written by a
    step or a prefill, or the zeros a cache is made or re-used with
    (:class:`repro_torch.launch.serve.ServeEngine`).
    """
    sc = k_chunk.shape[1]
    scores = torch.einsum("bqkgd,btkd->bkgqt", q, k_chunk).float()
    scores = scores / (q.shape[-1] ** 0.5)
    pos = chunk_offset + torch.arange(sc, device=q.device)
    scores = torch.where(pos <= index, scores, -torch.inf)
    m = torch.amax(scores, dim=-1, keepdim=True)
    has = torch.isfinite(m)
    m_safe = torch.where(has, m, 0.0)
    p = torch.exp(scores - m_safe)
    p = torch.where(torch.isfinite(scores), p, 0.0)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bkgqt,btkd->bkgqd", p.to(v_chunk.dtype), v_chunk)
    return o, l, m_safe, has


def seq_shards():
    """The model group over which the current rules shard the cache's
    sequence, or None (no rules, no mesh, or ``cache_seq`` held whole)."""
    rules = current_rules()
    if rules is None or rules.mesh is None \
            or not rules.mesh_axes_for("cache_seq"):
        return None
    from repro_torch.core.collectives import mesh_groups
    return mesh_groups(rules)[1]


def tile_shards(length: int):
    """The model group over which a cache of ``length`` positions that the
    rules do not size (the enc-dec's cross cache) is split: under mesh
    rules, where ``length`` tiles the model axis, as the reference's
    ``decode_attention`` decides per cache; else None (held whole)."""
    rules = current_rules()
    if rules is None or rules.mesh is None:
        return None
    from repro_torch.core.collectives import mesh_groups
    model = mesh_groups(rules)[1]
    return model if model.k > 1 and length % model.k == 0 else None


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, index: torch.Tensor,
                     mesh=None) -> torch.Tensor:
    """One-token attention against the cache: q (B,1,H,hd) · k/v_cache
    (B,S,KV,hd), positions ≤ index (a (1,) device tensor) valid.

    Without ``mesh`` (the model group of a mesh,
    :class:`repro_torch.core.collectives.Group`) the reference's
    single-shard math. With it, k/v_cache are this rank's chunk of a cache
    sharded on seq over that group: each rank's flash-decode partial,
    merged as the reference's ``shard_fn``: the max m over the ranks, each
    partial scaled by exp(m − m_max), l and o summed over the ranks, every
    payload f32."""
    b, _, h, hd = q.shape
    kv = k_cache.shape[2]
    qg = q.reshape(b, 1, kv, h // kv, hd)
    if mesh is None:
        o, l, _, _ = _decode_attn_chunk(qg, k_cache, v_cache, index, 0)
        out = (o / torch.clamp(l, min=1e-30)).to(q.dtype)  # (B,KV,G,1,hd)
        return out.reshape(b, 1, h, hd)
    sc = k_cache.shape[1]
    o, l, m, _ = _decode_attn_chunk(qg, k_cache, v_cache, index,
                                    mesh.index * sc)
    m_glob = mesh.maximum(m)
    scale = torch.exp(m - m_glob)
    l_glob = mesh.sum(l * scale)
    o_glob = mesh.sum(o.float() * scale)
    out = (o_glob / torch.clamp(l_glob, min=1e-30)).to(q.dtype)
    return out.reshape(b, 1, h, hd)


def write_cache(cache: torch.Tensor, k: torch.Tensor, shards=None) -> None:
    """The prefill's k (B, s, KV, hd) into ``cache`` (B, S, KV, hd): its
    first s positions, or, on the rank of ``shards`` (the model group of a
    seq-sharded cache), the positions of its chunk. Where k holds this
    rank's KV/M heads (the rules split ``kv_heads``) the ranks' heads are
    put together: into a seq-sharded cache by one all-to-all over model
    (rank j gets every rank's heads of its chunk), into a whole one by a
    gather along the heads."""
    heads = L.tp_group("kv_heads") if k.shape[2] < cache.shape[2] else None
    if heads is not None and shards is not None:
        sc = cache.shape[1]
        n = min(max(k.shape[1] - shards.index * sc, 0), sc)
        k = _heads_to_chunks(k, sc, shards)
        cache[:, :n] = k[:, :n]
        return
    if heads is not None:
        k = heads.gather_dim(k, 2)
    s = k.shape[1]
    if shards is None:
        cache[:, :s] = k
        return
    sc = cache.shape[1]
    lo = shards.index * sc
    n = min(max(s - lo, 0), sc)
    if n:
        cache[:, :n] = k[:, lo:lo + n]


def _heads_to_chunks(k: torch.Tensor, sc: int, model) -> torch.Tensor:
    """This rank's KV/M heads of a prefill's k (B, s, KV/M, hd) → every
    head of its chunk of the sequence (B, sc, KV, hd) of a cache split in
    chunks of ``sc`` over ``model``: k padded with zeros to the cache's
    M·sc positions, chunk j sent to rank j (``all_to_all``), the sources'
    heads laid side by side in rank order. The first ``s − index·sc``
    positions (at most sc) are the prefill's."""
    b, s, kv_loc, hd = k.shape
    m = model.k
    if s > m * sc:
        raise ValueError(f"{s} prefill positions exceed the cache's "
                         f"{m} x {sc}")
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, m * sc - s))
    send = k.reshape(b, m, sc, kv_loc, hd).movedim(1, 0)
    recv = model.all_to_all(send)                   # (M src, B, sc, KV/M, hd)
    return recv.movedim(0, 2).reshape(b, sc, m * kv_loc, hd)


def decode_step_attention(params: L.Params, x: torch.Tensor,
                          cache_k: torch.Tensor, cache_v: torch.Tensor,
                          index: torch.Tensor, cfg: ModelConfig,
                          cross: bool = False, shards=None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token attention step; returns (y, cache_k, cache_v).

    x: (B,1,d). cache_k/v: (B,S,KV,hd). ``index``: the position, a (1,)
    int64 device tensor (:func:`decode_index`). The new k, v are written
    into the caches in place at ``index`` (the reference donates the cache
    buffers and updates them functionally; in place is the same result
    without a second cache in memory). ``cross=True`` is the enc-dec
    cross-attention against the fixed encoder states: no RoPE, no cache
    write, every one of the cache's S positions attended (the reference's
    ``eff_index = S − 1``, here a device tensor too, so the step captures);
    with ``shards`` (the model group of a split cross cache,
    :func:`tile_shards`) the caches are this rank's chunks of the whole S
    and the ranks' partials are merged. Under rules that shard
    ``cache_seq`` (:func:`seq_shards`) the self-attention caches are this
    rank's chunks: the rank whose chunk holds ``index`` writes the new k,
    v, and the ranks' partials are merged.
    """
    d = x.shape[-1]
    heads, kv_heads = L.tp_group("heads"), L.tp_group("kv_heads")
    if cross:
        q = _proj(x, params["wq"])
        if "bq" in params:
            q = q + params["bq"].to(x.dtype)
        whole = cache_k.shape[1] * (shards.k if shards is not None else 1)
        index = torch.full_like(index, whole - 1)
    else:
        q, k_new, v_new = _project_qkv(params, x)
        pos = index.to(torch.int32).expand(x.shape[0], 1)
        cos, sin = rotary_cos_sin(pos, cfg)
        q = L.apply_rope(q, cos, sin)
        k_new = L.apply_rope(k_new, cos, sin)
        if kv_heads is not None:
            # the token's every KV head, for the cache that holds them all
            k_new, v_new = kv_heads.gather_dim(k_new, 2), \
                kv_heads.gather_dim(v_new, 2)
        shards = seq_shards()
        for cache, new in ((cache_k, k_new), (cache_v, v_new)):
            if shards is None:
                cache.index_copy_(1, index, new.to(cache.dtype))
            else:
                _write_step(cache, new, index, shards)
    if heads is not None:
        # every head's query for the decode attention over the cache
        q = heads.gather_dim(q, 2)
    out = decode_attention(q, cache_k, cache_v, index, shards)
    if heads is not None:
        # this rank's heads, through its row shard of wo
        hq = out.shape[2] // heads.k
        out = out.narrow(2, heads.index * hq, hq)
    y = L.tp_out(_out_proj(out, params["wo"], d), heads, None)
    return y, cache_k, cache_v


def _write_step(cache: torch.Tensor, new: torch.Tensor, index: torch.Tensor,
                shards) -> None:
    """A step's k or v (B, 1, KV, hd) at ``index`` into this rank's chunk
    of a seq-sharded cache, where the chunk holds the index; elsewhere the
    chunk's row it would take is written with its own value. Device ops
    only: the host never reads the index."""
    sc = cache.shape[1]
    local = index - shards.index * sc
    mine = (local >= 0) & (local < sc)
    row = local.clamp(0, sc - 1)
    keep = cache.index_select(1, row)
    cache.index_copy_(1, row, torch.where(mine, new.to(cache.dtype), keep))
