"""Shared building blocks: param declarations, norms, RoPE, embeddings, MLP.

The port of ``repro.models.layers``. Parameters are declared through
:class:`Param` and drawn by :func:`init_params` into a nested dict of
tensors; :class:`ParamTree` turns that dict into ``nn.Module``s whose
parameter names are the reference's dict keys (``attn.wq``, ``mlp.w_up``,
…), with a list of layers as an ``nn.ModuleList``. The functions read their
parameters as ``params["wq"]``, so they take a ``ParamTree`` or a plain dict
of tensors alike.

Under mesh rules (:func:`repro_torch.sharding.use_rules`) :func:`embed`
takes the reference's mesh paths on a rank's shard of the table (vocab→model,
d_model→data): the vocab-parallel lookup for T ≥ 32,768 tokens, an exact
masked lookup summed over the ranks for fewer; :func:`unembed` of a table
shard sums the partial logits of its d_model slice over the data axis and
gathers them over the model axis.
Without rules, the plain gather.

Tensor and sequence parallelism (Megatron's, as the reference's rules lay
it out on a serving mesh). Where the rules split a sequence's ``act_seq``
over the model axis (:func:`act_shards`, decided per call from its length)
the residual stream between layers is this rank's chunk of the sequence
(B_loc, S/M, D). The norms run on the chunk (:func:`apply_norm`, their
scale gathered over data); a layer gathers the normed chunk along the
sequence before its products (:func:`seq_gather`) and returns its output
to the chunk: a row-parallel product's partial sums summed over model in
f32 and scattered along the sequence (:func:`tp_sum`), a product held
whole cut to the chunk (:func:`seq_chunk`). Where the sequence is whole (a
decode step, S = 1) the same partial sums are summed over model. A rank
holds a split weight as its column shard (``w_gate``/``w_up``: the
``mlp`` dim over model) or row shard (``w_down``), and each d_model dim
as its FSDP slice over data, gathered before use (:func:`fsdp`). Which
dims split is read from the rules (:func:`tp_group`): the serving engine's
and the trainer's alike. Under autograd every collective on the way is
differentiable, its backward its transpose
(:mod:`repro_torch.core.collectives`): the sequence gather's a
sum-scatter, :func:`tp_sum`'s sum-scatter a gather (its all-reduce an
all-reduce), the FSDP gather's a sum-scatter over data, and a norm on the
act_seq chunk leaves its scale the chunk's part of the gradient, which the
trainer sums over the ranks that hold the scale.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.sharding import current_rules


@dataclasses.dataclass(frozen=True)
class Param:
    """Declaration of one parameter leaf, the reference's: its shape, its
    logical sharding axes (one name a dim, read by
    :mod:`repro_torch.sharding`; empty where none is declared) and its
    draw."""

    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...] = ()
    init: str = "normal"       # normal | zeros | ones | fan_in | ssm_a
    scale: float = 0.02

    def __post_init__(self):
        if self.logical and len(self.logical) != len(self.shape):
            raise ValueError(f"logical axes {self.logical} do not match "
                             f"shape {self.shape}")


ParamDefs = Dict[str, Any]  # nested dict of Param, a list for a layer stack


def init_leaf(p: Param, gen: torch.Generator, dtype: torch.dtype
               ) -> torch.Tensor:
    dev = gen.device
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=dev)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=dev)
    if p.init == "ssm_a":
        # Mamba2 A init: A = −exp(a_log) spread over [1, 16]
        h = p.shape[-1]
        return torch.log(torch.linspace(1.0, 16.0, h, device=dev)
                         ).expand(p.shape).to(dtype).clone()
    if p.init == "fan_in":
        fan_in = p.shape[0] if len(p.shape) == 1 else math.prod(p.shape[:-1])
        scale = 1.0 / max(1.0, fan_in) ** 0.5
    elif p.init == "normal":
        scale = p.scale
    else:
        raise ValueError(f"unknown init {p.init!r}")
    x = torch.randn(p.shape, generator=gen, dtype=torch.float32, device=dev)
    return (x * scale).to(dtype)


def _map_defs(defs: ParamDefs, leaf) -> Dict[str, Any]:
    if isinstance(defs, Param):
        return leaf(defs)
    if isinstance(defs, list):
        return [_map_defs(d, leaf) for d in defs]
    return {k: _map_defs(d, leaf) for k, d in defs.items()}


def axes_of(defs: ParamDefs) -> Dict[str, Any]:
    """The tree of logical-axis tuples matching ``init_params``' output."""
    return _map_defs(defs, lambda p: p.logical)


def shapes_of(defs: ParamDefs) -> Dict[str, Any]:
    return _map_defs(defs, lambda p: p.shape)


def init_params(defs: ParamDefs, gen: torch.Generator,
                dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Draw a param tree from ``defs`` on ``gen``'s device: normal·scale,
    normal/√fan_in, zeros, ones or Mamba2's A spread, as the reference draws
    them. The leaves
    are drawn in declaration order from one generator, so a seed fixes the
    tree (it does not give JAX's numbers)."""
    return _map_defs(defs, lambda p: init_leaf(p, gen, dtype))


def empty_params(defs: ParamDefs, dtype: torch.dtype, device
                 ) -> Dict[str, Any]:
    """An uninitialised param tree of ``defs``' shapes, to load values into."""
    return _map_defs(defs, lambda p: torch.empty(p.shape, dtype=dtype,
                                                 device=device))


class ParamTree(nn.Module):
    """A nested dict of tensors as modules: a tensor becomes a parameter of
    that name, a dict a child ``ParamTree``, a list an ``nn.ModuleList``.
    ``tree["name"]`` reads a parameter or child as ``tree.name`` does."""

    def __init__(self, tree: Mapping[str, Any]):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, torch.Tensor):
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))
            elif isinstance(value, list):
                self.add_module(name, nn.ModuleList(
                    ParamTree(x) for x in value))
            else:
                self.add_module(name, ParamTree(value))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


Params = Union[ParamTree, Mapping[str, Any]]


# the layer stacks of the families' params: a list of per-layer params in
# the port's models, ``(depth, …)`` leaves in the reference's layout
STACKS = ("layers", "enc_layers", "dec_layers")


def layer_list(layers) -> list:
    """The per-layer params of a layer stack: a list (or ``nn.ModuleList``)
    as it is, or the reference's stacked layout (a dict whose leaves carry a
    leading ``n_layers`` dim) as per-layer views of it."""
    if not isinstance(layers, Mapping):
        return layers

    def select(node, i):
        if isinstance(node, Mapping):
            return {k: select(v, i) for k, v in node.items()}
        return node[i]

    def first(node):
        return first(next(iter(node.values()))) \
            if isinstance(node, Mapping) else node
    return [select(layers, i) for i in range(first(layers).shape[0])]


# ---------------------------------------------------------------------------
# tensor and sequence parallelism on a mesh (the module docstring)
# ---------------------------------------------------------------------------

def _groups():
    """The current rules' (data, model) groups, or None without a mesh."""
    rules = current_rules()
    if rules is None or rules.mesh is None:
        return None
    from repro_torch.core.collectives import mesh_groups
    return mesh_groups(rules)


def tp_group(name: str):
    """The model group where the current rules split the logical dim
    ``name`` over the model axis (a rank holds its 1/M of it), else None
    (no mesh, or the dim held whole)."""
    rules = current_rules()
    if rules is None or rules.mesh is None:
        return None
    axes = rules.mesh_axes_for(name)
    if not axes:
        return None
    if axes != (rules.roles["model"],):
        raise ValueError(f"the tensor-parallel paths split {name!r} over the "
                         f"model axis alone, not {axes}")
    return _groups()[1]


def act_shards(length: int):
    """The model group over which the current rules split a sequence of
    ``length`` positions (the residual's ``act_seq``), or None: no mesh,
    ``act_seq`` held whole, or a length that does not divide the axis (a
    decode step's one token)."""
    rules = current_rules()
    if rules is None or rules.mesh is None \
            or not rules.would_shard("act_seq", length):
        return None
    return tp_group("act_seq")


def fsdp(w: torch.Tensor, dim: int, whole: int) -> torch.Tensor:
    """``w`` with its d_model dim ``dim`` whole (``whole`` long): as the
    rank holds it, or its FSDP slice gathered over the data axis (the
    serving layout's ``embed``→data). Raises where the rank holds neither."""
    n = w.shape[dim]
    if n == whole:
        return w
    groups = _groups()
    if groups is None or n * groups[0].k != whole:
        raise ValueError(f"dim {dim} of {tuple(w.shape)} is neither the "
                         f"whole {whole} nor its share of the data axis")
    return groups[0].gather_dim(w, dim)


def seq_gather(x: torch.Tensor, seq) -> torch.Tensor:
    """The whole sequence (dim 1) from this rank's chunk over ``seq`` (the
    group :func:`act_shards` gave), or ``x`` where it is whole (None)."""
    return x if seq is None else seq.gather_dim(x, 1)


def seq_chunk(x: torch.Tensor, seq) -> torch.Tensor:
    """This rank's chunk of a whole sequence (dim 1) over ``seq``, or
    ``x`` (None)."""
    if seq is None:
        return x
    n = x.shape[1] // seq.k
    return x.narrow(1, seq.index * n, n).contiguous()


def tp_sum(y: torch.Tensor, model, seq) -> torch.Tensor:
    """A row-parallel product's partial sums ``y`` (B, S, D) over this
    rank's shard of the contraction → their sum over ``model``, in f32 as
    the reference's payloads are, cast back to y's dtype: this rank's
    act_seq chunk (a sum-scatter along the sequence over ``seq``), or the
    whole sequence where it is whole (``seq`` None)."""
    y32 = y.float()
    out = model.sum(y32) if seq is None else seq.sum_scatter_dim(y32, 1)
    return out.to(y.dtype)


def tp_out(y: torch.Tensor, model, seq) -> torch.Tensor:
    """A layer's output ``y`` (B, S, D) into the residual's layout: the sum
    over ``model`` of a row-parallel product's partials (:func:`tp_sum`),
    or where the contraction is whole (``model`` None) ``y`` cut to this
    rank's chunk (:func:`seq_chunk`)."""
    return seq_chunk(y, seq) if model is None else tp_sum(y, model, seq)


# ---------------------------------------------------------------------------
# numerics
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             model=None) -> torch.Tensor:
    """RMSNorm over the last dim, in f32. With ``model`` (a group) x is this
    rank's slice of that dim and ``scale`` its slice of the scale: the sum
    of squares is summed over the group in f32 before the rsqrt (the gated
    norm of a Mamba2 mixer split by heads)."""
    dtype = x.dtype
    x = x.float()
    if model is None:
        var = torch.mean(x * x, dim=-1, keepdim=True)
    else:
        ss = model.sum(torch.sum(x * x, dim=-1, keepdim=True))
        var = ss / (x.shape[-1] * model.k)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=-1, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + eps)
    return (x * scale.float() + bias.float()).to(dtype)


def norm_defs(d: int, norm_type: str = "rms") -> ParamDefs:
    if norm_type == "layer":
        return {"scale": Param((d,), ("embed",), init="ones"),
                "bias": Param((d,), ("embed",), init="zeros")}
    return {"scale": Param((d,), ("embed",), init="ones")}


def apply_norm(params: Params, x: torch.Tensor, norm_type: str,
               eps: float) -> torch.Tensor:
    """The block's norm of ``x`` (whole or this rank's act_seq chunk: the
    norm is per position), its scale and bias gathered over data where the
    rank holds their FSDP slice."""
    d = x.shape[-1]
    scale = fsdp(params["scale"], 0, d)
    if norm_type == "layer":
        return layer_norm(x, scale, fsdp(params["bias"], 0, d), eps)
    return rms_norm(x, scale, eps)


def rotary_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                   dtype: torch.dtype = torch.float32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (...,) int → cos/sin of shape (..., head_dim//2)."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32), exponent)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); cos/sin: (..., seq, head_dim//2).
    The products are in cos's dtype (f32), as in the reference, where a
    bf16 x promotes against the f32 tables."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = cos[..., None, :]  # broadcast over heads
    sin = sin[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

def embed_defs(vocab: int, d_model: int) -> ParamDefs:
    return {"embedding": Param((vocab, d_model), ("vocab", "embed"))}


# tokens from which a mesh takes the vocab-parallel lookup (the reference's)
SHARDED_MIN_TOKENS = 32768


def embed(params: Params, tokens: torch.Tensor, dtype: torch.dtype,
          seq=None) -> torch.Tensor:
    """Token embedding lookup: a gather of the rows, in ``dtype``. Under
    mesh rules ``tokens`` (B_loc, S) are this rank's rows of the batch and
    ``params["embedding"]`` its (V/M, D/Dn) shard; the result is its rows'
    (B_loc, S, D), or with ``seq`` (:func:`act_shards` of S) its act_seq
    chunk (B_loc, S/M, D); exact (every sum on the way has one nonzero
    term), laid out as the one-device lookup's (contiguous: a gather along
    seq or d_model returns a permuted view, and the layers after it round
    otherwise on a permuted residual stream on the card)."""
    rules = current_rules()
    if rules is not None and rules.mesh is not None:
        return _embed_mesh(params["embedding"], tokens, dtype, rules,
                           seq).contiguous()
    return F.embedding(tokens, params["embedding"]).to(dtype)


def _embed_mesh(table, tokens, dtype, rules, seq):
    from repro_torch.core.collectives import mesh_groups
    data, model = mesh_groups(rules)
    split_v = bool(rules.mesh_axes_for("vocab"))
    split_d = bool(rules.mesh_axes_for("embed"))
    b_loc, s = tokens.shape
    if (b_loc * data.k * s >= SHARDED_MIN_TOKENS and split_v
            and s % model.k == 0):
        x = embed_sharded(table, tokens, dtype, data, model, split_d)
        return x if seq is not None else model.gather_dim(x, 1)
    # decode-sized T: the tokens move and the table stays. Every rank looks
    # up every row of the batch in its shard; the vocab shards' partials
    # are summed over model, the d_model slices gathered over data
    tok = data.gather_dim(tokens, 0)
    x = _masked_lookup(table, tok, model.index * table.shape[0]
                       if split_v else 0)
    if split_v:
        x = model.sum(x)
    if split_d:
        x = data.gather_dim(x, 2)
    return seq_chunk(x.narrow(0, data.index * b_loc, b_loc).to(dtype), seq)


def _masked_lookup(table: torch.Tensor, tokens: torch.Tensor, lo: int
                   ) -> torch.Tensor:
    """f32 rows of the tokens that fall in this shard (its first id ``lo``),
    zeros for the others."""
    ids = tokens - lo
    ok = (ids >= 0) & (ids < table.shape[0])
    x = F.embedding(ids.clamp(0, table.shape[0] - 1), table).float()
    return torch.where(ok[..., None], x, 0.0)


def embed_sharded(table: torch.Tensor, tokens: torch.Tensor,
                  dtype: torch.dtype, data, model, split_d: bool = True
                  ) -> torch.Tensor:
    """The reference's ``_embed_sharded`` on this rank's tokens (B_loc, S)
    and its (V/M, D/Dn) table shard: the table gathered over data (FSDP), a
    masked local gather in f32, the sum-scatter over model into the act_seq
    layout (B_loc, S/M, D), in ``dtype``, as the reference."""
    tab = data.gather_dim(table, 1) if split_d else table
    x = _masked_lookup(tab, tokens, model.index * tab.shape[0])
    return model.sum_scatter_dim(x, 1).to(dtype)


def unembed(params: Params, x: torch.Tensor, tied: bool) -> torch.Tensor:
    """x @ tableᵀ. Under mesh rules the table (the tied embedding or the
    untied ``out_embedding``) is this rank's (V/M, D/Dn) shard and ``x``
    (B_loc, D) this rank's rows (a prefill's last position, a decode
    step's token): the table stays where it sits and the rows move, as
    the reference's decode-sized paths do. Where the table's d_model is
    split, every data rank's rows are gathered, each rank's partial logits
    over its d_model slice summed over data in f32 and its rows kept; the
    vocab shards' logits are gathered over model."""
    table = params["embedding"] if tied else params["out_embedding"]
    rules = current_rules()
    if rules is None or rules.mesh is None:
        return x @ table.to(x.dtype).T
    d, d_loc = x.shape[-1], table.shape[1]
    if d_loc == d:
        logits = x @ table.to(x.dtype).T
    else:
        data = _groups()[0]
        if d_loc * data.k != d:
            raise ValueError(f"a table of {tuple(table.shape)} is neither "
                             f"the whole d_model {d} nor its share of the "
                             f"data axis")
        rows = x.shape[0]
        xg = data.gather_dim(x, 0).narrow(-1, data.index * d_loc, d_loc)
        part = (xg @ table.to(x.dtype).T).float()
        logits = data.sum(part).to(x.dtype).narrow(0, data.index * rows,
                                                   rows)
    model = tp_group("vocab")
    return logits if model is None else model.gather_dim(logits, -1)


def unembed_defs(vocab: int, d_model: int, tied: bool) -> ParamDefs:
    if tied:
        return {}
    return {"out_embedding": Param((vocab, d_model), ("vocab", "embed"))}


# ---------------------------------------------------------------------------
# dense (SwiGLU) MLP
# ---------------------------------------------------------------------------

def mlp_defs(d_model: int, d_ff: int) -> ParamDefs:
    return {
        "w_gate": Param((d_model, d_ff), ("embed", "mlp"), init="fan_in"),
        "w_up": Param((d_model, d_ff), ("embed", "mlp"), init="fan_in"),
        "w_down": Param((d_ff, d_model), ("mlp", "embed"), init="fan_in"),
    }


def mlp(params: Params, x: torch.Tensor, seq=None) -> torch.Tensor:
    """The SwiGLU MLP of ``x`` (B, S, D), or with ``seq`` of this rank's
    act_seq chunk (the output the same chunk). Where the rules split
    ``mlp`` the rank holds the column shards of ``w_gate``/``w_up`` and
    the row shard of ``w_down``: the sequence gathered, its hidden
    (B, S, F/M), the partial sums summed over model (:func:`tp_sum`);
    else the MLP runs on what ``x`` holds (it is per position)."""
    dtype = x.dtype
    d = x.shape[-1]
    model = tp_group("mlp")
    if model is not None:
        x = seq_gather(x, seq)
    gate = x @ fsdp(params["w_gate"], 0, d).to(dtype)
    up = x @ fsdp(params["w_up"], 0, d).to(dtype)
    out = (F.silu(gate) * up) @ fsdp(params["w_down"], 1, d).to(dtype)
    return out if model is None else tp_sum(out, model, seq)
