"""Logical-axis sharding rules, the port of ``repro.sharding``: rules map
logical dim names to mesh axes.

Model code declares each parameter's dims by *logical* name
(:class:`repro_torch.models.layers.Param`'s ``logical``, e.g. ``("embed",
"heads", "head_dim")``); a :class:`ShardingRules` decides which mesh axis
each logical name lands on, with a fallback to replication where a dim's
size is not divisible by the mesh axes' size (e.g. smollm's 15 heads on a
16-way model axis), and each mesh axis used at most once in an array.

A spec is a plain tuple, one entry a dim up to the last sharded one: ``None``
(replicated), a mesh axis name, or a tuple of names (the reference's
``PartitionSpec`` entries). :func:`shard_shape` gives the per-device shape a
spec leaves of an array on a mesh's axis sizes, which the dry run reads.

:func:`use_rules` makes rules current for the calls inside it, as the
reference's does; the model code reads them with :func:`current_rules` and
takes its mesh paths where they have a mesh. :func:`shard_of` and
:func:`shard_tree` give the slice of each dim that this rank's mesh
coordinates take (the port's counterpart of placing an array under a
``NamedSharding``); :func:`unshard_tree` puts the ranks' slices back
together.

The reference's ``constrain`` and ``sharding_for`` have no counterpart:
they hand a spec to XLA's SPMD partitioner, and PyTorch's eager program has
none. So a rank holds each weight as the slice its mesh path reads, and the
model code computes on what it holds. Serving and training on a mesh with a
model axis both hold every leaf as ``spec_for`` gives it under rules fitted
to the model's dims (:func:`model_dims`; :func:`serve_specs`,
:func:`train_specs`): the attention's heads, the MLP's columns, the Mamba2
mixers' heads, the vocab and the experts over model, each d_model dim over
data (FSDP), a dim held whole where it does not divide; the layers run
tensor and sequence parallel (:mod:`repro_torch.models.layers`). The
serving engine holds the decode cache by its own axes
(:class:`repro_torch.launch.serve.ServeEngine`); the trainer holds its
optimizer moments and sync state as their params
(:mod:`repro_torch.core.local_sgd`), and on a mesh without a model axis
shards no weights and splits the batch over its ranks.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple, Union

from repro_torch.config.base import MeshConfig

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]

# Default logical→mesh assignment, the reference's. "fsdp" role rides the
# data axis; tensor parallel rides the model axis; the local-SGD replica dim
# rides the pod axis.
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "replica": ("pod",),
    "batch": ("data",),
    "seq": (),
    # sequence-sharded residual stream (Megatron-SP)
    "act_seq": ("model",),
    # context-parallel attention: off by default
    "attn_q_seq": (),
    # grouped-query scores (B, kv, g, s, t): kv heads first, else the
    # q-group dim (spec_for's divisibility and used-axis rules)
    "q_group": ("model",),
    # flattened token dim (B·S): both the batch and the act_seq factors
    "tokens": ("data", "model"),
    "cache_seq": ("model",),      # sequence-sharded KV cache
    "embed": ("data",),           # FSDP shard of the contraction dim
    "embed_tp": ("model",),       # 2D-sharded weights for serving
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "expert_embed": ("data",),    # MoE tables' d_model dim (FSDP)
    "expert_cap": ("data",),      # MoE expert-buffer capacity dim
    "expert_mlp": (),
    "layers": (),
    "ssm_state": (),
    "ssm_heads": ("model",),
    "conv": (),
    "stats": (),
}


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a mesh: the port's
    :class:`repro_torch.launch.mesh.Mesh` (``axes``, ``shape``), a
    :class:`MeshConfig` (``axis_names``, ``shape``), or anything with
    ``axis_names`` and ``devices.shape`` (a ``jax.sharding.Mesh``); ``{}``
    for ``None``."""
    if mesh is None:
        return {}
    names = getattr(mesh, "axis_names", None) or mesh.axes
    shape = mesh.devices.shape if hasattr(mesh, "devices") else mesh.shape
    return dict(zip(names, (int(s) for s in shape)))


class ShardingRules:
    """``rules`` (logical name → mesh axes) sized on ``mesh``; ``roles``
    names the mesh's data and model axes (``{"data": …, "model": …}``),
    which the models' mesh paths take their groups from
    (:func:`repro_torch.core.collectives.mesh_groups`) whatever the rules
    hold whole."""

    def __init__(self, rules: Mapping[str, Tuple[str, ...]], mesh=None,
                 roles: Optional[Mapping[str, str]] = None):
        self.rules = dict(rules)
        self.mesh = mesh
        self.roles = dict(roles or {"data": "data", "model": "model"})
        self._axis_sizes = axis_sizes(mesh)

    def mesh_axes_for(self, logical: Optional[str]) -> Tuple[str, ...]:
        if logical is None:
            return ()
        axes = self.rules.get(logical, ())
        if axes is None:
            return ()
        if isinstance(axes, str):
            axes = (axes,)
        # drop axes absent from the mesh (e.g. "pod" on the single-pod mesh)
        return tuple(a for a in axes if a in self._axis_sizes)

    def would_shard(self, logical: Optional[str], size: int) -> bool:
        """Whether a dim of this logical name and size shards on this
        mesh."""
        total = 1
        for a in self.mesh_axes_for(logical):
            total *= self._axis_sizes.get(a, 1)
        return total > 1 and size % total == 0

    def spec_for(self, logical_axes: Sequence[Optional[str]],
                 shape: Optional[Sequence[int]] = None) -> Spec:
        """The spec of one array; replicates non-divisible dims and uses each
        mesh axis at most once (an earlier dim takes it first)."""
        entries = []
        used: set = set()
        for i, name in enumerate(logical_axes):
            axes = tuple(a for a in self.mesh_axes_for(name) if a not in used)
            if shape is not None and axes:
                size = 1
                for a in axes:
                    size *= self._axis_sizes.get(a, 1)
                if size and shape[i] % size != 0:
                    axes = ()
            used.update(axes)
            if len(axes) == 0:
                entries.append(None)
            elif len(axes) == 1:
                entries.append(axes[0])
            else:
                entries.append(axes)
        while entries and entries[-1] is None:
            entries.pop()
        return tuple(entries)

    def shard_shape(self, spec: Spec, shape: Sequence[int]) -> Tuple[int, ...]:
        """The per-device shape ``spec`` leaves of an array of ``shape`` on
        this rules' mesh: each sharded dim divided by the product of its
        mesh axes' sizes."""
        out = []
        for i, n in enumerate(shape):
            entry = spec[i] if i < len(spec) else None
            axes = (entry,) if isinstance(entry, str) else entry or ()
            div = 1
            for a in axes:
                div *= self._axis_sizes.get(a, 1)
            if n % div:
                raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                                 f"over {axes} ({div})")
            out.append(n // div)
        return tuple(out)


_RULES: contextvars.ContextVar = contextvars.ContextVar("sharding_rules",
                                                       default=None)


def current_rules() -> Optional[ShardingRules]:
    """The rules :func:`use_rules` made current, or None."""
    return _RULES.get()


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    """Make ``rules`` current inside the block (None: no rules)."""
    token = _RULES.set(rules)
    try:
        yield rules
    finally:
        _RULES.reset(token)


def rules_for(mesh_cfg: MeshConfig, mesh=None,
              overrides: Optional[Dict[str, Tuple[str, ...]]] = None
              ) -> ShardingRules:
    """The default rules with the role axes remapped onto ``mesh_cfg``'s
    axis names (data, model, and the replica axis or ``"pod"``), then
    ``overrides``; sized on ``mesh`` (see :func:`axis_sizes`)."""
    rules = dict(DEFAULT_RULES)
    remap = {"data": mesh_cfg.data_axis, "model": mesh_cfg.model_axis,
             "pod": mesh_cfg.replica_axis or "pod"}
    rules = {k: tuple(remap.get(a, a)
                      for a in (v if not isinstance(v, str) else (v,)))
             if v else ()
             for k, v in rules.items()}
    if overrides:
        rules.update(overrides)
    return ShardingRules(rules, mesh, {"data": mesh_cfg.data_axis,
                                       "model": mesh_cfg.model_axis})


def fitted_rules(mesh_cfg: MeshConfig, mesh,
                 dims: Mapping[str, Union[int, Sequence[int]]]
                 ) -> ShardingRules:
    """:func:`rules_for` with each logical dim of ``dims`` (name → its size,
    or the sizes of every dim of that name) held whole where a size does
    not divide its mesh axes, so the model code reads from the rules how a
    rank holds it."""
    rules = rules_for(mesh_cfg, mesh)
    held = {}
    for name, sizes in dims.items():
        sizes = (sizes,) if isinstance(sizes, int) else tuple(sizes)
        if not all(rules.would_shard(name, n) for n in sizes):
            held[name] = ()
    return rules_for(mesh_cfg, mesh, held)


def model_dims(cfg) -> Dict[str, Union[int, Tuple[int, ...]]]:
    """The logical dims of a model (``cfg`` a ``ModelConfig``) that a rank
    on a mesh holds split where they divide their mesh axes, by name → the
    size of each dim of that name (:func:`fitted_rules`' table): the
    vocab, d_model, the experts and the expert tables' d_model, the
    attention's query and KV heads, ``mlp`` (the MLP's d_ff and the Mamba2
    mixers' d_inner together: a mixer's columns are its heads') and the
    mixers' heads. The serving engine's rules
    (:func:`repro_torch.launch.serve.serving_rules`) and the trainer's
    (:func:`training_rules`) both fit these."""
    dims: Dict[str, Union[int, Tuple[int, ...]]] = {
        "vocab": cfg.vocab_size, "embed": cfg.d_model}
    if cfg.is_moe:
        dims.update(experts=cfg.moe.num_experts, expert_embed=cfg.d_model)
    mlp = []
    if cfg.family != "ssm":
        dims.update(heads=cfg.n_heads, kv_heads=cfg.n_kv_heads)
    if cfg.family in ("dense", "vlm", "audio", "hybrid"):
        mlp.append(cfg.d_ff)
    if cfg.family in ("ssm", "hybrid"):
        d_inner = cfg.ssm.expand * cfg.d_model
        mlp.append(d_inner)
        dims["ssm_heads"] = d_inner // cfg.ssm.head_dim
    if mlp:
        dims["mlp"] = tuple(mlp)
    return dims


def training_rules(cfg, mesh) -> Optional[ShardingRules]:
    """The rules a trainer (``cfg`` a ``TrainConfig``) runs under on
    ``mesh`` (a live :class:`repro_torch.launch.mesh.Mesh`, or anything
    :func:`axis_sizes` reads), or None where the mesh has no model axis
    (the trainer then splits only the batch). The reference's training
    rules (``rules_for(cfg.mesh, mesh)``) with the dims of
    :func:`model_dims` held whole where a size of them does not divide its
    mesh axes (as :func:`fitted_rules`), so that the model code reads from
    the rules how a rank holds each: the attention's heads, the MLP's
    columns, the Mamba2 mixers' heads and the vocab over model, each
    d_model dim over data, the residual's ``act_seq`` over model where a
    sequence's length divides the axis (decided per call,
    :func:`repro_torch.models.layers.act_shards`). Under a replica strategy
    the replica axis is stripped, as the reference's local-SGD block
    strips its manual axis."""
    if mesh is None or cfg.mesh.model_axis not in axis_sizes(mesh):
        return None
    if cfg.mesh.data_axis not in axis_sizes(mesh):
        raise ValueError(f"a trainer on a mesh with a model axis needs a "
                         f"data axis too (of 1 rank where the batch is not "
                         f"split): {mesh!r}")
    rules = fitted_rules(cfg.mesh, mesh, model_dims(cfg.model))
    if cfg.sync.strategy in ("periodic", "hierarchical"):
        rules = strip_axes(rules, {cfg.mesh.replica_axis or "pod"})
    return rules


def strip_axes(rules: ShardingRules, axes) -> ShardingRules:
    """Rules with the given mesh axes removed from every mapping (the
    reference uses it inside ``shard_map`` bodies, whose axes are manual)."""
    axes = set(axes)
    stripped = {k: tuple(a for a in (v if not isinstance(v, str) else (v,))
                         if a not in axes)
                for k, v in rules.rules.items()}
    return ShardingRules(stripped, rules.mesh, rules.roles)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def tree_specs(logical_tree, shapes_tree, rules: ShardingRules):
    """A tree of logical-axis tuples and the matching tree of shapes (nested
    dicts and lists alike) → the tree of specs."""
    if _is_axes(logical_tree):
        return rules.spec_for(logical_tree, shapes_tree)
    if isinstance(logical_tree, list):
        return [tree_specs(la, shp, rules)
                for la, shp in zip(logical_tree, shapes_tree, strict=True)]
    if logical_tree.keys() != shapes_tree.keys():
        raise ValueError(f"trees differ: {sorted(logical_tree)} against "
                         f"{sorted(shapes_tree)}")
    return {k: tree_specs(v, shapes_tree[k], rules)
            for k, v in logical_tree.items()}


# ---------------------------------------------------------------------------
# a rank's shard
# ---------------------------------------------------------------------------

def entry_axes(entry: MeshAxes) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, the slowest first."""
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def spec_axes(spec: Spec) -> set:
    """The mesh axes a spec splits its array over."""
    return {a for entry in spec for a in entry_axes(entry)}


def _block(entry: MeshAxes, coords: Mapping[str, int],
           sizes: Mapping[str, int]) -> Tuple[int, int]:
    """(this block's index, the number of blocks) of one spec entry: its
    axes row-major, the first the slowest, as ``PartitionSpec`` orders a
    tuple of axes."""
    index, count = 0, 1
    for a in entry_axes(entry):
        index = index * sizes[a] + coords[a]
        count *= sizes[a]
    return index, count


def coords_of(mesh) -> Dict[str, int]:
    """This rank's index along each axis of ``mesh`` (a live
    :class:`repro_torch.launch.mesh.Mesh`)."""
    return {a: mesh.rank(a) for a in axis_sizes(mesh)}


def _slice(tensor, spec: Spec, coords, sizes):
    out = tensor
    for dim, entry in enumerate(spec):
        index, count = _block(entry, coords, sizes)
        if count == 1:
            continue
        if out.shape[dim] % count:
            raise ValueError(f"dim {dim} of {tuple(tensor.shape)} does not "
                             f"split over {entry_axes(entry)} ({count})")
        size = out.shape[dim] // count
        out = out.narrow(dim, index * size, size)
    return out


def shard_of(tensor, spec: Spec, mesh):
    """The slice of ``tensor`` that this rank's coordinates on ``mesh``
    take under ``spec`` (a view; each sharded dim must divide)."""
    return _slice(tensor, spec, coords_of(mesh), axis_sizes(mesh))


def block_of(tensor, spec: Spec, coords: Mapping[str, int], mesh):
    """The slice of ``tensor`` that the mesh coordinates ``coords`` (axis →
    index) take under ``spec`` on ``mesh`` (anything :func:`axis_sizes`
    reads): another rank's :func:`shard_of`, seen from here."""
    return _slice(tensor, spec, coords, axis_sizes(mesh))


def map_with_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree (nested dicts and lists, visited in
    the tree's own order) and the matching tree of specs."""
    if isinstance(tree, Mapping):
        if set(tree) != set(specs):
            raise ValueError(f"trees differ: {sorted(tree)} against "
                             f"{sorted(specs)}")
        return {k: map_with_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_specs(fn, t, s)
                for t, s in zip(tree, specs, strict=True)]
    return fn(tree, specs)


def shard_tree(tree, specs, mesh):
    """:func:`shard_of` over a tree (nested dicts and lists) and the matching
    tree of specs."""
    coords, sizes = coords_of(mesh), axis_sizes(mesh)
    return map_with_specs(lambda t, s: _slice(t, s, coords, sizes), tree,
                          specs)


def unshard_tree(trees: Sequence, specs, mesh):
    """The whole tree from every rank's :func:`shard_tree` (``trees`` in
    world-rank order, numpy arrays or tensors; ``mesh`` anything
    :func:`axis_sizes` reads, e.g. a :class:`MeshConfig`): each leaf the
    ranks' slices put back along every sharded dim. The inverse of
    :func:`shard_tree` for the tests; ranks that hold one block alike must
    hold it bitwise alike."""
    import numpy as np
    sizes = axis_sizes(mesh)
    names = list(sizes)
    world = 1
    for n in sizes.values():
        world *= n
    if len(trees) != world:
        raise ValueError(f"{len(trees)} trees for a mesh of {world} ranks")
    coords = [dict(zip(names, np.unravel_index(r, tuple(sizes.values()))))
              for r in range(world)]

    def join(spec, *parts):
        parts = [np.asarray(p) for p in parts]
        shape = list(parts[0].shape)
        for dim, entry in enumerate(spec):
            shape[dim] *= _block(entry, coords[0], sizes)[1]
        out = np.zeros(shape, parts[0].dtype)
        filled = np.zeros(shape, bool)
        for part, c in zip(parts, coords):
            index = tuple(slice(_block(e, c, sizes)[0] * n,
                                (_block(e, c, sizes)[0] + 1) * n)
                          for e, n in zip(spec, part.shape))
            if filled[index].any() and not np.array_equal(out[index], part):
                raise ValueError("two ranks hold one block differently")
            out[index] = part
            filled[index] = True
        return out

    def walk(spec_node, *nodes):
        if isinstance(spec_node, Mapping):
            return {k: walk(v, *(n[k] for n in nodes))
                    for k, v in spec_node.items()}
        if isinstance(spec_node, list):
            return [walk(s, *(n[i] for n in nodes))
                    for i, s in enumerate(spec_node)]
        return join(spec_node, *nodes)
    return walk(specs, *trees)


# ---------------------------------------------------------------------------
# what a serving and a training rank hold
# ---------------------------------------------------------------------------

def serve_specs(defs, rules: ShardingRules):
    """The tree of specs of a model's params under ``rules``:
    ``rules.spec_for`` of every leaf's logical axes and shape, as the
    reference places its params (``sharding_for`` of every leaf when it
    serves, ``state_shardings`` when it trains). A serving rank holds its
    params so, and a training rank each layer of its replica's
    (:func:`train_specs`). ``defs`` is the model's ``param_defs()`` (its
    leaves carry ``logical`` and ``shape``)."""
    return _map_defs(defs, lambda p: rules.spec_for(p.logical, p.shape))


def _map_defs(node, fn):
    if isinstance(node, Mapping):
        return {k: _map_defs(v, fn) for k, v in node.items()}
    if isinstance(node, list):
        return [_map_defs(v, fn) for v in node]
    return fn(node)


def train_specs(defs, rules: ShardingRules):
    """The tree of specs a training rank holds one replica's params under,
    in the trainer's layout: :func:`serve_specs`, each layer stack (a list
    in ``defs``) one dict of ``(depth, …)`` leaves whose depth dim stays
    whole (the spec's first entry ``None``; the reference's ``layers``
    dim, which no mesh axis takes)."""
    def stack(node):
        if isinstance(node, Mapping):
            return {k: stack(v) for k, v in node.items()}
        if isinstance(node, list):
            first = node[0]
            if any(layer != first for layer in node):
                raise ValueError("the layers of a stack hold their leaves "
                                 "under different specs")
            return map_with_specs(
                lambda spec, _: (None,) + spec if any(spec) else (),
                first, first)
        return node
    return stack(serve_specs(defs, rules))


def flat_keys(tree, prefix: str = "") -> Dict[str, Any]:
    """A tree's leaves by dotted key (``layers.0.moe.w_gate``), as a
    ``ParamTree``'s state dict names them."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, list):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix[:-1]: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(flat_keys(v, f"{prefix}{k}."))
    return out
