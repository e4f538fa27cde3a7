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

The reference's ``constrain`` and ``sharding_for`` have no counterpart:
they hand a spec to XLA's SPMD partitioner, and PyTorch's eager program has
none. The port shards no weights yet (ROADMAP item 21); its trainer splits
the batch over its ranks (:mod:`repro_torch.core.local_sgd`).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

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
    def __init__(self, rules: Mapping[str, Tuple[str, ...]], mesh=None):
        self.rules = dict(rules)
        self.mesh = mesh
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
    return ShardingRules(rules, mesh)


def strip_axes(rules: ShardingRules, axes) -> ShardingRules:
    """Rules with the given mesh axes removed from every mapping (the
    reference uses it inside ``shard_map`` bodies, whose axes are manual)."""
    axes = set(axes)
    stripped = {k: tuple(a for a in (v if not isinstance(v, str) else (v,))
                         if a not in axes)
                for k, v in rules.rules.items()}
    return ShardingRules(stripped, rules.mesh)


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
