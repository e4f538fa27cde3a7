"""Shape cells and the per-card calls of the dry run, the port of
``repro.launch.specs``.

A *cell* is an architecture × input shape. :func:`build_cell` builds the
call one card of a mesh makes for it, on the meta device (nothing is drawn
or computed: :class:`repro_torch.launch.roofline.WorkCounter` counts it):

* train cells: the trainer's step (:func:`repro_torch.core.local_sgd.
  make_ddp_step`, or under a replica strategy the local-SGD block of
  ``sync.period`` steps with the rank's one replica), with the plain
  attention and chunked SSD scan the trainer runs and ``remat``;
* prefill: ``model.prefill`` on the flash and SSD kernels (their work
  recorded from their shapes);
* decode: one ``model.decode_step`` against a cache of the cell's length.

The per-card batch is the share of the batch axes that the sharding rules
give (:mod:`repro_torch.sharding`). A cell counts the one-card call: the
whole model run on its rows, so along the model axis the cards repeat each
other's work, which the record's ``useful_ratio`` shows (the mesh paths'
collectives cannot run on one process). A train cell's state is counted at
the shapes a rank of the cell's mesh holds it in: every leaf, its optimizer
moments and its sync state at the shard shape
:func:`repro_torch.sharding.train_specs` gives under
:func:`repro_torch.sharding.training_rules`, as the trainer on a mesh with
a model axis holds them. Serving cells count the
weights whole (a ``ServeEngine(mesh=)`` rank holds its shard of every
weight, as ``sharding.serve_specs`` gives it, and of the cache).
The collectives a card's call would make across the mesh (the gradients'
all-reduce over the batch axes, the replicas' sync) are priced from
:func:`repro_torch.core.costmodel.wire_bytes_per_sync` on the link of the
axis they cross (:func:`repro_torch.launch.roofline.link_for_axis`).

Cells (LM shapes are seq_len × global_batch), the reference's:
    train_4k     S=4096   B=256   → train step (DDP or local SGD)
    prefill_32k  S=32768  B=32    → prefill
    decode_32k   S=32768  B=128   → one decode step against an S-long cache
    long_500k    S=524288 B=1     → decode; sub-quadratic archs only
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import tree as T
from repro_torch.config import TrainConfig, get_arch
from repro_torch.config.base import (DataConfig, MeshConfig, ModelConfig,
                                     OptimizerConfig, SyncConfig)
from repro_torch.core import costmodel
from repro_torch.core import local_sgd as LS
from repro_torch.core import sync as SY
from repro_torch.launch.roofline import WorkCounter, link_for_axis
from repro_torch.models import layers as L
from repro_torch.models.registry import analytic_param_count, build_model
from repro_torch.optim import apply_updates_
from repro_torch.sharding import (axis_sizes, map_with_specs, rules_for,
                                  train_specs, training_rules)

META = torch.device("meta")
SERVE_DTYPE = torch.bfloat16     # the serving cells' weights and caches


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPE_CELLS: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train", 4_096, 256),
    "prefill_32k": ShapeCell("prefill", 32_768, 32),
    "decode_32k": ShapeCell("decode", 32_768, 128),
    "long_500k": ShapeCell("decode", 524_288, 1),
}

# one card, and the reference's production meshes
# (``repro.launch.mesh.production_mesh_config``)
MESHES: Dict[str, MeshConfig] = {
    "1": MeshConfig(shape=(1,), axis_names=("data",)),
    "16x16": MeshConfig(shape=(16, 16), axis_names=("data", "model")),
    "2x16x16": MeshConfig(shape=(2, 16, 16),
                          axis_names=("pod", "data", "model"),
                          replica_axis="pod"),
}


def cell_runnable(cfg: ModelConfig, shape_name: str) -> Tuple[bool, str]:
    """The reference's mandated skips."""
    if shape_name == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention arch: 524k-token decode is "
                       "quadratic/cache-infeasible — mandated skip")
    return True, ""


def model_flops_estimate(cfg: ModelConfig, kind: str, batch: int,
                         seq: int) -> float:
    """6·N_active·tokens (train), 2·N_active·tokens (prefill), 2·N_active a
    request (decode): the reference's MODEL_FLOPS."""
    n_active = analytic_param_count(cfg, active_only=True)
    if kind == "train":
        return 6.0 * n_active * batch * seq
    if kind == "prefill":
        return 2.0 * n_active * batch * seq
    if kind == "decode":
        return 2.0 * n_active * batch      # one token per request
    raise ValueError(kind)


def make_train_config(cfg: ModelConfig, mesh_cfg: MeshConfig, cell: ShapeCell,
                      sync: Optional[SyncConfig] = None,
                      optimizer: str = "adamw", remat: str = "full",
                      ) -> TrainConfig:
    """The reference's train config of a cell: AdamW, cosine, bf16 moments
    past 100 B params."""
    moment_dtype = ("bfloat16"
                    if analytic_param_count(cfg) > 100e9 else "float32")
    return TrainConfig(
        model=cfg,
        mesh=mesh_cfg,
        sync=sync or SyncConfig(),
        optimizer=OptimizerConfig(name=optimizer, learning_rate=3e-4,
                                  schedule="cosine", warmup_steps=100,
                                  total_steps=10_000, grad_clip=1.0,
                                  moment_dtype=moment_dtype),
        data=DataConfig(seq_len=cell.seq, global_batch=cell.batch),
        remat=remat,
    )


@dataclasses.dataclass
class BuiltCell:
    arch: str
    shape_name: str
    kind: str
    run: Callable[[], Any]         # one card's call, on the meta device
    model_flops: float             # the reference's estimate, all cards
    param_count: int
    active_param_count: int
    batch_per_card: int
    opt_steps: int                 # optimizer steps in one call
    state_bytes: int               # what a card holds before the call
    wire: Dict[str, float]         # collective bytes a card, by link
    collectives: Dict[str, dict]
    notes: str = ""
    # (a call of the same work, times): what the call repeats, counted once
    repeat: Optional[Tuple[Callable[[], Any], int]] = None

    def count(self) -> WorkCounter:
        """The call's work: ``run`` under a counter, plus ``repeat``'s
        call counted once and added its number of times."""
        counter = WorkCounter()
        with counter:
            self.run()
        if self.repeat is not None:
            fn, times = self.repeat
            again = WorkCounter()
            with again:
                fn()
            counter.add(again, times)
        return counter


def _batch_per_card(mesh_cfg: MeshConfig, axes: Tuple[str, ...],
                    batch: int) -> int:
    rules = rules_for(mesh_cfg, mesh_cfg, overrides={"batch": axes})
    spec = rules.spec_for(("batch",), (batch,))
    return rules.shard_shape(spec, (batch,))[0]


def _inputs(cfg: ModelConfig, kind: str, batch: int, seq: int,
            dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The model's train or prefill inputs on the meta device, as the
    reference's ``input_layout`` shapes them: the VLM's text after its
    image prefix, the audio family's frames beside the tokens."""
    s = max(1, seq - cfg.num_image_tokens) if cfg.family == "vlm" else seq
    tok = torch.zeros((batch, s), dtype=torch.long, device=META)
    out = {"tokens": tok}
    if kind == "train":
        out["targets"] = tok.clone()
    if cfg.family == "vlm":
        out["patches"] = torch.zeros((batch, cfg.num_image_tokens,
                                      cfg.d_model), dtype=dtype, device=META)
    if cfg.family == "audio":
        out["frames"] = torch.zeros((batch, cfg.n_audio_frames, cfg.d_model),
                                    dtype=dtype, device=META)
    return out


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in T.leaves(tree)
               if isinstance(t, torch.Tensor))


def _held_bytes(state, model, tcfg: TrainConfig, mesh_cfg: MeshConfig,
                replicated: bool) -> int:
    """The bytes of a trainer ``state`` as a rank of ``mesh_cfg`` holds it:
    each params/opt/sync leaf at its shard shape under the training rules
    (:func:`repro_torch.core.local_sgd.state_specs`), whole where the mesh
    has no model axis."""
    rules = training_rules(tcfg, mesh_cfg)
    if rules is None:
        return _bytes(state)
    specs = LS.state_specs(state, train_specs(model.param_defs(), rules),
                           replicated)
    total = 0
    for key in ("params", "opt", "sync"):
        def held(t, spec):
            n = 1
            for d in rules.shard_shape(spec, t.shape):
                n *= d
            return n * t.element_size()
        total += sum(T.leaves(map_with_specs(held, state[key], specs[key])))
    return total


def _wire(sizes: Dict[str, int], axes, param_bytes: float, k: int,
          cfg: SyncConfig, times: int, name: str, out: Dict[str, float],
          colls: Dict[str, dict]) -> None:
    """Add ``times`` collectives of ``cfg`` over ``axes`` (k ranks) of
    ``param_bytes`` a rank to the wire bytes of their link."""
    if k <= 1:
        return
    link = "ib" if any(link_for_axis(sizes, a) == "ib" for a in axes) \
        else "nvlink"
    wire = times * costmodel.wire_bytes_per_sync(param_bytes, k, cfg)
    out[link] += wire
    colls[name] = {"count": times, "group": k, "axes": list(axes),
                   "link": link, "wire_bytes": wire}


def build_cell(arch: str, shape_name: str, mesh_cfg: MeshConfig, *,
               sync: Optional[SyncConfig] = None, remat: str = "full",
               cfg_override: Optional[ModelConfig] = None) -> BuiltCell:
    cell = SHAPE_CELLS[shape_name]
    cfg = cfg_override or get_arch(arch)
    ok, reason = cell_runnable(cfg, shape_name)
    if not ok:
        raise ValueError(f"cell {arch}×{shape_name} skipped: {reason}")
    sizes = axis_sizes(mesh_cfg)
    param_count = analytic_param_count(cfg)
    common = dict(arch=arch, shape_name=shape_name, kind=cell.kind,
                  model_flops=model_flops_estimate(cfg, cell.kind, cell.batch,
                                                   cell.seq),
                  param_count=param_count,
                  active_param_count=analytic_param_count(cfg, True))
    wire = {"nvlink": 0.0, "ib": 0.0}
    colls: Dict[str, dict] = {}
    rep_axis = mesh_cfg.replica_axis or "pod"
    data = (mesh_cfg.data_axis,) if mesh_cfg.data_axis in sizes else ()

    if cell.kind == "train":
        tcfg = make_train_config(cfg, mesh_cfg, cell, sync=sync, remat=remat)
        model = build_model(cfg, attn_impl="torch", ssd_impl="torch",
                            remat=remat)
        params = L.empty_params(model.param_defs(),
                                getattr(torch, cfg.param_dtype), META)
        grad_bytes = 4.0 * param_count
        local = SY.needs_replica_axis(tcfg.sync)
        axes = ((rep_axis,) if rep_axis in sizes and (
            local or mesh_cfg.replica_axis) else ()) + data
        b = _batch_per_card(mesh_cfg, axes, cell.batch)
        batch = _inputs(cfg, "train", b, cell.seq,
                        getattr(torch, cfg.dtype))
        n_data = sizes.get(mesh_cfg.data_axis, 1)
        notes = ("state as a rank holds it: every leaf, its moments and "
                 "sync state at train_specs' shard shapes; the one-card "
                 "call counted")
        if not local:
            state = LS.state_of(params, tcfg)
            step = LS.make_ddp_step(model, tcfg)
            k = 1
            for a in axes:
                k *= sizes[a]
            _wire(sizes, axes, grad_bytes, k, SyncConfig(), 1,
                  "grad_all_reduce", wire, colls)
            return BuiltCell(run=lambda: step(state, batch),
                             batch_per_card=b, opt_steps=1,
                             state_bytes=_held_bytes(state, model, tcfg,
                                                     mesh_cfg, False)
                             + _bytes(batch),
                             wire=wire, collectives=colls, notes=notes,
                             **common)
        # a rank's one replica through the local-SGD block (on one process
        # "periodic" computes hierarchical's block); its gradient
        # all-reduced over the data ranks every step, the replicas synced
        # over the replica axis every H steps
        h = max(1, tcfg.sync.period)
        block_cfg = dataclasses.replace(
            tcfg, sync=dataclasses.replace(tcfg.sync, strategy="periodic"),
            mesh=MeshConfig(shape=(1,), axis_names=(rep_axis,),
                            replica_axis=rep_axis))
        state = LS.state_of(params, block_cfg, replicas=1)
        block = LS.make_local_sgd_block(model, block_cfg)
        _wire(sizes, data, grad_bytes, n_data, SyncConfig(), h,
              "grad_all_reduce", wire, colls)
        _wire(sizes, (rep_axis,), grad_bytes, sizes.get(rep_axis, 1),
              tcfg.sync, 1, "replica_sync", wire, colls)
        # the block's H local steps have one shape: it is counted as the
        # block of one microbatch (its copy, a step, the sync) and H − 1
        # more of its steps (a replica's gradient and update)
        one = {k: v.unsqueeze(0) for k, v in batch.items()}
        p_r = T.map(lambda x: x[0], state["params"])
        o_r = T.map(lambda x: x[0], state["opt"])

        def local_step():
            grads = LS.value_and_grad(model, p_r, batch)[2]
            apply_updates_(block_cfg.optimizer, grads, o_r, p_r, 0)
        return BuiltCell(run=lambda: block(state, one), batch_per_card=b,
                         opt_steps=h, repeat=(local_step, h - 1),
                         state_bytes=_held_bytes(state, model, tcfg,
                                                 mesh_cfg, True)
                         + h * _bytes(batch),
                         wire=wire, collectives=colls, notes=notes, **common)

    # serving: the batch over the replica and data axes
    model = build_model(cfg, attn_impl="kernel", ssd_impl="kernel")
    params = L.empty_params(model.param_defs(), SERVE_DTYPE, META)
    axes = ((mesh_cfg.replica_axis,) if mesh_cfg.replica_axis else ()) + data
    b = _batch_per_card(mesh_cfg, axes, cell.batch)
    if cell.kind == "prefill":
        batch = _inputs(cfg, "prefill", b, cell.seq, SERVE_DTYPE)

        def run():
            with torch.no_grad():
                return model.prefill(params, batch)
    else:
        batch = {"token": torch.zeros((b, 1), dtype=torch.long, device=META),
                 "cache": model.init_cache(b, cell.seq, SERVE_DTYPE, META),
                 "index": cell.seq - 1}

        def run():
            with torch.no_grad():
                return model.decode_step(params, batch)
    return BuiltCell(run=run, batch_per_card=b, opt_steps=1,
                     state_bytes=_bytes(params) + _bytes(batch), wire=wire,
                     collectives=colls,
                     notes="weights whole on each card (the one-card "
                           "call; ServeEngine(mesh=) shards every weight "
                           "and the cache)", **common)
