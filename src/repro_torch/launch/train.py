"""End-to-end trainer, the port of ``repro.launch.train``: arch config →
model (any family, with the plain attention and chunked SSD scan the
reference trains with, and ``cfg.remat``'s activation checkpointing) →
MSF sync engine → optimizer → data pipeline → checkpoint manager →
fault-tolerant step runner, with the adaptive MSF controller and its H
ladder, on one process or across the ranks of a mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --smoke --device cpu --replicas 4 --steps 3 \\
        --set sync.strategy=periodic --set sync.period=2

``--arch mamba2-2.7b`` or ``--arch zamba2-1.2b`` trains the SSM or hybrid
family the same way, the other dense archs (internlm2-1.8b, llama3.2-3b,
qwen2.5-3b) as smollm-360m, and the MoE (phi3.5-moe-42b-a6.6b,
qwen3-moe-235b-a22b: its loss adds the load-balance term), the VLM
(paligemma-3b) and the encoder-decoder (whisper-base), whose stub
frontends' inputs the pipeline feeds as zeros (``patches``, ``frames``);
``--set remat=full`` checkpoints each layer (``dots`` too for the dense,
MoE and VLM families), as a full-width model on one card needs.

Across processes it runs under ``torchrun``, which starts the ranks, with
``--backend gloo|nccl`` (one replica a rank; ``--replicas`` is then the
world size, or with ``--data N`` the world is a ``(pod, data)`` mesh of
``world / N`` replicas of N data ranks each, for ``sync.strategy=
hierarchical``):

    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --backend gloo --smoke --device cpu --steps 3 \\
        --set sync.strategy=periodic --set sync.period=2

``--model M`` adds a model axis of M ranks: a ``(pod, data, model)`` mesh
under a replica strategy, a ``(data, model)`` mesh of ``world / M`` data
ranks under ``sync_every_step``; each rank then holds its shard of every
leaf as the reference's training rules split it, and of its optimizer and
sync state, and the step runs tensor and sequence parallel with a
vocab-parallel CE (:mod:`repro_torch.core.local_sgd`; every family):

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --backend gloo --arch phi3.5-moe-42b-a6.6b --smoke --device cpu \
        --model 2 --steps 2 --set sync.strategy=periodic \
        --set sync.period=2 --set sync.compression=int8

Rank 0 prints the JSON line, which names the mesh. The adaptive H ladder
and the fault-tolerant
restarts run across ranks too: every rank's controller sees the world's
block times and the ranks agree on each move of H; a fault on one rank
restarts every rank (:mod:`repro_torch.runtime.ft`). Under
``hierarchical`` the ladder moves H for the ``pod`` replicas.

Under a replica strategy one step is one block of ``sync.period`` local
steps on every replica, then a sync. The K replicas are the replica axis of
``cfg.mesh`` (``--replicas K`` sets a ``("pod",)`` axis of K); on one card
they are a leading dim of the state. With ``--set sync.adaptive=true`` the
period moves mid-run over the ladder ``sync.ladder_rungs()`` (e.g. ``--set
sync.adapt_ladder=1,2,4``), re-solved every ``sync.adapt_every`` blocks from
the measured block and sync times, and the JSON line gains an ``adaptive``
block. It runs on the card unless ``--device cpu`` is given; without a card
and without that it raises. Checkpoints are written only where ``--set
checkpoint.directory=...`` names a directory: then every
``checkpoint.interval_steps`` steps, and a restart restores the latest this
run wrote. Without it nothing is written, and a restart goes back to the
state the run started from.
"""
from __future__ import annotations

import json
import time
from typing import Union

import numpy as np
import torch

from repro_torch import sharding as S
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import (DataConfig, TrainConfig,
                                config_fingerprint, get_arch, get_smoke)
from repro_torch.config.cli import apply_overrides, build_parser
from repro_torch.core import collectives as CL
from repro_torch.core import local_sgd as LS
from repro_torch.core import sync as SY
from repro_torch.data.pipeline import DataPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import mesh_config
from repro_torch.launch.roofline import NVLINK_BW
from repro_torch.models.registry import build_model
from repro_torch.runtime import StepRunner


# the sync link a replica's analytic T_sync is priced on where no measured
# one is at hand: the launcher's ranks share one node (one card, or the cards
# of one host under torchrun), so NVLink's H100 rate
SYNC_LINK_BW = NVLINK_BW


class _Blocked:
    """Groups H microbatches into one (H, B, …) train block: stacked on the
    host with numpy (``DataPipeline.next_host``), then placed on the
    pipeline's device (``DataPipeline.place``)."""

    def __init__(self, inner: DataPipeline, h: int):
        self.inner = inner
        self.h = h

    def state(self):
        return self.inner.state()

    def __iter__(self):
        return self

    def __next__(self):
        mbs = [self.inner.next_host() for _ in range(self.h)]
        return self.inner.place({k: np.stack([m[k] for m in mbs])
                                 for k in mbs[0]})


def _param_bytes_per_chip(cfg: TrainConfig) -> int:
    """f32 parameter bytes over the devices of ``cfg.mesh``: the devices the
    reference would spread them over, not the port's one card, so that both
    packages price the same sync."""
    return max(1, 4 * cfg.model.param_count() // max(1, cfg.mesh.num_devices))


def _block_kernels(cfg: TrainConfig, dev: torch.device, quant_impl: str):
    """The loaders of the kernel libraries a local-SGD block reaches: the
    quant kernel's where the int8 sync runs on the card."""
    from repro_torch.kernels.quant import ops as quant_ops
    if dev.type == "cuda" and quant_impl == "kernel" \
            and cfg.sync.compression == "int8":
        return (quant_ops.load_library,)
    return ()


def _build_ladder(cfg: TrainConfig, model, dev: torch.device, telemetry,
                  counter, replicas: int, quant_impl: str, mesh=None):
    """Ladder warmup: every kernel the block reaches built and loaded (the
    int8 sync's quant kernel, on the card), a rung per H (the block timed
    into the telemetry at the H of its batch, with its sync's time), the
    switch transform, and the controller in ladder mode. ``counter.mark()``
    closes the warmup window the zero-compiles check measures from. With a
    ``mesh`` a rung takes this rank's rows and syncs over the mesh, the
    switch's means are over its replica axis, and the ranks agree on every
    move."""
    from repro_torch.core.autotune import AdaptiveController
    from repro_torch.runtime.ladder import LadderRuntime, compile_rungs

    rungs = cfg.sync.ladder_rungs()
    sample = DataPipeline(cfg.data, cfg.model, mesh=mesh).next_host()
    block = LS.make_local_sgd_block(model, cfg, quant_impl=quant_impl,
                                    telemetry=telemetry, mesh=mesh)
    warmed = compile_rungs(block, sample, rungs,
                           kernels=_block_kernels(cfg, dev, quant_impl))
    ctrl = AdaptiveController(
        cfg.sync, param_bytes_per_chip=_param_bytes_per_chip(cfg),
        replicas=max(2, replicas), link_bw=SYNC_LINK_BW,
        lr=cfg.optimizer.learning_rate, telemetry=telemetry, ladder=rungs)
    counter.mark()
    return LadderRuntime(
        warmed, lambda s: LS.ladder_switch_state(s, cfg, mesh), ctrl,
        telemetry=telemetry, device=dev, compile_counter=counter, mesh=mesh)


def build_trainer(cfg: TrainConfig,
                  device: Union[str, torch.device, None] = None,
                  mesh=None, *, quant_impl: str = "kernel"):
    """Returns (step_fn, initial state, make_pipeline, model, telemetry,
    ladder), the reference's six.

    The model is ``cfg.model``'s family, any of the six, with the plain
    attention and chunked SSD scan (``attn_impl="torch"``,
    ``ssd_impl="torch"``) and ``cfg.remat``. The state is drawn on
    ``device`` from a generator seeded ``cfg.seed`` (K copies of one draw
    under a replica strategy). The step updates the optimizer moments of
    the state it is given in place (and, under ``sync_every_step``, its
    params), as the reference's trainer donates its state to the jitted
    step: keep a copy of a state to step from it again.
    ``make_pipeline(start)`` yields the step's batches from data step
    ``start``: (H, B, S) blocks of the
    current H microbatches under a replica strategy, (B, S) batches
    otherwise (the VLM's ``patches`` and the audio ``frames`` beside the
    tokens, zeros, with the same leading dims). ``quant_impl`` is the int8
    wire's quantize/dequantize (the quant kernel, or its plain version with
    ``"torch"``).

    With ``sync.adaptive`` on a replica strategy, ``ladder`` is a live
    :class:`repro_torch.runtime.ladder.LadderRuntime`: a rung per H of
    ``cfg.sync.ladder_rungs()``, every kernel they reach built and loaded
    first, and the controller moving H mid-run with no kernel built or
    loaded after that warmup (its ``CompileCounter``). Then ``step_fn`` is
    the plain block; drive ``ladder.step_fn``. With ``sync.adaptive`` on
    ``sync_every_step`` the step is wrapped in the block-time telemetry and
    :func:`adaptive_report` recommends an H for the next launch.
    ``telemetry`` is a live :class:`repro_torch.core.telemetry
    .BlockTelemetry` in both adaptive modes, ``None`` otherwise.

    With a ``mesh`` (:class:`repro_torch.launch.mesh.Mesh`, the default
    device its own) each rank holds one replica: the state is this rank's
    share (:func:`repro_torch.core.local_sgd.scatter_replicas` of the
    one-process state, the same draw), ``make_pipeline`` yields this
    rank's rows, and the step syncs over the mesh. On a mesh with a model
    axis (:func:`repro_torch.sharding.training_rules`) the rank holds its
    shards of the replica, each leaf drawn and its shard kept leaf by leaf
    (never the whole model on a rank). The ladder is then live
    on every rank: its rungs take this rank's rows, every rank's telemetry
    holds the world's block times (the max over the ranks) and the ranks
    agree on each move of H, which is the mesh's replica-axis size's own
    (the ``pod`` replicas under ``hierarchical``).
    """
    dev = resolve_device(device if device is not None else
                         mesh.device if mesh is not None else "cuda")
    model = build_model(cfg.model, attn_impl="torch", ssd_impl="torch",
                        remat=cfg.remat)
    use_replicas = SY.needs_replica_axis(cfg.sync)
    replicas = (cfg.mesh.axis_size(cfg.mesh.replica_axis or "pod")
                if use_replicas else 0)
    build_ladder = cfg.sync.adaptive and use_replicas
    counter = None
    if build_ladder:
        # made before any kernel is loaded, so the warmup's loads are
        # counted (and everything after mark() must be zero)
        from repro_torch.runtime.ladder import CompileCounter
        counter = CompileCounter()
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    state = LS.init_state(model, cfg, gen,
                          replicas=1 if mesh is not None and use_replicas
                          else replicas, rules=S.training_rules(cfg, mesh),
                          mesh=mesh)
    h = cfg.sync.period if use_replicas else 0

    telemetry = None
    ladder = None
    step = LS.make_train_step(model, cfg, quant_impl=quant_impl, mesh=mesh)
    if cfg.sync.adaptive:
        from repro_torch.core.telemetry import BlockTelemetry
        telemetry = BlockTelemetry()
        if build_ladder:
            ladder = _build_ladder(cfg, model, dev, telemetry, counter,
                                   replicas, quant_impl, mesh)
        else:
            step = LS.timed_step(step, 1, telemetry)

    def make_pipeline(start_step: int):
        pipe = DataPipeline(cfg.data, cfg.model, device=dev,
                            start_step=start_step, mesh=mesh)
        cur_h = ladder.h if ladder is not None else h
        return _Blocked(pipe, cur_h) if cur_h else pipe

    return step, state, make_pipeline, model, telemetry, ladder


def adaptive_report(cfg: TrainConfig, telemetry, mesh=None) -> dict:
    """The non-ladder adaptive summary: the re-solve's recommendation for
    the NEXT launch (``sync_every_step`` has no block to ladder). A
    single-H run can't split T_step/T_sync from block times alone; it falls
    back to the measured step time and the analytic sync. The
    parameter bytes are divided over ``cfg.mesh``'s devices and the replica
    count uses ``build_trainer``'s ``or "pod"`` fallback, as the reference
    prices them. With a ``mesh`` (a collective: every rank calls it) the
    controller gets the ranks' measured T_step and T_sync, each the max over
    the ranks."""
    from repro_torch.core.autotune import TuneInputs, choose_period
    est = telemetry.estimates()
    t_step = est[0] if est else telemetry.per_step_s()
    if mesh is not None:
        got = CL.max_over([est[0] if est else -1.0, est[1] if est else -1.0,
                           t_step if t_step else -1.0])
        est = got[:2] if min(got[:2]) >= 0 else None
        t_step = est[0] if est else (got[2] if got[2] >= 0 else None)
    rec = None
    if t_step:
        inp = TuneInputs(
            param_bytes_per_chip=_param_bytes_per_chip(cfg),
            replicas=max(2, cfg.mesh.axis_size(
                cfg.mesh.replica_axis or "pod")),
            step_time_s=t_step, link_bw=SYNC_LINK_BW,
            lr=cfg.optimizer.learning_rate)
        rec = choose_period(
            inp, cfg.sync,
            target_overhead=cfg.sync.adapt_target_overhead,
            max_drift=cfg.sync.adapt_max_drift,
            sync_time_override=est[1] if est else None)
    out = {"telemetry": telemetry.to_dict(), "recommended_h": rec}
    if mesh is not None:
        out["ranks_max"] = {"t_step_s": t_step,
                            "t_sync_s": est[1] if est else None}
    return out


def main(argv=None) -> None:
    p = build_parser("end-to-end trainer")
    p.add_argument("--smoke", action="store_true",
                   help="reduced config (2 layers, seq 64)")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--replicas", type=int, default=1,
                   help="local-SGD replicas K on the one device (across "
                        "ranks: the world size over --data)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                   help="run as a rank of the world torchrun started, its "
                        "collectives on this backend")
    p.add_argument("--data", type=int, default=1,
                   help="across ranks: data ranks a replica (a (pod, data) "
                        "mesh when > 1)")
    p.add_argument("--model", type=int, default=1,
                   help="across ranks: model ranks a data row (a (pod, "
                        "data, model) mesh, or (data, model) under "
                        "sync_every_step, when > 1)")
    args = p.parse_args(argv)

    mesh = None
    if args.backend is not None:
        from repro_torch.launch import mesh as M
        dev = M.init_from_env(args.backend, args.device)
        world = torch.distributed.get_world_size()
        if world % (args.data * args.model):
            raise ValueError(f"--data {args.data} × --model {args.model} "
                             f"does not divide the world of {world}")
        replicas = world // (args.data * args.model)
        rows = world // args.model
        if args.model > 1:
            replicated = SY.needs_replica_axis(
                apply_overrides(TrainConfig(), args.overrides).sync)
            shape, axes = (((replicas, args.data, args.model),
                            ("pod", "data", "model")) if replicated
                           else ((rows, args.model), ("data", "model")))
        else:
            shape, axes = (((replicas, args.data), ("pod", "data"))
                           if args.data > 1 else ((replicas,), ("pod",)))
        mesh = M.make_mesh(shape, axes)
    else:
        if args.model > 1:
            raise ValueError("--model needs ranks: pass --backend under "
                             "torchrun")
        dev = resolve_device(args.device or "cuda")
        replicas, shape, axes = args.replicas, (args.replicas,), ("pod",)
        rows = replicas
    model_cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    mesh_cfg = mesh_config(shape, axes)
    cfg = TrainConfig(model=model_cfg, mesh=mesh_cfg,
                      data=DataConfig(seq_len=64 if args.smoke else 4096,
                                      global_batch=2 * rows),
                      steps=args.steps)
    cfg = apply_overrides(cfg, args.overrides)

    step, state, make_pipeline, model, telemetry, ladder = build_trainer(
        cfg, dev, mesh)
    # checkpoints only into a directory the caller names: the default one
    # is shared by every run on the host
    named = any(o.split("=", 1)[0].strip() == "checkpoint.directory"
                for o in args.overrides)
    # across ranks rank 0 writes: the replicas gathered, or DDP's state,
    # the same on every rank, as it is
    axis = ((cfg.mesh.replica_axis or "pod")
            if SY.needs_replica_axis(cfg.sync) else None)
    ckpt = (CheckpointManager(
        cfg.checkpoint, mesh=mesh, axis=axis,
        specs=LS.rank_state_specs(model, cfg, mesh, state)) if named
        else None)
    runner = StepRunner(step, ckpt, cfg.fault, cfg.checkpoint.interval_steps,
                        make_pipeline, fingerprint=config_fingerprint(cfg),
                        ladder=ladder, mesh=mesh)
    t0 = time.perf_counter()
    state, final_step = runner.run(state, 0, cfg.steps)
    if ckpt is not None:
        ckpt.wait()
    dt = time.perf_counter() - t0
    losses = [m["loss"] for m in runner.metrics_log]
    out = {
        "arch": model_cfg.name,
        "steps": final_step,
        "wall_s": round(dt, 2),
        "first_loss": round(losses[0], 4) if losses else None,
        "last_loss": round(losses[-1], 4) if losses else None,
        "restarts": runner.restarts,
        "stragglers": len(runner.watchdog.events),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    if mesh is not None:
        out["ranks"] = mesh.size()
        out["backend"] = mesh.backend
        out["mesh"] = dict(zip(mesh.axes, mesh.shape))
    if ladder is not None:
        # the live H-ladder run: trajectory, switches, per-rung telemetry
        # and the compile count
        out["adaptive"] = ladder.to_dict()
        out["adaptive"]["controller_history"] = [
            list(t) for t in ladder.controller.history]
    elif telemetry is not None:
        out["adaptive"] = adaptive_report(cfg, telemetry, mesh)
    if mesh is None or mesh.rank() == 0:
        print(json.dumps(out))
    if mesh is not None:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
