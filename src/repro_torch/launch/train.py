"""End-to-end trainer, the port of ``repro.launch.train`` on one card: arch
config → model (plain attention, as the reference trains) → MSF sync engine
→ optimizer → data pipeline → checkpoint manager → fault-tolerant step
runner, with the adaptive MSF controller and its H ladder.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --smoke --device cpu --replicas 4 --steps 3 \\
        --set sync.strategy=periodic --set sync.period=2

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

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import (DataConfig, MeshConfig, TrainConfig,
                                config_fingerprint, get_arch, get_smoke)
from repro_torch.config.cli import apply_overrides, build_parser
from repro_torch.core import local_sgd as LS
from repro_torch.core import sync as SY
from repro_torch.data.pipeline import DataPipeline
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.runtime import StepRunner


class _Blocked:
    """Groups H microbatches into one (H, B, …) train block: stacked on the
    host with numpy (``DataPipeline.next_host``), then placed on the
    pipeline's device."""

    def __init__(self, inner: DataPipeline, h: int):
        self.inner = inner
        self.h = h

    def state(self):
        return self.inner.state()

    def __iter__(self):
        return self

    def __next__(self):
        mbs = [self.inner.next_host() for _ in range(self.h)]
        return {k: torch.from_numpy(np.stack([m[k] for m in mbs]))
                .to(self.inner.device) for k in mbs[0]}


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
                  counter, replicas: int, quant_impl: str):
    """Ladder warmup: every kernel the block reaches built and loaded (the
    int8 sync's quant kernel, on the card), a rung per H (the block timed
    into the telemetry at the H of its batch, with its sync's time), the
    switch transform, and the controller in ladder mode. ``counter.mark()``
    closes the warmup window the zero-compiles check measures from."""
    from repro_torch.core.autotune import DCN_BW, AdaptiveController
    from repro_torch.runtime.ladder import LadderRuntime, compile_rungs

    rungs = cfg.sync.ladder_rungs()
    sample = DataPipeline(cfg.data, cfg.model).next_host()
    block = LS.make_local_sgd_block(model, cfg, quant_impl=quant_impl,
                                    telemetry=telemetry)
    warmed = compile_rungs(block, sample, rungs,
                           kernels=_block_kernels(cfg, dev, quant_impl))
    ctrl = AdaptiveController(
        cfg.sync, param_bytes_per_chip=_param_bytes_per_chip(cfg),
        replicas=max(2, replicas), link_bw=DCN_BW,
        lr=cfg.optimizer.learning_rate, telemetry=telemetry, ladder=rungs)
    counter.mark()
    return LadderRuntime(
        warmed, lambda s: LS.ladder_switch_state(s, cfg), ctrl,
        telemetry=telemetry, device=dev, compile_counter=counter)


def build_trainer(cfg: TrainConfig, device: Union[str, torch.device] = "cuda",
                  *, quant_impl: str = "kernel"):
    """Returns (step_fn, initial state, make_pipeline, model, telemetry,
    ladder), the reference's six.

    The state is drawn on ``device`` from a generator seeded ``cfg.seed``
    (K copies of one draw under a replica strategy). The step updates the
    optimizer moments of the state it is given in place, as the
    reference's trainer donates its state to the jitted step: keep a copy
    of a state to step from it again. ``make_pipeline(start)`` yields the
    step's batches from data step ``start``: (H, B, S) blocks of the
    current H microbatches under a replica strategy, (B, S) batches
    otherwise. ``quant_impl`` is the int8 wire's quantize/dequantize (the
    quant kernel, or its plain version with ``"torch"``).

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
    """
    dev = resolve_device(device)
    if cfg.model.family != "dense":
        raise NotImplementedError(f"training the {cfg.model.family!r} family "
                                  f"waits for a later slice (ROADMAP §1 "
                                  f"item 14); the port serves it")
    model = build_model(cfg.model, attn_impl="torch")
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
    step = LS.make_train_step(model, cfg, quant_impl=quant_impl)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    state = LS.init_state(model, cfg, gen, replicas=replicas)
    h = cfg.sync.period if use_replicas else 0

    telemetry = None
    ladder = None
    if cfg.sync.adaptive:
        from repro_torch.core.telemetry import BlockTelemetry
        telemetry = BlockTelemetry()
        if build_ladder:
            ladder = _build_ladder(cfg, model, dev, telemetry, counter,
                                   replicas, quant_impl)
        else:
            step = LS.timed_step(step, 1, telemetry)

    def make_pipeline(start_step: int):
        pipe = DataPipeline(cfg.data, cfg.model, device=dev,
                            start_step=start_step)
        cur_h = ladder.h if ladder is not None else h
        return _Blocked(pipe, cur_h) if cur_h else pipe

    return step, state, make_pipeline, model, telemetry, ladder


def adaptive_report(cfg: TrainConfig, telemetry) -> dict:
    """The non-ladder adaptive summary: the re-solve's recommendation for
    the NEXT launch (``sync_every_step`` has no block to ladder). A single-H
    run can't split T_step/T_sync from block times alone; it falls back to
    the measured step time and the analytic sync. The parameter bytes are
    divided over ``cfg.mesh``'s devices and the replica count uses
    ``build_trainer``'s ``or "pod"`` fallback, as the reference prices
    them."""
    from repro_torch.core.autotune import DCN_BW, TuneInputs, choose_period
    est = telemetry.estimates()
    t_step = est[0] if est else telemetry.per_step_s()
    rec = None
    if t_step:
        inp = TuneInputs(
            param_bytes_per_chip=_param_bytes_per_chip(cfg),
            replicas=max(2, cfg.mesh.axis_size(
                cfg.mesh.replica_axis or "pod")),
            step_time_s=t_step, link_bw=DCN_BW,
            lr=cfg.optimizer.learning_rate)
        rec = choose_period(
            inp, cfg.sync,
            target_overhead=cfg.sync.adapt_target_overhead,
            max_drift=cfg.sync.adapt_max_drift,
            sync_time_override=est[1] if est else None)
    return {"telemetry": telemetry.to_dict(), "recommended_h": rec}


def main(argv=None) -> None:
    p = build_parser("end-to-end trainer")
    p.add_argument("--smoke", action="store_true",
                   help="reduced config (2 layers, seq 64)")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--replicas", type=int, default=1,
                   help="local-SGD replicas K on the one device")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    model_cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    mesh_cfg = MeshConfig(shape=(args.replicas,), axis_names=("pod",),
                          replica_axis="pod")
    cfg = TrainConfig(model=model_cfg, mesh=mesh_cfg,
                      data=DataConfig(seq_len=64 if args.smoke else 4096,
                                      global_batch=2 * args.replicas),
                      steps=args.steps)
    cfg = apply_overrides(cfg, args.overrides)

    step, state, make_pipeline, _, telemetry, ladder = build_trainer(cfg, dev)
    # checkpoints only into a directory the caller names: the default one
    # is shared by every run on the host
    named = any(o.split("=", 1)[0].strip() == "checkpoint.directory"
                for o in args.overrides)
    ckpt = CheckpointManager(cfg.checkpoint) if named else None
    runner = StepRunner(step, ckpt, cfg.fault, cfg.checkpoint.interval_steps,
                        make_pipeline, fingerprint=config_fingerprint(cfg),
                        ladder=ladder)
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
    if ladder is not None:
        # the live H-ladder run: trajectory, switches, per-rung telemetry
        # and the compile count
        out["adaptive"] = ladder.to_dict()
        out["adaptive"]["controller_history"] = [
            list(t) for t in ladder.controller.history]
    elif telemetry is not None:
        out["adaptive"] = adaptive_report(cfg, telemetry)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
