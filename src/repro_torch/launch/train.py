"""End-to-end trainer, the port of ``repro.launch.train`` on one
card: arch config → model (plain attention, as the reference trains) → MSF
sync engine → optimizer → data pipeline → a loop of train steps.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --smoke --device cpu --replicas 4 --steps 3 \\
        --set sync.strategy=periodic --set sync.period=2

Under a replica strategy one step is one block of ``sync.period`` local
steps on every replica, then a sync. The K replicas are the replica axis of
``cfg.mesh`` (``--replicas K`` sets a ``("pod",)`` axis of K); on one card
they are a leading dim of the state. It runs on the card unless
``--device cpu`` is given; without a card and without that it raises. The
reference's checkpoint manager, fault-tolerant step runner, telemetry and
H-ladder wait for ROADMAP §1 items 10 and 15.
"""
from __future__ import annotations

import json
import time
from typing import Union

import numpy as np
import torch

from repro_torch.config import (DataConfig, MeshConfig, TrainConfig,
                                get_arch, get_smoke)
from repro_torch.config.cli import apply_overrides, build_parser
from repro_torch.core import local_sgd as LS
from repro_torch.core import sync as SY
from repro_torch.data.pipeline import DataPipeline
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model


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


def build_trainer(cfg: TrainConfig, device: Union[str, torch.device] = "cuda",
                  *, quant_impl: str = "kernel"):
    """Returns (step_fn, initial state, make_pipeline, model).

    The state is drawn on ``device`` from a generator seeded ``cfg.seed``
    (K copies of one draw under a replica strategy). ``make_pipeline(start)``
    yields the step's batches from data step ``start``: (H, B, S) blocks of
    ``sync.period`` microbatches under a replica strategy, (B, S) batches
    otherwise. ``quant_impl`` is the int8 wire's quantize/dequantize (the
    quant kernel, or its plain version with ``"torch"``).
    """
    dev = resolve_device(device)
    if cfg.sync.adaptive:
        raise NotImplementedError("sync.adaptive needs the tuner and the "
                                  "H-ladder runtime (ROADMAP §1 items 10, "
                                  "15)")
    if cfg.model.family != "dense":
        raise NotImplementedError(f"training the {cfg.model.family!r} family "
                                  f"waits for a later slice (ROADMAP §1 "
                                  f"item 14); the port serves it")
    model = build_model(cfg.model, attn_impl="torch")
    use_replicas = SY.needs_replica_axis(cfg.sync)
    replicas = (cfg.mesh.axis_size(cfg.mesh.replica_axis or "pod")
                if use_replicas else 0)
    step = LS.make_train_step(model, cfg, quant_impl=quant_impl)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    state = LS.init_state(model, cfg, gen, replicas=replicas)
    h = cfg.sync.period if use_replicas else 0

    def make_pipeline(start_step: int):
        pipe = DataPipeline(cfg.data, cfg.model, device=dev,
                            start_step=start_step)
        return _Blocked(pipe, h) if h else pipe

    return step, state, make_pipeline, model


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

    step, state, make_pipeline, _ = build_trainer(cfg, dev)
    pipeline = make_pipeline(0)
    losses = []
    t0 = time.perf_counter()
    for _ in range(cfg.steps):
        state, metrics = step(state, next(pipeline))
        losses.append(float(metrics["loss"]))
    dt = time.perf_counter() - t0
    print(json.dumps({
        "arch": model_cfg.name,
        "steps": cfg.steps,
        "wall_s": round(dt, 2),
        "first_loss": round(losses[0], 4) if losses else None,
        "last_loss": round(losses[-1], 4) if losses else None,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }))


if __name__ == "__main__":
    main()
