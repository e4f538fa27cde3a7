"""End-to-end LM training with the paper's MSF schedule on the PyTorch/CUDA
port (local SGD).

Trains a reduced llama-family model through ``repro_torch``'s trainer
(``build_trainer``: config, sync engine, optimizer, data pipeline),
comparing every-step sync (the paper's MSF = 1) against periodic sync of K
replicas every H = 4 steps, at matched optimizer steps. The K replicas are
a leading dim of the state on one card.

    PYTHONPATH=src python examples/torch_lm_local_sgd.py            # the card
    PYTHONPATH=src python examples/torch_lm_local_sgd.py --device cpu \\
        --blocks 2
"""
import argparse
import dataclasses
import json
import time

from repro_torch.config import (DataConfig, MeshConfig, OptimizerConfig,
                                SyncConfig, TrainConfig, get_smoke)
from repro_torch.core.sync import amortized_bytes_per_step
from repro_torch.device import resolve_device
from repro_torch.launch.train import build_trainer
from repro_torch.models.registry import analytic_param_count

REPLICAS = 2


def run(strategy: str, period: int, steps: int, dev) -> dict:
    model_cfg = dataclasses.replace(get_smoke("llama3.2-3b"),
                                    n_layers=4, d_model=256, d_ff=512)
    cfg = TrainConfig(
        model=model_cfg,
        mesh=MeshConfig(shape=(REPLICAS,), axis_names=("pod",),
                        replica_axis="pod"),
        sync=SyncConfig(strategy=strategy, period=period),
        optimizer=OptimizerConfig(name="adamw", learning_rate=1e-3,
                                  schedule="cosine", total_steps=1000),
        data=DataConfig(seq_len=128, global_batch=8))
    step, state, make_pipeline, _, _, _ = build_trainer(cfg, dev)
    pipe = make_pipeline(0)
    h = period if strategy != "sync_every_step" else 1
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step(state, next(pipe))
        losses.append(float(metrics["loss"]))
    wall = time.perf_counter() - t0
    params_bytes = analytic_param_count(cfg.model) * 4
    wire = amortized_bytes_per_step(params_bytes, REPLICAS, cfg.sync)
    return {
        "strategy": f"{strategy}(H={period})",
        "params": analytic_param_count(cfg.model),
        "optimizer_steps": steps * h,
        "first_loss": round(losses[0], 3),
        "last_loss": round(losses[-1], 3),
        "wall_s": round(wall, 1),
        "sync_bytes_per_step": int(wire),
        "device": str(dev),
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--blocks", type=int, default=10,
                   help="periodic blocks of H = 4 (every-step: 4× as many "
                        "steps)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    print("every-step sync (paper MSF=1 / DDP baseline):")
    a = run("sync_every_step", 1, 4 * args.blocks, dev)
    print(json.dumps(a, indent=1))
    print(f"\nperiodic sync of {REPLICAS} replicas (paper's DMS, H=4):")
    b = run("periodic", 4, args.blocks, dev)
    print(json.dumps(b, indent=1))
    print(f"\nsync bytes/step: {a['sync_bytes_per_step'] / 1e6:.1f} MB → "
          f"{b['sync_bytes_per_step'] / 1e6:.1f} MB "
          f"({a['sync_bytes_per_step'] / max(1, b['sync_bytes_per_step']):.0f}"
          f"× less traffic at matched optimizer steps)")


if __name__ == "__main__":
    main()
