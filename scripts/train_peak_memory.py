#!/usr/bin/env python3
"""Peak device memory of one full-width local-SGD block, as the trainer
runs it and as it would run if the block left its input state alone.

    python3 scripts/train_peak_memory.py

The trainer of ``chip_smoke.py``'s phase 8: smollm-360m at full width (32
layers, bf16 compute, f32 master params), K = 4 replicas, H = 4, int8 sync
with error feedback on the quant kernel, AdamW, 8 × 2,048 tokens a
microbatch. For each of

* ``in place``: the trainer's step (``build_trainer``), which updates the
  optimizer moments of the state it is given in place, as the reference's
  trainer donates its state to the jitted step;
* ``moments copied``: the same step with a copy of the moments made on the
  card first and held through the block (two f32 values a parameter a
  replica), the memory a block that stepped a copy of its input's moments
  would add,

it prints the peak of ``torch.cuda.max_memory_allocated`` over one block
from a fresh state (the caller holding its input state, as a training
loop does), or the out-of-memory error where the card cannot hold it;
after the card's name and power limit (``nvidia-smi``).
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("train_peak_memory: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch import tree as T
    from repro_torch.config import (DataConfig, MeshConfig, OptimizerConfig,
                                    SyncConfig, TrainConfig, get_arch)
    from repro_torch.launch.train import build_trainer
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(f"card: {smi.stdout.strip().splitlines()[0]}", flush=True)
    dev = torch.device("cuda", 0)
    k = 4
    cfg = TrainConfig(
        model=get_arch("smollm-360m"),
        mesh=MeshConfig(shape=(k,), axis_names=("pod",), replica_axis="pod"),
        sync=SyncConfig(strategy="periodic", period=4, compression="int8"),
        optimizer=OptimizerConfig(name="adamw", learning_rate=1e-3,
                                  schedule="cosine", total_steps=1000),
        data=DataConfig(seq_len=2048, global_batch=8))
    for variant in ("in place", "moments copied"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step, state, make_pipeline, model, _, _ = build_trainer(cfg, dev)
        batch = next(make_pipeline(0))
        t0 = time.perf_counter()
        copied = None
        try:
            if variant == "moments copied":
                copied = T.map(lambda x: x.clone() if isinstance(
                    x, torch.Tensor) else x, state["opt"])
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            out, metrics = step(state, batch)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            total = torch.cuda.get_device_properties(dev).total_memory
            print(f"{variant}: one block in "
                  f"{time.perf_counter() - t0:.3f} s, loss {loss:.4f}; state, "
                  f"batch and copies held {held / 2**30:.2f} GiB; peak "
                  f"{peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB) of "
                  f"{total / 2**30:.2f} GiB", flush=True)
            del out, metrics
        except torch.cuda.OutOfMemoryError as err:
            peak = torch.cuda.max_memory_allocated()
            print(f"{variant}: out of memory after "
                  f"{time.perf_counter() - t0:.3f} s, peak allocated before "
                  f"the failing allocation {peak / 2**30:.2f} GiB; "
                  f"{str(err).splitlines()[0]}", flush=True)
        del step, state, batch, model, copied
    return 0


if __name__ == "__main__":
    sys.exit(main())
