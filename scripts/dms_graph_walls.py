#!/usr/bin/env python3
"""Wall time of ``dms`` with each epoch a CUDA graph replay, against the
same call with ``graphs=False``, in turns, by the number of epochs.

    python3 scripts/dms_graph_walls.py [--epochs 1,2,3,4,8] [--rounds 6]

The paper's main path of ``chip_smoke.py`` phase 3: the epsilon stand-in
(400,000 × 2,000, seed 0), K = 32 workers, block 64, the cluster hinge
kernel. Three calls a round: a graphed one that captures (``dms``'s kept
captures cleared first), a graphed one on the capture it kept, and an
eager one that runs every block from Python. For each epoch count it runs
``rounds`` rounds, the three in a rotating order, each timed on the host
clock up to a ``torch.cuda.synchronize()``, holds the three models
bitwise equal, and prints each call's median and quartiles and the rounds
each graphed call beat the eager one. The process's very first call, a
graphed one at the first epoch count, is printed apart and not counted.
The card's name and power limit (``nvidia-smi``) come first.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", default="1,2,3,4,8",
                   help="comma list of epoch counts")
    p.add_argument("--rounds", type=int, default=6)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("dms_graph_walls: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.core import svm
    from repro_torch.data import make_svm_dataset
    from repro_torch.runtime import graphs as G
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(f"card: {smi.stdout.strip().splitlines()[0]}", flush=True)
    dev = torch.device("cuda", 0)
    ds = make_svm_dataset("epsilon", seed=0)
    x = torch.from_numpy(ds.x_train).to(dev)
    y = torch.from_numpy(ds.y_train).to(dev)
    w0 = torch.zeros(x.shape[1], device=dev)
    k, bs = 32, 64
    blocks = (x.shape[0] // k) // bs
    print(f"epsilon {tuple(x.shape)}, K={k}, block {bs}: {blocks} blocks an "
          f"epoch", flush=True)

    paths = ("capture", "kept", "eager")

    def call(epochs, path):
        if path == "capture":
            svm.DMS_GRAPHS.clear()
        captures = G.CAPTURES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w = svm.dms(w0, x, y, workers=k, epochs=epochs, block_size=bs,
                    device=dev, graphs=path != "eager")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if G.CAPTURES - captures != (path == "capture"):
            raise AssertionError(f"{G.CAPTURES - captures} captures in a "
                                 f"{path} call")
        return w, wall

    first = True
    for epochs in (int(e) for e in args.epochs.split(",")):
        walls = {path: [] for path in paths}
        for i in range(args.rounds):
            # a kept call replays the last capture: round 0 starts with one
            order = paths[i % 3:] + paths[:i % 3]
            models = {}
            for path in order:
                models[path], wall = call(epochs, path)
                if first:
                    print(f"the process's first call (graphed, {epochs} "
                          f"epochs): {wall:.4f} s", flush=True)
                    first = False
                    models[path], wall = call(epochs, path)
                walls[path].append(wall)
            if not all(torch.equal(models[p], models["eager"])
                       for p in paths):
                raise AssertionError(f"{epochs} epochs: the graphed model "
                                     f"differs from the eager one")
        e = np.array(walls["eager"])

        def q(v):
            return (f"median {np.median(v):.4f} s, quartiles "
                    f"{np.percentile(v, 25):.4f}–{np.percentile(v, 75):.4f}")
        line = [f"{epochs} epochs ({epochs * blocks} blocks), {args.rounds} "
                f"rounds: eager {q(e)}"]
        for path in ("capture", "kept"):
            g = np.array(walls[path])
            wins = int(sum(a < b for a, b in zip(g, e)))
            line.append(f"graph, {path} {q(g)}, faster than eager in {wins} "
                        f"of {args.rounds}")
        print("; ".join(line) + "; bitwise equal", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
