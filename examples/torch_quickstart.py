"""Quickstart on the PyTorch/CUDA port: the paper's finding in a minute.

Trains the paper's SGD-SVM on a synthetic ijcnn1 stand-in at three model
synchronization frequencies (MSF = block size) with ``repro_torch``'s
``dms`` and shows what the paper shows: accuracy is flat across MSF while
the sync count, the communication driver, drops by orders of magnitude.

    PYTHONPATH=src python examples/torch_quickstart.py             # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --n 2000
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import svm
from repro_torch.data import make_svm_dataset
from repro_torch.device import resolve_device, wait


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--n", type=int, default=8000, help="training points")
    p.add_argument("--epochs", type=int, default=12)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    ds = make_svm_dataset("ijcnn1", n_override=args.n)
    xcv = torch.from_numpy(ds.x_cv).to(dev)
    ycv = torch.from_numpy(ds.y_cv).to(dev)
    w0 = np.zeros(ds.features, np.float32)
    workers = 8

    print(f"dataset: ijcnn1 stand-in (n={ds.n_train}, d={ds.features}) on "
          f"{dev}")
    print(f"DMS: {workers} workers × {args.epochs} epochs\n")
    print(f"{'block (1/MSF)':>14} {'syncs/epoch':>12} {'cv acc':>8} "
          f"{'wall s':>8}")
    for block in (1, 16, 256):
        syncs = ds.n_train // workers // block
        t0 = time.perf_counter()
        w = svm.dms(w0, ds.x_train, ds.y_train, workers=workers,
                    epochs=args.epochs, block_size=block, device=dev)
        wait(w)
        dt = time.perf_counter() - t0
        acc = float(svm.accuracy(w, xcv, ycv))
        print(f"{block:>14} {syncs:>12} {acc:>8.4f} {dt:>8.2f}")

    print("\npaper's conclusion: lower the MSF (bigger blocks) — same "
          "accuracy, a fraction of the communication.")


if __name__ == "__main__":
    main()
