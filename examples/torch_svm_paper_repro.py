"""The paper's experimental arc on the PyTorch/CUDA port.

For each paper dataset stand-in it runs, through ``repro_torch.core.svm``:
  1. the sequential baseline (Algorithm 1, ``seq_sgd``),
  2. distributed DMS at parallelism 32 (Algorithm 3, ``dms``: the hinge
     kernel on the card),
  3. the sequential replica sweep over block sizes (Algorithm 2, ``srdms``,
     Figs 1–4),
and prints the speedup/accuracy summary in the paper's Table II format.

    PYTHONPATH=src python examples/torch_svm_paper_repro.py [--quick]
    PYTHONPATH=src python examples/torch_svm_paper_repro.py --device cpu \\
        --n 1000 --epochs 2
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
    p.add_argument("--quick", action="store_true")
    p.add_argument("--n", type=int, default=0,
                   help="points of every data set (default: by --quick)")
    p.add_argument("--epochs", type=int, default=0)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    n_map = ({"ijcnn1": 4000, "webspam": 6000} if args.quick
             else {"ijcnn1": 12000, "webspam": 30000, "epsilon": 6000})
    if args.n:
        n_map = {name: args.n for name in n_map}
    epochs = args.epochs or (8 if args.quick else 15)

    def tensor(a):
        return torch.from_numpy(a).to(dev)

    print(f"on {dev}, {epochs} epochs")
    print("| dataset | seq s | par s (K=32) | seq acc | par acc | speedup |")
    print("|---|---|---|---|---|---|")
    for name, n in n_map.items():
        ds = make_svm_dataset(name, n_override=n)
        x, y = tensor(ds.x_train), tensor(ds.y_train)
        xt, yt = tensor(ds.x_test), tensor(ds.y_test)
        w0 = np.zeros(ds.features, np.float32)

        t0 = time.perf_counter()
        w_seq = svm.seq_sgd(w0, x, y, epochs=epochs, device=dev)
        wait(w_seq)
        t_seq = time.perf_counter() - t0

        t0 = time.perf_counter()
        w_par = svm.dms(w0, x, y, workers=32, epochs=epochs, block_size=64,
                        device=dev)
        wait(w_par)
        t_par = time.perf_counter() - t0

        print(f"| {name} | {t_seq:.2f} | {t_par:.2f} "
              f"| {float(svm.accuracy(w_seq, xt, yt)):.4f} "
              f"| {float(svm.accuracy(w_par, xt, yt)):.4f} "
              f"| {t_seq / t_par:.1f}× |")

        # block-size sweep (Figs 1–4 analog)
        for bs in (1, 8, 512):
            w = svm.srdms(w0, x, y, epochs=epochs, block_size=bs, device=dev)
            acc = float(svm.accuracy(w, tensor(ds.x_cv), tensor(ds.y_cv)))
            print(f"    block={bs:<4d} cv_acc={acc:.4f}")


if __name__ == "__main__":
    main()
