#!/usr/bin/env python3
"""Which ``torch.distributed`` collectives the gloo backend runs on CUDA
tensors (and on CPU tensors) in this PyTorch, on two ranks of one card.

    python3 scripts/gloo_cuda_probe.py

The backend table of the ``torch.distributed`` docs marks gloo's
``all_to_all``, ``reduce_scatter`` and ``all_gather`` unsupported on CUDA;
``repro_torch.core.collectives`` stages through the host only what gloo
cannot run, so the rule rests on what this probe finds. Each op runs once
on a small float32 tensor on each device type; a line per rank and op says
``ok`` with the head of the result (to compare with the CPU's) or ``FAIL``
with the error. The Python, PyTorch and CUDA versions come first. It needs
one card; the ranks meet on a free port of 127.0.0.1.
"""
from __future__ import annotations

import datetime
import socket
import sys

import torch
import torch.distributed as dist

OPS = ("all_reduce", "all_to_all_single", "reduce_scatter_tensor",
       "all_gather_into_tensor", "all_gather")


def run(op: str, dev: str, rank: int, world: int) -> torch.Tensor:
    x = (torch.arange(8.0).reshape(4, 2) + 10 * rank).to(dev)
    if op == "all_reduce":
        dist.all_reduce(x)
        return x
    if op == "all_to_all_single":
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        return out
    if op == "reduce_scatter_tensor":
        out = torch.empty(4 // world, 2, device=dev)
        dist.reduce_scatter_tensor(out, x)
        return out
    if op == "all_gather_into_tensor":
        out = torch.empty(4 * world, 2, device=dev)
        dist.all_gather_into_tensor(out, x)
        return out
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x)
    return torch.cat(parts)


def rank_main(rank: int, world: int, port: int) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        for dev in ("cpu", "cuda"):
            for op in OPS:
                try:
                    out = run(op, dev, rank, world)
                    if dev == "cuda":
                        torch.cuda.synchronize()
                    msg = f"ok {out.flatten().tolist()[:6]}"
                except RuntimeError as exc:
                    msg = f"FAIL {str(exc).splitlines()[0][:160]}"
                dist.barrier()
                print(f"rank {rank} {dev} {op}: {msg}", flush=True)
    finally:
        dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA card", file=sys.stderr)
        return 1
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          flush=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    import torch.multiprocessing as mp
    mp.spawn(rank_main, args=(2, port), nprocs=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
