"""Batched serving on the PyTorch/CUDA port: prefill + decode with the KV
(or SSM) cache on any arch, through ``repro_torch.launch.serve.ServeEngine``
(the flash and SSD kernels on the card's prefill, the decode step a CUDA
graph replay there).

    PYTHONPATH=src python examples/torch_serve_batched.py [--arch smollm-360m]
    PYTHONPATH=src python examples/torch_serve_batched.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.config import get_smoke
from repro_torch.launch.serve import ServeEngine


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--arch", default="smollm-360m")
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--gen-tokens", type=int, default=12)
    args = p.parse_args(argv)

    cfg = get_smoke(args.arch)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab_size,
                           size=(args.requests, args.prompt_len),
                           dtype=np.int32)
    extras = {}
    if cfg.family == "vlm":
        extras["patches"] = torch.zeros(
            (args.requests, cfg.num_image_tokens, cfg.d_model),
            dtype=torch.bfloat16)
    if cfg.family == "audio":
        extras["frames"] = torch.zeros(
            (args.requests, cfg.n_audio_frames, cfg.d_model),
            dtype=torch.bfloat16)

    engine = ServeEngine(cfg, args.device,
                         max_len=args.prompt_len + args.gen_tokens
                         + (cfg.num_image_tokens or 0) + 1)
    t0 = time.perf_counter()
    tokens = engine.generate(prompts, args.gen_tokens, extras=extras)
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} device={engine.device} "
          f"requests={args.requests} generated={tokens.shape[1]} tok/req "
          f"({tokens.size / dt:.1f} tok/s)")
    for i, row in enumerate(tokens[:4]):
        print(f"  req{i}: {row.tolist()}")


if __name__ == "__main__":
    main()
