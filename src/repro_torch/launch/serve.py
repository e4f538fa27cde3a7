"""Batched serving: prefill → greedy decode with a cache.

The port of ``repro.launch.serve``: a batch of prompts is prefilled once
(written into the model's decode cache: k, v of ``max_len`` for attention,
the O(1) SSM state and conv tails for Mamba2 layers), then stepped token by
token. Params are cast to the serving dtype (bf16). It runs on the card
unless ``device="cpu"`` is given; without a card and without that it raises.
It serves the dense (smollm-360m), ssm (mamba2-2.7b) and hybrid
(zamba2-1.2b) families.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \\
        --smoke --device cpu --requests 4 --gen-tokens 8
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.config import get_arch, get_smoke
from repro_torch.config.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model


class ServeEngine:
    """Greedy batched generation on one device. ``params`` is a state dict
    (e.g. from :func:`repro_torch.interop.lm_params_from_jax`); without it
    the weights are drawn from a generator seeded 0 on the device.
    ``attn_impl`` and ``ssd_impl`` select the prefill's attention and SSD
    scan: ``"kernel"`` (the CUDA kernels on the card) or ``"torch"``."""

    def __init__(self, cfg: ModelConfig,
                 device: Union[str, torch.device] = "cuda",
                 max_len: int = 128, dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "kernel", ssd_impl: str = "kernel",
                 params: Optional[Mapping[str, torch.Tensor]] = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = build_model(cfg, attn_impl=attn_impl, ssd_impl=ssd_impl)
        self.max_len = max_len
        self.dtype = dtype
        if params is None:
            tree = self.model.init(
                torch.Generator(self.device).manual_seed(0))
        else:
            tree = self.model.load(params, self.device)
        self.params = tree.to(dtype)  # floating params only, as the reference

    @torch.no_grad()
    def prefill(self, prompts: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """prompts (B, S) → (last-position logits (B, V), the decode cache,
        written by the prefill: its first S positions of ``max_len`` for
        attention, the final state and conv tails for Mamba2 layers)."""
        cache = self.model.init_cache(prompts.shape[0], self.max_len,
                                      dtype=self.dtype, device=self.device)
        return self.model.prefill(self.params, {"tokens": prompts}, cache)

    @torch.no_grad()
    def decode(self, token: torch.Tensor, cache: Dict[str, torch.Tensor],
               index: int) -> torch.Tensor:
        """One step: token (B, 1) at position ``index`` → logits (B, V); the
        cache is updated in place."""
        logits, _ = self.model.decode_step(
            self.params, {"token": token, "cache": cache, "index": index})
        return logits

    def generate(self, prompts: Union[np.ndarray, torch.Tensor],
                 gen_tokens: int) -> np.ndarray:
        """prompts: (B, S_prompt) int → (B, gen_tokens) int32, greedy."""
        prompts = torch.as_tensor(prompts, device=self.device).long()
        b, s_prompt = prompts.shape
        if s_prompt + gen_tokens > self.max_len:
            raise ValueError(f"{s_prompt} prompt + {gen_tokens} new tokens "
                             f"exceed max_len {self.max_len}")
        logits, cache = self.prefill(prompts)
        out = []
        index = s_prompt
        token = torch.argmax(logits, dim=-1)[:, None]
        for _ in range(gen_tokens):
            out.append(token[:, 0])
            logits = self.decode(token, cache, index)
            token = torch.argmax(logits, dim=-1)[:, None]
            index += 1
        return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="batched serving driver")
    p.add_argument("--arch", default="smollm-360m", help="architecture id")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--gen-tokens", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = p.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab_size,
                           size=(args.requests, args.prompt_len),
                           dtype=np.int32)
    engine = ServeEngine(cfg, args.device,
                         max_len=args.prompt_len + args.gen_tokens + 1)
    t0 = time.perf_counter()
    tokens = engine.generate(prompts, args.gen_tokens)
    dt = time.perf_counter() - t0
    dev = engine.device
    print(json.dumps({
        "arch": cfg.name,
        "requests": args.requests,
        "generated": tokens.shape[1],
        "tokens_per_s": round(tokens.size / dt, 1),
        "sample": tokens[0].tolist(),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }))


if __name__ == "__main__":
    main()
