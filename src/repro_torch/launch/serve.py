"""Batched serving: prefill → greedy decode with a cache.

The port of ``repro.launch.serve``: a batch of prompts is prefilled once
(written into the model's decode cache: k, v of ``max_len`` for attention,
the O(1) SSM state and conv tails for Mamba2 layers, the encoder's k, v for
cross-attention), then stepped token by token. Params are in the serving
dtype (bf16). It runs on the card unless ``device="cpu"`` is given; without
a card and without that it raises. It serves every family of the
reference: dense, moe, vlm (``extras={"patches": (B, P, D)}``, decoding
from position P + S), ssm, hybrid and audio (``extras={"frames": (B, T,
D)}``).

As the reference jits its decode step, the engine compiles its decode loop:
on the card each greedy step (embedding, layers, logits, ``argmax``, the
index advanced) is one CUDA graph replay (:mod:`repro_torch.runtime.graphs`),
captured at the first ``generate`` of a batch size on that batch size's
static cache and reused by every later call; ``graphs=False`` runs the same
step eagerly, the comparison path on the card and the path on the CPU.

On a ``(data, model)`` process mesh (``mesh=``, a
:class:`repro_torch.launch.mesh.Mesh` of that rank) the engine serves every
family as the reference's engine does on its mesh: every call runs under
the mesh's rules (:func:`serving_rules`); the rank holds every weight as
the rules shard it (:func:`repro_torch.sharding.serve_specs`: the
attention's heads, the MLP's columns, the Mamba2 mixers' heads, the vocab
and the experts over model, each d_model dim over data, a dim held whole
where it does not divide), its shards of the attention caches (their
sequence over model, wherever it tiles the axis: the self caches by
``max_len``, the enc-dec's cross cache by its frames) and of the Mamba2
state and x conv tails (by heads), and its data shard of the batch and of
each extra (patches, frames); the layers run tensor and sequence parallel
(:mod:`repro_torch.models.layers`); ``generate`` returns the whole batch's
tokens on every rank. Decode runs eagerly there.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \\
        --smoke --device cpu --requests 4 --gen-tokens 8
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \\
        --arch mamba2-2.7b --smoke --device cpu --mesh 2,2 --backend gloo
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import sharding as S
from repro_torch import tree as T
from repro_torch.config import get_arch, get_smoke
from repro_torch.config.base import ModelConfig
from repro_torch.core.collectives import mesh_groups
from repro_torch.device import resolve_device, same_device
from repro_torch.launch.mesh import mesh_config
from repro_torch.models import layers as L
from repro_torch.models.registry import build_model
from repro_torch.runtime import graphs as G


def serving_rules(cfg: ModelConfig, mesh, max_len: int) -> S.ShardingRules:
    """The rules a serving engine runs under on ``mesh`` (axes ``data`` and
    ``model``): the default rules, with each dim of
    :func:`repro_torch.sharding.model_dims` and the cache's ``max_len``
    held whole where a size of it does not divide its mesh axes, so the
    model code reads from the rules how a rank holds each of them (the
    trainer's rules fit the same dims,
    :func:`repro_torch.sharding.training_rules`). ``act_seq`` is fitted per
    call, on the length of the sequence at hand
    (:func:`repro_torch.models.layers.act_shards`: a prefill's, or a decode
    step's one token, held whole)."""
    if tuple(mesh.axes) != ("data", "model"):
        raise ValueError(f"serving takes a (data, model) mesh, not "
                         f"{mesh.axes}")
    return S.fitted_rules(mesh_config(mesh.shape, mesh.axes), mesh,
                          {**S.model_dims(cfg), "cache_seq": max_len})


class ServeEngine:
    """Greedy batched generation on one device, or on this rank of a mesh.
    ``params`` is a state dict (e.g. from
    :func:`repro_torch.interop.lm_params_from_jax`; on a mesh this rank's
    shards, :func:`repro_torch.interop.rank_params_from_jax`), loaded in
    ``dtype``; or another engine's ``params`` (a ParamTree of ``dtype`` on
    the device), served as it is, without a copy; without it the weights are
    drawn on the device from a generator seeded 0, leaf by leaf in f32, each
    cast to ``dtype`` before the next is drawn (the values of a draw in f32
    cast afterwards, without an f32 copy of the whole model); on a mesh each
    rank draws every leaf and keeps its shard, so it holds the one-device
    engine's values.
    ``attn_impl`` and ``ssd_impl`` select the prefill's attention and SSD
    scan: ``"kernel"`` (the CUDA kernels on the card) or ``"torch"``.
    ``graphs``: the decode loop as CUDA graph replays (None: on a card,
    without a mesh), or eagerly (False); True on the CPU or on a mesh
    raises.

    ``mesh``: this rank's :class:`repro_torch.launch.mesh.Mesh` of axes
    ``(data, model)``, on whose device the engine runs (module docstring);
    every family. A batch must split over the data axis.

    The engine owns one decode cache per batch size, of its ``max_len``:
    each prefill of that batch size zeroes it and writes into it, so a
    request finds the cache a fresh engine would, and a captured step
    stays valid for every request of that size. :meth:`release` frees a
    batch size's cache and captured step."""

    def __init__(self, cfg: ModelConfig,
                 device: Union[str, torch.device] = "cuda",
                 max_len: int = 128, dtype: torch.dtype = torch.bfloat16,
                 attn_impl: str = "kernel", ssd_impl: str = "kernel",
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 graphs: Optional[bool] = None, mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.rules = None
        if mesh is not None:
            if not same_device(self.device, mesh.device):
                raise ValueError(f"the engine runs on {self.device}, its "
                                 f"mesh rank on {mesh.device}")
            if graphs:
                raise ValueError(
                    "a mesh runs its decode eagerly (graphs=False): a gloo "
                    "mesh's collectives cannot be captured in a CUDA graph, "
                    "and an NCCL capture is ROADMAP §1 item 19 (g)")
            graphs = False
            self.rules = serving_rules(cfg, mesh, max_len)
            self.data, self.seq_axis = mesh_groups(self.rules)
        self.graphs = G.use_graphs(graphs, self.device)
        self.cfg = cfg
        self.model = build_model(cfg, attn_impl=attn_impl, ssd_impl=ssd_impl)
        self.max_len = max_len
        self.dtype = dtype
        if params is None:
            gen = torch.Generator(self.device).manual_seed(0)
            if mesh is None:
                self.params = self.model.init(gen, dtype)
            else:
                self.params = L.ParamTree(S.map_with_specs(
                    lambda p, spec: self._shard(L.init_leaf(p, gen, dtype),
                                                spec),
                    self.model.param_defs(), self.specs()))
        elif isinstance(params, torch.nn.Module):
            held = {(p.dtype, p.device) for p in params.parameters()}
            if not all(t == dtype and same_device(d, self.device)
                       for t, d in held):
                raise ValueError(f"params held as {sorted(map(str, held))}; "
                                 f"the engine serves {dtype} on "
                                 f"{self.device}")
            self.params = params
        elif mesh is None:
            self.params = self.model.load(params, self.device, dtype)
        else:
            self.params = L.ParamTree(S.map_with_specs(
                lambda p, spec: torch.empty(
                    self.rules.shard_shape(spec, p.shape), dtype=dtype,
                    device=self.device),
                self.model.param_defs(), self.specs()))
            self.params.load_state_dict(params, strict=True)
        self._caches: Dict[int, Dict[str, torch.Tensor]] = {}
        self._loops: Dict[int, "DecodeLoop"] = {}

    def specs(self):
        """The specs this rank holds the params under (a mesh only):
        :func:`repro_torch.sharding.serve_specs` under its rules."""
        return S.serve_specs(self.model.param_defs(), self.rules)

    def _shard(self, leaf: torch.Tensor, spec) -> torch.Tensor:
        """This rank's shard of a drawn leaf (its own memory), or the leaf."""
        if not any(spec):
            return leaf
        return S.shard_of(leaf, spec, self.mesh).clone()

    def rows(self, batch: int) -> int:
        """The rows of a batch of ``batch`` that this engine holds: all of
        them, or on a mesh its data shard."""
        if self.mesh is None:
            return batch
        if batch % self.data.k:
            raise ValueError(f"a batch of {batch} does not split over the "
                             f"data axis's {self.data.k} ranks")
        return batch // self.data.k

    def local(self, batch: torch.Tensor) -> torch.Tensor:
        """This engine's rows of a whole batch (dim 0)."""
        rows = self.rows(batch.shape[0])
        if self.mesh is None:
            return batch
        return batch.narrow(0, self.data.index * rows, rows)

    def cache(self, batch: int) -> Dict[str, torch.Tensor]:
        """The decode cache of a batch of ``batch`` rows, made (zeros) at
        first use. On a mesh each leaf at this rank's size: its rows; its
        chunk of a self-attention cache's ``max_len`` where the rules shard
        ``cache_seq``; the enc-dec's cross cache split by its own length
        (:func:`repro_torch.models.attention.tile_shards`); the SSM state
        by its heads and the x conv tail by its columns where the rules
        split ``ssm_heads`` (the B and C tails whole)."""
        if batch not in self._caches:
            length = self.max_len
            if self.rules is not None and \
                    self.rules.mesh_axes_for("cache_seq"):
                length //= self.seq_axis.k
            with S.use_rules(self.rules):
                self._caches[batch] = self.model.init_cache(
                    self.rows(batch), length, dtype=self.dtype,
                    device=self.device)
        return self._caches[batch]

    @torch.no_grad()
    def prefill(self, prompts: torch.Tensor,
                extras: Optional[Mapping[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """prompts (B, S) → (last-position logits (B, V), the decode cache
        of B rows, zeroed and written by the prefill: its first
        :meth:`start` positions of ``max_len`` for attention, the final state
        and conv tails for Mamba2 layers, the encoder's k, v for
        cross-attention). ``extras``: the VLM's ``patches`` (B, P, D), the
        audio family's ``frames`` (B, T, D), moved to the device. The cache
        is the engine's own: the next prefill of B rows zeroes and
        overwrites it, so it is valid until then. On a mesh ``prompts`` and
        each extra are the whole batch, the model takes this rank's rows of
        each, and the logits and cache are its rows."""
        cache = self.cache(prompts.shape[0])
        for leaf in T.leaves(cache):
            leaf.zero_()
        batch = {"tokens": self.local(prompts)}
        for name, value in (extras or {}).items():
            batch[name] = self.local(torch.as_tensor(value)).to(self.device)
        with S.use_rules(self.rules):
            return self.model.prefill(self.params, batch, cache)

    def start(self, prompt_len: int) -> int:
        """The position a prompt of ``prompt_len`` tokens decodes from: its
        length, after the VLM's image prefix."""
        return self.model.positions_before() + prompt_len

    @torch.no_grad()
    def decode(self, token: torch.Tensor, cache: Dict[str, torch.Tensor],
               index) -> torch.Tensor:
        """One eager step: token (B, 1) at position ``index`` (an int or an
        integer device tensor) → logits (B, V); the cache is updated in
        place. On a mesh, B is this rank's rows."""
        with S.use_rules(self.rules):
            logits, _ = self.model.decode_step(
                self.params, {"token": token, "cache": cache,
                              "index": index})
        return logits

    def release(self, batch: int) -> None:
        """Drop the decode cache and the decode loop (its graph and memory
        pool) of ``batch`` rows; the next use makes them anew."""
        self._loops.pop(batch, None)
        self._caches.pop(batch, None)

    def decode_loop(self, batch: int) -> "DecodeLoop":
        """The greedy decode step of ``batch`` rows on :meth:`cache`,
        captured at its first use when the engine runs graphs."""
        if batch not in self._loops:
            self._loops[batch] = DecodeLoop(self, batch)
        return self._loops[batch]

    def generate(self, prompts: Union[np.ndarray, torch.Tensor],
                 gen_tokens: int,
                 extras: Optional[Mapping[str, torch.Tensor]] = None
                 ) -> np.ndarray:
        """prompts: (B, S_prompt) int → (B, gen_tokens) int32, greedy.
        ``extras`` as :meth:`prefill` takes them. On a mesh every rank
        passes the whole batch and gets the whole batch's tokens."""
        prompts = torch.as_tensor(prompts, device=self.device).long()
        b, s_prompt = prompts.shape
        start = self.start(s_prompt)
        if start + gen_tokens > self.max_len:
            raise ValueError(f"{start} prefilled positions + {gen_tokens} new "
                             f"tokens exceed max_len {self.max_len}")
        logits, _ = self.prefill(prompts, extras)
        loop = self.decode_loop(b)
        loop.start(logits, start)
        for _ in range(gen_tokens):
            loop.step()
        if self.mesh is None:
            return loop.tokens(start, gen_tokens)
        tokens = self.data.gather_dim(loop.seq[:, start:start + gen_tokens],
                                      0)
        return tokens.to(torch.int32).cpu().numpy()


class DecodeLoop:
    """Greedy decode steps of one batch size on its engine's static cache.

    One step, the body of :class:`repro_torch.runtime.graphs.Compiled`:
    ``token`` (B, 1) is written into ``seq`` (B, max_len) at ``index`` (a
    (1,) int64 tensor), decoded there, replaced by the argmax of the
    step's logits, and ``index`` advances; the step returns the logits.
    Every buffer stays on the device, so the host reads nothing between
    steps and the tokens once, at the end. The capture runs no step (no
    warm-up), so it neither advances the SSM state nor writes k, v into
    the live cache; ``compiled`` holds the capture's host times. On a mesh
    B is this rank's rows of the batch."""

    def __init__(self, engine: ServeEngine, batch: int):
        dev = engine.device
        rows = engine.rows(batch)
        self.token = torch.zeros((rows, 1), dtype=torch.long, device=dev)
        self.index = torch.zeros((1,), dtype=torch.long, device=dev)
        self.seq = torch.zeros((rows, engine.max_len), dtype=torch.long,
                               device=dev)
        model, params = engine.model, engine.params

        @torch.no_grad()
        def step(token, index, seq, cache):
            seq.index_copy_(1, index, token)
            logits, _ = model.decode_step(
                params, {"token": token, "cache": cache, "index": index})
            token.copy_(torch.argmax(logits, dim=-1, keepdim=True))
            index.add_(1)
            return logits

        self.compiled = G.Compiled(step, self.token, self.index, self.seq,
                                   engine.cache(batch), graph=engine.graphs)
        self.rules = engine.rules

    def start(self, logits: torch.Tensor, index: int) -> None:
        """Begin after a prefill: its logits' argmax is the token at
        position ``index`` (:meth:`ServeEngine.start`)."""
        self.token.copy_(torch.argmax(logits, dim=-1, keepdim=True))
        self.index.fill_(index)

    def step(self) -> torch.Tensor:
        """One step (under the engine's mesh rules, if any); its logits (B,
        V), overwritten by the next step under graphs."""
        with S.use_rules(self.rules):
            return self.compiled()

    def tokens(self, start: int, n: int) -> np.ndarray:
        """Tokens at positions ``start`` to ``start + n`` on the host, as
        (B, n) int32."""
        return self.seq[:, start:start + n].to(torch.int32).cpu().numpy()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="batched serving driver")
    p.add_argument("--arch", default="smollm-360m", help="architecture id")
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--gen-tokens", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--mesh", default=None, metavar="D,M",
                   help="serve any family on a (data D, model M) mesh of "
                        "the ranks torchrun started (D·M of them); "
                        "--requests must split over D")
    p.add_argument("--backend", choices=("nccl", "gloo"), default="nccl",
                   help="the mesh's collectives: nccl (a card a rank) or "
                        "gloo (ranks that share a card, or the CPU)")
    args = p.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_arch(args.arch)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab_size,
                           size=(args.requests, args.prompt_len),
                           dtype=np.int32)
    # zero patches and frames, as the reference's CLI feeds them
    extras = {}
    if cfg.family == "vlm":
        extras["patches"] = torch.zeros(
            (args.requests, cfg.num_image_tokens, cfg.d_model))
    if cfg.family == "audio":
        extras["frames"] = torch.zeros(
            (args.requests, cfg.n_audio_frames, cfg.d_model))
    max_len = args.prompt_len + args.gen_tokens + 1
    if cfg.family == "vlm":
        max_len += cfg.num_image_tokens     # the image prefix's positions
    mesh = None
    if args.mesh:
        from repro_torch.launch import mesh as M
        M.init_from_env(args.backend, args.device)
        shape = tuple(int(n) for n in args.mesh.split(","))
        mesh = M.make_mesh(shape, ("data", "model"))
        max_len += -max_len % shape[1]      # so the caches split over model
    try:
        engine = ServeEngine(cfg, mesh.device if mesh else args.device,
                             max_len=max_len, mesh=mesh)
        t0 = time.perf_counter()
        tokens = engine.generate(prompts, args.gen_tokens, extras)
        dt = time.perf_counter() - t0
        dev = engine.device
        line = {
            "arch": cfg.name,
            "requests": args.requests,
            "generated": tokens.shape[1],
            "tokens_per_s": round(tokens.size / dt, 1),
            "sample": tokens[0].tolist(),
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
        }
        if mesh is None:
            print(json.dumps(line))
        elif mesh.rank() == 0:
            line.update(mesh=list(mesh.shape), backend=mesh.backend)
            print(json.dumps(line))
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
