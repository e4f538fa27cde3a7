"""The model families the port serves beside smollm, mamba2 and zamba2 —
the dense internlm2-1.8b, llama3.2-3b and qwen2.5-3b, the MoE phi3.5-moe
and qwen3-moe, the prefix-LM VLM paligemma-3b and the encoder-decoder
whisper-base — against the reference on the CPU at smoke width, with the
reference's params carried over by ``repro_torch.interop.lm_params_from_jax``.

Every port path is held to the reference's ``attn_impl="jnp"`` model (its
Pallas path computes another prefix-LM mask, ROADMAP §3), run under
``jax.jit`` once per arch and dtype: prefill logits and cache, then
teacher-forced decode steps on a cache of ``max_len`` written by the
prefill (the VLM decoding from position P + S, after its image prefix).
Tolerances are ``test_torch_lm.py``'s: in f32 rtol 1e-4 / atol 1e-5 (the
two packages differ in the order of their sums), in bf16 atol 5e-2 and a
relative L2 of 3e-2 (each product rounds to bf16 at places that differ).
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jget_arch
from repro.config import get_smoke as jget_smoke
from repro.config import list_archs as jlist_archs
from repro.models.registry import analytic_param_count as jcount
from repro.models.registry import build_model as jbuild
from repro_torch import interop
from repro_torch.config import get_arch, get_smoke, list_archs
from repro_torch.launch import serve as tserve
from repro_torch.models.registry import analytic_param_count as tcount
from repro_torch.models.registry import build_model as tbuild

torch.set_num_threads(1)

F32 = dict(rtol=1e-4, atol=1e-5)
BF16_ATOL, BF16_REL_L2 = 5e-2, 3e-2
NEW_ARCHS = ["internlm2-1.8b", "llama3.2-3b", "qwen2.5-3b",
             "phi3.5-moe-42b-a6.6b", "qwen3-moe-235b-a22b", "paligemma-3b",
             "whisper-base"]
B, S, STEPS, GEN = 2, 12, 3, 6


def _close(got, want, dtype):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= BF16_REL_L2, rel


def _cfgs(arch, dtype):
    return (dataclasses.replace(jget_smoke(arch), dtype=dtype),
            dataclasses.replace(get_smoke(arch), dtype=dtype))


def _extras(cfg, seed=1):
    """The VLM's patches or the audio family's frames, numpy-seeded f32."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"patches": rng.normal(
            size=(B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)}
    if cfg.family == "audio":
        return {"frames": rng.normal(
            size=(B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)}
    return {}


def _start(cfg):
    """The decode position after a prefill of S prompt tokens."""
    return S + (cfg.num_image_tokens if cfg.family == "vlm" else 0)


@functools.lru_cache(maxsize=None)
def _reference(arch, dtype):
    """The reference's model under jit: its params as the port's state
    dict, the prompt, the extras, its prefill logits and cache, and its
    teacher-forced decode logits on a cache grown to ``max_len``."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jm = jbuild(jcfg, attn_impl="jnp")
    jp = jm.init(jax.random.key(7))
    rng = np.random.default_rng(5)
    tokens = rng.integers(1, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    forced = rng.integers(1, jcfg.vocab_size, size=(B, STEPS)).astype(np.int32)
    extras = _extras(jcfg)
    prefill, decode = jax.jit(jm.prefill), jax.jit(jm.decode_step)
    batch = {"tokens": jnp.asarray(tokens),
             **{k: jnp.asarray(v) for k, v in extras.items()}}
    logits, cache = prefill(jp, batch)
    start = _start(jcfg)
    max_len = start + GEN + 1

    def grown(cache):
        full = jm.init_cache(B, max_len, jnp.dtype(dtype))

        def grow(dst, src):
            pad = [(0, d - s) for d, s in zip(dst.shape, src.shape)]
            return jnp.pad(src.astype(dst.dtype), pad)
        return jax.tree.map(grow, full, cache)

    steps, c = [], grown(cache)
    for i in range(STEPS):
        out, c = decode(jp, {"token": jnp.asarray(forced[:, i:i + 1]),
                             "cache": c, "index": jnp.int32(start + i)})
        steps.append(np.asarray(out, np.float32))

    def greedy(prompts):
        """Greedy tokens of a loop over the reference model's prefill and
        decode_step, as the port's engine runs them."""
        out, c = prefill(jp, {**batch, "tokens": jnp.asarray(prompts)})
        c, gen = grown(c), []
        for i in range(GEN):
            token = jnp.argmax(out, axis=-1)[:, None].astype(jnp.int32)
            gen.append(np.asarray(token)[:, 0])
            out, c = decode(jp, {"token": token, "cache": c,
                                 "index": jnp.int32(start + i)})
        return np.stack(gen, axis=1)

    sd = interop.lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    return dict(sd=sd, tokens=tokens, forced=forced, extras=extras,
                logits=np.asarray(logits, np.float32),
                cache={k: np.asarray(v, np.float32) for k, v in cache.items()},
                steps=steps, max_len=max_len, greedy=greedy)


# ---------------------------------------------------------------- configs

def test_registry_and_param_counts_match_reference():
    """Every arch id of the reference, its full and smoke configs equal,
    and the analytic parameter counts equal, total and active, with and
    without the embeddings."""
    assert list_archs() == jlist_archs()
    for arch in list_archs():
        for got, want in ((get_arch(arch), jget_arch(arch)),
                          (get_smoke(arch), jget_smoke(arch))):
            assert dataclasses.asdict(got) == dataclasses.asdict(want), arch
        for active in (False, True):
            for emb in (False, True):
                assert tcount(get_arch(arch), active, emb) == jcount(
                    jget_arch(arch), active, emb), (arch, active, emb)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_param_defs_match_reference(arch):
    """The port's state dict keys and shapes: the reference's leaves with
    each layer stack split per layer."""
    jcfg, tcfg = _cfgs(arch, "float32")
    sd = _reference(arch, "float32")["sd"]
    params = tbuild(tcfg).init(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in params.state_dict().items()} == {
        k: tuple(v.shape) for k, v in sd.items()}
    if tcfg.is_moe:
        e, d, f = tcfg.moe.num_experts, tcfg.d_model, tcfg.d_ff
        assert sd["layers.1.moe.w_gate"].shape == (e, d, f)
    if tcfg.family == "audio":
        assert f"enc_layers.{tcfg.n_encoder_layers - 1}.attn.wq" in sd
        assert f"dec_layers.{tcfg.n_layers - 1}.cross_attn.wk" in sd
        jp = jbuild(jcfg).init(jax.random.key(0))
        with pytest.raises(ValueError):
            interop.lm_params_from_jax(
                jax.tree.map(np.asarray, jp),
                dataclasses.replace(tcfg, n_encoder_layers=3))


# ------------------------------------------------------------- parity

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["torch", "kernel"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_and_decode(arch, impl, dtype):
    """Prefill logits and cache, then teacher-forced decode steps on a cache
    of max_len written by the prefill, each against the reference's."""
    ref = _reference(arch, dtype)
    _, tcfg = _cfgs(arch, dtype)
    tm = tbuild(tcfg, attn_impl=impl)
    tp = tm.load(ref["sd"], "cpu")
    batch = {"tokens": torch.from_numpy(ref["tokens"]).long(),
             **{k: torch.from_numpy(v) for k, v in ref["extras"].items()}}
    with torch.no_grad():
        logits, cache = tm.prefill(tp, batch)
        _close(logits, ref["logits"], dtype)
        assert set(cache) == set(ref["cache"])
        for name, want in ref["cache"].items():
            _close(cache[name], want, dtype)
        given = tm.init_cache(B, ref["max_len"], dtype=getattr(torch, dtype))
        again, given = tm.prefill(tp, batch, given)
        assert torch.equal(again, logits)
        start = _start(tcfg)
        for i in range(STEPS):
            token = torch.from_numpy(ref["forced"][:, i:i + 1]).long()
            out, given = tm.decode_step(
                tp, {"token": token, "cache": given, "index": start + i})
            _close(out, ref["steps"][i], dtype)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_serve_engine_generate_matches_reference(arch, impl):
    """The engine's greedy tokens (with the VLM's patches or the audio
    frames as ``extras``) equal a loop over the reference model's prefill
    and decode_step in f32, the VLM decoding from P + S."""
    ref = _reference(arch, "float32")
    _, tcfg = _cfgs(arch, "float32")
    prompts = np.random.default_rng(9).integers(
        1, tcfg.vocab_size, size=(B, S)).astype(np.int32)
    want = ref["greedy"](prompts)
    engine = tserve.ServeEngine(tcfg, "cpu", max_len=ref["max_len"],
                                dtype=torch.float32, attn_impl=impl,
                                params=ref["sd"])
    got = engine.generate(prompts, GEN, ref["extras"])
    assert got.dtype == np.int32 and got.shape == (B, GEN)
    np.testing.assert_array_equal(got, want)
    assert engine.start(S) == _start(tcfg)
    with pytest.raises(ValueError, match="max_len"):
        engine.generate(prompts, GEN + 2, ref["extras"])


# ------------------------------------------------------------- engine

@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-2.7b",
                                  "zamba2-1.2b"])
def test_engine_weights_drawn_leaf_by_leaf_are_the_old_draws(arch):
    """Weights drawn leaf by leaf in the serving dtype: bitwise the whole
    tree drawn in f32 (param_dtype) and cast afterwards, as the engine drew
    them before."""
    cfg = get_smoke(arch)
    engine = tserve.ServeEngine(cfg, "cpu")
    old = tbuild(cfg).init(torch.Generator("cpu").manual_seed(0))
    old = old.to(torch.bfloat16)
    got, want = engine.params.state_dict(), old.state_dict()
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].dtype == torch.bfloat16
        assert torch.equal(got[name], want[name]), name


def test_engines_share_one_copy_of_the_weights():
    """An engine handed another's params serves them as they are (no copy),
    with its own attention path; params of another dtype are refused."""
    cfg = get_smoke("phi3.5-moe-42b-a6.6b")
    first = tserve.ServeEngine(cfg, "cpu", max_len=24)
    second = tserve.ServeEngine(cfg, "cpu", max_len=24, attn_impl="torch",
                                params=first.params)
    assert second.params is first.params
    prompts = np.arange(1, 17, dtype=np.int32).reshape(2, 8)
    np.testing.assert_array_equal(second.generate(prompts, 4),
                                  first.generate(prompts, 4))
    with pytest.raises(ValueError, match="float32"):
        tserve.ServeEngine(cfg, "cpu", dtype=torch.float32,
                           params=first.params)


@pytest.mark.parametrize("arch", ["paligemma-3b", "whisper-base",
                                  "qwen3-moe-235b-a22b"])
def test_serve_cli_on_cpu(arch, capsys):
    """The CLI feeds zero patches or frames; the VLM's max_len covers its
    image prefix (a 4-token prompt with 2 new tokens)."""
    tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                 "--prompt-len", "4", "--gen-tokens", "2"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["arch"] == get_smoke(arch).name and out["device"] == "cpu"
    assert out["generated"] == 2 and len(out["sample"]) == 2
