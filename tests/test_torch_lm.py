"""The port's LM serving path (``repro_torch.models``, ``launch.serve``)
against the reference (``repro.models``, ``repro.launch.serve``) on the CPU,
on the smollm smoke config, with the reference's params carried over by
``repro_torch.interop.lm_params_from_jax``.

Tolerances. In f32 (``ModelConfig.dtype="float32"``) both packages do the
same arithmetic and differ only in the order of their sums (matrix products,
softmax rows): about 1e-6 relative, so rtol 1e-4 / atol 1e-5 with a margin.
In bf16 (the config's default) each product rounds to bf16 (2⁻⁹ relative) at
places that differ between the two frameworks, so logits of order 1 are held
to atol 5e-2 and a relative L2 of 3e-2.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smollm_360m as jconfigs
from repro.launch import mesh as jmesh
from repro.launch.serve import ServeEngine as JServeEngine
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models.registry import build_model as jbuild
from repro_torch import interop
from repro_torch.config import get_arch, get_smoke, list_archs
from repro_torch.configs import smollm_360m as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models.registry import build_model as tbuild

torch.set_num_threads(1)

F32 = dict(rtol=1e-4, atol=1e-5)
BF16_ATOL, BF16_REL_L2 = 5e-2, 3e-2
IMPLS = [("jnp", "torch"), ("pallas", "kernel")]


def _cfgs(dtype):
    return (dataclasses.replace(jconfigs.smoke(), dtype=dtype),
            dataclasses.replace(tconfigs.smoke(), dtype=dtype))


def _np(t):
    return t.detach().float().numpy()


def _carried(jcfg, tcfg, seed=0, j_impl="jnp", t_impl="torch"):
    """A reference model and params, and the port's with the same params."""
    jm = jbuild(jcfg, attn_impl=j_impl)
    jp = jm.init(jax.random.key(seed))
    sd = interop.lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    tm = tbuild(tcfg, attn_impl=t_impl)
    return jm, jp, tm, tm.load(sd, "cpu")


def _close(got, want, dtype):
    got, want = _np(got), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= BF16_REL_L2, rel


# ---------------------------------------------------------------- configs

def test_arch_registry_matches_reference():
    assert "smollm-360m" in list_archs()
    from repro.config import get_arch as jget_arch, get_smoke as jget_smoke
    for got, want in ((get_arch("smollm-360m"), jget_arch("smollm-360m")),
                      (get_smoke("smollm-360m"), jget_smoke("smollm-360m"))):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    with pytest.raises(KeyError):
        get_arch("gpt-5")


def test_param_defs_match_reference():
    """Same leaves, shapes and draws (init kind, scale) as the reference's
    defs, the port's per-layer list against the reference's stacked dim."""
    for tied in (True, False):
        jcfg, tcfg = (dataclasses.replace(c, tie_embeddings=tied, qkv_bias=True)
                      for c in _cfgs("float32"))
        jdefs = jbuild(jcfg).param_defs()
        tdefs = tbuild(tcfg).param_defs()
        want = {}
        for path, p in jax.tree_util.tree_flatten_with_path(
                jdefs, is_leaf=lambda x: isinstance(x, JL.Param))[0]:
            keys = [e.key for e in path]
            if keys[0] == "layers":
                for i in range(jcfg.n_layers):
                    want[".".join(["layers", str(i)] + keys[1:])] = (
                        p.shape[1:], p.init, p.scale)
            else:
                want[".".join(keys)] = (p.shape, p.init, p.scale)
        params = TL.ParamTree(TL.empty_params(tdefs, torch.float32, "cpu"))
        assert params.state_dict().keys() == want.keys()
        flat_defs = {}

        def walk(prefix, d):
            if isinstance(d, TL.Param):
                flat_defs[prefix[:-1]] = (d.shape, d.init, d.scale)
            elif isinstance(d, list):
                for i, x in enumerate(d):
                    walk(f"{prefix}{i}.", x)
            else:
                for k, x in d.items():
                    walk(f"{prefix}{k}.", x)
        walk("", tdefs)
        assert flat_defs == want


def test_init_params_distributions():
    gen = torch.Generator().manual_seed(0)
    defs = {"n": TL.Param((256, 64)), "f": TL.Param((96, 3, 32), init="fan_in"),
            "o": TL.Param((7,), init="ones"), "z": TL.Param((5,), init="zeros")}
    p = TL.init_params(defs, gen)
    assert torch.equal(p["o"], torch.ones(7))
    assert torch.equal(p["z"], torch.zeros(5))
    assert abs(float(p["n"].std()) - 0.02) < 0.002
    assert abs(float(p["f"].std()) - 1 / (96 * 3) ** 0.5) < 0.006
    again = TL.init_params(defs, torch.Generator().manual_seed(0))
    assert all(torch.equal(p[k], again[k]) for k in defs)


# ------------------------------------------------------------ layers

def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 96)).astype(np.float32)
    scale = rng.normal(size=96).astype(np.float32)
    _close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5), "float32")
    bias = rng.normal(size=96).astype(np.float32)
    _close(TL.layer_norm(*map(torch.from_numpy, (x, scale, bias)), 1e-5),
           JL.layer_norm(*map(jnp.asarray, (x, scale, bias)), 1e-5),
           "float32")

    pos = np.tile(np.arange(7), (2, 1)).astype(np.int32)
    xh = rng.normal(size=(2, 7, 3, 32)).astype(np.float32)
    tcos, tsin = TL.rotary_cos_sin(torch.from_numpy(pos), 32, 10000.0)
    jcos, jsin = JL.rotary_cos_sin(jnp.asarray(pos), 32, 10000.0)
    _close(tcos, jcos, "float32")
    _close(tsin, jsin, "float32")
    _close(TL.apply_rope(torch.from_numpy(xh), tcos, tsin),
           JL.apply_rope(jnp.asarray(xh), jcos, jsin), "float32")

    mlp = {k: rng.normal(size=s).astype(np.float32) / 10 for k, s in
           (("w_gate", (96, 256)), ("w_up", (96, 256)), ("w_down", (256, 96)))}
    _close(TL.mlp({k: torch.from_numpy(v) for k, v in mlp.items()},
                  torch.from_numpy(x)),
           JL.mlp({k: jnp.asarray(v) for k, v in mlp.items()}, jnp.asarray(x)),
           "float32")

    table = rng.normal(size=(512, 96)).astype(np.float32)
    for tied, key in ((True, "embedding"), (False, "out_embedding")):
        _close(TL.unembed({key: torch.from_numpy(table)},
                          torch.from_numpy(x), tied),
               JL.unembed({key: jnp.asarray(table)}, jnp.asarray(x), tied),
               "float32")
    tokens = rng.integers(0, 512, size=(2, 7)).astype(np.int32)
    for dtype in ("float32", "bfloat16"):
        got = TL.embed({"embedding": torch.from_numpy(table)},
                       torch.from_numpy(tokens).long(), getattr(torch, dtype))
        want = JL.embed({"embedding": jnp.asarray(table)},
                        jnp.asarray(tokens), jnp.dtype(dtype))
        assert got.dtype == getattr(torch, dtype)
        assert np.array_equal(_np(got), np.asarray(want, np.float32))


# The reference's Pallas path attends to the prefix only in prefix mode
# (ROADMAP §3); the port's kernel path follows make_mask there, so it is
# held to the reference's jnp path in that mode.
ATTN_CASES = [(j, t, mode, pref) for j, t in IMPLS
              for mode, pref in (("causal", 0), ("full", 0))]
ATTN_CASES += [("jnp", t, "prefix", 5) for t in ("torch", "kernel")]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("j_impl,t_impl,mask_mode,prefix", ATTN_CASES)
def test_full_attention(dtype, bias, j_impl, t_impl, mask_mode, prefix):
    """Attention params as plain dicts of the same numpy arrays (with
    random q/k/v biases when ``bias``)."""
    jcfg, tcfg = _cfgs(dtype)
    rng = np.random.default_rng(1)
    shapes = {"wq": (96, 3, 32), "wk": (96, 1, 32), "wv": (96, 1, 32),
              "wo": (3, 32, 96)}
    if bias:
        shapes.update(bq=(3, 32), bk=(1, 32), bv=(1, 32))
    params = {k: (rng.normal(size=s) / 8).astype(np.float32)
              for k, s in shapes.items()}
    x = rng.normal(size=(2, 24, 96)).astype(np.float32)
    pos = np.tile(np.arange(24), (2, 1)).astype(np.int32)
    want, jk, _ = JA.full_attention(
        {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(x, jnp.dtype(dtype)), jnp.asarray(pos), jcfg,
        mask_mode=mask_mode, prefix_len=prefix, impl=j_impl, return_kv=True)
    got, tk, _ = TA.full_attention(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(pos),
        tcfg, mask_mode=mask_mode, prefix_len=prefix, impl=t_impl,
        return_kv=True)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)
    _close(tk, jk, dtype)


@pytest.mark.parametrize("mask_mode,prefix", [("causal", 0), ("prefix", 11),
                                              ("full", 0)])
def test_sdpa_chunked(mask_mode, prefix):
    """The q-chunked plain twin at q_chunk=8 against the reference's, and
    against the unchunked one."""
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 32, 6, 16)).astype(np.float32)
    k = rng.normal(size=(2, 32, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 32, 2, 16)).astype(np.float32)
    got = TA._sdpa_chunked(*map(torch.from_numpy, (q, k, v)), mask_mode,
                           prefix, q_chunk=8)
    want = JA._sdpa_chunked_jnp(*map(jnp.asarray, (q, k, v)), mask_mode,
                                prefix, q_chunk=8)
    _close(got, want, "float32")
    whole = TA._sdpa(*map(torch.from_numpy, (q, k, v)),
                     TA.make_mask(32, 32, mask_mode, prefix))
    _close(got, whole, "float32")


# ------------------------------------------------------------- decoder

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("j_impl,t_impl", IMPLS)
def test_prefill_and_decode(dtype, j_impl, t_impl):
    """Prefill logits and cache, then three decode steps on a cache of
    max_len written by the prefill, each against the reference's."""
    jcfg, tcfg = _cfgs(dtype)
    jm, jp, tm, tp = _carried(jcfg, tcfg, seed=3, j_impl=j_impl,
                              t_impl=t_impl)
    tokens = np.random.default_rng(4).integers(
        1, jcfg.vocab_size, size=(2, 24)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens).long()})
    _close(tl, jl, dtype)
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == jc[name].shape
        _close(tc[name], jc[name], dtype)
    x = tm._embed_inputs(tp, {"tokens": torch.from_numpy(tokens).long()})
    hidden, cache = tm.backbone(tp, x, return_cache=True)
    assert torch.equal(tm.backbone(tp, x), hidden)
    assert torch.equal(cache["k"], tc["k"])

    cdt = jnp.dtype(dtype)
    jcache = jax.tree.map(
        lambda a: jnp.pad(a.astype(cdt), [(0, 0), (0, 0), (0, 4), (0, 0),
                                          (0, 0)]), jc)
    # the decode-ready cache: the prefill writes into one of max_len
    given = tm.init_cache(2, 28, dtype=getattr(torch, dtype))
    tl2, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(tokens).long()},
                             given)
    assert tcache is given and torch.equal(tl2, tl)
    for name in ("k", "v"):
        assert torch.equal(tcache[name][:, :, :24], tc[name])
        assert not tcache[name][:, :, 24:].any()
    token = np.argmax(np.asarray(jl, np.float32), axis=-1)[:, None]
    for index in range(24, 27):
        jl, jcache = jm.decode_step(jp, {"token": jnp.asarray(token, jnp.int32),
                                         "cache": jcache,
                                         "index": jnp.int32(index)})
        tl, tcache = tm.decode_step(tp, {"token": torch.from_numpy(token),
                                         "cache": tcache, "index": index})
        _close(tl, jl, dtype)
        _close(tcache["k"], jcache["k"], dtype)
        token = np.argmax(np.asarray(jl, np.float32), axis=-1)[:, None]


def test_serve_engine_generate_matches_reference():
    """Greedy tokens equal to the reference engine's, in f32, with its
    params carried over."""
    jcfg, tcfg = _cfgs("float32")
    jeng = JServeEngine(jcfg, jmesh.make_test_mesh((1, 1)),
                        jmesh.test_mesh_config((1, 1)), max_len=29,
                        dtype=jnp.float32)
    sd = interop.lm_params_from_jax(jax.tree.map(np.asarray, jeng.params),
                                    tcfg)
    prompts = np.random.default_rng(0).integers(
        1, jcfg.vocab_size, size=(3, 16), dtype=np.int32)
    want = jeng.generate(prompts, 12)
    for impl in ("kernel", "torch"):
        teng = tserve.ServeEngine(tcfg, "cpu", max_len=29,
                                  dtype=torch.float32, attn_impl=impl,
                                  params=sd)
        got = teng.generate(prompts, 12)
        assert got.dtype == np.int32 and got.shape == (3, 12)
        np.testing.assert_array_equal(got, np.asarray(want))


def test_lm_params_from_jax():
    jcfg, tcfg = _cfgs("bfloat16")
    jm = jbuild(jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                      jm.init(jax.random.key(0)))
    sd = interop.lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    assert sd["layers.1.attn.wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _np(sd["layers.1.attn.wq"]),
        np.asarray(jp["layers"]["attn"]["wq"][1], np.float32))
    tm = tbuild(tcfg)
    assert set(sd) == set(tm.init(torch.Generator().manual_seed(0))
                          .state_dict())
    bad = dict(sd)
    bad["layers.0.mlp.w_up"] = bad["layers.0.mlp.w_up"].T
    with pytest.raises(RuntimeError):
        tm.load(bad, "cpu")
    with pytest.raises(ValueError):
        interop.lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                   dataclasses.replace(tcfg, n_layers=3))


# --------------------------------------------------------- entry points

def test_entry_points_need_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.ServeEngine(get_smoke("smollm-360m"))
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--smoke", "--requests", "1", "--gen-tokens", "1"])


def test_serve_cli_on_cpu(capsys):
    tserve.main(["--arch", "smollm-360m", "--smoke", "--device", "cpu",
                 "--requests", "2", "--prompt-len", "8", "--gen-tokens", "4"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["arch"] == "smollm-smoke" and out["device"] == "cpu"
    assert out["requests"] == 2 and out["generated"] == 4
    assert len(out["sample"]) == 4 and out["tokens_per_s"] > 0


def test_other_families_not_ported():
    """Every family builds; an unknown family or attention impl raises.
    The moe, vlm and audio families train: their loss is finite under the
    plain attention and refused under the forward-only flash kernel, and
    ``build_trainer`` builds them with the plain attention."""
    from repro_torch.config import TrainConfig
    from repro_torch.data.pipeline import stub_inputs
    from repro_torch.launch.train import build_trainer
    with pytest.raises(KeyError):
        tbuild(dataclasses.replace(tconfigs.smoke(), family="rnn"))
    with pytest.raises(ValueError):
        tbuild(tconfigs.smoke(), attn_impl="pallas")
    for arch in ("phi3.5-moe-42b-a6.6b", "paligemma-3b", "whisper-base"):
        cfg = get_smoke(arch)
        batch = {"tokens": torch.ones(1, 4, dtype=torch.long),
                 "targets": torch.ones(1, 4, dtype=torch.long),
                 **{k: torch.from_numpy(v)
                    for k, v in stub_inputs(cfg, 1).items()}}
        for impl in ("torch", "kernel"):
            model = tbuild(cfg, attn_impl=impl)
            params = model.init(torch.Generator().manual_seed(0))
            if impl == "kernel":
                with pytest.raises(ValueError, match="attn_impl='torch'"):
                    model.loss(params, batch)
                continue
            loss, metrics = model.loss(params, batch)
            assert torch.isfinite(loss)
            assert sorted(metrics) == (["aux", "ce"] if cfg.is_moe
                                       else ["ce"])
        _, _, _, model, _, _ = build_trainer(TrainConfig(model=cfg),
                                             device="cpu")
        assert model.attn_impl == "torch"
