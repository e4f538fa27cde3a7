"""The port's SSM and hybrid serving paths (``repro_torch.models.ssm``,
``repro_torch.models.hybrid``, ``launch.serve``) against the reference
(``repro.models.ssm``/``hybrid``, ``repro.launch.serve``) on the CPU, at the
mamba2-2.7b and zamba2-1.2b smoke configs, with the reference's params
carried over by ``repro_torch.interop.lm_params_from_jax``.

Tolerances. In f32 both packages do the same arithmetic and differ in the
order of their sums (products, the chunked scan's einsums; the port's
``ssd_impl="kernel"`` runs the exact recurrence on the CPU, which the
reference's chunked form matches to ~1e-6): rtol 1e-4 / atol 1e-5, as for
smollm. In bf16 each product rounds to bf16 at places that differ between
the two frameworks: logits of order 1 and every cache leaf are held to atol
5e-2 and a relative L2 of 3e-2.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_arch as jget_arch, get_smoke as jget_smoke
from repro.launch import mesh as jmesh
from repro.launch.serve import ServeEngine as JServeEngine
from repro.models import layers as JL
from repro.models.registry import build_model as jbuild
from repro_torch import interop
from repro_torch.config import TrainConfig, get_arch, get_smoke, list_archs
from repro_torch.launch import serve as tserve
from repro_torch.launch.train import build_trainer
from repro_torch.models import layers as TL
from repro_torch.models.registry import build_model as tbuild

torch.set_num_threads(1)

ARCHS = ["mamba2-2.7b", "zamba2-1.2b"]
F32 = dict(rtol=1e-4, atol=1e-5)
BF16_ATOL, BF16_REL_L2 = 5e-2, 3e-2
IMPLS = ["torch", "kernel"]


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(jget_smoke(arch), dtype=dtype),
            dataclasses.replace(get_smoke(arch), dtype=dtype))


def _np(t):
    return t.detach().float().numpy()


def _carried(jcfg, tcfg, seed=0, impl="torch"):
    """A reference model and params, and the port's with the same params
    (``impl`` for both the attention and the SSD scan)."""
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.key(seed))
    sd = interop.lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    tm = tbuild(tcfg, attn_impl=impl, ssd_impl=impl)
    return jm, jp, tm, tm.load(sd, "cpu")


def _close(got, want, dtype):
    got, want = _np(got), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)
        den = np.linalg.norm(want)
        if den > 0:
            assert np.linalg.norm(got - want) / den <= BF16_REL_L2


def _leaves(cache):
    """(path, leaf) of a nested cache dict, sorted by path."""
    out = []
    for k in sorted(cache):
        v = cache[k]
        if isinstance(v, dict):
            out += [(f"{k}.{p}", x) for p, x in _leaves(v)]
        else:
            out.append((k, v))
    return out


# ---------------------------------------------------------------- configs

def test_configs_match_reference():
    """The two configs, full and smoke, field by field."""
    archs = list_archs()
    for arch in ARCHS:
        assert arch in archs
        for got, want in ((get_arch(arch), jget_arch(arch)),
                          (get_smoke(arch), jget_smoke(arch))):
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    full = get_arch("mamba2-2.7b")
    assert (full.n_layers, full.d_model, full.ssm.expand * full.d_model,
            full.vocab_size, full.tie_embeddings) == (64, 2560, 5120, 50280,
                                                      False)
    z = get_arch("zamba2-1.2b")
    assert z.n_layers // z.shared_block_every == 6


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("full", [False, True])
def test_param_defs_match_reference(arch, full):
    """Same leaves, shapes and draws (init kind, scale) as the reference's
    defs, the port's per-layer list against the reference's stacked dim;
    the full configs' defs are built without drawing anything."""
    jcfg, tcfg = ((jget_arch(arch), get_arch(arch)) if full
                  else _cfgs(arch))
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
    got = {}

    def walk(prefix, d):
        if isinstance(d, TL.Param):
            got[prefix[:-1]] = (d.shape, d.init, d.scale)
        elif isinstance(d, list):
            for i, x in enumerate(d):
                walk(f"{prefix}{i}.", x)
        else:
            for k, x in d.items():
                walk(f"{prefix}{k}.", x)
    walk("", tdefs)
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_ssm_a(arch):
    """``a_log`` is drawn as the reference draws it, log(linspace(1, 16, h))
    in every layer; the tree is fixed by the seed."""
    jcfg, tcfg = _cfgs(arch)
    jp = jbuild(jcfg).init(jax.random.key(0))
    tm = tbuild(tcfg)
    params = tm.init(torch.Generator().manual_seed(0))
    want = np.asarray(jp["layers"]["mamba"]["a_log"])
    for i, lp in enumerate(params["layers"]):
        np.testing.assert_allclose(_np(lp["mamba"]["a_log"]), want[i],
                                   rtol=1e-6, atol=1e-6)
        assert torch.equal(lp["mamba"]["d_skip"],
                           torch.ones_like(lp["mamba"]["d_skip"]))
    again = tm.init(torch.Generator().manual_seed(0)).state_dict()
    assert all(torch.equal(v, again[k])
               for k, v in params.state_dict().items())


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_defs_match_reference(arch):
    """The Mamba2 cache leaves' shapes and dtypes at the full configs (the
    SSM state f32 and O(1) in length, the conv tails in the cache dtype),
    as the reference declares them; nothing is allocated."""
    from repro.models import ssm as jssm
    from repro_torch.models import ssm as tssm
    jcfg, tcfg = jget_arch(arch), get_arch(arch)
    want = jssm.mamba_cache_defs(jcfg, 4, jcfg.n_layers, jnp.bfloat16)
    got = tssm.mamba_cache_defs(tcfg, 4, tcfg.n_layers, torch.bfloat16)
    assert set(got) == set(want)
    for k, (shape, dt) in got.items():
        assert shape == want[k][0]
        assert str(dt).split(".")[-1] == jnp.dtype(want[k][1]).name


# ------------------------------------------------------------- models

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_and_decode(arch, dtype, impl):
    """Prefill logits and every cache leaf, then four decode steps on the
    cache the prefill wrote (the reference's grown to max_len), each step's
    logits and cache leaves against the reference's. The prompt spans three
    chunks of the smoke config's 8, the last one ragged."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jm, jp, tm, tp = _carried(jcfg, tcfg, seed=3, impl=impl)
    b, s, steps = 2, 21, 4
    tokens = np.random.default_rng(4).integers(
        1, jcfg.vocab_size, size=(b, s)).astype(np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens).long()})
    _close(tl, jl, dtype)
    flat_j = {".".join(str(e.key) for e in path): v for path, v in
              jax.tree_util.tree_flatten_with_path(jc)[0]}
    assert [k for k, _ in _leaves(tc)] == sorted(flat_j)
    for name, leaf in _leaves(tc):
        _close(leaf, flat_j[name], dtype)
    x = torch.nn.functional.embedding(torch.from_numpy(tokens).long(),
                                      tp["embed"]["embedding"]).to(tm.dtype)
    hidden, _ = tm.backbone(tp, x, return_cache=True)
    assert torch.equal(tm.backbone(tp, x), hidden)

    # the decode-ready cache: the prefill writes into one of max_len
    cdt = getattr(torch, dtype)
    max_len = s + steps
    given = tm.init_cache(b, max_len, dtype=cdt)
    tl2, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(tokens).long()},
                             given)
    assert tcache is given and torch.equal(tl2, tl)
    full = jm.init_cache(b, max_len, dtype=jnp.dtype(dtype))

    def grow(dst, src):   # the reference engine's _grow_cache
        pad = [(0, d - w) for d, w in zip(dst.shape, src.shape)]
        return jnp.pad(src.astype(dst.dtype), pad)
    jcache = jax.tree.map(grow, full, jc)
    token = np.argmax(np.asarray(jl, np.float32), axis=-1)[:, None]
    for index in range(s, s + steps):
        jl, jcache = jm.decode_step(jp, {"token": jnp.asarray(token, jnp.int32),
                                         "cache": jcache,
                                         "index": jnp.int32(index)})
        tl, out = tm.decode_step(tp, {"token": torch.from_numpy(token),
                                      "cache": tcache, "index": index})
        assert out is tcache
        _close(tl, jl, dtype)
        flat_j = {".".join(str(e.key) for e in path): v for path, v in
                  jax.tree_util.tree_flatten_with_path(jcache)[0]}
        for name, leaf in _leaves(tcache):
            _close(leaf, flat_j[name], dtype)
        token = np.argmax(np.asarray(jl, np.float32), axis=-1)[:, None]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_generate_matches_reference(arch):
    """Greedy tokens equal to the reference engine's, in f32, with its
    params carried over, on both paths."""
    jcfg, tcfg = _cfgs(arch)
    jeng = JServeEngine(jcfg, jmesh.make_test_mesh((1, 1)),
                        jmesh.test_mesh_config((1, 1)), max_len=29,
                        dtype=jnp.float32)
    sd = interop.lm_params_from_jax(jax.tree.map(np.asarray, jeng.params),
                                    tcfg)
    prompts = np.random.default_rng(0).integers(
        1, jcfg.vocab_size, size=(3, 16), dtype=np.int32)
    want = np.asarray(jeng.generate(prompts, 12))
    for impl in IMPLS:
        teng = tserve.ServeEngine(tcfg, "cpu", max_len=29,
                                  dtype=torch.float32, attn_impl=impl,
                                  ssd_impl=impl, params=sd)
        got = teng.generate(prompts, 12)
        assert got.dtype == np.int32 and got.shape == (3, 12)
        np.testing.assert_array_equal(got, want)


def _decode_after(prefill, decode, tokens, p):
    """Logits after prefilling ``tokens[:, :p]`` and decoding the rest one
    token at a time."""
    logits, cache = prefill(tokens[:, :p])
    for i in range(p, tokens.shape[1]):
        logits, cache = decode(tokens[:, i:i + 1], cache, i)
    return logits


def _both_paths(arch, tokens, p):
    """(port decode-after-p, port full prefill, reference decode-after-p
    through its engine's ``_grow_cache``, reference full prefill): last
    logits, f32, the same params."""
    jcfg, tcfg = _cfgs(arch)
    n = tokens.shape[1]
    jeng = JServeEngine(jcfg, jmesh.make_test_mesh((1, 1)),
                        jmesh.test_mesh_config((1, 1)), max_len=n + 1,
                        dtype=jnp.float32)
    sd = interop.lm_params_from_jax(jax.tree.map(np.asarray, jeng.params),
                                    tcfg)
    teng = tserve.ServeEngine(tcfg, "cpu", max_len=n + 1, dtype=torch.float32,
                              params=sd)
    tt = torch.from_numpy(tokens).long()

    def t_decode(tok, cache, i):
        return teng.decode(tok, cache, i), cache

    def j_prefill(tok):
        logits, cache = jeng._prefill(jeng.params, {"tokens": jnp.asarray(tok)})
        return logits, jeng._grow_cache(cache, tok.shape[0])

    def j_decode(tok, cache, i):
        return jeng._decode(jeng.params, {"token": jnp.asarray(tok),
                                          "cache": cache,
                                          "index": jnp.int32(i)})
    with jax.set_mesh(jeng.mesh):
        jref = np.asarray(_decode_after(j_prefill, j_decode, tokens, p))
        jref_full = np.asarray(jeng._prefill(
            jeng.params, {"tokens": jnp.asarray(tokens)})[0])
    return (_np(_decode_after(teng.prefill, t_decode, tt, p)),
            _np(teng.prefill(tt)[0]), jref, jref_full)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("p", [1, 2])
def test_short_prompt_conv_tails(arch, p):
    """After a prompt shorter than conv_width − 1 = 3, the port's decode
    continues the sequence exactly as a prefill of all of it does, while the
    reference's engine (which pads the conv tails at their end, so the zeros
    land in the newest slots) does not."""
    tokens = np.random.default_rng(10 + p).integers(
        1, 512, size=(2, 6)).astype(np.int32)
    port, port_full, jref, jref_full = _both_paths(arch, tokens, p)
    np.testing.assert_allclose(port, port_full, **F32)
    np.testing.assert_allclose(port_full, jref_full, **F32)
    assert np.abs(jref - jref_full).max() > 1e-2


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("p", [3, 5])
def test_conv_tails_agree_from_three_tokens(arch, p):
    """From a prompt of conv_width − 1 tokens on, the reference's engine and
    the port both continue the sequence as a full prefill does."""
    tokens = np.random.default_rng(20 + p).integers(
        1, 512, size=(2, 6)).astype(np.int32)
    port, port_full, jref, jref_full = _both_paths(arch, tokens, p)
    np.testing.assert_allclose(port, port_full, **F32)
    np.testing.assert_allclose(jref, jref_full, **F32)
    np.testing.assert_allclose(port, jref, **F32)


# ------------------------------------------------------------- interop

@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_from_jax(arch):
    """The layer stack split per layer, the hybrid's shared block as one
    block, bf16 kept; a wrong shape or layer count is refused."""
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jm = jbuild(jcfg)
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                      jm.init(jax.random.key(0)))
    sd = interop.lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    key = f"layers.{jcfg.n_layers - 1}.mamba.in_x"
    assert sd[key].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _np(sd[key]), np.asarray(jp["layers"]["mamba"]["in_x"][-1], np.float32))
    tm = tbuild(tcfg)
    assert set(sd) == set(tm.init(torch.Generator().manual_seed(0))
                          .state_dict())
    if tcfg.family == "hybrid":
        np.testing.assert_array_equal(
            _np(sd["shared.attn.wq"]),
            np.asarray(jp["shared"]["attn"]["wq"], np.float32))
        assert not any(k.startswith("shared.0") for k in sd)
    bad = dict(sd)
    bad["layers.0.mamba.out"] = bad["layers.0.mamba.out"].T
    with pytest.raises(RuntimeError):
        tm.load(bad, "cpu")
    with pytest.raises(ValueError):
        interop.lm_params_from_jax(jax.tree.map(np.asarray, jp),
                                   dataclasses.replace(tcfg, n_layers=3))


# --------------------------------------------------------- entry points

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_on_cpu(arch, capsys):
    tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                 "--requests", "2", "--prompt-len", "9", "--gen-tokens", "4"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["arch"] == get_smoke(arch).name and out["device"] == "cpu"
    assert out["requests"] == 2 and out["generated"] == 4
    assert len(out["sample"]) == 4 and out["tokens_per_s"] > 0


def test_entry_points_need_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for arch in ARCHS:
        with pytest.raises(RuntimeError, match="CUDA"):
            tserve.ServeEngine(get_smoke(arch))
        with pytest.raises(RuntimeError, match="CUDA"):
            tserve.main(["--arch", arch, "--smoke", "--requests", "1",
                         "--gen-tokens", "1"])


def test_registry_builds_ssm_and_hybrid():
    """The two families are built with their impls; bad impls and families
    raise; the trainer builds them on its training path (the plain
    attention and chunked scan; ``tests/test_torch_train_ssm.py`` trains
    them)."""
    ssm = tbuild(get_smoke("mamba2-2.7b"), ssd_impl="torch")
    hyb = tbuild(get_smoke("zamba2-1.2b"), attn_impl="torch")
    assert type(ssm).__name__ == "SSMModel" and ssm.ssd_impl == "torch"
    assert type(hyb).__name__ == "HybridModel"
    assert (hyb.attn_impl, hyb.ssd_impl, hyb.n_groups) == ("torch", "kernel",
                                                           2)
    for arch in ARCHS:
        with pytest.raises(ValueError):
            tbuild(get_smoke(arch), ssd_impl="pallas")
    with pytest.raises(ValueError):
        tbuild(get_smoke("zamba2-1.2b"), attn_impl="jnp")
    model = build_trainer(TrainConfig(model=get_smoke("mamba2-2.7b")),
                          "cpu")[3]
    assert type(model).__name__ == "SSMModel" and model.ssd_impl == "torch"
