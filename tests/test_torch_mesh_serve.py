"""The port's ``ServeEngine(mesh=)`` against the reference's ``ServeEngine``
on a (data 2, model 2) mesh.

One subprocess (``conftest.run_with_devices``, 4 devices) runs the
reference's engine on phi3.5-moe's smoke config in f32: the prefill of 64
prompts of 512 tokens (T = 32,768, the reference's threshold: its
vocab-parallel embedding and its all-to-all MoE), 4 greedy steps (the
one-hot MoE, the seq-sharded decode attention), ``generate``; and dumps its
weights, logits and tokens to one npz. One ``repro_torch.launch.mesh.spawn``
of 4 gloo CPU ranks serves the same prompts with those weights
(``interop.rank_params_from_jax``). Bound: prefill and step logits rtol
1e-4 / atol 1e-5, the tokens identical.
"""
import dataclasses

import numpy as np
import pytest

from conftest import run_with_devices
from repro_torch import sharding as S
from repro_torch.config import get_smoke
from repro_torch.launch import mesh as M

import torch_dist_ranks as R

ARCH = "phi3.5-moe-42b-a6.6b"
B, SEQ, GEN, MAX_LEN = 64, 512, 4, 520
MESH = M.mesh_config((2, 2), ("data", "model"))

REFERENCE = r"""
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.config import get_smoke
from repro.launch.mesh import make_test_mesh, test_mesh_config
from repro.launch.serve import ServeEngine

cfg = dataclasses.replace(get_smoke("__ARCH__"), dtype="float32")
mesh, mesh_cfg = make_test_mesh((2, 2)), test_mesh_config((2, 2))
engine = ServeEngine(cfg, mesh, mesh_cfg, max_len=__MAX_LEN__,
                     dtype=jnp.float32)
prompts = np.random.default_rng(0).integers(
    1, cfg.vocab_size, (__B__, __SEQ__)).astype(np.int32)
out = {"prompts": prompts}
with jax.set_mesh(mesh):
    logits, cache = engine._prefill(engine.params,
                                    {"tokens": jnp.asarray(prompts)})
    out["prefill"] = np.asarray(logits)
    cache = engine._grow_cache(cache, prompts.shape[0])
    token = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    steps = []
    for i in range(__GEN__):
        logits, cache = engine._decode(
            engine.params, {"token": token, "cache": cache,
                            "index": jnp.int32(__SEQ__ + i)})
        steps.append(np.asarray(logits))
        token = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
out["steps"] = np.stack(steps)
out["tokens"] = engine.generate(prompts, __GEN__)

def flat(node, prefix):
    for k, v in node.items():
        if isinstance(v, dict):
            flat(v, prefix + k + "/")
        else:
            out["params/" + prefix + k] = np.asarray(v)
flat(engine.params, "")
np.savez("__OUT__", **out)
print("OK")
"""


def _cfg():
    return dataclasses.replace(get_smoke(ARCH), dtype="float32")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_serve") / "reference.npz"
    code = REFERENCE
    for key, value in dict(ARCH=ARCH, B=B, SEQ=SEQ, GEN=GEN, MAX_LEN=MAX_LEN,
                           OUT=path).items():
        code = code.replace(f"__{key}__", str(value))
    assert "OK" in run_with_devices(code, n_devices=4, timeout=600)
    with np.load(path) as data:
        return {key: data[key] for key in data.files}


class _Sized:
    """A mesh config seen as a live mesh's axes and shape (what
    ``serving_rules`` reads)."""

    def __init__(self, mesh_cfg):
        self.axes, self.shape = mesh_cfg.axis_names, mesh_cfg.shape


def _params(ref):
    tree = {}
    for key, value in ref.items():
        if key.startswith("params/"):
            *path, leaf = key.split("/")[1:]
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = value
    return tree


@pytest.fixture(scope="module")
def ranks(reference):
    return M.spawn(R.mesh_serve, 4, backend="gloo", device="cpu",
                   args=(_cfg(), _params(reference), reference["prompts"],
                         GEN, MAX_LEN), timeout_s=600)


def _rows(ranks, key):
    for r in (0, 2):
        assert np.array_equal(ranks[r][key], ranks[r + 1][key])
    return np.concatenate([ranks[0][key], ranks[2][key]])


def test_prefill_logits_match_reference(reference, ranks):
    got = _rows(ranks, "prefill")
    assert got.shape == (B, _cfg().vocab_size)
    np.testing.assert_allclose(got, reference["prefill"], rtol=1e-4,
                               atol=1e-5)
    # T = 32,768: the all-to-all path once a layer
    assert all(o["paths"] == {"sharded": _cfg().n_layers} for o in ranks)


def test_step_logits_match_reference(reference, ranks):
    got = np.concatenate([ranks[0]["steps"], ranks[2]["steps"]], axis=1)
    for r in (0, 2):
        assert np.array_equal(ranks[r]["steps"], ranks[r + 1]["steps"])
    np.testing.assert_allclose(got, reference["steps"], rtol=1e-4,
                               atol=1e-5)


def test_generate_tokens_identical_on_every_rank(reference, ranks):
    for out in ranks:
        assert out["tokens"].shape == (B, GEN)
        assert np.array_equal(out["tokens"], reference["tokens"])


def test_shard_tree_round_trip_bitwise(reference, ranks):
    """Every leaf held as the serving rules' ``spec_for`` gives it (each
    dim split where it divides its axis: here every leaf, at least its
    d_model over data), the ranks' shards put back together bitwise."""
    from repro_torch import interop
    from repro_torch.launch.serve import serving_rules
    from repro_torch.models.registry import build_model
    whole = interop.lm_params_from_jax(_params(reference), _cfg())
    specs = ranks[0]["specs"]
    rules = serving_rules(_cfg(), _Sized(MESH), MAX_LEN)
    defs = S.flat_keys(build_model(_cfg()).param_defs())
    assert specs == {k: rules.spec_for(p.logical, p.shape)
                     for k, p in defs.items()}
    # every leaf is split: each has a d_model dim, over data
    assert all(any(s) for s in specs.values())
    assert specs["layers.0.attn.wq"] == ("data", "model")
    assert specs["layers.0.attn.wo"] == ("model", None, "data")
    assert specs["layers.0.moe.router"] == ("data", "model")
    back = S.unshard_tree([o["shards"] for o in ranks], specs, MESH)
    assert back.keys() == whole.keys()
    for key, value in whole.items():
        assert np.array_equal(back[key], value.numpy()), key
    # the engine holds what it was handed
    for out in ranks:
        for key, value in out["params"].items():
            assert np.array_equal(value, out["shards"][key]), key


def test_graphs_on_a_gloo_mesh_raise(ranks):
    assert "runs its decode eagerly" in ranks[0]["raises"]["graphs"]


def test_trainer_builds_every_family_on_a_mesh(ranks):
    """``build_trainer`` builds on a mesh with a model axis for every family
    of the registry: each rank holds its (V/2, D/2) shard of the smoke
    model's table."""
    from repro_torch.models.registry import FAMILIES
    for out in ranks:
        assert sorted(out["families"]) == sorted(FAMILIES)
        for family, (arch, shape) in out["families"].items():
            cfg = get_smoke(arch)
            assert shape == (cfg.vocab_size // 2, cfg.d_model // 2), family


def test_nothing_staged_on_cpu_ranks(ranks):
    assert all(o["staged"] == {} for o in ranks)
