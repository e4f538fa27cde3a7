"""The port's mesh paths of the MoE, the embedding and decode attention
against the reference's on fake CPU devices.

One subprocess (``conftest.run_with_devices``, 4 devices, mesh (data 2,
model 2)) runs the reference's ``moe_ffn`` (its ``_moe_ffn_sharded`` with
the gradient, a skewed router whose slots drop, ``_moe_ffn_onehot``), its
vocab-parallel ``embed`` and its seq-sharded ``decode_attention``, and dumps
them to one npz; one ``repro_torch.launch.mesh.spawn`` of 4 gloo CPU ranks
runs the port's on the same numpy-seeded inputs; each case is a test here.

Bounds: the reference's own (``tests/test_distributed.py``): the sharded
MoE's out and gradients rtol 1e-3 / atol 1e-5 and aux rtol 1e-5 (here
against the reference's sharded path itself, which drops the same slots);
the one-hot path rtol 1e-4 / atol 1e-5; decode attention rtol 1e-4 / atol
1e-5; the embedding bitwise (every sum on its way has one nonzero term).
"""
import json

import numpy as np
import pytest

from conftest import run_with_devices
from repro_torch import sharding as S
from repro_torch.launch import mesh as M

import torch_dist_ranks as R

CFG = dict(d_model=32, d_ff=16, experts=8, top_k=2)
MESH = M.mesh_config((2, 2), ("data", "model"))

REFERENCE = r"""
import json
import jax, jax.numpy as jnp, numpy as np
from repro.config import MeshConfig, ModelConfig, MoEConfig
from repro.models import attention as A
from repro.models import layers as L
from repro.models import moe as M
from repro.sharding import rules_for, use_rules
from repro.launch.mesh import make_test_mesh

kw = json.loads('''__CFG__''')
cfg = ModelConfig(name="t", family="moe", d_model=kw["d_model"],
                  d_ff=kw["d_ff"], moe=MoEConfig(num_experts=kw["experts"],
                                                 top_k=kw["top_k"]))
e, d, f = kw["experts"], kw["d_model"], kw["d_ff"]
mesh = make_test_mesh((2, 2))
rules = rules_for(MeshConfig(shape=(2, 2), axis_names=("data", "model")),
                  mesh)
rng = np.random.default_rng(0)

def normal(*shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)

params = {"router": normal(d, e, scale=d ** -0.5),
          "w_gate": normal(e, d, f, scale=d ** -0.5),
          "w_up": normal(e, d, f, scale=d ** -0.5),
          "w_down": normal(e, f, d, scale=f ** -0.5)}
skewed = dict(params, router=params["router"] + np.linspace(
    0.0, 1.5, e, dtype=np.float32))
out = {f"params/{k}": v for k, v in params.items()}
out.update({f"skewed_params/{k}": v for k, v in skewed.items()})
out["sharded"] = normal(8, 4096, d)
out["skewed"] = normal(8, 4096, d) + 1.0
out["onehot"] = normal(4, 16, d)
out["table"] = normal(64, 16)
out["tokens"] = rng.integers(0, 64, (8, 4096)).astype(np.int32)
out["q"], out["k"], out["v"] = (normal(4, 1, 4, 16), normal(4, 64, 2, 16),
                                normal(4, 64, 2, 16))
out["index"] = np.int32(37)

def loss(p, x):
    y, aux = M.moe_ffn(p, x, cfg)
    return jnp.mean(y ** 2) + 0.01 * aux

with jax.set_mesh(mesh), use_rules(rules):
    y, aux = jax.jit(lambda p, x: M.moe_ffn(p, x, cfg))(params,
                                                         out["sharded"])
    out["ref/sharded/out"], out["ref/sharded/aux"] = np.asarray(y), float(aux)
    g = jax.jit(jax.grad(loss))(params, out["sharded"])
    for k in g:
        out[f"ref/sharded/grad/{k}"] = np.asarray(g[k])
    y, aux = jax.jit(lambda p, x: M.moe_ffn(p, x, cfg))(skewed,
                                                         out["skewed"])
    out["ref/skewed/out"], out["ref/skewed/aux"] = np.asarray(y), float(aux)
    y, aux = jax.jit(lambda p, x: M.moe_ffn(p, x, cfg))(params,
                                                         out["onehot"])
    out["ref/onehot/out"], out["ref/onehot/aux"] = np.asarray(y), float(aux)
    out["ref/embed"] = np.asarray(jax.jit(
        lambda t, tok: L.embed({"embedding": t}, tok, jnp.float32))(
            out["table"], out["tokens"]))
    out["ref/decode"] = np.asarray(jax.jit(
        lambda q, k, v: A.decode_attention(q, k, v, jnp.int32(37)))(
            out["q"], out["k"], out["v"]))

# the reference's sharded path drops a slot where its rank in its expert's
# queue among its (data, model) shard's tokens reaches C_s
def drops(p, x):
    n, cap = 0, None
    b, s = x.shape[0] // 2, x.shape[1] // 2
    for i in range(2):
        for j in range(2):
            xt = x[i * b:(i + 1) * b, j * s:(j + 1) * s].reshape(-1, d)
            _, idx = M._top_k_routing(jnp.asarray(xt @ p["router"]), 2)
            t = xt.shape[0]
            cap = -(-int(max(8, 1.25 * 2 * t / e)) // 8) * 8
            flat = np.asarray(idx).reshape(-1)
            pos = np.cumsum(np.eye(e, dtype=np.int64)[flat], 0)[
                np.arange(flat.size), flat] - 1
            n += int((pos >= cap).sum())
    return n
out["ref/sharded/drops"] = drops(params, out["sharded"])
out["ref/skewed/drops"] = drops(skewed, out["skewed"])
np.savez("__OUT__", **out)
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_moe") / "reference.npz"
    code = (REFERENCE.replace("__CFG__", json.dumps(CFG))
            .replace("__OUT__", str(path)))
    assert "OK" in run_with_devices(code, n_devices=4, timeout=600)
    with np.load(path) as data:
        return {key: data[key] for key in data.files}


def _tree(ref, prefix):
    return {k[len(prefix):]: v for k, v in ref.items() if k.startswith(prefix)}


@pytest.fixture(scope="module")
def ranks(reference):
    cases = {k: reference[k] for k in ("sharded", "skewed", "onehot",
                                       "table", "tokens", "q", "k", "v")}
    cases["index"] = int(reference["index"])
    cases["skewed_params"] = _tree(reference, "skewed_params/")
    return M.spawn(R.mesh_moe_cases, 4, backend="gloo", device="cpu",
                   args=(CFG, _tree(reference, "params/"), cases),
                   timeout_s=600)


def _batch(ranks, key, *sub):
    """The whole batch: the data ranks' rows (ranks 0 and 2), after
    checking that the model ranks of each data row agree bitwise."""
    def get(r):
        out = ranks[r][key]
        for s in sub:
            out = out[s]
        return out
    for r in (0, 2):
        assert np.array_equal(get(r), get(r + 1))
    return np.concatenate([get(0), get(2)])


def test_sharded_moe_matches_reference(reference, ranks):
    np.testing.assert_allclose(_batch(ranks, "sharded", "out"),
                               reference["ref/sharded/out"], rtol=1e-3,
                               atol=1e-5)
    for out in ranks:
        np.testing.assert_allclose(out["sharded"]["aux"],
                                   reference["ref/sharded/aux"], rtol=1e-5)
        assert out["sharded"]["paths"] == {"sharded": 1}
    assert sum(o["sharded"]["drops"] for o in ranks) \
        == int(reference["ref/sharded/drops"])


@pytest.mark.parametrize("leaf", ["router", "w_gate", "w_up", "w_down"])
def test_sharded_moe_gradient_matches_reference(reference, ranks, leaf):
    """Each rank's loss is its share of mean(out²) + 0.01·aux; each
    table's gradient shards (the router's too: a serving rank holds its
    (D/2, E/2) shard, gathered whole before the router product) put back
    together."""
    want = reference[f"ref/sharded/grad/{leaf}"]
    grads = [o["sharded"]["grads"][leaf] for o in ranks]
    rules = S.rules_for(MESH, MESH)
    from repro_torch.config.base import ModelConfig, MoEConfig
    from repro_torch.models import moe
    cfg = ModelConfig(name="t", family="moe", d_model=CFG["d_model"],
                      d_ff=CFG["d_ff"],
                      moe=MoEConfig(num_experts=CFG["experts"],
                                    top_k=CFG["top_k"]))
    spec = S.serve_specs({"moe": moe.moe_defs(cfg)}, rules)["moe"][leaf]
    assert spec, leaf
    got = S.unshard_tree([{leaf: g} for g in grads], {leaf: spec},
                         MESH)[leaf]
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


def test_skewed_router_drops_as_the_reference(reference, ranks):
    drops = int(reference["ref/skewed/drops"])
    assert drops > 0
    # each model rank of a data row counts its own slice's drops once
    assert sum(o["skewed"]["drops"] for o in ranks) == drops
    np.testing.assert_allclose(_batch(ranks, "skewed", "out"),
                               reference["ref/skewed/out"], rtol=1e-3,
                               atol=1e-5)
    for out in ranks:
        np.testing.assert_allclose(out["skewed"]["aux"],
                                   reference["ref/skewed/aux"], rtol=1e-5)


def test_onehot_moe_matches_reference(reference, ranks):
    np.testing.assert_allclose(_batch(ranks, "onehot", "out"),
                               reference["ref/onehot/out"], rtol=1e-4,
                               atol=1e-5)
    for out in ranks:
        assert out["onehot"]["paths"] == {"onehot": 1}
        np.testing.assert_allclose(out["onehot"]["aux"],
                                   reference["ref/onehot/aux"], rtol=1e-5)


def test_vocab_parallel_embed_bitwise(reference, ranks):
    got = _batch(ranks, "embed")
    assert got.dtype == np.float32
    assert np.array_equal(got, reference["ref/embed"])
    assert np.array_equal(got, reference["table"][reference["tokens"]])


def test_seq_sharded_decode_attention(reference, ranks):
    np.testing.assert_allclose(_batch(ranks, "decode"),
                               reference["ref/decode"], rtol=1e-4, atol=1e-5)


def test_nothing_staged_on_cpu_ranks(ranks):
    assert all(o["staged"] == {} for o in ranks)
