"""The port's trainer on a (pod, data, model) process mesh against the
reference's on fake CPU devices.

One subprocess (``conftest.run_with_devices``, 4 devices) runs the
reference: ``make_ddp_step`` on a (data 2, model 2) mesh for the dense
``TestDDPStep`` case (qwen2.5-3b smoke, ``sgd`` lr 0.1, 8 × 32 tokens) and
for phi3.5-moe smoke in f32 at T = 32,768 tokens (its ``_moe_ffn_sharded``
and ``_embed_sharded``) and at T = 256 (the one-hot MoE and the masked
lookup), each MoE case with ``grad_clip`` 0.05 (below the norm) and the gradient of its loss
under the mesh rules; and ``make_local_sgd_block`` on (pod 2, data 1, model
2), int8 ``periodic``, momentum, two blocks; and its ``ce_loss`` under
its rules on (2, 2), with the gradients of the hidden and the table. One
``repro_torch.launch.mesh.spawn`` of 4 gloo CPU ranks runs the port's from
the same initial states and batches (``interop.rank_train_state_from_jax``),
every leaf held as the reference's training rules split it, then the
vocab-parallel CE on each rank's rows and table shard, the sharded
quantize of a leaf, a checkpoint written on the model mesh and the
trainer's CLI with ``--model 2`` (phi3.5-moe and zamba2-1.2b). In the test
process the trainer's specs are held to the reference's
``state_shardings`` specs for every family.

Bounds: the dense case the reference's own (``tests/test_distributed.py::
TestDDPStep``): loss relative 1e-3, params rtol 2e-3 / atol 2e-4. The MoE
cases those of ``tests/test_torch_mesh_moe.py``: every leaf's gradient and
param after a step rtol 1e-3 / atol 1e-5, ``aux`` rtol 1e-5; the loss
relative 1e-5 (f32, the same sums up to their order). The local-SGD block
the trainer's: losses relative 1e-3, every params and moments leaf within
relative L2 1e-3; an int8 value may flip by one step, which moves the
residual ``ef`` there by that step: every ``ef`` value within its
replica's scale of the reference's, and at most 1e-4 of them off by more
than 1e-2 of it. The sharded
quantize, the checkpoint and its replay bitwise; the mesh's global norm
against the whole gradient tree's relative 1e-6. The CE: the loss
relative 1e-5, its gradients within 1e-5 of the reference's largest.
"""
import json
import os

import numpy as np
import pytest

from conftest import run_with_devices
from repro_torch import sharding as S
from repro_torch import tree as T
from repro_torch.kernels.quant import ref as quant_ref
from repro_torch.launch import mesh as M

import torch_dist_ranks as R

CASES = {
    "qwen": dict(arch="qwen2.5-3b", f32=False, rows=8, seq=32, seed=0,
                 opt=dict(name="sgd", learning_rate=0.1)),
    "sharded": dict(arch="phi3.5-moe-42b-a6.6b", f32=True, rows=64, seq=512,
                    seed=1, grads=True,
                    opt=dict(name="sgd", learning_rate=0.1, grad_clip=0.05)),
    "onehot": dict(arch="phi3.5-moe-42b-a6.6b", f32=True, rows=8, seq=32,
                   seed=2, grads=True,
                   opt=dict(name="sgd", learning_rate=0.1, grad_clip=0.05)),
}
LOCAL = dict(arch="phi3.5-moe-42b-a6.6b", rows=4, seq=32, seed=3, h=2,
             blocks=2, sync=dict(strategy="periodic", period=2,
                                 compression="int8"),
             opt=dict(name="momentum", learning_rate=0.05))
# the vocab-parallel CE on (data 2, model 2): (rows, seq, d_model, vocab,
# chunk, masked prefix or None, seed); the odd vocab is held whole
CE = {"whole": (4, 32, 16, 512, 0, None, 20),
      "chunked_text": (4, 32, 16, 512, 8, 12, 21),
      "odd_vocab": (4, 32, 16, 509, 8, None, 22)}
DDP_MESH = M.mesh_config((2, 2), ("data", "model"))
LOCAL_MESH = M.mesh_config((2, 1, 2), ("pod", "data", "model"))
# the CLI on the MoE and on one of the SSM, hybrid, VLM and audio families
CLI = {arch: ["--arch", arch, "--smoke", "--device", "cpu",
              "--backend", "gloo", "--model", "2", "--steps", "2",
              "--set", "sync.strategy=periodic", "--set", "sync.period=2",
              "--set", "sync.compression=int8", "--set", "data.seq_len=16"]
       for arch in ("phi3.5-moe-42b-a6.6b", "zamba2-1.2b")}

REFERENCE = r"""
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.config import (DataConfig, MeshConfig, OptimizerConfig,
                          SyncConfig, TrainConfig, get_smoke)
from repro.core import local_sgd as LS
from repro.models.registry import build_model
from repro.sharding import rules_for, use_rules
from repro.launch.mesh import make_test_mesh

CASES = json.loads('''__CASES__''')
LOCAL = json.loads('''__LOCAL__''')
out = {}

def dump(tag, tree):
    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + "/" + k)
        else:
            out[prefix] = np.asarray(node)
    walk(tree, tag)

def tokens(rng, cfg, shape):
    return {k: rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
            for k in ("tokens", "targets")}

mesh = make_test_mesh((2, 2), ("data", "model"))
mesh_cfg = MeshConfig(shape=(2, 2), axis_names=("data", "model"))
rules = rules_for(mesh_cfg, mesh)
for tag, c in CASES.items():
    model_cfg = get_smoke(c["arch"])
    if c["f32"]:
        model_cfg = dataclasses.replace(model_cfg, dtype="float32")
    cfg = TrainConfig(model=model_cfg, mesh=mesh_cfg,
                      optimizer=OptimizerConfig(**c["opt"]),
                      data=DataConfig(seq_len=c["seq"],
                                      global_batch=c["rows"]))
    model = build_model(cfg.model)
    batch = tokens(np.random.default_rng(c["seed"]), model_cfg,
                   (c["rows"], c["seq"]))
    dump(f"{tag}/batch", batch)
    with jax.set_mesh(mesh):
        state = LS.init_state(model, cfg, jax.random.key(c["seed"]))
        dump(f"{tag}/init", state)
        jb = jax.tree.map(jnp.asarray, batch)
        if c.get("grads"):
            with use_rules(rules):
                _, g = jax.jit(jax.value_and_grad(
                    lambda p: model.loss(p, jb), has_aux=True))(
                        state["params"])
            dump(f"{tag}/grads", g)
        state, metrics = jax.jit(LS.make_ddp_step(model, cfg, mesh))(
            state, jb)
        dump(f"{tag}/metrics", metrics)
        dump(f"{tag}/final", state["params"])

from repro.models.losses import ce_loss
for tag, (rows, seq, d, v, chunk, prefix, seed) in json.loads(
        '''__CE__''').items():
    rng = np.random.default_rng(seed)
    inp = {"x": rng.normal(size=(rows, seq, d)).astype(np.float32),
           "table": rng.normal(size=(v, d)).astype(np.float32),
           "targets": rng.integers(0, v, (rows, seq)).astype(np.int32)}
    mask = None
    if prefix is not None:
        inp["mask"] = np.repeat(np.arange(seq)[None] >= prefix, rows,
                                0).astype(np.float32)
        mask = jnp.asarray(inp["mask"])
    dump(f"ce/{tag}/in", inp)
    with jax.set_mesh(mesh), use_rules(rules):
        fn = jax.jit(jax.value_and_grad(
            lambda x, t: ce_loss(x, t, jnp.asarray(inp["targets"]), mask,
                                 chunk), argnums=(0, 1)))
        loss, (gx, gt) = fn(jnp.asarray(inp["x"]), jnp.asarray(inp["table"]))
    dump(f"ce/{tag}/out", {"loss": loss, "x": gx, "table": gt})

c = LOCAL
model_cfg = dataclasses.replace(get_smoke(c["arch"]), dtype="float32")
mesh3 = jax.make_mesh((2, 1, 2), ("pod", "data", "model"),
                      axis_types=(jax.sharding.AxisType.Auto,) * 3)
cfg = TrainConfig(model=model_cfg,
                  mesh=MeshConfig(shape=(2, 1, 2),
                                  axis_names=("pod", "data", "model"),
                                  replica_axis="pod"),
                  sync=SyncConfig(**c["sync"]),
                  optimizer=OptimizerConfig(**c["opt"]),
                  data=DataConfig(seq_len=c["seq"], global_batch=c["rows"]))
model = build_model(cfg.model)
rng = np.random.default_rng(c["seed"])
blocks = [tokens(rng, model_cfg, (c["h"], c["rows"], c["seq"]))
          for _ in range(c["blocks"])]
for b, blk in enumerate(blocks):
    dump(f"local/batch/{b}", blk)
with jax.set_mesh(mesh3):
    state = LS.init_state(model, cfg, jax.random.key(c["seed"]), replicas=2)
    dump("local/init", state)
    spec = lambda x: P("pod") if x.ndim else P()
    state = jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(mesh3, spec(x))), state)
    step = jax.jit(LS.make_local_sgd_block(model, cfg, mesh3))
    for b, blk in enumerate(blocks):
        state, metrics = step(state, jax.tree.map(jnp.asarray, blk))
        dump(f"local/metrics/{b}", metrics)
        if b == 0:
            dump("local/first", state)
    dump("local/final", state)
np.savez("__OUT__", **out)
print("OK")
"""


def _subtree(data, prefix):
    tree = {}
    for key, arr in data.items():
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        parts = key[len(prefix) + 1:].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.array(arr)
    return tree


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_train") / "reference.npz"
    code = (REFERENCE.replace("__CASES__", json.dumps(CASES))
            .replace("__LOCAL__", json.dumps(LOCAL))
            .replace("__CE__", json.dumps(CE))
            .replace("__OUT__", str(path)))
    assert "OK" in run_with_devices(code, n_devices=4, timeout=900)
    with np.load(path) as data:
        return {key: data[key] for key in data.files}


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("mesh_ckpt"))


@pytest.fixture(scope="module")
def ranks(reference, ckpt_dir):
    # an empty dict (sgd's moments, a sync state of nothing) dumps no key
    inits = {tag: {"opt": {}, "sync": {}, **_subtree(reference,
                                                     f"{tag}/init")}
             for tag in CASES}
    batches = {tag: _subtree(reference, f"{tag}/batch") for tag in CASES}
    inits["local"] = _subtree(reference, "local/init")
    inits["ce"] = {tag: (_subtree(reference, f"ce/{tag}/in"), CE[tag][4])
                   for tag in CE}
    batches["local"] = [_subtree(reference, f"local/batch/{b}")
                        for b in range(LOCAL["blocks"])]
    return M.spawn(R.mesh_train_cases, 4, backend="gloo", device="cpu",
                   args=(CASES, LOCAL, inits, batches, ckpt_dir, CLI),
                   timeout_s=900)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _flat(tree):
    return S.flat_keys(tree)


def _rel_l2(got, want):
    want = np.asarray(want, np.float64)
    diff = np.linalg.norm(np.asarray(got, np.float64) - want)
    return diff / max(np.linalg.norm(want), 1e-30)


def _ddp_specs(ranks, tag):
    return S.map_with_specs(lambda _, s: s, _get(ranks[0], ("ddp", tag,
                                                            "final")),
                            _nest(ranks[0]["ddp"][tag]["specs"]))


def _nest(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = tuple(value)
    return tree


def _whole(ranks, path, specs, mesh):
    return S.unshard_tree([_get(o, path) for o in ranks], specs, mesh)


def test_dense_ddp_step_matches_reference(reference, ranks):
    """The reference's TestDDPStep case on a (2, 2) mesh: the tied
    embedding held as shards (vocab over model, d_model over data)."""
    specs = _ddp_specs(ranks, "qwen")
    assert specs["embed"]["embedding"] == ("model", "data")
    want = reference["qwen/metrics/loss"]
    for o in ranks:
        got = o["ddp"]["qwen"]["metrics"]["loss"]
        assert abs(got - want) / abs(want) < 1e-3, (got, want)
    final = _whole(ranks, ("ddp", "qwen", "final"), specs, DDP_MESH)
    want_p = _flat(_subtree(reference, "qwen/final"))
    got_p = _flat(final)
    assert sorted(got_p) == sorted(want_p)
    for key, w in want_p.items():
        np.testing.assert_allclose(got_p[key].astype(np.float32),
                                   w.astype(np.float32), rtol=2e-3,
                                   atol=2e-4, err_msg=key)


@pytest.mark.parametrize("tag,path", [("sharded", "sharded"),
                                      ("onehot", "onehot")])
def test_moe_ddp_loss_and_aux_match_reference(reference, ranks, tag, path):
    for o in ranks:
        got = o["ddp"][tag]
        assert got["paths"] == {path: _layers()}
        np.testing.assert_allclose(got["metrics"]["loss"],
                                   reference[f"{tag}/metrics/loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(got["metrics"]["aux"],
                                   reference[f"{tag}/metrics/aux"],
                                   rtol=1e-5)


def _layers():
    from repro_torch.config import get_smoke
    return get_smoke("phi3.5-moe-42b-a6.6b").n_layers


@pytest.mark.parametrize("tag", ["sharded", "onehot"])
@pytest.mark.parametrize("what", ["grads", "final"])
def test_moe_ddp_every_leaf_matches_reference(reference, ranks, tag, what):
    """Every leaf's gradient (this rank's block of the reduced gradient)
    and param after one clipped step, put back together, against the
    reference's unsharded ones; every leaf held as ``spec_for`` splits it
    (the attention's heads, the experts and the vocab over model, d_model
    over data; the norms' scales over data)."""
    specs = _ddp_specs(ranks, tag)
    flat_specs = _flat(specs)
    assert flat_specs["layers.moe.w_gate"] == (None, "model", "data")
    assert flat_specs["layers.moe.w_down"] == (None, "model", None, "data")
    assert flat_specs["layers.moe.router"] == (None, "data", "model")
    assert flat_specs["layers.attn.wq"] == (None, "data", "model")
    assert flat_specs["layers.attn.wo"] == (None, "model", None, "data")
    assert flat_specs["layers.ln1.scale"] == (None, "data")
    assert flat_specs["embed.embedding"] == ("model", "data")
    assert flat_specs["out_embedding"] == ("model", "data")
    got = _flat(_whole(ranks, ("ddp", tag, what), specs, DDP_MESH))
    want = _flat(_subtree(reference, f"{tag}/{what}"))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=1e-3, atol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("tag", ["sharded", "onehot"])
def test_global_norm_of_the_mesh_is_the_whole_trees(reference, ranks, tag):
    """grad_clip's norm: each shard's squares summed over its blocks'
    ranks once, a whole leaf's counted once, equals the norm of the
    gradient tree put back together (and the reference's)."""
    for o in ranks:
        got = o["ddp"][tag]
        assert abs(got["norm"] - got["whole_norm"]) \
            <= 1e-6 * got["whole_norm"]
    want = np.sqrt(sum(np.sum(np.square(g.astype(np.float64)))
                       for g in T.leaves(_subtree(reference,
                                                  f"{tag}/grads"))))
    assert abs(ranks[0]["ddp"][tag]["norm"] - want) <= 1e-4 * want
    # the clip is active: the step's param delta is the clipped norm's
    assert want > CASES[tag]["opt"]["grad_clip"]


@pytest.mark.parametrize("tag", sorted(CE))
def test_vocab_parallel_ce_matches_reference(reference, ranks, tag):
    """``losses.ce_loss`` under the trainer's rules on (data 2, model 2):
    each rank's rows of the final hidden and its (V/2, D/2) shard of the
    table (the odd vocab's (V, D/2): held whole over model), unchunked and
    in checkpointed chunks, over a text mask; against the reference's
    ``ce_loss`` under its rules on 4 devices. The mean of the ranks'
    losses at relative 1e-5; the gradients of the hidden and of the table,
    each rank's summed over the ranks that hold the same block and divided
    by the 4 (the trainer's reduction), put back together, within 1e-5 of
    the reference's largest."""
    rows, seq, d, v, *_ = CE[tag]
    want = _subtree(reference, f"ce/{tag}/out")
    got = [o["ce"][tag] for o in ranks]
    loss = np.mean([g["loss"] for g in got])
    assert abs(loss - want["loss"]) <= 1e-5 * abs(want["loss"]), (loss,
                                                                   want)
    spec = tuple(got[0]["spec"])
    assert spec == (("model", "data") if v % 2 == 0 else (None, "data"))
    for key, spec_k in (("x", ("data",)), ("table", spec)):
        whole = S.unshard_tree([g[key] for g in got], spec_k, DDP_MESH)
        scale = np.abs(want[key]).max()
        err = np.abs(whole - want[key]).max()
        assert err <= 1e-5 * scale, (key, err, scale)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_sharded_quantize_is_the_whole_leafs(ranks, impl):
    """Each rank's block packed with the whole leaf's scale (its amax
    maxed over the ranks of the other blocks): the blocks put back
    together are bitwise the whole leaf's quantization, per row."""
    import torch
    leaf = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 2, 4, 16, 8)).astype(np.float32) * 3.0)
    spec = tuple(ranks[0]["quant"]["spec"])
    q = S.unshard_tree([o["quant"][impl]["q"] for o in ranks], spec,
                       DDP_MESH)
    res = S.unshard_tree([o["quant"][impl]["res"] for o in ranks], spec,
                         DDP_MESH)
    want_q, want_s = quant_ref.quantize(leaf, rows=True)
    assert np.array_equal(q, want_q.numpy())
    for o in ranks:
        assert np.array_equal(o["quant"][impl]["scale"], want_s.numpy())
    want_res = leaf - quant_ref.dequantize(want_q, want_s)
    assert np.array_equal(res, want_res.numpy())


@pytest.mark.parametrize("what", ["first", "final"])
def test_local_sgd_block_matches_reference(reference, ranks, what):
    """make_local_sgd_block on (pod 2, data 1, model 2), int8 periodic:
    params, moments and ef of both replicas, put back together, within
    the trainer's bound after each block; the losses at 1e-3."""
    specs = {k: ranks[0]["local"]["specs"][k]
             for k in ("params", "opt", "sync")}
    # d_model stays whole on a data axis of one rank
    assert specs["sync"]["ef"]["layers"]["moe"]["w_up"] \
        == (None, None, "model")
    got = S.unshard_tree([o["local"][what] for o in ranks], {
        k: S.map_with_specs(lambda s, _: ("pod",) + tuple(s[1:])
                            if any(s) else ("pod",), v, v)
        for k, v in specs.items()}, LOCAL_MESH)
    want = _subtree(reference, f"local/{what}")
    block = 0 if what == "first" else LOCAL["blocks"] - 1
    scales = _flat(S.unshard_tree(
        [o["local"]["payloads"][block]["scale"] for o in ranks],
        S.map_with_specs(lambda _, s: ("pod",), specs["params"],
                         specs["params"]), LOCAL_MESH))
    flips, values = 0, 0
    for part in ("params", "opt", "sync"):
        g, w = _flat(got[part]), _flat(want[part])
        assert sorted(g) == sorted(w), part
        for key in w:
            assert g[key].shape == w[key].shape, key
            if part != "sync":
                assert _rel_l2(g[key], w[key]) <= 1e-3, (part, key)
                continue
            # the residual where an int8 value flipped moves by that
            # replica's quantization step (its scale), and elsewhere by
            # at most 1e-2 of the step (f32 sums); flips are rare
            step = np.broadcast_to(scales[key[len("ef."):]].reshape(
                (-1,) + (1,) * (w[key].ndim - 1)), w[key].shape)
            diff = np.abs(g[key].astype(np.float64) - w[key])
            flipped = diff > 1e-2 * step
            flips += int(flipped.sum())
            values += diff.size
            assert np.all(diff <= step * (1 + 1e-5)), key
    assert flips <= 1e-4 * values, (flips, values)
    for b in range(LOCAL["blocks"]):
        for o in ranks:
            got_l = o["local"]["metrics"][b]["loss"]
            want_l = float(reference[f"local/metrics/{b}/loss"])
            assert abs(got_l - want_l) <= 1e-3 * abs(want_l)
    assert ranks[0]["local"]["paths"] == {"onehot": _layers() * LOCAL["h"]}


def test_local_sgd_payloads_are_the_whole_leafs(ranks):
    """Every sync's int8 payloads: the two model ranks of a replica pack
    their blocks of a leaf with one scale, the whole leaf's."""
    for pod in (0, 1):
        for a, b in zip(ranks[2 * pod]["local"]["payloads"],
                        ranks[2 * pod + 1]["local"]["payloads"]):
            for sa, sb in zip(T.leaves(a["scale"]), T.leaves(b["scale"])):
                assert np.array_equal(sa, sb)


def test_checkpoint_on_a_model_mesh_is_the_one_process_file(reference,
                                                            ranks,
                                                            ckpt_dir):
    """The file rank 0 writes holds the whole leaves (the blocks put back
    together, the replicas stacked), under the one-process state's keys;
    read back each rank holds its blocks bitwise and steps from them
    bitwise as from the state it wrote."""
    specs = {k: ranks[0]["local"]["specs"][k]
             for k in ("params", "opt", "sync")}
    latest = open(os.path.join(ckpt_dir, "LATEST")).read().strip()
    with np.load(os.path.join(ckpt_dir, latest, "arrays.npz")) as f:
        arrays = {k: f[k] for k in f.files}
    whole = S.unshard_tree([o["local"]["final"] for o in ranks], {
        k: S.map_with_specs(lambda s, _: ("pod",) + tuple(s[1:])
                            if any(s) else ("pod",), v, v)
        for k, v in specs.items()}, LOCAL_MESH)
    want = {k.replace(".", "/"): v for k, v in _flat(whole).items()}
    init = {k.replace(".", "/"): v for k, v in
            _flat({p: _subtree(reference, f"local/init/{p}")
                   for p in ("params", "opt", "sync")}).items()}
    assert sorted(arrays) == sorted(list(want) + ["step"])
    assert sorted(init) == sorted(want)
    for key, value in want.items():
        assert arrays[key].shape == init[key].shape, key
        assert np.array_equal(arrays[key], value), key
    for o in ranks:
        assert o["local"]["restored_equal"]
        assert o["local"]["replay_bitwise"]


@pytest.mark.parametrize("arch", sorted(CLI))
def test_cli_trains_on_a_model_mesh(ranks, arch):
    line = json.loads(ranks[0]["cli"][arch].strip().splitlines()[-1])
    from repro_torch.config import get_smoke
    assert line["arch"] == get_smoke(arch).name
    assert line["mesh"] == {"pod": 2, "data": 1, "model": 2}
    assert line["steps"] == 2 and line["ranks"] == 4
    assert np.isfinite(line["first_loss"]) and np.isfinite(line["last_loss"])
    assert all(o["cli"][arch] == "" for o in ranks[1:])


class _FakeMesh:
    """axis_names/devices.shape stand-in for the reference's rules."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.zeros(shape)


def _held(spec, sizes, skip=0):
    """A spec with its first ``skip`` entries dropped and every mesh axis
    of one rank taken out (a split into one block places as whole), the
    trailing whole entries trimmed."""
    out = []
    for entry in tuple(spec)[skip:]:
        axes = tuple(a for a in S.entry_axes(entry) if sizes[a] > 1)
        out.append(None if not axes else axes[0] if len(axes) == 1
                   else axes)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@pytest.mark.parametrize("arch", R.FAMILY_ARCHS + ("qwen3-moe-235b-a22b",))
def test_trainer_specs_are_unchanged_by_serving_tp(arch):
    """The trainer holds every leaf as the serving engine's rules split it
    and as the reference's trainer places it: on (data 2, model 2) under
    DDP and on (pod 2, data 1, model 2) under int8 local SGD with AdamW,
    every params, moments and sync leaf's spec (``local_sgd.state_specs``
    of ``sharding.train_specs``) is the reference's ``state_shardings``
    spec of it (``rules_for`` on the mesh, ``spec_for`` of each leaf's
    logical axes and shape; the replica dim, which the rank holds one row
    of, and mesh axes of one rank aside), and each layer's is the serving
    rules' ``serve_specs`` (the cache's length aside, both fit the same
    dims, ``sharding.model_dims``)."""
    import jax
    import torch
    from repro.config import MeshConfig as JMeshConfig
    from repro.config import OptimizerConfig as JOpt
    from repro.config import SyncConfig as JSync
    from repro.config import TrainConfig as JTrainConfig
    from repro.config import get_smoke as jget_smoke
    from repro.core import local_sgd as JLS
    from repro.models.registry import build_model as jbuild
    from repro.sharding import rules_for as jrules_for
    from repro_torch.config import (MeshConfig, OptimizerConfig, SyncConfig,
                                    TrainConfig, get_smoke)
    from repro_torch.core import local_sgd as LS
    from repro_torch.launch.serve import serving_rules
    from repro_torch.models import layers as TL
    from repro_torch.models.registry import build_model
    is_tuple = (lambda x: isinstance(x, tuple)
                and all(isinstance(e, (str, type(None))) for e in x))
    for shape, names in (((2, 2), ("data", "model")),
                         ((2, 1, 2), ("pod", "data", "model"))):
        local = "pod" in names
        sync = dict(strategy="periodic", period=2, compression="int8") \
            if local else {}
        kw = dict(shape=shape, axis_names=names,
                  replica_axis="pod" if local else "")
        jcfg = JTrainConfig(model=jget_smoke(arch), mesh=JMeshConfig(**kw),
                            optimizer=JOpt(name="adamw"),
                            sync=JSync(**sync))
        jmodel = jbuild(jcfg.model)
        jstate = jax.eval_shape(lambda: JLS.init_state(
            jmodel, jcfg, jax.random.key(0), replicas=2 if local else 0))
        axes = JLS.build_state_axes(jmodel, jcfg, replicated=local)
        rules = jrules_for(jcfg.mesh, _FakeMesh(shape, names))
        want = jax.tree.map(lambda la, x: tuple(rules.spec_for(la, x.shape)),
                            {k: axes[k] for k in ("params", "opt", "sync")},
                            {k: jstate[k] for k in ("params", "opt", "sync")},
                            is_leaf=is_tuple)

        cfg = TrainConfig(model=get_smoke(arch), mesh=MeshConfig(**kw),
                          optimizer=OptimizerConfig(name="adamw"),
                          sync=SyncConfig(**sync))
        model = build_model(cfg.model)
        defs = model.param_defs()
        rules_t = S.training_rules(cfg, cfg.mesh)
        param_specs = S.train_specs(defs, rules_t)
        state = LS.state_of(TL.empty_params(defs, torch.float32, "meta"),
                            cfg, 2 if local else 0)
        got = LS.state_specs(state, param_specs, local)
        sizes = dict(zip(names, shape))
        skip = 1 if local else 0
        got_flat = {k: _held(v, sizes, skip) for k, v in
                    _flat({k: got[k] for k in want}).items()}
        want_flat = {k: _held(v, sizes, skip) for k, v in
                     _flat(want).items()}
        assert got_flat == want_flat, (shape, {
            k: (got_flat.get(k), v) for k, v in want_flat.items()
            if got_flat.get(k) != v})
        # the serving layout, layer by layer
        serve = _flat(S.serve_specs(defs, serving_rules(
            cfg.model, _Sized((shape[-2], shape[-1])), 64)))
        for key, spec in _flat(param_specs).items():
            parts = key.split(".")
            layer = (".".join([parts[0], "0"] + parts[1:])
                     if parts[0] in TL.STACKS else key)
            assert _held(spec, sizes, 1 if parts[0] in TL.STACKS else 0) \
                == _held(serve[layer], sizes), (shape, key)


class _Sized:
    """A (data, model) mesh's axes and shape, as ``serving_rules`` reads
    them."""

    def __init__(self, shape):
        self.axes, self.shape = ("data", "model"), shape
