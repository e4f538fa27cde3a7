"""The port's trainer across processes (``make_local_sgd_block`` and
``make_ddp_step`` with a mesh, ``scatter_replicas`` / ``gather_replicas``,
``DataPipeline.process_slice``, rank-0 checkpoints) against the reference on
a ``(pod 2, data 2)`` mesh, on the smollm smoke config in f32.

One subprocess (``conftest.run_with_devices``, 4 fake devices as ``(pod 2,
data 2, model 1)``) runs the reference's jitted periodic block (int8),
hierarchical block (delayed) and DDP step for two blocks or steps from
``init_state`` on the same ``DataPipeline`` batches and dumps the initial
states, batches, losses and final states. One
``repro_torch.launch.mesh.spawn`` of 4 gloo CPU ranks runs the port's: the
replicas are the ``pod`` axis, each replica's gradient is all-reduced over
its two ``data`` ranks every step, and DDP all-reduces over all four; each
rank takes its process slice of every batch.

Bounds: the trainer's, losses relative 1e-3 and each params leaf within
relative L2 1e-3 (a mean over two data ranks sums in another order than the
reference's auto-sharded gradient, and an int8 value may flip by one step).
The scatter/gather round trip and the checkpoint are bitwise.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro_torch import tree as T
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import CheckpointConfig, DataConfig
from repro_torch.configs import smollm_360m as tconfigs
from repro_torch.data import DataPipeline
from repro_torch.launch import mesh as M

import torch_dist_ranks as R

H, BLOCKS = 2, 2
OPT = dict(name="adamw", learning_rate=3e-3, schedule="cosine",
           total_steps=20, weight_decay=0.01)
DATA = dict(seq_len=16, global_batch=8)
RUNS = [("periodic", dict(strategy="periodic", period=H,
                          compression="int8"), True),
        ("hierarchical", dict(strategy="hierarchical", period=H,
                              overlap="delayed"), True),
        ("ddp", dict(), False)]

REFERENCE = r"""
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.config import (DataConfig, MeshConfig, OptimizerConfig,
                          SyncConfig, TrainConfig, get_smoke)
from repro.core import local_sgd as LS
from repro.data.pipeline import DataPipeline
from repro.models.registry import build_model

H, BLOCKS = __H__, __BLOCKS__
RUNS = json.loads('''__RUNS__''')
OPT = json.loads('''__OPT__''')
DATA = json.loads('''__DATA__''')
out = {}

def dump(tag, tree):
    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + "/" + k)
        else:
            out[prefix] = np.asarray(node)
    walk(tree, tag)

model_cfg = dataclasses.replace(get_smoke("smollm-360m"), dtype="float32",
                                ce_chunk=8)
mesh = jax.make_mesh((2, 2, 1), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
mesh_cfg = MeshConfig(shape=(2, 2, 1), axis_names=("pod", "data", "model"),
                      replica_axis="pod")
pipe = DataPipeline(DataConfig(**DATA), model_cfg)
mbs = [pipe.next_host() for _ in range(H * BLOCKS)]
blocks = [{k: np.stack([m[k] for m in mbs[b * H:(b + 1) * H]]) for k in mbs[0]}
          for b in range(BLOCKS)]
for b, blk in enumerate(blocks):
    dump(f"batch/{b}", blk)
model = build_model(model_cfg)

for tag, sync, replicated in RUNS:
    cfg = TrainConfig(model=model_cfg, mesh=mesh_cfg, sync=SyncConfig(**sync),
                      optimizer=OptimizerConfig(**OPT),
                      data=DataConfig(**DATA))
    replicas = 2 if replicated else 0
    make = LS.make_local_sgd_block if replicated else LS.make_ddp_step
    batches = blocks if replicated else [{k: v[0] for k, v in blk.items()}
                                         for blk in blocks]
    with jax.set_mesh(mesh):
        state = LS.init_state(model, cfg, jax.random.key(0),
                              replicas=replicas)
        dump(f"{tag}/init", state)
        spec = lambda x: P("pod") if replicas and x.ndim else P()
        state = jax.tree.map(
            lambda x: jax.device_put(x, NamedSharding(mesh, spec(x))), state)
        step = jax.jit(make(model, cfg, mesh))
        for b, batch in enumerate(batches):
            state, metrics = step(state, jax.tree.map(jnp.asarray, batch))
            dump(f"{tag}/metrics/{b}", metrics)
        dump(f"{tag}/final", state)
        if replicated:
            dump(f"{tag}/finalized", LS.finalize_state(state, cfg))
np.savez("__OUT__", **out)
print("OK")
"""


def _model_cfg():
    return dataclasses.replace(tconfigs.smoke(), dtype="float32", ce_chunk=8)


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


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("dist_train") / "reference.npz"
    code = (REFERENCE.replace("__RUNS__", json.dumps(RUNS))
            .replace("__OPT__", json.dumps(OPT))
            .replace("__DATA__", json.dumps(DATA))
            .replace("__H__", str(H)).replace("__BLOCKS__", str(BLOCKS))
            .replace("__OUT__", str(path)))
    assert "OK" in run_with_devices(code, n_devices=4, timeout=900)
    with np.load(path) as data:
        return {key: data[key] for key in data.files}


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("dist_ckpt"))


@pytest.fixture(scope="module")
def ranks(reference, ckpt_dir):
    inits = {tag: _subtree(reference, f"{tag}/init") for tag, _, _ in RUNS}
    blocks = [_subtree(reference, f"batch/{b}") for b in range(BLOCKS)]
    batches = {tag: (blocks if rep else [{k: v[0] for k, v in blk.items()}
                                         for blk in blocks])
               for tag, _, rep in RUNS}
    return M.spawn(R.train_runs, 4, backend="gloo", device="cpu",
                   args=(RUNS, inits, batches, _model_cfg(), OPT, DATA,
                         ckpt_dir), timeout_s=900)


def _rel_l2(got, want):
    want = np.asarray(want, np.float64)
    diff = np.linalg.norm(np.asarray(got, np.float64) - want)
    return diff / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("run", RUNS, ids=[r[0] for r in RUNS])
def test_trainer_across_ranks_matches_reference(reference, ranks, run):
    tag, _, replicated = run
    want_final = _subtree(reference, f"{tag}/final")
    for rank, out in enumerate(ranks):
        got = out["runs"][tag]
        for b, metrics in enumerate(got["losses"]):
            want = _subtree(reference, f"{tag}/metrics/{b}")
            np.testing.assert_allclose(metrics["loss"], want["loss"],
                                       rtol=1e-3, err_msg=f"{tag} {b}")
        assert got["step"] == int(want_final["step"])
        want_p = _flat(want_final["params"])
        got_p = _flat(got["final"]["params"])
        assert sorted(got_p) == sorted(want_p)
        for key, want in want_p.items():
            assert got_p[key].shape == want.shape, key
            assert _rel_l2(got_p[key], want) <= 1e-3, (rank, tag, key)
        if replicated:
            assert got["round_trip"]
    # the replicas' gathered state is one state on every rank
    for out in ranks[1:]:
        for a, b in zip(T.leaves(out["runs"][tag]["final"]),
                        T.leaves(ranks[0]["runs"][tag]["final"])):
            assert a.tobytes() == b.tobytes()


def test_finalize_across_ranks_matches_reference(reference, ranks):
    want = _flat(_subtree(reference, "periodic/finalized")["params"])
    got = _flat(ranks[0]["runs"]["periodic"]["finalized"])
    for key, w in want.items():
        assert _rel_l2(got[key], w) <= 1e-3, key


def test_process_slice_is_the_rank_rows(ranks):
    pipe = DataPipeline(DataConfig(**DATA), _model_cfg())
    whole = pipe.next_host()
    per = DATA["global_batch"] // len(ranks)
    for r, out in enumerate(ranks):
        for key, value in whole.items():
            assert out["slice"][key].tobytes() == \
                value[r * per:(r + 1) * per].tobytes()


def test_rank0_checkpoint_restores_bitwise_in_one_process(ranks, ckpt_dir):
    got = ranks[0]["runs"]["periodic"]
    assert all(out["runs"]["periodic"]["restored_own"] for out in ranks)
    like = {"params": T.map(torch.from_numpy, got["final"]["params"]),
            "opt": T.map(torch.from_numpy, got["final"]["opt"]),
            "sync": T.map(torch.from_numpy, got["final"]["sync"]),
            "step": 0}
    ckpt = CheckpointManager(CheckpointConfig(directory=ckpt_dir))
    assert ckpt.latest_step() == BLOCKS * H
    state, _ = ckpt.restore(like, device="cpu")
    assert state["step"] == BLOCKS * H
    for part in ("params", "opt", "sync"):
        for a, b in zip(T.leaves(state[part]), T.leaves(got["final"][part])):
            assert a.numpy().tobytes() == b.tobytes()
