"""The port's H ladder across processes (``build_trainer(cfg, device, mesh)``
with ``sync.adaptive``, ``LadderRuntime(mesh=)``, ``ladder_switch_state(…,
mesh)``, ``timed_step(mesh=)``, ``collectives.agree``) on the smollm smoke
config in f32, int8 sync with error feedback.

One subprocess (``conftest.run_with_devices``, 4 fake devices) runs the
reference's ladder as ``tests/test_ladder.py``'s trainer-ladder test does:
``build_trainer`` on a ``(4, 1)`` mesh with the replicas on ``data``, rungs
(2, 4), 3 blocks at H = 2, the switch, 2 at H = 4, on the ``DataPipeline``'s
microbatch stream re-blocked at the switch. One ``spawn`` of 4 gloo CPU
ranks (bodies in ``tests/torch_dist_ranks.py``) runs the port's ladder with
the same forced moves from the reference's initial state, each rank its
rows; a hierarchical ladder on ``(pod 2, data 2)``; skewed per-rank timings
through every rank's controller; controllers that disagree; and the CLI.

Bounds: against the reference, the trainer's (losses relative 1e-3, each
params leaf relative L2 1e-3). Against the port's one-process run of the
same ladder (K = 4 replicas as a leading dim, or K = 2 periodic for the
hierarchical case, whose data ranks sum a gradient in another order):
bitwise, the switch with error feedback included; the hierarchical case at
the trainer's bounds.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.config import (DataConfig, MeshConfig, OptimizerConfig,
                                SyncConfig, TrainConfig)
from repro_torch.configs import smollm_360m as tconfigs
from repro_torch.core.autotune import AdaptiveController
from repro_torch.launch import mesh as M
from repro_torch.launch import train as ttrain

import torch_dist_ranks as R

torch.set_num_threads(1)

OPT = dict(name="adamw", learning_rate=3e-3, schedule="cosine",
           total_steps=20, weight_decay=0.01)
DATA = dict(seq_len=16, global_batch=8)
HS = (2, 2, 2, 4, 4)
CLI = ["--arch", "smollm-360m", "--smoke", "--device", "cpu",
       "--backend", "gloo", "--steps", "6",
       "--set", "sync.strategy=periodic", "--set", "sync.period=4",
       "--set", "sync.adaptive=true", "--set", "sync.adapt_every=2",
       "--set", "sync.adapt_ladder=1,2,4", "--set", "sync.compression=int8",
       "--set", "sync.adapt_max_drift=0.001", "--set", "data.seq_len=16"]

REFERENCE = r"""
import dataclasses, json, sys
sys.argv = ["t"]
import jax, numpy as np
from repro.config import DataConfig, OptimizerConfig, TrainConfig, get_smoke
from repro.config.base import replace as cfg_replace
from repro.data.pipeline import DataPipeline
from repro.launch.mesh import make_test_mesh, test_mesh_config
from repro.launch.train import build_trainer

OPT = json.loads('''__OPT__''')
DATA = json.loads('''__DATA__''')
HS = json.loads('''__HS__''')
out = {}

def dump(tag, tree):
    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + "/" + k)
        else:
            out[prefix] = np.asarray(node)
    walk(tree, tag)

mesh = make_test_mesh((4, 1))
cfg = TrainConfig(
    model=dataclasses.replace(get_smoke("smollm-360m"), dtype="float32",
                              ce_chunk=8),
    mesh=cfg_replace(test_mesh_config((4, 1)), replica_axis="data"),
    optimizer=OptimizerConfig(**OPT), data=DataConfig(**DATA), steps=8)
cfg = cfg_replace(cfg, **{"sync.strategy": "periodic", "sync.period": 2,
                          "sync.compression": "int8", "sync.adaptive": True,
                          "sync.adapt_ladder": (2, 4)})
step, state, make_pipeline, model, telemetry, ladder = build_trainer(cfg,
                                                                     mesh)
assert sorted(ladder.rungs) == [2, 4]
dump("init", jax.device_get(state))
pipe = DataPipeline(cfg.data, cfg.model)
blocks = []
for h in HS:
    mbs = [pipe.next_host() for _ in range(h)]
    blocks.append({k: np.stack([m[k] for m in mbs]) for k in mbs[0]})
with jax.set_mesh(mesh):
    for b, batch in enumerate(blocks):
        dump(f"batch/{b}", batch)
        if b and HS[b] != HS[b - 1]:
            dump("pre", jax.device_get(state))
            state = ladder.switch_fn(state)
            dump("switched", jax.device_get(state))
        state, metrics = ladder.rungs[HS[b]](state, batch)
        dump(f"metrics/{b}", jax.device_get(metrics))
    dump("final", jax.device_get(state))
assert ladder.compile_counter.since_mark == 0
np.savez("__OUT__", **out)
print("OK")
"""


def _model_cfg():
    return dataclasses.replace(tconfigs.smoke(), dtype="float32", ce_chunk=8)


def _cfg(mesh_cfg, **sync):
    return TrainConfig(model=_model_cfg(), mesh=mesh_cfg,
                       sync=SyncConfig(compression="int8", adaptive=True,
                                       adapt_ladder=(2, 4), period=2, **sync),
                       optimizer=OptimizerConfig(**OPT),
                       data=DataConfig(**DATA))


def _ladder_cfg():
    return _cfg(MeshConfig(shape=(4, 1), axis_names=("data", "model"),
                           replica_axis="data"), strategy="periodic")


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


def _rel_l2(got, want):
    want = np.asarray(want, np.float64)
    diff = np.linalg.norm(np.asarray(got, np.float64) - want)
    return diff / max(np.linalg.norm(want), 1e-30)


def _same(got, want):
    a, b = T.leaves(got), T.leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.tobytes() == y.tobytes()


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("dist_ladder") / "reference.npz"
    code = (REFERENCE.replace("__OPT__", json.dumps(OPT))
            .replace("__DATA__", json.dumps(DATA))
            .replace("__HS__", json.dumps(list(HS)))
            .replace("__OUT__", str(path)))
    assert "OK" in run_with_devices(code, n_devices=4, timeout=900)
    with np.load(path) as data:
        return {key: data[key] for key in data.files}


def _blocks(reference):
    return [_subtree(reference, f"batch/{b}") for b in range(len(HS))]


@pytest.fixture(scope="module")
def ranks(reference):
    return M.spawn(R.ladder_runs, 4, backend="gloo", device="cpu",
                   args=(_subtree(reference, "init"), _blocks(reference),
                         _model_cfg(), OPT, DATA, CLI), timeout_s=600)


def _one_process(cfg, init, blocks):
    """The same ladder on one process, K replicas a leading dim."""
    _, state, _, _, _, ladder = ttrain.build_trainer(cfg, "cpu")
    if init is not None:
        state = interop.lm_train_state_from_jax(
            {"opt": {}, "sync": {}, **init}, cfg)
    tensors = [{k: torch.from_numpy(v) for k, v in b.items()} for b in blocks]
    state, losses, pre, switched, whole = R.drive_ladder(ladder, state,
                                                         tensors)
    return dict(losses=losses, pre=pre, switched=switched,
                final=whole(state), step=state["step"])


@pytest.fixture(scope="module")
def one_process(reference):
    return _one_process(_ladder_cfg(), _subtree(reference, "init"),
                        _blocks(reference))


def test_ladder_across_ranks_matches_reference(reference, ranks):
    """3 blocks at H = 2, the switch, 2 at H = 4 on 4 ranks against the
    reference's ladder on 4 devices: losses, the state before and after
    the switch and the final params within the trainer's bounds; no kernel
    built or loaded after the warmup on any rank; a rung refuses another
    H's block."""
    for rank, out in enumerate(ranks):
        got = out["ladder"]
        for b, loss in enumerate(got["losses"]):
            want = float(_subtree(reference, f"metrics/{b}")["loss"])
            np.testing.assert_allclose(loss, want, rtol=1e-3,
                                       err_msg=f"rank {rank} block {b}")
        for tag in ("pre", "switched", "final"):
            want_p = _flat(_subtree(reference, tag)["params"])
            got_p = _flat(got[tag]["params"])
            assert sorted(got_p) == sorted(want_p)
            for key, want in want_p.items():
                assert got_p[key].shape == want.shape, key
                assert _rel_l2(got_p[key], want) <= 1e-3, (rank, tag, key)
        assert got["step"] == int(_subtree(reference, "final")["step"])
        for leaf in T.leaves(got["switched"]["sync"]["ef"]):
            assert not leaf.any()
        summary = got["summary"]
        assert summary["ranks"] == 4 and summary["ladder"] == [2, 4]
        assert summary["compiles_after_warmup"] == 0
        assert got["refused"]


def test_ladder_across_ranks_is_the_one_process_ladder(ranks, one_process):
    """The 4 ranks' ladder is bitwise the one-process K = 4 ladder: every
    block's loss, the state before and after the switch (error feedback
    folded into the params over the ranks) and the final state, on every
    rank."""
    for out in ranks:
        got = out["ladder"]
        assert got["losses"] == one_process["losses"]
        for tag in ("pre", "switched", "final"):
            _same(got[tag], one_process[tag])
        assert got["step"] == one_process["step"] == 3 * 2 + 2 * 4


def test_hierarchical_ladder_across_ranks(ranks):
    """On (pod 2, data 2) under ``hierarchical`` the ladder moves H for the
    2 pod replicas: against the one-process periodic K = 2 ladder (each
    replica both data ranks' rows) within the trainer's bounds, and one
    state on every rank."""
    blocks = [{k: v for k, v in b.items()} for b in _block_stream()]
    want = _one_process(_cfg(MeshConfig(shape=(2,), axis_names=("pod",),
                                        replica_axis="pod"),
                             strategy="periodic"), None, blocks)
    for out in ranks:
        got = out["hierarchical"]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-3)
        got_p, want_p = _flat(got["final"]["params"]), \
            _flat(want["final"]["params"])
        for key, w in want_p.items():
            assert _rel_l2(got_p[key], w) <= 1e-3, key
        assert got["summary"]["ranks"] == 4
        assert got["summary"]["compiles_after_warmup"] == 0
        _same(got["final"], ranks[0]["hierarchical"]["final"])


def _block_stream():
    from repro_torch.data import DataPipeline
    pipe = DataPipeline(DataConfig(**DATA), _model_cfg())
    out = []
    for h in HS:
        mbs = [pipe.next_host() for _ in range(h)]
        out.append({k: np.stack([m[k] for m in mbs]) for k in mbs[0]})
    return out


def test_blocks_are_the_reference_stream(reference):
    for got, want in zip(_block_stream(), _blocks(reference)):
        for key in want:
            assert got[key].tobytes() == want[key].tobytes()


def _controller_fed(samples):
    ctrl = AdaptiveController(
        SyncConfig(strategy="periodic", period=2, adaptive=True,
                   adapt_ladder=(1, 2, 4), adapt_every=2),
        param_bytes_per_chip=1 << 20, replicas=4, ladder=(1, 2, 4))
    for h, wall, sync in samples:
        assert h == ctrl.h
        ctrl.observe_block(block_s=wall, sync_s=sync)
    return ctrl.history


def test_skewed_timings_give_every_rank_the_same_h(ranks):
    """Rank 3's sync is 2,000× the others': every rank's telemetry records
    the max over the ranks, every rank's controller moves to the top rung,
    as one controller fed the max does; fed rank 0's own times it would
    hold H."""
    traj = ranks[0]["skewed"]["trajectory"]
    for out in ranks:
        assert out["skewed"] == ranks[0]["skewed"]
    samples = ranks[0]["skewed"]["samples"]
    assert [s for _, _, s in samples] == [2.0] * len(samples)
    assert _controller_fed(samples) == traj == [(0, 2), (2, 4)]
    own = [(h, 0.01 * h + 0.001, 0.001) for h, _, _ in samples[:2]]
    assert _controller_fed(own) == [(0, 2)]


def test_disagreeing_controllers_raise_on_every_rank(ranks):
    for out in ranks:
        assert out["disagree"] is not None
        assert "H ranges from 1 to 2" in out["disagree"]


@pytest.fixture(scope="module")
def cli_lines(ranks):
    return [out["cli"] for out in ranks]


def test_adaptive_cli_across_ranks(cli_lines):
    """The CLI on 4 ranks (``--backend gloo``, one replica a rank), as the
    reference's adaptive smoke: H moves mid-run on the drift cap, and the
    trajectory, the rank count and no compile after the warmup are in rank
    0's JSON line; the other ranks print nothing."""
    assert all(line == "" for line in cli_lines[1:])
    rec = json.loads(cli_lines[0].strip().splitlines()[-1])
    ad = rec["adaptive"]
    assert rec["ranks"] == 4 and rec["backend"] == "gloo"
    assert rec["steps"] == 6 and rec["device"] == "cpu"
    assert ad["ranks"] == 4 and ad["ladder"] == [1, 2, 4]
    assert ad["h_trajectory"] == [[0, 4], [2, 1]]
    assert ad["compiles_after_warmup"] == 0
    assert ad["telemetry"]["t_sync_s"] > 0
