"""The port's H ladder (``repro_torch.runtime.ladder``,
``local_sgd.ladder_switch_state``, ``launch.train``'s adaptive trainer)
and the SVM block ladder (``repro_torch.core.svm``'s steppers) against the
reference on the CPU.

One subprocess (``conftest.run_with_devices``, 4 fake devices) runs the
reference twice:

* its jitted ``make_train_step`` on the smollm smoke config in f32 (K = 4
  replicas, int8 sync with error feedback): 3 blocks at H = 2,
  ``ladder_switch_state``, 2 blocks at H = 4, on the ``DataPipeline``'s
  microbatch stream re-blocked at the switch;
* ``jax.jit(dms_block_stepper(...))`` on a 4-device mesh in every
  overlap × topology × async mode: 3 blocks of 2 points, the
  ``dms_ladder_switch``, 2 blocks of 4, and one ``dms_timed_steps`` compute
  + sync. (The reference's AOT ``dms_block_ladder`` rungs fail on this jax,
  ROADMAP §3, so the stepper is held to the jitted stepper.)

Bounds: the trainer's losses rtol 1e-4, its params and moments as
``tests/test_torch_train.py`` holds them under int8 (atol one quant step of
the leaf, the moments 1e-3 of their largest value), the switched state's
sync buffers exactly zero where the reference's are; the SVM carries to
``tests/test_torch_svm.py``'s trained-model bound, atol 1e-4, and their
counters equal. ``ladder_switch_state`` itself, a pure function, is held
in-process to the reference's for every mode of ``tests/test_torch_sync.py``
at its bounds (rtol 1e-6 / atol 1e-7), counters equal.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro.config import SyncConfig as JSyncConfig
from repro.config import TrainConfig as JTrainConfig
from repro.core import local_sgd as JLS
from repro.core import sync as JS
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import (CheckpointConfig, DataConfig,
                                FaultToleranceConfig, MeshConfig, ModelConfig,
                                OptimizerConfig, SyncConfig, TrainConfig,
                                get_smoke)
from repro_torch.core import local_sgd as LS
from repro_torch.core import svm
from repro_torch.core import sync as S
from repro_torch.core.autotune import AdaptiveController, snap_to_ladder
from repro_torch.core.telemetry import BlockTelemetry
from repro_torch.data.pipeline import DataPipeline
from repro_torch.kernels import nvcc
from repro_torch.launch import train as ttrain
from repro_torch.runtime import LadderRuntime, StepRunner
from repro_torch.runtime.ladder import CompileCounter, compile_rungs

torch.set_num_threads(1)

K, SVM_D = 4, 8
OPT = dict(name="adamw", learning_rate=3e-3, schedule="cosine",
           total_steps=20, weight_decay=0.01)
DATA = dict(seq_len=16, global_batch=8)
SVM_CASES = [dict(overlap="none", topology="all"),
             dict(overlap="delayed", topology="all"),
             dict(overlap="chunked", chunks=2, topology="all"),
             dict(overlap="none", topology="ring"),
             dict(overlap="none", topology="pairwise"),
             dict(overlap="delayed", topology="ring"),
             dict(overlap="delayed", topology="pairwise"),
             dict(overlap="chunked", chunks=2, topology="ring"),
             dict(overlap="chunked", chunks=2, topology="pairwise"),
             dict(overlap="none", topology="ring", gossip_async=True),
             dict(overlap="none", topology="pairwise", gossip_async=True)]
MODEL_ATOL = 1e-4           # tests/test_torch_svm.py's trained-model bound

REFERENCE = r"""
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.config import (DataConfig, MeshConfig, OptimizerConfig,
                          SyncConfig, TrainConfig, get_smoke)
from repro.core import local_sgd as LS
from repro.core import svm
from repro.data.pipeline import DataPipeline
from repro.models.registry import build_model

K, D = __K__, __D__
OPT = json.loads('''__OPT__''')
DATA = json.loads('''__DATA__''')
CASES = json.loads('''__CASES__''')
out = {}

def dump(tag, tree):
    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + "/" + k)
        else:
            out[prefix] = np.asarray(node)
    walk(tree, tag)

# --- the trainer: 3 blocks at H=2, the switch, 2 blocks at H=4 ------------
model_cfg = dataclasses.replace(get_smoke("smollm-360m"), dtype="float32",
                                ce_chunk=8)
mesh = jax.make_mesh((K, 1, 1), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
cfg = TrainConfig(model=model_cfg,
                  mesh=MeshConfig(shape=(K, 1, 1),
                                  axis_names=("pod", "data", "model"),
                                  replica_axis="pod"),
                  sync=SyncConfig(strategy="periodic", period=2,
                                  compression="int8", adaptive=True,
                                  adapt_ladder=(2, 4)),
                  optimizer=OptimizerConfig(**OPT), data=DataConfig(**DATA))
pipe = DataPipeline(cfg.data, cfg.model)
def block(h):
    mbs = [pipe.next_host() for _ in range(h)]
    return {k: np.stack([m[k] for m in mbs]) for k in mbs[0]}
blocks = [block(2) for _ in range(3)] + [block(4) for _ in range(2)]
for b, blk in enumerate(blocks):
    dump(f"batch/{b}", blk)
model = build_model(model_cfg)
with jax.set_mesh(mesh):
    state = LS.init_state(model, cfg, jax.random.key(0), replicas=K)
    dump("init", state)
    spec = lambda x: P("pod") if x.ndim else P()
    state = jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(mesh, spec(x))), state)
    step = jax.jit(LS.make_train_step(model, cfg, mesh))
    for b, batch in enumerate(blocks):
        if b == 3:
            dump("pre", state)
            state = LS.ladder_switch_state(state, cfg)
            dump("switched", state)
        state, metrics = step(state, jax.tree.map(jnp.asarray, batch))
        dump(f"metrics/{b}", metrics)
    dump("final", state)

# --- the SVM stepper on a 4-device mesh ------------------------------------
smesh = jax.make_mesh((K,), ("data",),
                      axis_types=(jax.sharding.AxisType.Auto,))
rng = np.random.default_rng(0)
w0 = rng.normal(size=(D,)).astype(np.float32)
out["svm/w0"] = w0
def data(bs):
    return (rng.normal(size=(K, bs, D)).astype(np.float32),
            np.sign(rng.normal(size=(K, bs))).astype(np.float32))
with jax.set_mesh(smesh):
    for i, kw in enumerate(CASES):
        stepper = jax.jit(svm.dms_block_stepper(smesh, "data", d=D, **kw))
        carry = svm.dms_stepper_init(jnp.asarray(w0), K, **kw)
        for b in range(5):
            if b == 3:
                dump(f"svm/{i}/pre", carry)
                carry = svm.dms_ladder_switch(jax.device_get(carry), d=D,
                                              **kw)
                dump(f"svm/{i}/switched", carry)
            x, y = data(2 if b < 3 else 4)
            out[f"svm/{i}/x/{b}"], out[f"svm/{i}/y/{b}"] = x, y
            carry = stepper(carry, jnp.asarray(x), jnp.asarray(y),
                            jnp.float32(0.5 if b < 3 else 0.25))
        dump(f"svm/{i}/final", carry)
        if kw["overlap"] != "none" and kw["topology"] != "all":
            continue
        compute, sync = svm.dms_timed_steps(smesh, "data", block_size=2,
                                            **kw)
        x, y = data(2)
        out[f"timed/{i}/x"], out[f"timed/{i}/y"] = x, y
        shared = kw["overlap"] == "none" and kw["topology"] == "all"
        wl = rng.normal(size=(K, D)).astype(np.float32)
        out[f"timed/{i}/w"] = wl
        w_in = jnp.asarray(wl[0] if shared else wl)
        w_end = compute(w_in, jnp.asarray(x), jnp.asarray(y),
                        jnp.float32(0.5))
        out[f"timed/{i}/compute"] = np.asarray(w_end)
        cnt = jnp.int32(3)
        if kw.get("gossip_async"):
            sent, mixbuf = svm.dms_async_buffers_init(jnp.asarray(wl),
                                                      kw["topology"])
            res = sync(w_end, sent + 0.1, mixbuf, cnt)
        elif kw["topology"] != "all":
            res = sync(w_end, cnt)
        elif kw["overlap"] == "none":
            res = sync(w_end)
        elif kw["overlap"] == "delayed":
            res = sync(jnp.asarray(wl), w_end, 0.01 * jnp.asarray(wl))
        else:
            res = sync(w_end, cnt)
        res = res if isinstance(res, tuple) else (res,)
        for j, r in enumerate(res):
            out[f"timed/{i}/sync/{j}"] = np.asarray(r)
np.savez("__OUT__", **out)
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("ladder") / "reference.npz"
    code = (REFERENCE.replace("__OPT__", json.dumps(OPT))
            .replace("__DATA__", json.dumps(DATA))
            .replace("__CASES__", json.dumps(SVM_CASES))
            .replace("__K__", str(K)).replace("__D__", str(SVM_D))
            .replace("__OUT__", str(path)))
    assert "OK" in run_with_devices(code, n_devices=K, timeout=900)
    with np.load(path) as data:
        return {key: data[key] for key in data.files}


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


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


# ---------------------------------------------------------------------------
# config, snap, controller in ladder mode (tests/test_ladder.py's cases)
# ---------------------------------------------------------------------------

class TestLadderConfig:
    def test_geometric_ladder(self):
        cfg = SyncConfig(strategy="periodic", period=8, adapt_h_max=64)
        assert cfg.ladder_rungs() == (1, 2, 4, 8, 16, 32, 64)

    def test_period_always_included(self):
        cfg = SyncConfig(strategy="periodic", period=24, adapt_h_max=8)
        assert cfg.ladder_rungs() == (1, 2, 4, 8, 24)

    def test_explicit_ladder_overrides(self):
        cfg = SyncConfig(strategy="periodic", period=3,
                         adapt_ladder=(1, 3, 9, 27))
        assert cfg.ladder_rungs() == (1, 3, 9, 27)

    def test_validate_rejects_bad_ladder(self):
        with pytest.raises(ValueError, match="adapt_ladder"):
            S.validate(SyncConfig(strategy="periodic", adaptive=True,
                                  adapt_ladder=(0, 2)))
        with pytest.raises(ValueError, match="rung_hysteresis"):
            S.validate(SyncConfig(strategy="periodic", adaptive=True,
                                  adapt_rung_hysteresis=0))


class TestSnapToLadder:
    def test_log_nearest(self):
        ladder = (1, 2, 4, 8, 16)
        assert [snap_to_ladder(h, ladder) for h in (1, 3, 6, 100)] == \
            [1, 4, 8, 16]
        assert snap_to_ladder(4, (2, 8)) == 2

    def test_empty_ladder_raises(self):
        with pytest.raises(ValueError):
            snap_to_ladder(4, ())


def _ctrl(**kw):
    kw.setdefault("param_bytes_per_chip", 10**8)
    kw.setdefault("replicas", 8)
    kw.setdefault("lr", 1e-6)
    return AdaptiveController(SyncConfig(strategy="periodic"), **kw)


class TestControllerLadderMode:
    def test_moves_only_onto_rungs(self):
        c = _ctrl(h0=1, adapt_every=1, ladder=(1, 2, 4, 8, 16, 32, 64))
        c.telemetry._skip_step = c.telemetry._skip_sync = 0
        c.observe_block(step_s=1e-3, sync_s=0.9e-3)
        assert c.h in (2, 4, 8, 16, 32, 64)

    def test_h0_snaps_into_ladder(self):
        assert _ctrl(h0=24, ladder=(1, 2, 4, 8, 16, 32)).h == 32

    def test_rung_hysteresis_holds_adjacent_moves(self):
        c = _ctrl(h0=8, adapt_every=1, ladder=(1, 2, 4, 8, 16, 32),
                  rung_hysteresis=2)
        c.telemetry._skip_step = c.telemetry._skip_sync = 0
        c.observe_block(step_s=1e-3, sync_s=16 * 0.05 * 1e-3)
        assert c.h == 8
        c.observe_block(step_s=1e-3, sync_s=64 * 0.05 * 1e-3)
        assert c.h > 8

    def test_analytic_fallback_moves_from_block_times_alone(self):
        c = _ctrl(h0=8, adapt_every=1, ladder=(1, 2, 4, 8),
                  param_bytes_per_chip=10**4)
        c.telemetry._skip_block = 0
        c.observe_block(block_s=8 * 0.05)
        assert c.h == 1 and c.history[-1][1] == 1


class TestAdaptiveReport:
    """``adaptive_report`` prices the replica axis with ``build_trainer``'s
    ``or "pod"`` fallback and the sync bytes over ``cfg.mesh``'s devices, as
    the reference does."""

    def _report(self, mesh_cfg):
        cfg = TrainConfig(mesh=mesh_cfg,
                          sync=SyncConfig(strategy="sync_every_step",
                                          adaptive=True))
        tel = BlockTelemetry(warmup=0)
        for _ in range(3):
            tel.record_step_time(1e-3)
            tel.record_sync_time(2e-3)
        return ttrain.adaptive_report(cfg, tel)

    @pytest.mark.parametrize("axis", ["", None, "pod"])
    def test_replica_axis_fallback(self, axis):
        mesh_cfg = dataclasses.replace(
            MeshConfig(shape=(1, 1), axis_names=("data", "model")),
            replica_axis=axis)
        rep = self._report(mesh_cfg)
        assert rep["recommended_h"] == self._report(MeshConfig(
            shape=(1, 1), axis_names=("data", "model"),
            replica_axis="pod"))["recommended_h"]
        assert rep["recommended_h"] is not None

    def test_matches_reference(self):
        from repro.config import MeshConfig as JMeshConfig
        from repro.core.telemetry import BlockTelemetry as JTelemetry
        from repro.launch.mesh import make_test_mesh
        from repro.launch.train import adaptive_report
        got = self._report(MeshConfig(shape=(1, 1),
                                      axis_names=("data", "model")))
        tel = JTelemetry(warmup=0)
        for _ in range(3):
            tel.record_step_time(1e-3)
            tel.record_sync_time(2e-3)
        mesh = make_test_mesh((1, 1))
        with jax.set_mesh(mesh):
            want = adaptive_report(JTrainConfig(
                mesh=JMeshConfig(shape=(1, 1), axis_names=("data", "model")),
                sync=JSyncConfig(strategy="sync_every_step", adaptive=True)),
                mesh, tel)
        assert got == want


# ---------------------------------------------------------------------------
# the switch transform, every sync mode
# ---------------------------------------------------------------------------

from test_torch_sync import MODES as SYNC_MODES  # noqa: E402
from test_torch_sync import SHAPES  # noqa: E402


def _sync_state(mode):
    """A live stacked (params, sync) of ``SHAPES``: replicas apart, every
    buffer nonzero, the counters at 3."""
    mode = dict(mode)
    k = mode.pop("k", K)
    rng = np.random.default_rng(len(json.dumps(mode, sort_keys=True)) + k)
    cfg = dict(strategy="periodic", chunks=3, **mode)

    def arrays(shapes):
        if isinstance(shapes, dict):
            return {n: arrays(s) for n, s in shapes.items()}
        return rng.normal(size=(k,) + shapes).astype(np.float32)

    params = arrays(SHAPES)
    sync = JS.init_sync_state(JSyncConfig(**cfg), jax.tree.map(
        lambda a: jnp.asarray(a[0]), params))
    sync = jax.tree.map(
        lambda x: np.full((k,), 3, np.int32) if x.dtype == jnp.int32
        else rng.normal(size=(k,) + x.shape).astype(np.float32), sync)
    return cfg, params, sync


@pytest.mark.parametrize("i", range(len(SYNC_MODES)),
                         ids=[json.dumps(m, sort_keys=True)
                              for m in SYNC_MODES])
def test_ladder_switch_state_matches_reference(i):
    cfg, params, sync = _sync_state(SYNC_MODES[i])
    want = JLS.ladder_switch_state(
        {"params": jax.tree.map(jnp.asarray, params),
         "sync": jax.tree.map(jnp.asarray, sync), "step": jnp.int32(6)},
        JTrainConfig(sync=JSyncConfig(**cfg)))
    to_t = lambda tree: T.map(lambda a: torch.from_numpy(np.array(a)), tree)
    state = {"params": to_t(params), "sync": to_t(sync), "step": 6}
    before = T.map(torch.clone, {"params": state["params"],
                                 "sync": state["sync"]})
    got = LS.ladder_switch_state(state, TrainConfig(
        sync=SyncConfig(**cfg)))
    for part in ("params", "sync"):        # the input is left as it was
        for a, b in zip(T.leaves(state[part]), T.leaves(before[part])):
            assert torch.equal(a, b)
    assert got["step"] == 6
    for part in ("params", "sync"):
        got_f = _flat(T.map(_np, got[part]))
        want_f = _flat(jax.tree.map(np.asarray, want[part]))
        assert sorted(got_f) == sorted(want_f)
        for key, w in want_f.items():
            if w.dtype == np.int32:
                np.testing.assert_array_equal(got_f[key], w, err_msg=key)
            else:
                np.testing.assert_allclose(got_f[key], w, rtol=1e-6,
                                           atol=1e-7, err_msg=part + key)
    for leaf in T.leaves(got["params"]):
        assert torch.equal(leaf, leaf[:1].expand(leaf.shape)) or (
            cfg.get("overlap", "none") == "none"
            and cfg.get("topology", "all") == "all")
    fresh = S.init_sync_state(SyncConfig(**cfg), T.map(
        lambda p: p[0], got["params"]))
    for key, value in got["sync"].items():
        if key in ("slowmo_m",):           # optimizer-like, carried
            continue
        for a, b in zip(T.leaves(value), T.leaves(fresh[key])):
            assert torch.equal(a, b.expand(a.shape)), key


# ---------------------------------------------------------------------------
# the trainer's ladder against the reference's jitted step
# ---------------------------------------------------------------------------

def _train_cfg():
    return TrainConfig(
        model=dataclasses.replace(get_smoke("smollm-360m"), dtype="float32",
                                  ce_chunk=8),
        mesh=MeshConfig(shape=(K, 1, 1), axis_names=("pod", "data", "model"),
                        replica_axis="pod"),
        sync=SyncConfig(strategy="periodic", period=2, compression="int8",
                        adaptive=True, adapt_ladder=(2, 4)),
        optimizer=OptimizerConfig(**OPT), data=DataConfig(**DATA))


def _tol(ef, part, key, want):
    """tests/test_torch_train.py's int8 bounds."""
    if part == "opt":
        return dict(rtol=1e-4, atol=max(1e-5, 1e-3 * float(
            np.abs(want).max())))
    leaf = key if part == "params" else "/" + key.split("/", 2)[-1]
    step = 2 * float(np.abs(ef[leaf]).max()) if leaf in ef else 0.0
    return dict(rtol=1e-4, atol=max(1e-5, step))


def _check_state(got, want, ef):
    for part in ("params", "opt", "sync"):
        got_f, want_f = _flat(T.map(_np, got[part])), _flat(want[part])
        assert sorted(got_f) == sorted(want_f), part
        for key in want_f:
            np.testing.assert_allclose(
                got_f[key], np.asarray(want_f[key], np.float32),
                err_msg=part + key, **_tol(ef, part, key, want_f[key]))


def test_trainer_ladder_matches_reference(reference):
    """3 blocks at H = 2, the switch, 2 blocks at H = 4 through the rungs
    of ``build_trainer``'s ladder, from the reference's initial state and
    on its batches: losses, the state before and after the switch and the
    final state to the trainer's bounds; no kernel built or loaded after
    the warmup; a rung refuses another H's block."""
    cfg = _train_cfg()
    step, _, _, _, telemetry, ladder = ttrain.build_trainer(cfg, "cpu")
    assert isinstance(ladder, LadderRuntime) and sorted(ladder.rungs) == [2, 4]
    assert isinstance(telemetry, BlockTelemetry)
    assert ladder.telemetry is telemetry and ladder.h == 2
    state = interop.lm_train_state_from_jax(
        {"opt": {}, "sync": {}, **_subtree(reference, "init")}, cfg)
    batches = [{k: torch.from_numpy(v) for k, v in
                _subtree(reference, f"batch/{b}").items()} for b in range(5)]
    for b, batch in enumerate(batches):
        if b == 3:
            _check_state(state, _subtree(reference, "pre"),
                         _flat(_subtree(reference, "pre")["sync"]["ef"]))
            state = ladder.switch_fn(state)
            want = _subtree(reference, "switched")
            _check_state(state, want, _flat(want["sync"]["ef"]))
            for leaf in T.leaves(state["sync"]["ef"]):
                assert not leaf.any()
        state, metrics = ladder.rungs[2 if b < 3 else 4](state, batch)
        np.testing.assert_allclose(
            float(metrics["loss"]),
            float(_subtree(reference, f"metrics/{b}")["loss"]), rtol=1e-4)
    want = _subtree(reference, "final")
    assert state["step"] == int(want["step"]) == 3 * 2 + 2 * 4
    _check_state(state, want, _flat(want["sync"]["ef"]))
    assert ladder.compile_counter.since_mark == 0
    assert telemetry.n_blocks == 4 and telemetry.n_syncs == 4
    with pytest.raises(ValueError, match="rung H=2"):
        ladder.rungs[2](state, batches[3])


def test_switch_then_rung_equals_fresh_step():
    """On the port alone, bitwise: the switch is ``ladder_switch_state``,
    and the next block under the new rung is a fresh ``make_train_step``
    from the switched state on the same batch."""
    cfg = _train_cfg()
    _, state, make_pipeline, model, _, ladder = ttrain.build_trainer(cfg,
                                                                     "cpu")
    pipe = make_pipeline(0)
    state, _ = ladder.step_fn(state, next(pipe))
    snap = T.map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
                 state)
    switched = ladder.switch_fn(state)
    want = LS.ladder_switch_state(snap, cfg)
    for a, b in zip(T.leaves(switched), T.leaves(want)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    for a, b in zip(T.leaves(state), T.leaves(snap)):   # left as it was
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    kept = T.map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
                 switched)
    batch = next(DataPipeline_blocked(cfg, 4, start=2))
    got, _ = ladder.rungs[4](switched, batch)
    fresh, _ = LS.make_train_step(model, cfg)(kept, batch)
    for a, b in zip(T.leaves(got), T.leaves(fresh)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def DataPipeline_blocked(cfg, h, start):
    return ttrain._Blocked(DataPipeline(cfg.data, cfg.model,
                                        start_step=start), h)


def test_compile_counter_hears_builds_and_loads(monkeypatch):
    """The counter hears every ``nvcc.build`` and ``nvcc.load`` call made
    after it was made; the warmup's loads fall before ``mark()``; a rung
    raises on a block of another H."""
    counter = CompileCounter()
    monkeypatch.setattr(nvcc, "nvcc_path", lambda: (_ for _ in ()).throw(
        RuntimeError("no nvcc here")))
    monkeypatch.setattr(nvcc, "BUILD_DIR",
                        nvcc.BUILD_DIR.parent / "_no_such_build_dir")
    with pytest.raises(RuntimeError, match="no nvcc"):
        nvcc.load("quant", [nvcc.Path(__file__)])
    assert counter.count == 2          # load, then the build it needs
    loads = []
    rungs = compile_rungs(lambda s, b: (s, {}),
                          {"tokens": np.zeros((2, 3), np.int32)}, (1, 4),
                          kernels=(lambda: loads.append(1)
                                   or nvcc._event(),))
    assert loads == [1] and counter.count == 3
    counter.mark()
    rungs[4]({}, {"tokens": torch.zeros(4, 2, 3)})
    with pytest.raises(ValueError, match="rung H=1"):
        rungs[1]({}, {"tokens": torch.zeros(4, 2, 3)})
    assert counter.since_mark == 0
    nvcc._event()
    assert counter.since_mark == 1 and counter.count == 4
    assert CompileCounter().count == 0


def test_ladder_warmup_loads_before_the_mark(monkeypatch):
    """``build_trainer`` loads the block's kernels (the quant kernel's on
    the card; stood in for here by a loader that counts a load) after its
    counter is made, and closes the window after them."""
    loads = []
    assert ttrain._block_kernels(_train_cfg(), torch.device("cpu"),
                                 "kernel") == ()

    def fake_kernels(cfg, dev, quant_impl):
        assert cfg.sync.compression == "int8" and quant_impl == "kernel"
        return (lambda: loads.append(1) or nvcc._event(),)

    monkeypatch.setattr(ttrain, "_block_kernels", fake_kernels)
    _, _, _, _, _, ladder = ttrain.build_trainer(_train_cfg(), "cpu")
    assert loads == [1]
    assert ladder.to_dict()["compiles_total"] == 1
    assert ladder.to_dict()["compiles_after_warmup"] == 0


def test_adaptive_cli_moves_h(capsys, tmp_path):
    """The CLI on the CPU, as the reference's adaptive smoke: H moves
    mid-run, the trajectory and per-rung telemetry are in the JSON line,
    and no kernel is built or loaded after the warmup. The drift cap
    (``adapt_max_drift`` 1e-3 at lr 1e-3) binds H to 1 whatever the
    measured times, so the move does not hang on this host's timing."""
    ttrain.main(["--arch", "smollm-360m", "--smoke", "--device", "cpu",
                 "--replicas", "4", "--steps", "10",
                 "--set", "sync.strategy=periodic", "--set", "sync.period=4",
                 "--set", "sync.adaptive=true", "--set", "sync.adapt_every=2",
                 "--set", "sync.adapt_ladder=1,2,4",
                 "--set", "sync.compression=int8",
                 "--set", "sync.adapt_max_drift=0.001",
                 "--set", "data.seq_len=32",
                 "--set", f"checkpoint.directory={tmp_path}"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ad = rec["adaptive"]
    assert rec["device"] == "cpu" and rec["steps"] == 10
    assert ad["ladder"] == [1, 2, 4]
    assert ad["switches"] >= 1, ad["h_trajectory"]
    assert ad["h_trajectory"][1] == [2, 1]
    assert ad["compiles_after_warmup"] == 0
    assert ad["h_trajectory"][0] == [0, 4]
    assert len(ad["h_trajectory"]) == ad["switches"] + 1
    assert all(h in ad["ladder"] for _, h in ad["h_trajectory"])
    assert ad["controller_history"][0] == [0, 4]
    assert ad["telemetry"]["per_rung"] and ad["telemetry"]["t_sync_s"] > 0


def test_cli_writes_checkpoints_only_where_named(capsys, tmp_path,
                                                monkeypatch):
    """Without ``checkpoint.directory`` the CLI creates no directory at
    all (the default one is shared by every run on the host); with it,
    every directory it creates lies under the one named."""
    made = []
    real = os.makedirs
    monkeypatch.setattr(os, "makedirs", lambda p, *a, **k: (
        made.append(os.path.abspath(p)), real(p, *a, **k))[1])
    args = ["--arch", "smollm-360m", "--smoke", "--device", "cpu",
            "--steps", "2", "--set", "data.seq_len=16",
            "--set", "checkpoint.interval_steps=1"]
    ttrain.main(args)
    assert made == []
    ckdir = tmp_path / "ck"
    ttrain.main(args + ["--set", f"checkpoint.directory={ckdir}"])
    assert made and all(p.startswith(str(ckdir)) for p in made), made
    assert sorted(os.listdir(ckdir)) == ["LATEST", "step_000000001",
                                         "step_000000002"]
    recs = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    assert [r["steps"] for r in recs] == [2, 2]


def test_adaptive_ddp_reports_recommendation(capsys):
    ttrain.main(["--arch", "smollm-360m", "--smoke", "--device", "cpu",
                 "--steps", "3", "--set", "sync.adaptive=true",
                 "--set", "data.seq_len=16"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["adaptive"]["recommended_h"] >= 1
    assert rec["adaptive"]["telemetry"]["n_blocks"] == 2


# ---------------------------------------------------------------------------
# a checkpoint taken mid-ladder (a scripted controller)
# ---------------------------------------------------------------------------

class Scripted:
    def __init__(self, h0, script):
        self.h = h0
        self.script = dict(script)
        self._blocks = 0
        self.history = [(0, h0)]

    def observe_block(self, **kw):
        self._blocks += 1
        if self._blocks in self.script:
            self.h = self.script[self._blocks]
            self.history.append((self._blocks, self.h))
        return self.h


def _scripted_runner(tmp_path, name, fault_cfg, script=None,
                     switch_fn=dict):
    data_cfg = DataConfig(seq_len=8, global_batch=2, seed=3)
    model_cfg = ModelConfig(vocab_size=97)

    def rung(state, batch):
        m = batch["tokens"].float().mean()
        return {"w": state["w"] * 0.9 + 0.1 * m}, {"loss": m}

    ladder = LadderRuntime({1: rung, 2: rung}, switch_fn=switch_fn,
                           controller=Scripted(2, script or {2: 1}),
                           device="cpu")

    def make_pipeline(start):
        return ttrain._Blocked(DataPipeline(data_cfg, model_cfg,
                                            start_step=start), ladder.h)

    ckpt = CheckpointManager(CheckpointConfig(
        directory=str(tmp_path / name), interval_steps=3))
    return StepRunner(None, ckpt, fault_cfg, ckpt_interval=3,
                      make_pipeline=make_pipeline, ladder=ladder), ladder


class TestMidLadderCheckpoint:
    @pytest.mark.parametrize("fail_at", [1, 4])
    def test_restore_rung_and_bitexact_replay(self, tmp_path, fail_at):
        """A fault after the step-3 checkpoint restores its rung; one
        before it, after the rung moved, goes back to the start rung. Both
        replays are bitwise the run without a fault."""
        ra, la = _scripted_runner(tmp_path, "a", FaultToleranceConfig())
        sa, _ = ra.run({"w": torch.ones(())}, 0, 6)
        rb, lb = _scripted_runner(tmp_path, "b", FaultToleranceConfig(
            inject_failure_at=fail_at + (fail_at == 1) * 2))
        sb, _ = rb.run({"w": torch.ones(())}, 0, 6)
        assert rb.restarts == 1
        assert la.h == lb.h == 1
        assert lb.trajectory[-1][1] == 1
        assert sa["w"].numpy().tobytes() == sb["w"].numpy().tobytes()
        replayed = {m["step"]: m["loss"] for m in rb.metrics_log}
        assert [m["loss"] for m in ra.metrics_log] == \
            [replayed[s] for s in range(6)]

    @pytest.mark.parametrize("script,fail_at",
                             [({3: 1}, 4), ({3: 1}, 5), ({2: 1, 3: 2}, 5)],
                             ids=["move-at-3-fault-4", "move-at-3-fault-5",
                                  "moves-at-2-3-fault-5"])
    def test_move_on_a_checkpoint_step_is_in_it(self, tmp_path, script,
                                                fail_at):
        """A controller move that falls on the step-3 checkpoint is taken
        before the checkpoint: it holds the switched state (the switch
        halves w here), the new rung and the block count, so a fault after
        it replays bitwise the run without one, on the same rungs."""
        def halve(s):
            return {"w": s["w"] * 0.5}

        ra, la = _scripted_runner(tmp_path, "a", FaultToleranceConfig(),
                                  script, halve)
        sa, _ = ra.run({"w": torch.ones(())}, 0, 6)
        _, extra = ra.ckpt.restore({"w": torch.zeros(())}, step=3)
        assert extra["ladder"] == {"h": script[3], "blocks": 3}
        rb, lb = _scripted_runner(tmp_path, "b", FaultToleranceConfig(
            inject_failure_at=fail_at), script, halve)
        sb, _ = rb.run({"w": torch.ones(())}, 0, 6)
        assert rb.restarts == 1 and la.h == lb.h
        assert sa["w"].numpy().tobytes() == sb["w"].numpy().tobytes()
        replayed = {m["step"]: m["loss"] for m in rb.metrics_log}
        assert [m["loss"] for m in ra.metrics_log] == \
            [replayed[s] for s in range(6)]

    def test_checkpoint_extra_records_rung(self, tmp_path):
        runner, _ = _scripted_runner(tmp_path, "c", FaultToleranceConfig())
        runner.run({"w": torch.ones(())}, 0, 6)
        _, extra = runner.ckpt.restore({"w": torch.zeros(())})
        # taken after the ladder has seen the 6th block
        assert extra["ladder"] == {"h": 1, "blocks": 6}

    def test_restore_rejects_uncompiled_rung(self):
        lad = LadderRuntime({1: lambda s, b: (s, {})}, switch_fn=lambda s: s,
                            controller=Scripted(1, {}))
        with pytest.raises(ValueError, match="not in compiled ladder"):
            lad.restore({"h": 16})
        with pytest.raises(ValueError, match="start rung"):
            LadderRuntime({2: None}, lambda s: s, Scripted(1, {}))


# ---------------------------------------------------------------------------
# the SVM steppers and the block ladder
# ---------------------------------------------------------------------------

def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("grad_impl", ["kernel", "torch"])
@pytest.mark.parametrize("i", range(len(SVM_CASES)),
                         ids=[json.dumps(c, sort_keys=True)
                              for c in SVM_CASES])
def test_svm_ladder_matches_reference_stepper(reference, i, grad_impl):
    """3 blocks of 2 points on the bs=2 rung, ``dms_ladder_switch``, 2 blocks
    of 4 on the bs=4 rung: every carry against the reference's jitted
    stepper; the switch bitwise a fresh ``dms_stepper_init`` at the worker
    mean; a rung refuses another block size."""
    kw = SVM_CASES[i]
    ladder = svm.dms_block_ladder(d=SVM_D, workers=K, block_sizes=(2, 4),
                                  grad_impl=grad_impl, device="cpu", **kw)
    carry = svm.dms_stepper_init(_t(reference["svm/w0"]), K, **kw)
    for b in range(5):
        if b == 3:
            _check_carry(carry, _subtree(reference, f"svm/{i}/pre"))
            pre = carry
            carry = svm.dms_ladder_switch(carry, d=SVM_D, **kw)
            _check_carry(carry, _subtree(reference, f"svm/{i}/switched"))
            wk = pre["w"].float() + (pre["pending"] if "pending" in pre
                                     else 0)
            fresh = svm.dms_stepper_init(wk.mean(dim=0)[:SVM_D], K, **kw)
            assert sorted(fresh) == sorted(carry)
            for key in fresh:
                assert torch.equal(carry[key], fresh[key]), key
        x, y = (_t(reference[f"svm/{i}/{n}/{b}"]) for n in ("x", "y"))
        carry = ladder[2 if b < 3 else 4](carry, x, y,
                                          torch.tensor(0.5 if b < 3
                                                       else 0.25))
    _check_carry(carry, _subtree(reference, f"svm/{i}/final"))
    with pytest.raises(ValueError, match="rung bs=2"):
        ladder[2](carry, x, y, torch.tensor(0.25))


def _check_carry(got, want):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if key == "cnt":
            assert g.dtype == torch.int32 and g.dim() == 0
            assert int(g) == int(w)
        else:
            np.testing.assert_allclose(_np(g), w, rtol=0, atol=MODEL_ATOL,
                                       err_msg=key)


@pytest.mark.parametrize("i", [i for i, c in enumerate(SVM_CASES)
                               if c["overlap"] == "none"
                               or c["topology"] == "all"])
def test_svm_timed_steps_match_reference(reference, i):
    kw = SVM_CASES[i]
    compute, sync = svm.dms_timed_steps(block_size=2,
                                        telemetry=BlockTelemetry(), **kw)
    x, y, wl = (_t(reference[f"timed/{i}/{n}"]) for n in ("x", "y", "w"))
    shared = kw["overlap"] == "none" and kw["topology"] == "all"
    w_end = compute(wl[0] if shared else wl, x, y, torch.tensor(0.5))
    np.testing.assert_allclose(_np(w_end), reference[f"timed/{i}/compute"],
                               rtol=1e-5, atol=1e-6)
    w_end = _t(reference[f"timed/{i}/compute"])
    cnt = torch.tensor(3, dtype=torch.int32)
    if kw.get("gossip_async"):
        sent, mixbuf = svm.dms_async_buffers_init(wl, kw["topology"])
        res = sync(w_end, sent + 0.1, mixbuf, cnt)
    elif kw["topology"] != "all":
        res = sync(w_end, cnt)
    elif kw["overlap"] == "none":
        res = sync(w_end)
    elif kw["overlap"] == "delayed":
        res = sync(wl, w_end, 0.01 * wl)
    else:
        res = sync(w_end, cnt)
    res = res if isinstance(res, tuple) else (res,)
    for j, r in enumerate(res):
        np.testing.assert_allclose(_np(r), reference[f"timed/{i}/sync/{j}"],
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kw", [dict(), dict(overlap="delayed"),
                                dict(overlap="chunked"),
                                dict(topology="ring"),
                                dict(topology="pairwise"),
                                dict(topology="ring", gossip_async=True)],
                         ids=str)
def test_svm_ladder_without_switch_equals_dms(kw):
    """The stepper chained over 2 epochs at one block size is ``dms``
    (``backend="vmap"``) on the same data, bitwise: ``dms`` is that loop,
    then the flush (row 0 of the blocking mean's K equal rows, else the
    worker mean). Async gossip alone keeps the reference's own loop
    (the mixing matrix as a product): rtol 1e-6 there."""
    from repro_torch.data import make_svm_dataset
    ds = make_svm_dataset("ijcnn1", seed=0, n_override=1000)
    x, y = torch.from_numpy(ds.x_train), torch.from_numpy(ds.y_train)
    d, bs, epochs = x.shape[1], 16, 2
    w0 = torch.zeros(d)
    want = svm.dms(w0, x, y, workers=K, epochs=epochs, block_size=bs,
                   device="cpu", **kw)
    xs, ys = svm._shard_data(x, y, K)
    nb = xs.shape[1] // bs
    xb = xs[:, :nb * bs].reshape(K, nb, bs, d)
    yb = ys[:, :nb * bs].reshape(K, nb, bs)
    rung = svm.dms_block_ladder(d=d, workers=K, block_sizes=(bs,),
                                device="cpu", **kw)[bs]
    carry = svm.dms_stepper_init(w0, K, **kw)
    for t in range(epochs):
        for i in range(nb):
            carry = rung(carry, xb[:, i], yb[:, i], svm._alpha(t, w0.dtype))
    got = carry["w"].mean(dim=0)[:d] if kw else carry["w"][0]
    if kw.get("gossip_async"):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-7)
    else:
        if not kw:
            assert torch.equal(carry["w"], carry["w"][:1].expand(K, d))
        assert got.numpy().tobytes() == want.numpy().tobytes()
