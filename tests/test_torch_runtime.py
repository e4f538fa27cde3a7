"""The port's fault-tolerant runner (``repro_torch.runtime.ft``) on the CPU:
``tests/test_runtime.py``'s cases — a replay after an injected fault
bitwise equal to the run without one, with the fault after a checkpoint
and before the first; exhausted restarts raise; stragglers recorded — with
the toy step held against the reference's runner on the same batches; a
restart before the run's first checkpoint that never reads a checkpoint
another run left; the runner taking its start state over; the runner
without a checkpoint manager; the trainer's
in-place step replayed from the runner's own copy of its start state; and
the local-SGD block's contract with its input state: it takes the state's
optimizer moments over and leaves its params and sync state as they were,
so two calls, each from its own copy of one state, agree bitwise.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.config import (CheckpointConfig as JCheckpointConfig,
                          DataConfig as JDataConfig,
                          FaultToleranceConfig as JFaultToleranceConfig,
                          ModelConfig as JModelConfig)
from repro.data.pipeline import DataPipeline as JPipeline
from repro.runtime import StepRunner as JRunner
from repro_torch import tree as T
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import (CheckpointConfig, DataConfig,
                                FaultToleranceConfig, MeshConfig, ModelConfig,
                                OptimizerConfig, SyncConfig, TrainConfig,
                                get_smoke)
from repro_torch.core import local_sgd as LS
from repro_torch.data.pipeline import DataPipeline
from repro_torch.launch import train as ttrain
from repro_torch.models.registry import build_model
from repro_torch.runtime import StepRunner
from repro_torch.runtime.ft import SimulatedFault

torch.set_num_threads(1)

DATA = dict(seq_len=8, global_batch=2, seed=3)


def _toy_step(state, batch):
    """state = {'w': scalar, 'sum': running sum of batch means}."""
    m = batch["tokens"].float().mean()
    return {"w": state["w"] * 0.9 + 0.1 * m, "sum": state["sum"] + m}, \
        {"loss": m}


def _jtoy_step(state, batch):
    m = jnp.mean(batch["tokens"].astype(jnp.float32))
    return {"w": state["w"] * 0.9 + 0.1 * m, "sum": state["sum"] + m}, \
        {"loss": m}


def _runner(tmp_path, name, fault=None, step=_toy_step, interval=5):
    ckpt = CheckpointManager(CheckpointConfig(directory=str(tmp_path / name)))
    return StepRunner(step, ckpt, fault or FaultToleranceConfig(),
                      ckpt_interval=interval,
                      make_pipeline=lambda start: DataPipeline(
                          DataConfig(**DATA), ModelConfig(vocab_size=97),
                          start_step=start))


def _state0():
    return {"w": torch.zeros(()), "sum": torch.zeros(())}


@pytest.mark.parametrize("fail_at", [3, 13])
def test_failure_replay_is_bitwise_identical(tmp_path, fail_at):
    """A fault at step 13 restores the step-10 checkpoint; one at step 3
    comes before the first checkpoint and restarts from the start state.
    Both replays are bitwise the run without a fault, and that run is
    bitwise the reference runner's on the same batches."""
    ra = _runner(tmp_path, "a")
    sa, end_a = ra.run(_state0(), 0, 20)
    rb = _runner(tmp_path, "b",
                 FaultToleranceConfig(inject_failure_at=fail_at))
    sb, end_b = rb.run(_state0(), 0, 20)
    assert rb.restarts == 1 and end_a == end_b == 20
    _equal(sa, sb)
    jr = JRunner(_jtoy_step, JManager(JCheckpointConfig(
        directory=str(tmp_path / "j"))), JFaultToleranceConfig(),
        ckpt_interval=5, make_pipeline=lambda start: JPipeline(
            JDataConfig(**DATA), JModelConfig(vocab_size=97),
            start_step=start))
    sj, _ = jr.run({"w": jnp.float32(0), "sum": jnp.float32(0)}, 0, 20)
    for key in ("w", "sum"):
        assert sa[key].numpy().tobytes() == np.asarray(sj[key]).tobytes()
    assert [m["loss"] for m in ra.metrics_log] == \
        [m["loss"] for m in jr.metrics_log]


def _equal(a, b):
    for x, y in zip(T.leaves(a), T.leaves(b)):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y


def test_exhausted_restarts_raise(tmp_path):
    def always_fail(state, batch):
        raise SimulatedFault("boom")

    r = _runner(tmp_path, "x", FaultToleranceConfig(max_restarts=2),
                step=always_fail)
    with pytest.raises(SimulatedFault):
        r.run(_state0(), 0, 10)
    assert r.restarts == 3


def test_no_retry_without_restarts(tmp_path):
    r = _runner(tmp_path, "y", FaultToleranceConfig(max_restarts=0,
                                                    inject_failure_at=2))
    with pytest.raises(SimulatedFault):
        r.run(_state0(), 0, 5)
    assert r.restarts == 1


def test_straggler_detection(tmp_path):
    r = _runner(tmp_path, "s", FaultToleranceConfig(step_deadline_sec=1e-9),
                interval=100)
    r.run(_state0(), 0, 3)
    assert len(r.watchdog.events) == 3   # every step "straggles"
    assert [e["step"] for e in r.watchdog.events] == [0, 1, 2]


# ---------------------------------------------------------------------------
# the local-SGD block and its input state
# ---------------------------------------------------------------------------

K, H = 2, 2


def _cfg(**sync):
    return TrainConfig(
        model=dataclasses.replace(get_smoke("smollm-360m"), dtype="float32"),
        mesh=MeshConfig(shape=(K,), axis_names=("pod",), replica_axis="pod"),
        sync=SyncConfig(strategy="periodic", period=H, **sync),
        optimizer=OptimizerConfig(name="adamw", learning_rate=3e-3,
                                  schedule="cosine", total_steps=20),
        data=DataConfig(seq_len=16, global_batch=2 * K))


def _block(cfg):
    pipe = DataPipeline(cfg.data, cfg.model)
    mbs = [pipe.next_host() for _ in range(H)]
    return {k: torch.from_numpy(np.stack([m[k] for m in mbs]))
            for k in mbs[0]}


def _copy(state):
    return T.map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
                 state)


@pytest.mark.parametrize("sync", [dict(compression="int8"),
                                  dict(overlap="delayed", topology="ring")],
                         ids=["int8", "delayed-ring"])
def test_block_leaves_its_input_alone(sync):
    """The block leaves the params and sync state it is given as they were
    and steps the given optimizer moments in place: the returned ``opt`` is
    the input's own tensors. Two calls, each from its own copy of one
    state, agree bitwise, as a replay from a kept copy needs."""
    cfg = _cfg(**sync)
    model = build_model(cfg.model, attn_impl="torch")
    state = LS.init_state(model, cfg, torch.Generator().manual_seed(1), K)
    before = _copy(state)
    batch = _block(cfg)
    step = LS.make_local_sgd_block(model, cfg)
    first, m1 = step(state, batch)
    _equal(state["params"], before["params"])
    _equal(state["sync"], before["sync"])
    assert all(a is b for a, b in zip(T.leaves(first["opt"]),
                                      T.leaves(state["opt"])))
    assert not torch.equal(T.leaves(state["opt"])[1],
                           T.leaves(before["opt"])[1])
    second, m2 = step(_copy(before), batch)
    _equal(first, second)
    assert float(m1["loss"]) == float(m2["loss"])


def test_restart_before_first_checkpoint_ignores_foreign_ones(tmp_path):
    """A checkpoint another run left in the directory (same fingerprint,
    a later step) is never restored by a restart that comes before this
    run's first checkpoint: the replay starts from this run's own start
    state and is bitwise the run without a fault."""
    ra = _runner(tmp_path, "a")
    sa, _ = ra.run(_state0(), 0, 20)
    other = _runner(tmp_path, "shared")
    other.run({"w": torch.full((), 7.0), "sum": torch.full((), 7.0)}, 0, 10)
    assert other.ckpt.latest_step() == 10
    rb = _runner(tmp_path, "shared", FaultToleranceConfig(inject_failure_at=3))
    sb, end = rb.run(_state0(), 0, 20)
    assert rb.restarts == 1 and end == 20
    _equal(sa, sb)
    assert [m["step"] for m in rb.metrics_log] == \
        [0, 1, 2] + list(range(20))
    assert [m["loss"] for m in rb.metrics_log[3:]] == \
        [m["loss"] for m in ra.metrics_log]


def test_runner_frees_the_start_state(tmp_path):
    """The runner takes the state over: the caller's dict is emptied and,
    once the first block has replaced them, no reference keeps the start
    state's tensors alive (a full-width state on one card cannot be held
    twice)."""
    import gc
    import weakref
    state = _state0()
    start = weakref.ref(state["w"])
    seen = []

    def step(s, batch):
        gc.collect()
        seen.append(start() is None)
        return _toy_step(s, batch)

    r = _runner(tmp_path, "g", FaultToleranceConfig(max_restarts=0),
                step=step)
    final, _ = r.run(state, 0, 3)
    assert state == {} and seen == [False, True, True]
    assert sorted(final) == ["sum", "w"]


def test_runner_without_checkpoint_manager(tmp_path):
    """``ckpt_manager=None``: nothing is saved, and a fault anywhere
    replays from the start state, bitwise the run without one."""
    ra = _runner(tmp_path, "a")
    sa, _ = ra.run(_state0(), 0, 20)
    rb = StepRunner(_toy_step, None,
                    FaultToleranceConfig(inject_failure_at=13),
                    ckpt_interval=5, make_pipeline=ra.make_pipeline)
    sb, end = rb.run(_state0(), 0, 20)
    assert rb.restarts == 1 and end == 20
    _equal(sa, sb)
    assert [m["step"] for m in rb.metrics_log] == \
        list(range(13)) + list(range(20))


def test_trainer_replays_from_its_start_state(tmp_path):
    """The trainer's step updates its input's moments in place, so a fault
    before the first checkpoint restarts from the runner's own host copy of
    the start state: bitwise the run without a fault. A fault after the
    checkpoint restores it, bitwise too."""
    cfg = _cfg(compression="int8")
    finals = []
    for fail_at in (-1, 1, 3):
        step, state, make_pipeline, _, _, _ = ttrain.build_trainer(cfg,
                                                                   "cpu")
        ckpt = CheckpointManager(CheckpointConfig(
            directory=str(tmp_path / f"f{fail_at}")))
        runner = StepRunner(step, ckpt, FaultToleranceConfig(
            inject_failure_at=fail_at), 2, make_pipeline)
        final, end = runner.run(state, 0, 4)
        assert end == 4 and runner.restarts == (fail_at >= 0)
        finals.append(final)
    for other in finals[1:]:
        _equal(finals[0], other)
