"""The port's fault-tolerant runner across processes (``StepRunner(mesh=)``
with ``CheckpointManager(mesh=)``) on the smollm smoke config in f32, int8
sync with error feedback, on 4 gloo CPU ranks (bodies in
``tests/torch_dist_ranks.py``).

Each run drives 6 blocks through a ladder whose moves are scripted (2 → 1
after block 2, 1 → 2 after block 3, as ``chip_smoke.py``'s phase (c)), with
a checkpoint every 3 blocks: without a fault; with a fault on rank 1 only
before step 4 (after the first checkpoint) and before step 2 (before it,
after the first move); with rank 1 held up before the last step; and with a
fault and no restart allowed. Every replay is bitwise the run without a
fault on every rank, and that run is bitwise the one-process K = 4 run of
the same ladder.
"""
import dataclasses

import pytest
import torch

from repro_torch import tree as T
from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import (CheckpointConfig, DataConfig,
                                FaultToleranceConfig, MeshConfig,
                                OptimizerConfig, SyncConfig, TrainConfig,
                                config_fingerprint)
from repro_torch.configs import smollm_360m as tconfigs
from repro_torch.data import DataPipeline
from repro_torch.launch import mesh as M
from repro_torch.launch import train as ttrain
from repro_torch.runtime import LadderRuntime, StepRunner
from repro_torch.runtime.ft import SimulatedFault

import torch_dist_ranks as R

torch.set_num_threads(1)

STEPS, STRAGGLE_S = 6, 1.0
KINDS = ("none", "fault@4", "fault@2", "straggle", "exhausted")


def _cfg():
    return TrainConfig(
        model=dataclasses.replace(tconfigs.smoke(), dtype="float32",
                                  ce_chunk=8),
        mesh=MeshConfig(shape=(4,), axis_names=("pod",), replica_axis="pod"),
        sync=SyncConfig(strategy="periodic", period=2, compression="int8",
                        adaptive=True, adapt_ladder=(1, 2)),
        optimizer=OptimizerConfig(name="adamw", learning_rate=3e-3,
                                  schedule="cosine", total_steps=20,
                                  weight_decay=0.01),
        data=DataConfig(seq_len=16, global_batch=8))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dist_ft"))
    return M.spawn(R.fault_runs, 4, backend="gloo", device="cpu",
                   args=(_cfg(), KINDS, STEPS, root, STRAGGLE_S),
                   timeout_s=300)


@pytest.fixture(scope="module")
def one_process(tmp_path_factory):
    """The run without a fault on one process, K = 4 replicas a leading
    dim."""
    cfg = _cfg()
    step, state, _, _, tel, live = ttrain.build_trainer(cfg, "cpu")
    ladder = LadderRuntime(live.rungs, live.switch_fn,
                           R.Scripted(2, {2: 1, 3: 2}), telemetry=tel,
                           device="cpu")

    def blocked(start):
        return ttrain._Blocked(DataPipeline(cfg.data, cfg.model,
                                            start_step=start), ladder.h)

    ckpt = CheckpointManager(CheckpointConfig(
        directory=str(tmp_path_factory.mktemp("ft_one")), interval_steps=3))
    runner = StepRunner(step, ckpt, FaultToleranceConfig(), 3, blocked,
                        fingerprint=config_fingerprint(cfg), ladder=ladder)
    state, end = runner.run(state, 0, STEPS)
    return dict(final=T.map(lambda t: t.numpy(),
                            {k: state[k] for k in ("params", "opt",
                                                   "sync")}),
                end=end, trajectory=ladder.trajectory,
                losses=[(m["step"], m["loss"]) for m in runner.metrics_log])


def _same(got, want):
    a, b = T.leaves(got), T.leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.tobytes() == y.tobytes()


def test_run_across_ranks_is_the_one_process_run(ranks, one_process):
    for out in ranks:
        got = out["none"]
        assert got["end"] == one_process["end"] == STEPS
        assert got["restarts"] == 0
        assert got["trajectory"] == one_process["trajectory"] == \
            [(0, 2), (2, 1), (3, 2)]
        assert got["losses"] == one_process["losses"]
        _same(got["final"], one_process["final"])


@pytest.mark.parametrize("kind", ["fault@4", "fault@2"])
def test_fault_on_one_rank_restarts_every_rank(ranks, kind):
    """A fault on rank 1 after the step-3 checkpoint (rank 0's file,
    restored on every rank) and one before it (each rank back to its own
    copy of its start state and the start rung): every rank restarts once
    and replays bitwise the run without a fault."""
    for out in ranks:
        got = out[kind]
        assert got["end"] == STEPS and got["restarts"] == 1
        assert got["trajectory"][-1] == (3, 2)
        _same(got["final"], out["none"]["final"])
        replayed = dict(got["losses"])      # the last loss of each step
        assert [replayed[s] for s in range(STEPS)] == \
            [loss for _, loss in out["none"]["losses"]]
        assert len(got["losses"]) > STEPS


def test_only_rank_0_writes_checkpoints(ranks):
    for kind in ("none", "fault@4", "fault@2"):
        assert ranks[0][kind]["writes"] == [3, 6], kind
        assert all(out[kind]["writes"] == [] for out in ranks[1:]), kind


def test_straggle_on_one_rank_is_every_rank_s(ranks):
    """Rank 1 is held up before the last step, outside its own step
    clock: the others wait for it in the step's agreement, and every rank
    records the same straggler events, the last step among them."""
    events = ranks[0]["straggle"]["events"]
    assert all(out["straggle"]["events"] == events for out in ranks)
    last = [e for e in events if e["step"] == STEPS - 1]
    assert last and last[0]["elapsed"] >= STRAGGLE_S / 2
    assert all(out["straggle"]["restarts"] == 0 for out in ranks)
    _same(ranks[1]["straggle"]["final"], ranks[1]["none"]["final"])


def test_exhausted_restarts_raise_on_every_rank(ranks):
    """With no restart allowed a fault on rank 1 raises on every rank
    (the others' fault names the other rank) and no rank hangs."""
    raised = [out["exhausted"]["raised"] for out in ranks]
    assert raised[1] == "injected fault at step 1"
    assert all(r == "a fault on another rank before step 1"
               for i, r in enumerate(raised) if i != 1)
    assert all(out["exhausted"]["restarts"] == 1 for out in ranks)


def test_ddp_state_restores_from_rank_0_on_every_rank(ranks):
    """Data parallelism's state is the same on every rank: rank 0 writes
    it as it is (``CheckpointManager(mesh=, axis=None)``), and a fault on
    rank 1 after the step-2 checkpoint replays bitwise on every rank."""
    for out in ranks:
        none, fault = out["ddp"][-1], out["ddp"][3]
        assert none["end"] == fault["end"] == 4
        assert (none["restarts"], fault["restarts"]) == (0, 1)
        assert none["files"] == fault["files"] == [2, 4]
        _same(fault["params"], none["params"])
        _same(none["params"], ranks[0]["ddp"][-1]["params"])


def test_a_fault_inside_the_step_is_not_agreed():
    """``StepRunner``'s docstring: with a mesh a ``SimulatedFault`` raised
    inside ``step_fn`` propagates (the other ranks are in the step's
    collectives); on one process it restores."""
    with pytest.raises(SimulatedFault, match="inside the step"):
        M.spawn(R.fault_inside_the_step, 1, backend="gloo", device="cpu",
                args=(True,), timeout_s=120)
    assert R.fault_inside_the_step(False) == (1, 3.0)
