"""Rank bodies of the port's distributed CPU tests (``tests/test_torch_dist_*.py``).

Each function here runs on every rank of a world that
``repro_torch.launch.mesh.spawn`` starts (gloo, CPU ranks) and returns what
the test compares. The module imports torch, numpy and the port only, so a
spawned rank does not import JAX.
"""
import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.launch import mesh as M

# one smoke arch of each family of the registry
FAMILY_ARCHS = ("smollm-360m", "phi3.5-moe-42b-a6.6b", "mamba2-2.7b",
                "zamba2-1.2b", "paligemma-3b", "whisper-base")


def _mesh_of(k: int, axis: str):
    """A mesh whose ``axis`` has ``k`` ranks, the world split into
    ``world / k`` such groups along a leading axis ``"x"``."""
    world = torch.distributed.get_world_size()
    if k == world:
        return M.make_mesh((k,), (axis,))
    return M.make_mesh((world // k, k), ("x", axis))


def _np(tree):
    return T.map(lambda t: t.detach().cpu().numpy(), tree)


# ---------------------------------------------------------------------------
# SVM
# ---------------------------------------------------------------------------

def svm_modes(x, y, modes, epochs, block_size, ladder):
    """``dms(backend="dist")`` in every mode, the same runs through
    ``dms_timed_steps``' pair, and a block-size ladder with a switch."""
    from repro_torch.core import svm
    from repro_torch.core.telemetry import BlockTelemetry
    torch.set_num_threads(1)
    d = x.shape[1]
    out = {"dms": [], "timed": {}, "ladder": None, "raises": []}
    meshes = {}
    for mode in modes:
        k = mode["k"]
        mesh = meshes.setdefault(k, _mesh_of(k, "data"))
        kw = {key: v for key, v in mode.items() if key != "k"}
        w = svm.dms(torch.zeros(d), x, y, workers=k, epochs=epochs,
                    block_size=block_size, backend="dist", mesh=mesh,
                    grad_impl="kernel", **kw)
        out["dms"].append(w.numpy())

    # the timed pair, driven as the reference's timing benchmark drives it
    k = 8
    mesh = meshes[k]
    r = mesh.rank("data")
    xs, ys = svm._shard_data(x, y, k)
    xs, ys = torch.from_numpy(xs[r:r + 1]), torch.from_numpy(ys[r:r + 1])
    nb = xs.shape[1] // block_size
    for name, kw in (("none", {}), ("delayed", dict(overlap="delayed")),
                     ("chunked", dict(overlap="chunked", chunks=4)),
                     ("ring", dict(topology="ring")),
                     ("pairwise_async", dict(topology="pairwise",
                                             gossip_async=True))):
        tel = BlockTelemetry()
        compute, sync = svm.dms_timed_steps(mesh, "data",
                                            block_size=block_size,
                                            telemetry=tel, **kw)
        w = torch.zeros(d)
        wl = w[None]
        pending = torch.zeros(1, d)
        sent, mixbuf = svm.dms_async_buffers_init(wl, kw.get("topology",
                                                             "ring"))
        cnt = 0
        for t in range(epochs):
            alpha = svm._alpha(t, torch.float32)
            for i in range(nb):
                xb = xs[:, i * block_size:(i + 1) * block_size]
                yb = ys[:, i * block_size:(i + 1) * block_size]
                if name == "none":
                    w = sync(compute(w, xb, yb, alpha))
                elif name == "delayed":
                    end = compute(wl, xb, yb, alpha)
                    wl, pending = sync(wl, end, pending)
                elif name == "chunked":
                    wl = sync(compute(wl, xb, yb, alpha),
                              torch.tensor(cnt))
                elif name == "ring":
                    wl = sync(compute(wl, xb, yb, alpha), cnt)
                else:
                    wl, sent, mixbuf = sync(compute(wl, xb, yb, alpha),
                                            sent, mixbuf, cnt)
                cnt += 1
        sync.flush()
        if name == "none":
            model = w
        else:
            model = svm.dms_flush({"w": wl}, d=d, overlap="delayed",
                                  mesh=mesh, axis="data")
        est = tel.estimates()
        out["timed"][name] = (model.numpy(), tel.n_steps, tel.n_syncs,
                              est[0] > 0 and est[1] > 0,
                              list(_times(tel)))

    # the ladder: epochs[0] at the small block, a switch, the rest larger
    small, large = ladder
    rungs = svm.dms_block_ladder(d=d, workers=k, block_sizes=(small, large),
                                 overlap="delayed", device="cpu", mesh=mesh)
    carry = svm.dms_stepper_init(torch.zeros(d), 1, overlap="delayed")
    for t, bs in enumerate((small, large)):
        if t:
            carry = svm.dms_ladder_switch(carry, overlap="delayed",
                                          mesh=mesh)
        alpha = svm._alpha(t, torch.float32)
        for i in range(xs.shape[1] // bs):
            carry = rungs[bs](carry, xs[:, i * bs:(i + 1) * bs],
                              ys[:, i * bs:(i + 1) * bs], alpha)
    out["ladder"] = svm.dms_flush(carry, d=d, overlap="delayed", mesh=mesh,
                                  axis="data").numpy()

    for bad in (dict(workers=4), dict(workers=8, graphs=True)):
        try:
            svm.dms(torch.zeros(d), x, y, epochs=1, block_size=block_size,
                    backend="dist", mesh=mesh, **bad)
        except ValueError as exc:
            out["raises"].append(str(exc))
    return out


def _times(tel):
    est = tel.estimates()
    return est if est else (None, None)


# ---------------------------------------------------------------------------
# sync engine
# ---------------------------------------------------------------------------

def sync_modes(modes, inputs):
    """``sync_point`` across ranks at two boundaries a mode: each rank takes
    its replica's row of the reference's inputs (``inputs[i][b]`` the
    stacked start/end/sync trees of mode i, boundary b) and returns its
    outputs and, where the reference dumped it, its int8 payload."""
    from repro_torch.config import SyncConfig
    from repro_torch.core import compression as TC
    from repro_torch.core import sync as TS
    torch.set_num_threads(1)
    meshes, out = {}, []
    for mode, boundaries in zip(modes, inputs):
        mode = dict(mode)
        k = mode.pop("k", 4)
        mesh = meshes.setdefault(k, _mesh_of(k, "pod"))
        r = mesh.rank("pod")
        cfg = SyncConfig(strategy="periodic", chunks=3, **mode)
        got = []
        for start, end, state in boundaries:
            mine = [T.map(lambda a: torch.from_numpy(np.array(a[r:r + 1])),
                          tree) for tree in (start, end, state)]
            wire = None
            if "ef" in mine[2]:
                values = (T.map(lambda e, s: e - s, mine[1], mine[0])
                          if cfg.topology == "all" else mine[1])
                q, s, _ = TC.compress_tree(values, mine[2]["ef"], rows=True)
                wire = (_np(q), _np(s))
            # before the sync, which may write its params into mine[1]
            params, new_state = TS.sync_point(*mine, cfg, mesh=mesh,
                                              axis="pod")
            got.append((_np(params), _np(new_state), wire))
        out.append(got)
    return out


def flush_modes(modes, params, states):
    """``flush_overlap`` across 4 ranks, each on its replica's row."""
    from repro_torch.config import SyncConfig
    from repro_torch.core import sync as TS
    torch.set_num_threads(1)
    mesh = _mesh_of(4, "pod")
    r = mesh.rank("pod")

    def mine(tree):
        return T.map(lambda a: torch.from_numpy(np.array(a[r:r + 1])), tree)
    return [_np(TS.flush_overlap(mine(params), mine(state),
                                 SyncConfig(strategy="periodic", **mode),
                                 mesh=mesh, axis="pod"))
            for mode, state in zip(modes, states)]


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

def train_runs(runs, init_states, batches, model_cfg, opt, data, ckpt_dir):
    """Each of ``runs`` (tag, sync kwargs, replicated) on a (pod 2, data 2)
    mesh from the reference's initial state (``scatter_replicas``), each
    rank on its process slice of the reference's batches; then the
    replica scatter/gather round trip, and a checkpoint written by rank 0."""
    import dataclasses
    from repro_torch import interop
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import (CheckpointConfig, DataConfig, MeshConfig,
                                    OptimizerConfig, SyncConfig, TrainConfig)
    from repro_torch.core import local_sgd as LS
    from repro_torch.data import DataPipeline
    from repro_torch.models.registry import build_model
    torch.set_num_threads(1)
    mesh = M.make_mesh((2, 2), ("pod", "data"))
    mesh_cfg = MeshConfig(shape=(2, 2, 1), axis_names=("pod", "data", "model"),
                          replica_axis="pod")
    model = build_model(model_cfg, attn_impl="torch")
    pipe = DataPipeline(DataConfig(**data), model_cfg, mesh=mesh)
    out = {"slice": pipe.next_host(), "runs": {}}
    for tag, sync, replicated in runs:
        cfg = TrainConfig(model=model_cfg, mesh=mesh_cfg,
                          sync=SyncConfig(**sync),
                          optimizer=OptimizerConfig(**opt),
                          data=DataConfig(**data))
        init = {"opt": {}, "sync": {}, **init_states[tag]}
        if replicated:
            full = interop.lm_train_state_from_jax(init, cfg)
            state = LS.scatter_replicas(full, mesh)
            back = LS.gather_replicas(state, mesh)
            same = all(torch.equal(a, b) for a, b in zip(
                T.leaves({k: full[k] for k in ("params", "opt", "sync")}),
                T.leaves({k: back[k] for k in ("params", "opt", "sync")})))
            step = LS.make_local_sgd_block(model, cfg, mesh=mesh)
        else:
            cfg = dataclasses.replace(cfg, mesh=MeshConfig())
            state = interop.lm_train_state_from_jax(init, cfg)
            same = True
            step = LS.make_ddp_step(model, cfg, mesh=mesh)
        losses = []
        per = data["global_batch"] // mesh.size()
        lo = mesh.rank() * per
        for batch in batches[tag]:
            # this rank's rows: dim 1 of a (H, B, S) block, dim 0 of a batch
            axis = 1 if replicated else 0
            mine = {k: torch.from_numpy(np.ascontiguousarray(
                np.take(v, np.arange(lo, lo + per), axis=axis)))
                for k, v in batch.items()}
            state, metrics = step(state, mine)
            losses.append({k: float(v) for k, v in metrics.items()})
        final = (LS.gather_replicas(state, mesh) if replicated else state)
        out["runs"][tag] = {"losses": losses, "round_trip": same,
                            "final": _np({k: final[k] for k in
                                          ("params", "opt", "sync")}),
                            "step": final["step"]}
        if tag == "periodic":
            fin = LS.finalize_state(state, cfg, mesh)
            out["runs"][tag]["finalized"] = _np(
                LS.gather_replicas(fin, mesh)["params"])
            ckpt = CheckpointManager(CheckpointConfig(directory=ckpt_dir),
                                     mesh=mesh)
            ckpt.save(int(state["step"]), state, fingerprint="dist")
            back, _ = ckpt.restore(state)
            out["runs"][tag]["restored_own"] = (
                back["step"] == state["step"] and all(
                    torch.equal(a, b) for k in ("params", "opt", "sync")
                    for a, b in zip(T.leaves(back[k]), T.leaves(state[k]))))
    return out


def mismatched_mesh(model_cfg):
    """A one-rank mesh for a config of two replicas: the block raises."""
    from repro_torch.config import MeshConfig, SyncConfig, TrainConfig
    from repro_torch.core import local_sgd as LS
    from repro_torch.models.registry import build_model
    mesh = M.make_mesh((1,), ("pod",))
    cfg = TrainConfig(model=model_cfg,
                      mesh=MeshConfig(shape=(2,), axis_names=("pod",),
                                      replica_axis="pod"),
                      sync=SyncConfig(strategy="periodic", period=2))
    LS.make_local_sgd_block(build_model(model_cfg, attn_impl="torch"), cfg,
                            mesh=mesh)


def adaptive_on_a_mesh(model_cfg):
    """``sync.adaptive`` on a replica strategy with a mesh: on a mesh whose
    replica axis holds the config's replicas ``build_trainer`` returns a
    live ladder (its rungs, and its summary naming the ranks); on one that
    does not it raises (the error is returned)."""
    from repro_torch.config import MeshConfig, SyncConfig, TrainConfig
    from repro_torch.launch.train import build_trainer
    from repro_torch.runtime import LadderRuntime
    mesh = M.make_mesh((1,), ("pod",))
    out = {}
    for k in (1, 2):
        cfg = TrainConfig(model=model_cfg,
                          mesh=MeshConfig(shape=(k,), axis_names=("pod",),
                                          replica_axis="pod"),
                          sync=SyncConfig(strategy="periodic", period=2,
                                          adaptive=True, adapt_ladder=(1, 2)))
        try:
            ladder = build_trainer(cfg, mesh=mesh)[-1]
        except ValueError as exc:
            out[k] = str(exc)
            continue
        out[k] = (isinstance(ladder, LadderRuntime), sorted(ladder.rungs),
                  ladder.to_dict()["ranks"])
    return out


# ---------------------------------------------------------------------------
# the adaptive MSF path across ranks: the H ladder and the fault runner
# ---------------------------------------------------------------------------

class Scripted:
    """A controller whose moves are a script {block: H} (``per_rank``: a
    script of each rank's own)."""

    def __init__(self, h0, script):
        self.h = h0
        self.script = dict(script)
        self._blocks = 0
        self.history = [(0, h0)]

    def observe_block(self, **_kw):
        self._blocks += 1
        if self._blocks in self.script:
            self.h = self.script[self._blocks]
            self.history.append((self._blocks, self.h))
        return self.h


def _rows(tree, lo, per, axis):
    """Rows ``[lo, lo + per)`` of every leaf along ``axis``."""
    return {k: torch.from_numpy(np.ascontiguousarray(
        np.take(v, np.arange(lo, lo + per), axis=axis)))
        for k, v in tree.items()}


def drive_ladder(ladder, state, blocks, mesh=None, axis=None):
    """``blocks`` (H, B, …) dicts through the ladder's rungs, the switch
    where H changes: (state, losses, the state gathered before and after
    the switch). With a mesh each block is this rank's rows, and the
    states are gathered over ``axis``."""
    from repro_torch.core import local_sgd as LS

    def whole(s):
        # copies: a later block steps the moments of its input in place
        s = LS.gather_replicas(s, mesh, axis) if mesh is not None else s
        return T.map(np.copy, _np({k: s[k] for k in ("params", "opt",
                                                     "sync")}))

    losses, pre, switched = [], None, None
    for b, block in enumerate(blocks):
        h = next(iter(block.values())).shape[0]
        if h != ladder.h:
            pre = whole(state)
            state = ladder.switch_fn(state)
            switched = whole(state)
            ladder.controller.h = h
        state, metrics = ladder.rungs[h](state, block)
        losses.append(float(metrics["loss"]))
    return state, losses, pre, switched, whole


class _FakeClock:
    """``time`` for ``local_sgd.timed_step``: each block's first reading
    is the last one's end, its second that plus ``wall``."""

    def __init__(self):
        self.t, self.wall, self._open = 0.0, 0.0, False

    def perf_counter(self):
        if self._open:
            self.t += self.wall
        self._open = not self._open
        return self.t


def skewed_controllers(mesh, step_s, sync_s, blocks):
    """Each rank's block wall ``step_s[r]·H + sync_s[r]`` and sync
    ``sync_s[r]`` through ``timed_step`` into its telemetry and a ladder
    (1, 2, 4) controller of its own: the ranks' trajectories and the
    samples the telemetry recorded (the max over the ranks)."""
    from repro_torch.config import SyncConfig
    from repro_torch.core import local_sgd as LS
    from repro_torch.core.autotune import AdaptiveController
    from repro_torch.core.telemetry import BlockTelemetry
    from repro_torch.runtime import LadderRuntime
    r = mesh.rank()
    clock, real = _FakeClock(), LS.time
    tel = BlockTelemetry()
    cfg = SyncConfig(strategy="periodic", period=2, adaptive=True,
                     adapt_ladder=(1, 2, 4), adapt_every=2)
    ctrl = AdaptiveController(cfg, param_bytes_per_chip=1 << 20, replicas=4,
                              telemetry=tel, ladder=(1, 2, 4))

    class _Sync:
        def take(self):
            return sync_s[r]

    def step(state, batch):
        clock.wall = step_s[r] * batch["tokens"].shape[0] + sync_s[r]
        return state, {}

    timed = LS.timed_step(step, None, tel, sync_clock=_Sync(), mesh=mesh)
    ladder = LadderRuntime({h: timed for h in (1, 2, 4)}, lambda s: s, ctrl,
                           telemetry=tel, mesh=mesh)
    samples = []
    record = tel.record_block
    tel.record_block = lambda h, w, s=None: (samples.append((h, w, s)),
                                             record(h, w, s))[1]
    LS.time = clock
    try:
        state = {"params": torch.zeros(1)}
        for _ in range(blocks):
            state, _ = ladder.step_fn(state, {"tokens":
                                              torch.zeros(ladder.h, 1)})
            state, _ = ladder.on_block(state)
    finally:
        LS.time = real
    return {"trajectory": ladder.trajectory, "samples": samples}


def disagreeing_controllers(mesh):
    """Rank 0's controller moves to H = 1 after the first block, the
    others' stay at 2: every rank raises at that block's agreement."""
    from repro_torch.core.collectives import Disagreement
    from repro_torch.runtime import LadderRuntime
    script = {1: 1} if mesh.rank() == 0 else {}
    ladder = LadderRuntime({1: None, 2: None}, lambda s: s,
                           Scripted(2, script), mesh=mesh)
    try:
        ladder.on_block({})
    except Disagreement as exc:
        return str(exc)
    return None


def ladder_runs(init, blocks, model_cfg, opt, data, cli_argv):
    """On 4 ranks: (1) ``build_trainer``'s ladder on a 4-rank ``data``
    replica axis from the reference's initial state, 3 blocks at H = 2,
    the switch, 2 at H = 4 (each rank its rows of the reference's
    blocks); (2) the same on a (pod 2, data 2) mesh under
    ``hierarchical`` from the seeded state; (3) skewed per-rank timings
    through each rank's controller; (4) controllers that disagree; (5) the
    CLI, whose end leaves the world."""
    import contextlib
    import io
    from repro_torch import interop
    from repro_torch.config import (DataConfig, MeshConfig, OptimizerConfig,
                                    SyncConfig, TrainConfig)
    from repro_torch.core import local_sgd as LS
    from repro_torch.launch import train as ttrain
    torch.set_num_threads(1)
    out = {}
    mesh = M.make_mesh((4,), ("data",))
    r = mesh.rank()
    sync = SyncConfig(strategy="periodic", period=2, compression="int8",
                      adaptive=True, adapt_ladder=(2, 4))
    cfg = TrainConfig(model=model_cfg,
                      mesh=MeshConfig(shape=(4, 1), axis_names=("data",
                                                                "model"),
                                      replica_axis="data"),
                      sync=sync, optimizer=OptimizerConfig(**opt),
                      data=DataConfig(**data))
    _, _, _, _, _, ladder = ttrain.build_trainer(cfg, "cpu", mesh)
    state = LS.scatter_replicas(interop.lm_train_state_from_jax(
        {"opt": {}, "sync": {}, **init}, cfg), mesh, "data")
    per = data["global_batch"] // 4
    mine = [_rows(b, r * per, per, 1) for b in blocks]
    state, losses, pre, switched, whole = drive_ladder(ladder, state, mine,
                                                       mesh, "data")
    try:
        ladder.rungs[2](state, mine[-1])
        refused = False
    except ValueError:
        refused = True
    out["ladder"] = dict(losses=losses, pre=pre, switched=switched,
                         final=whole(state), step=state["step"],
                         summary=ladder.to_dict(), refused=refused)

    mesh22 = M.make_mesh((2, 2), ("pod", "data"))
    hcfg = TrainConfig(model=model_cfg,
                       mesh=MeshConfig(shape=(2, 2), axis_names=("pod",
                                                                 "data"),
                                       replica_axis="pod"),
                       sync=SyncConfig(strategy="hierarchical", period=2,
                                       compression="int8", adaptive=True,
                                       adapt_ladder=(2, 4)),
                       optimizer=OptimizerConfig(**opt),
                       data=DataConfig(**data))
    _, state, _, _, _, hladder = ttrain.build_trainer(hcfg, "cpu", mesh22)
    mine = [_rows(b, r * per, per, 1) for b in blocks]
    state, losses, _, _, whole = drive_ladder(hladder, state, mine, mesh22,
                                              "pod")
    out["hierarchical"] = dict(losses=losses, final=whole(state),
                               summary=hladder.to_dict())

    out["skewed"] = skewed_controllers(
        mesh, step_s=[0.01, 0.01, 0.01, 0.01],
        sync_s=[0.001, 0.001, 0.001, 2.0], blocks=4)
    out["disagree"] = disagreeing_controllers(mesh)

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ttrain.main(cli_argv)
    out["cli"] = buf.getvalue()
    return out


def _fault_cfg(kind, r, steps, straggle_s):
    """Each rank's fault config for a run: the fault or straggle on rank 1
    only."""
    from repro_torch.config import FaultToleranceConfig
    if kind == "exhausted":
        return FaultToleranceConfig(max_restarts=0,
                                    inject_failure_at=1 if r == 1 else -1)
    if kind == "straggle":
        return FaultToleranceConfig(
            step_deadline_sec=straggle_s / 2,
            inject_straggle_sec=straggle_s if r == 1 else 0.0,
            inject_failure_at=steps if r == 1 else -1)
    fail_at = int(kind[len("fault@"):]) if kind.startswith("fault@") else -1
    return FaultToleranceConfig(inject_failure_at=fail_at if r == 1 else -1)


def fault_runs(cfg, kinds, steps, ckpt_root, straggle_s):
    """``StepRunner`` over a scripted ladder (2 → 1 after block 2, 1 → 2
    after block 3), checkpoints every 3 blocks, on a 4-rank ``pod`` mesh,
    once for each of ``kinds``: a run without a fault, ``fault@N`` (a
    fault on rank 1 before step N), ``straggle`` (rank 1 held up before
    the last step) and ``exhausted`` (a fault on rank 1 with no restart
    allowed). Returns each run's gathered final state, restarts, watchdog
    events, checkpoint writes and what was raised."""
    import os
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import CheckpointConfig, config_fingerprint
    from repro_torch.core import local_sgd as LS
    from repro_torch.data import DataPipeline
    from repro_torch.launch import train as ttrain
    from repro_torch.runtime import LadderRuntime, StepRunner
    from repro_torch.runtime.ft import SimulatedFault
    torch.set_num_threads(1)
    mesh = M.make_mesh((4,), ("pod",))
    r = mesh.rank()
    out = {}
    for kind in kinds:
        step, state, _, _, tel, live = ttrain.build_trainer(cfg, "cpu", mesh)
        ladder = LadderRuntime(live.rungs, live.switch_fn,
                               Scripted(2, {2: 1, 3: 2}), telemetry=tel,
                               device="cpu",
                               compile_counter=live.compile_counter,
                               mesh=mesh)

        def blocked(start, ladder=ladder):
            return ttrain._Blocked(DataPipeline(cfg.data, cfg.model,
                                                start_step=start, mesh=mesh),
                                   ladder.h)

        ckpt = CheckpointManager(CheckpointConfig(
            directory=os.path.join(ckpt_root, kind), interval_steps=3),
            mesh=mesh)
        writes = []
        write = ckpt._write
        ckpt._write = lambda s, *a: (writes.append(s), write(s, *a))[1]
        runner = StepRunner(step, ckpt, _fault_cfg(kind, r, steps,
                                                   straggle_s), 3, blocked,
                            fingerprint=config_fingerprint(cfg),
                            ladder=ladder, mesh=mesh)
        raised = None
        try:
            state, end = runner.run(state, 0, steps)
        except SimulatedFault as exc:
            raised, end = str(exc), None
        got = dict(end=end, restarts=runner.restarts, raised=raised,
                   events=runner.watchdog.events, writes=writes,
                   trajectory=ladder.trajectory,
                   losses=[(m["step"], m["loss"])
                           for m in runner.metrics_log])
        if raised is None:
            whole = LS.gather_replicas(state, mesh)
            got["final"] = _np({k: whole[k] for k in ("params", "opt",
                                                      "sync")})
            got["step"] = whole["step"]
        out[kind] = got
    out["ddp"] = _ddp_fault_runs(mesh, cfg, ckpt_root)
    return out


def _ddp_fault_runs(mesh, cfg, ckpt_root):
    """Data parallelism (every rank the same state) through ``StepRunner``
    with rank-0 checkpoints every 2 steps, without a fault and with one on
    rank 1 before step 3: each run's final params and restarts."""
    import dataclasses
    import os
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import (CheckpointConfig, FaultToleranceConfig,
                                    SyncConfig)
    from repro_torch.launch import train as ttrain
    from repro_torch.runtime import StepRunner
    cfg = dataclasses.replace(cfg, sync=SyncConfig())
    out = {}
    for fail_at in (-1, 3):
        step, state, make_pipeline, _, _, _ = ttrain.build_trainer(
            cfg, "cpu", mesh)
        ckpt = CheckpointManager(CheckpointConfig(
            directory=os.path.join(ckpt_root, f"ddp{fail_at}")),
            mesh=mesh, axis=None)
        runner = StepRunner(step, ckpt, FaultToleranceConfig(
            inject_failure_at=fail_at if mesh.rank() == 1 else -1), 2,
            make_pipeline, mesh=mesh)
        state, end = runner.run(state, 0, 4)
        out[fail_at] = dict(end=end, restarts=runner.restarts,
                            params=_np(state["params"]),
                            files=ckpt.all_steps())
    return out


def fault_inside_the_step(with_mesh):
    """A ``SimulatedFault`` raised inside the second step's ``step_fn``: on
    a 1-rank mesh it propagates; on one process the runner restores its
    start state and runs on (returns restarts and the final w)."""
    from repro_torch.config import (DataConfig, FaultToleranceConfig,
                                    ModelConfig)
    from repro_torch.data import DataPipeline
    from repro_torch.runtime import StepRunner
    from repro_torch.runtime.ft import SimulatedFault
    mesh = M.make_mesh((1,), ("pod",)) if with_mesh else None
    calls = []

    def step(state, batch):
        calls.append(1)
        if len(calls) == 2:
            raise SimulatedFault("inside the step")
        return {"w": state["w"] + 1}, {"loss": torch.zeros(())}

    runner = StepRunner(step, None, FaultToleranceConfig(), 1,
                        lambda s: DataPipeline(
                            DataConfig(seq_len=4, global_batch=2),
                            ModelConfig(vocab_size=17), start_step=s),
                        mesh=mesh)
    state, _ = runner.run({"w": torch.zeros(())}, 0, 3)
    return runner.restarts, float(state["w"])


# ---------------------------------------------------------------------------
# serving on a (data, model) mesh
# ---------------------------------------------------------------------------

def _mesh_2x2():
    from repro_torch import sharding as S
    mesh = M.make_mesh((2, 2), ("data", "model"))
    return mesh, S.rules_for(M.mesh_config((2, 2), ("data", "model")), mesh)


def _data_rows(a, mesh):
    """This rank's data shard of a whole batch (dim 0)."""
    t = torch.as_tensor(a)
    n = t.shape[0] // mesh.size("data")
    return t.narrow(0, mesh.rank("data") * n, n)


class _Drops:
    """The slots ``moe.routing`` dropped in this process while active."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.orig, self.count = moe, moe.routing, 0

        def routing(logits, cfg, capacity_factor=moe.CAPACITY_FACTOR):
            out = self.orig(logits, cfg, capacity_factor)
            self.count += int((out[2] >= out[3]).sum())
            return out
        moe.routing = routing
        return self

    def __exit__(self, *exc):
        self.moe.routing = self.orig


def mesh_moe_cases(cfg_kw, params, cases):
    """The MoE, embedding and decode-attention mesh paths on a (2, 2) mesh
    of CPU ranks. ``params``: the MoE's whole tables (numpy); ``cases``:
    the inputs by case. Returns, by case, this rank's outputs (grads: this
    rank's shard of each table, the router's too), the paths taken and
    drops."""
    from repro_torch import sharding as S
    from repro_torch.config.base import ModelConfig, MoEConfig
    from repro_torch.core import collectives as CL
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    torch.set_num_threads(1)
    mesh, rules = _mesh_2x2()
    cfg = ModelConfig(name="t", family="moe", d_model=cfg_kw["d_model"],
                      d_ff=cfg_kw["d_ff"],
                      moe=MoEConfig(num_experts=cfg_kw["experts"],
                                    top_k=cfg_kw["top_k"]))
    specs = S.serve_specs({"moe": moe.moe_defs(cfg)}, rules)["moe"]
    out = {}

    def tables(p):
        return S.shard_tree({k: torch.as_tensor(v) for k, v in p.items()},
                            specs, mesh)

    # the sharded path, its aux and its gradient
    p = {k: v.clone().requires_grad_(True)
         for k, v in tables(params).items()}
    x = _data_rows(cases["sharded"], mesh)
    moe.PATHS.clear()
    with S.use_rules(rules), _Drops() as drops:
        y, aux = moe.moe_ffn(p, x, cfg, return_aux=True)
    n = cases["sharded"].size
    # this rank's share: out is replicated over model, aux over every rank
    loss = (y ** 2).sum() / n / mesh.size("model") \
        + 0.01 * aux / mesh.size()
    loss.backward()
    out["sharded"] = dict(out=y.detach().numpy(), aux=float(aux),
                          grads={k: v.grad.numpy() for k, v in p.items()},
                          paths=dict(moe.PATHS), drops=drops.count)
    # slots drop: a skewed router
    moe.PATHS.clear()
    with torch.no_grad(), S.use_rules(rules), _Drops() as drops:
        y, aux = moe.moe_ffn(tables(cases["skewed_params"]),
                             _data_rows(cases["skewed"], mesh), cfg,
                             return_aux=True)
    out["skewed"] = dict(out=y.numpy(), aux=float(aux),
                         paths=dict(moe.PATHS), drops=drops.count)
    # decode-sized T: the one-hot path
    moe.PATHS.clear()
    with torch.no_grad(), S.use_rules(rules):
        y, aux = moe.moe_ffn(tables(params),
                             _data_rows(cases["onehot"], mesh), cfg,
                             return_aux=True)
    out["onehot"] = dict(out=y.numpy(), aux=float(aux),
                         paths=dict(moe.PATHS))
    # the vocab-parallel embedding
    table = torch.as_tensor(cases["table"])
    spec = rules.spec_for(("vocab", "embed"), table.shape)
    with S.use_rules(rules):
        e = L.embed({"embedding": S.shard_of(table, spec, mesh)},
                    _data_rows(cases["tokens"], mesh), torch.float32)
    out["embed"] = e.numpy()
    # seq-sharded decode attention
    model = CL.mesh_groups(rules)[1]
    chunk = cases["k"].shape[1] // model.k

    def seq_chunk(a):
        return _data_rows(a, mesh).narrow(1, model.index * chunk, chunk)
    o = A.decode_attention(_data_rows(cases["q"], mesh),
                           seq_chunk(cases["k"]), seq_chunk(cases["v"]),
                           torch.tensor([cases["index"]]), model)
    out["decode"] = o.numpy()
    out["staged"] = dict(CL.STAGED)
    return out


def mesh_serve(cfg, ref_params, prompts, gen, max_len):
    """``ServeEngine(mesh=)`` on a (2, 2) mesh of CPU ranks with the
    reference engine's weights: the prefill's logits, each teacher-free
    step's logits, ``generate``'s tokens; the round trip of the shards;
    what a gloo mesh refuses, and the trainer's family gate on it."""
    from repro_torch import interop
    from repro_torch import sharding as S
    from repro_torch.config import get_smoke
    from repro_torch.core import collectives as CL
    from repro_torch.launch.serve import ServeEngine, serving_rules
    from repro_torch.models import moe
    torch.set_num_threads(1)
    mesh, _ = _mesh_2x2()
    rules = serving_rules(cfg, mesh, max_len)
    sd = interop.rank_params_from_jax(ref_params, cfg, rules, mesh)
    engine = ServeEngine(cfg, "cpu", max_len=max_len, dtype=torch.float32,
                         params=sd, mesh=mesh)
    moe.PATHS.clear()
    tokens = torch.as_tensor(prompts).long()
    logits, cache = engine.prefill(tokens)
    prefill_paths = dict(moe.PATHS)
    steps, token = [], torch.argmax(logits, -1, keepdim=True)
    for i in range(gen):
        step = engine.decode(token, cache, prompts.shape[1] + i)
        steps.append(step.numpy())
        token = torch.argmax(step, -1, keepdim=True)
    out = dict(prefill=logits.numpy(), steps=np.stack(steps),
               tokens=engine.generate(prompts, gen), paths=prefill_paths,
               shards=_np(S.shard_tree(
                   interop.lm_params_from_jax(ref_params, cfg),
                   S.flat_keys(engine.specs()), mesh)),
               params=_np(dict(engine.params.state_dict())),
               specs=S.flat_keys(engine.specs()), raises={})
    try:
        ServeEngine(cfg, "cpu", max_len=max_len, dtype=torch.float32,
                    params=engine.params, mesh=mesh, graphs=True)
    except ValueError as exc:
        out["raises"]["graphs"] = str(exc)
    # the trainer builds on a mesh with a model axis for every family of the
    # registry: each rank's embedding shard of the smoke model
    from repro_torch.config import TrainConfig
    from repro_torch.launch.train import build_trainer
    out["families"] = {}
    for arch in FAMILY_ARCHS:
        cfg = TrainConfig(model=get_smoke(arch),
                          mesh=M.mesh_config((2, 2), ("data", "model")))
        state = build_trainer(cfg, "cpu", mesh)[1]
        out["families"][cfg.model.family] = (arch, tuple(
            state["params"]["embed"]["embedding"].shape))
    out["staged"] = dict(CL.STAGED)
    return out


def _flat_cache(cache, prefix=""):
    """A (nested) cache dict as {"a/b": numpy}."""
    out = {}
    for key, value in cache.items():
        if isinstance(value, dict):
            out.update(_flat_cache(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = value.detach().numpy().copy()
    return out


class _Handed:
    """The batch each ``prefill`` of ``model`` is handed, recorded."""

    def __init__(self, model):
        self.batches, self.orig = [], model.prefill

        def prefill(params, batch, cache=None):
            self.batches.append({k: v.clone() for k, v in batch.items()})
            return self.orig(params, batch, cache)
        model.prefill = prefill


def mesh_families(cases, gen):
    """``ServeEngine(mesh=)`` on a (2, 2) mesh of CPU ranks for each case
    (by name: cfg, the reference's params or None for the engine's own
    seeded draw, prompts, extras, max_len, the position decoding starts
    at): the prefill's logits and cache (this rank's rows and chunks), the
    greedy steps' logits, ``generate``'s tokens, the extras the model was
    handed; beside it the one-process engine on the same weights (its
    prefill's logits, cache and steps) and the prefill with the
    vocab-parallel embedding taken at this size. Then a cross cache split
    over model (the rank on its shards of the weights) against the whole
    one, on the same k, v."""
    from repro_torch import interop
    from repro_torch import sharding as S
    from repro_torch.launch.serve import ServeEngine, serving_rules
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    torch.set_num_threads(1)
    mesh, _ = _mesh_2x2()
    out = {}
    for name, case in cases.items():
        cfg, max_len = case["cfg"], case["max_len"]
        rules = serving_rules(cfg, mesh, max_len)
        if case["params"] is None:
            sd = one_sd = None
        else:
            sd = interop.rank_params_from_jax(case["params"], cfg, rules,
                                              mesh)
            one_sd = interop.lm_params_from_jax(case["params"], cfg)
        engine = ServeEngine(cfg, "cpu", max_len=max_len,
                             dtype=torch.float32, params=sd, mesh=mesh)
        one = ServeEngine(cfg, "cpu", max_len=max_len, dtype=torch.float32,
                          params=one_sd)
        prompts = torch.as_tensor(case["prompts"]).long()
        extras = {k: torch.as_tensor(v) for k, v in case["extras"].items()}
        handed = _Handed(engine.model)
        res = {}
        for label, eng in (("mesh", engine), ("one", one)):
            logits, cache = eng.prefill(prompts, extras)
            run = dict(prefill=logits.numpy().copy(),
                       cache=_flat_cache(cache))
            steps, token = [], torch.argmax(logits, -1, keepdim=True)
            for i in range(gen):
                step = eng.decode(token, cache, case["start"] + i)
                steps.append(step.numpy().copy())
                token = torch.argmax(step, -1, keepdim=True)
            run["steps"] = np.stack(steps)
            res[label] = run
        res["handed"] = {k: v.numpy() for k, v in handed.batches[0].items()}
        res["tokens"] = engine.generate(case["prompts"], gen, extras)
        # the vocab-parallel embedding at this size, against the same prefill
        threshold = L.SHARDED_MIN_TOKENS
        L.SHARDED_MIN_TOKENS = 1
        try:
            res["prefill_sharded_embed"] = engine.prefill(
                prompts, extras)[0].numpy().copy()
        finally:
            L.SHARDED_MIN_TOKENS = threshold
        res["shards"] = _np(dict(engine.params.state_dict()))
        res["specs"] = S.flat_keys(engine.specs())
        if case["params"] is None:
            # the engine's own draw: each leaf's shard of the one-process
            # engine's draw, bitwise
            whole = dict(one.params.state_dict())
            res["draw_bitwise"] = {
                key: bool(torch.equal(value, S.shard_of(
                    whole[key], res["specs"][key], mesh)))
                for key, value in engine.params.state_dict().items()}
        out[name] = res
    # a cross cache split over model against the whole one (same k, v)
    cfg = cases["whisper-base"]["cfg"]
    g = torch.Generator().manual_seed(5)
    b, t = 4, cfg.n_audio_frames
    p = {k: torch.randn(v.shape, generator=g) * 0.2 for k, v in
         A.attn_defs(cfg).items()}
    x = torch.randn((b, 1, cfg.d_model), generator=g)
    kv = torch.randn((2, b, t, cfg.n_kv_heads, cfg.resolved_head_dim),
                     generator=g)
    index = torch.tensor([3])
    whole, _, _ = A.decode_step_attention(p, x, kv[0], kv[1], index, cfg,
                                          cross=True)
    rules = serving_rules(cfg, mesh, 64)
    # the rank's shards of the weights under the serving rules
    held = _shard_params(T.map(lambda t: t.numpy(), p), A.attn_defs(cfg),
                         rules, mesh)
    with S.use_rules(rules):
        shards = A.tile_shards(t)
        sc = t // shards.k
        chunk = kv.narrow(2, shards.index * sc, sc)
        split, _, _ = A.decode_step_attention(held, x, chunk[0].clone(),
                                              chunk[1].clone(), index, cfg,
                                              cross=True, shards=shards)
        odd = A.tile_shards(t + 1)
    out["cross"] = dict(whole=whole.numpy(), split=split.numpy(),
                        k=shards.k, odd=odd)
    # an engine on the mesh for every family of the registry: each rank's
    # embedding shard of the smoke model
    from repro_torch.config import get_smoke
    out["engines"] = {}
    for arch in FAMILY_ARCHS:
        cfg = get_smoke(arch)
        engine = ServeEngine(cfg, "cpu", max_len=16, dtype=torch.float32,
                             mesh=mesh)
        out["engines"][cfg.family] = (arch, tuple(
            engine.params.state_dict()["embed.embedding"].shape))
    return out


def _shard_params(params, defs, rules, mesh):
    """This rank's shard of each whole leaf (numpy, nested as ``defs``)
    under ``rules.spec_for``, as tensors of its own."""
    from repro_torch import sharding as S
    specs = S.serve_specs(defs, rules)
    return S.map_with_specs(
        lambda a, spec: S.shard_of(torch.as_tensor(a), spec, mesh).clone(),
        params, specs)


class _Layout:
    """The residual each layer of a model's prefill and decode step takes
    (its (B, S) and the first layer's value), recorded while active."""

    def __init__(self, module, prefill, decode):
        self.module, self.names = module, (prefill, decode)
        self.shapes = {"prefill": [], "decode": []}
        self.first = {}

    def __enter__(self):
        self.orig = [getattr(self.module, n) for n in self.names]
        for kind, name, fn in zip(("prefill", "decode"), self.names,
                                  self.orig):
            setattr(self.module, name, self._wrap(kind, fn))
        return self

    def _wrap(self, kind, fn):
        def wrapped(lp, x, *args, **kw):
            self.shapes[kind].append(tuple(x.shape[:2]))
            self.first.setdefault(kind, x.numpy().copy())
            return fn(lp, x, *args, **kw)
        return wrapped

    def __exit__(self, *exc):
        for name, fn in zip(self.names, self.orig):
            setattr(self.module, name, fn)


def mesh_tp_cases(cases, attn, t_max):
    """The tensor- and sequence-parallel layers on a (2, 2) mesh of CPU
    ranks, each case (by name: the reference's whole params and inputs) on
    this rank's shards under the serving rules: its outputs (its act_seq
    chunk of a prefill's, its rows of a decode step's), k, v and caches.
    Beside them: each family's engine's param bytes, the residual's layout
    between layers, and what raises."""
    import dataclasses
    from repro_torch import sharding as S
    from repro_torch.config import get_smoke
    from repro_torch.launch.serve import ServeEngine, serving_rules
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as SSM
    from repro_torch.models import transformer as TR
    torch.set_num_threads(1)
    mesh, _ = _mesh_2x2()
    model = mesh.rank("model")
    out = {}

    def f32(arch):
        return dataclasses.replace(get_smoke(arch), dtype="float32")

    def rows(a):
        return _data_rows(a, mesh).clone()

    def setup(case, cfg, defs):
        rules = serving_rules(cfg, mesh, t_max)
        s = case["x"].shape[1]
        with S.use_rules(rules):
            seq = L.act_shards(s)
        b = case["x"].shape[0] // mesh.size("data")
        positions = torch.arange(s)[None].expand(b, s)
        return (rules, _shard_params(case["params"], defs, rules, mesh),
                L.seq_chunk(rows(case["x"]), seq), seq, positions)

    def np_(t):
        return t.detach().numpy().copy()

    for name, (arch, mode, prefix) in attn.items():
        case, cfg = cases[name], f32(arch)
        rules, p, x, seq, positions = setup(case, cfg, A.attn_defs(cfg))
        s = case["x"].shape[1]
        with S.use_rules(rules):
            y, k, v = A.full_attention(p, x, positions, cfg, mask_mode=mode,
                                       prefix_len=prefix, return_kv=True,
                                       seq=seq)
            sc = t_max // mesh.size("model")
            ck, cv = (rows(case[key]).narrow(1, model * sc, sc).clone()
                      for key in ("cache_k", "cache_v"))
            y1, nk, nv = A.decode_step_attention(
                p, rows(case["x1"]), ck, cv, torch.tensor([s]), cfg)
        out[name] = dict(y=np_(y), k=np_(k), v=np_(v), y1=np_(y1),
                         new_k=np_(nk), new_v=np_(nv),
                         kv_split=k.shape[2] < cfg.n_kv_heads)

    case, cfg = cases["cross"], f32("whisper-base")
    rules, p, x, seq, positions = setup(case, cfg, A.attn_defs(cfg))
    with S.use_rules(rules):
        y, k, v = A.full_attention(p, x, positions, cfg, mask_mode="full",
                                   kv_x=rows(case["enc"]), return_kv=True,
                                   seq=seq)
        shards = A.tile_shards(cfg.n_audio_frames)
        sc = cfg.n_audio_frames // shards.k
        ck, cv = (rows(case[key]).narrow(1, shards.index * sc, sc).clone()
                  for key in ("k", "v"))
        y1, _, _ = A.decode_step_attention(
            p, rows(case["x1"]), ck, cv, torch.tensor([0]), cfg, cross=True,
            shards=shards)
    out["cross"] = dict(y=np_(y), k=np_(k), v=np_(v), y1=np_(y1),
                        kv_split=k.shape[2] < cfg.n_kv_heads)

    case, cfg = cases["mlp"], f32("llama3.2-3b")
    rules, p, x, seq, _ = setup(case, cfg, L.mlp_defs(cfg.d_model, cfg.d_ff))
    with S.use_rules(rules):
        out["mlp"] = dict(y=np_(L.mlp(p, x, seq)),
                          y1=np_(L.mlp(p, rows(case["x1"]))))

    for name, arch in (("rms", "llama3.2-3b"), ("layer", "whisper-base")):
        case, cfg = cases[name], f32(arch)
        rules, p, x, _, _ = setup(case, cfg,
                                  L.norm_defs(cfg.d_model, cfg.norm_type))
        with S.use_rules(rules):
            out[name] = dict(y=np_(L.apply_norm(p, x, cfg.norm_type,
                                                cfg.norm_eps)))

    case, cfg = cases["mamba"], f32("mamba2-2.7b")
    defs = SSM.mamba_defs(cfg)
    rules, p, x, seq, _ = setup(case, cfg, defs)
    with S.use_rules(rules):
        y, tails = SSM.mamba_fwd(p, x, cfg, return_state=True, seq=seq)
        cache = {k: t.clone() for k, t in tails.items()}
        y1 = SSM.mamba_decode_step(p, rows(case["x1"]), cache, cfg)
    res = dict(y=np_(y), y1=np_(y1))
    res.update({f"state/{k}": np_(t) for k, t in tails.items()})
    res.update({f"stepped/{k}": np_(t) for k, t in cache.items()})
    out["mamba"] = res

    # each family's engine: the bytes a rank holds, against spec_for's
    # shard shapes and the whole model's
    out["bytes"] = {}
    for arch in FAMILY_ARCHS:
        cfg = get_smoke(arch)
        engine = ServeEngine(cfg, "cpu", max_len=16, dtype=torch.float32,
                             mesh=mesh)
        held = sum(t.numel() * t.element_size()
                   for t in engine.params.parameters())
        leaves = S.flat_keys(engine.model.param_defs()).values()
        shards = whole = 0
        for leaf in leaves:
            spec = engine.rules.spec_for(leaf.logical, leaf.shape)
            shards += 4 * int(np.prod(engine.rules.shard_shape(spec,
                                                               leaf.shape)))
            whole += 4 * int(np.prod(leaf.shape))
        out["bytes"][arch] = (held, shards, whole)

    # the residual between layers: a prefill's act_seq chunk, a decode
    # step's whole token
    out["layout"] = {}
    for arch, module, names in (
            ("llama3.2-3b", TR, ("layer_fwd", "layer_decode")),
            ("mamba2-2.7b", SSM, ("block_fwd", "block_decode"))):
        cfg = f32(arch)
        engine = ServeEngine(cfg, "cpu", max_len=t_max, dtype=torch.float32,
                             mesh=mesh)
        prompts = torch.as_tensor(np.random.default_rng(3).integers(
            1, cfg.vocab_size, (4, 16)))
        with _Layout(module, *names) as layout:
            logits, cache = engine.prefill(prompts)
            engine.decode(torch.argmax(logits, -1, keepdim=True), cache, 16)
        out["layout"][arch] = dict(layout.shapes, first=layout.first[
            "prefill"], step=layout.first["decode"])

    # no fallback: splits the code cannot compute on raise
    out["raises"] = {}
    cfg = f32("mamba2-2.7b")
    g = torch.Generator().manual_seed(0)
    p = L.init_params(SSM.mamba_defs(cfg), g)
    rules = S.rules_for(M.mesh_config((2, 2), ("data", "model")), mesh,
                        {"ssm_heads": ()})
    try:
        with S.use_rules(rules):
            SSM.mamba_fwd(_shard_params(T.map(lambda t: t.numpy(), p),
                                        SSM.mamba_defs(cfg), rules, mesh),
                          torch.zeros((2, 8, cfg.d_model)), cfg)
    except ValueError as exc:
        out["raises"]["mamba"] = str(exc)
    cfg = dataclasses.replace(f32("llama3.2-3b"), n_heads=6, n_kv_heads=3,
                              head_dim=32)
    rules = serving_rules(cfg, mesh, t_max)
    defs = A.attn_defs(cfg)
    p = _shard_params(T.map(lambda t: t.numpy(), L.init_params(defs, g)),
                      defs, rules, mesh)
    try:
        with S.use_rules(rules):
            A.full_attention(p, torch.zeros((2, 8, cfg.d_model)),
                             torch.arange(8)[None].expand(2, 8), cfg)
    except ValueError as exc:
        out["raises"]["q_group"] = str(exc)
    return out


# ---------------------------------------------------------------------------
# training on a (pod, data, model) mesh
# ---------------------------------------------------------------------------

def _train_cfg(kw, mesh_cfg, sync=None):
    import dataclasses
    from repro_torch.config import (DataConfig, OptimizerConfig, SyncConfig,
                                    TrainConfig, get_smoke)
    model_cfg = get_smoke(kw["arch"])
    if kw.get("f32", True):
        model_cfg = dataclasses.replace(model_cfg, dtype="float32")
    return TrainConfig(model=model_cfg, mesh=mesh_cfg,
                       sync=SyncConfig(**(sync or {})),
                       optimizer=OptimizerConfig(**kw["opt"]),
                       data=DataConfig(seq_len=kw["seq"],
                                       global_batch=kw["rows"]))


def _ce_case(inp, mesh, model_g, chunk):
    """``ce_loss`` under the trainer's rules for the table's dims on this
    rank's rows of ``inp["x"]`` and its shard of ``inp["table"]``: its
    loss, the table's spec, and the gradients of its rows and of its
    shard, each summed over the ranks that hold the same block and divided
    by the mesh's 4 ranks (``local_sgd.Within``'s reduction)."""
    from repro_torch import sharding as S
    from repro_torch.models.losses import ce_loss
    v, d = inp["table"].shape
    rules = S.fitted_rules(M.mesh_config((2, 2), ("data", "model")), mesh,
                           {"vocab": v, "embed": d})
    spec = rules.spec_for(("vocab", "embed"), (v, d))
    x = _data_rows(inp["x"], mesh).clone().requires_grad_()
    table = S.shard_of(torch.as_tensor(inp["table"]), spec,
                       mesh).clone().requires_grad_()
    mask = _data_rows(inp["mask"], mesh) if "mask" in inp else None
    with S.use_rules(rules):
        loss = ce_loss(x, table, _data_rows(inp["targets"], mesh).long(),
                       mask, chunk)
    gx, gt = torch.autograd.grad(loss, [x, table])
    model_g.sum_(gx)
    if "model" not in S.spec_axes(spec):
        model_g.sum_(gt)
    return {"loss": float(loss), "spec": spec,
            "x": (gx / 4).numpy(), "table": (gt / 4).numpy()}


def mesh_train_cases(cases, local, inits, batches, ckpt_dir, cli_argv):
    """The trainer on a (data 2, model 2) mesh of CPU ranks from the
    reference's initial states (``interop.rank_train_state_from_jax``):
    per DDP case this rank's loss and metrics, its blocks of the reduced
    gradient (where asked), the mesh's global norm against the norm of the
    whole gradient tree, its params after one step and the MoE paths
    taken; the sharded quantize of a leaf; the local-SGD block on (pod 2,
    data 1, model 2) for ``local["blocks"]`` blocks with its int8
    payloads; a checkpoint of that state written, read back and stepped
    from; last the CLI with ``--model 2`` for each family of ``cli_argv``
    (the last run leaves the world)."""
    import contextlib
    import copy
    import io
    from repro_torch import interop
    from repro_torch import sharding as S
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import CheckpointConfig
    from repro_torch.core import collectives as CL
    from repro_torch.core import compression as C
    from repro_torch.core import local_sgd as LS
    from repro_torch.launch import train as TR
    from repro_torch.models import moe
    from repro_torch.models.registry import build_model
    torch.set_num_threads(1)
    mesh = M.make_mesh((2, 2), ("data", "model"))
    out = {"rank": mesh.rank(), "data": mesh.rank("data"),
           "model": mesh.rank("model"), "ddp": {}}
    for tag, kw in cases.items():
        cfg = _train_cfg(kw, M.mesh_config((2, 2), ("data", "model")))
        model = build_model(cfg.model, attn_impl="torch")
        rules = S.training_rules(cfg, mesh)
        state = interop.rank_train_state_from_jax(inits[tag], cfg, rules,
                                                  mesh)
        batch = {k: _data_rows(v, mesh).long() for k, v in
                 batches[tag].items()}
        got = {"specs": S.flat_keys(S.train_specs(model.param_defs(),
                                                  rules))}
        if kw.get("grads"):
            within = LS.Within(model, cfg, mesh, rules, replicated=False)
            moe.PATHS.clear()
            _, _, grads = LS._grad_under(within, model, state["params"],
                                         batch)
            within.reduce_(grads)
            got["grads"] = _np(grads)
            got["norm"] = float(within.norm(grads))
            whole = LS.gather_shards({"params": grads},
                                     {"params": within.specs}, mesh)
            got["whole_norm"] = float(torch.sqrt(sum(
                torch.sum(g.double() ** 2)
                for g in T.leaves(whole["params"]))))
        moe.PATHS.clear()
        state, metrics = LS.make_ddp_step(model, cfg, mesh=mesh)(state,
                                                                 batch)
        got["paths"] = dict(moe.PATHS)
        got["metrics"] = {k: float(v) for k, v in metrics.items()}
        got["final"] = _np(state["params"])
        out["ddp"][tag] = got

    data_g, model_g = (CL.Group(mesh.group(a), mesh.device, mesh.backend)
                       for a in ("data", "model"))
    out["ce"] = {tag: _ce_case(inp, mesh, model_g, chunk)
                 for tag, (inp, chunk) in inits["ce"].items()}

    # the sharded quantize of one leaf: this rank's block, the whole
    # leaf's scale
    leaf = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 2, 4, 16, 8)).astype(np.float32) * 3.0)
    spec = (None, None, "model", "data")
    block = S.shard_of(leaf, spec, mesh).contiguous()
    shards = CL.Shards([model_g, data_g])
    out["quant"] = {"spec": spec}
    for impl in ("torch", "kernel"):
        q, s, res = C.quantize_shard(block, shards, rows=True, impl=impl,
                                     residual=True)
        out["quant"][impl] = dict(q=q.numpy(), scale=s.numpy(),
                                  res=res.numpy())

    # local SGD on (pod 2, data 1, model 2)
    mesh3 = M.make_mesh((2, 1, 2), ("pod", "data", "model"))
    cfg = _train_cfg(local, M.mesh_config((2, 1, 2),
                                          ("pod", "data", "model")),
                     local["sync"])
    model = build_model(cfg.model, attn_impl="torch")
    rules = S.training_rules(cfg, mesh3)
    state = interop.rank_train_state_from_jax(inits["local"], cfg, rules,
                                              mesh3)
    block_fn = LS.make_local_sgd_block(model, cfg, mesh=mesh3)
    rows = local["rows"] // 2
    lo = mesh3.rank("pod") * rows
    specs = LS.rank_state_specs(model, cfg, mesh3, state)
    payloads = []
    orig = C.compress_tree

    def keep(*args, **kw):
        got = orig(*args, **kw)
        payloads.append({"q": _np(got[0]), "scale": _np(got[1])})
        return got
    C.compress_tree = keep
    local_out = {"metrics": []}
    try:
        for b, blk in enumerate(batches["local"]):
            mine = {k: torch.as_tensor(v)[:, lo:lo + rows].long()
                    for k, v in blk.items()}
            moe.PATHS.clear()
            state, metrics = block_fn(state, mine)
            local_out["metrics"].append({k: float(v)
                                         for k, v in metrics.items()})
            local_out.setdefault("paths", dict(moe.PATHS))
            if b == 0:
                # a copy: the next block steps the moments in place
                local_out["first"] = T.map(np.copy, _np(
                    {k: state[k] for k in ("params", "opt", "sync")}))
    finally:
        C.compress_tree = orig
    local_out["payloads"] = payloads
    local_out["final"] = _np({k: state[k] for k in ("params", "opt",
                                                     "sync")})
    local_out["specs"] = specs
    # a checkpoint on the model mesh: the one-process file; read back, it
    # steps as the state it was written from
    ckpt = CheckpointManager(CheckpointConfig(directory=ckpt_dir),
                             mesh=mesh3, axis="pod", specs=specs)
    ckpt.save(int(state["step"]), state, fingerprint="mesh")
    back, _ = ckpt.restore(state)
    local_out["restored_equal"] = back["step"] == state["step"] and all(
        torch.equal(a, b) for k in ("params", "opt", "sync")
        for a, b in zip(T.leaves(back[k]), T.leaves(state[k])))
    blk = batches["local"][0]
    mine = {k: torch.as_tensor(v)[:, lo:lo + rows].long()
            for k, v in blk.items()}
    again = copy.deepcopy(state)
    s1, m1 = block_fn(again, mine)
    s2, m2 = block_fn(back, mine)
    local_out["replay_bitwise"] = float(m1["loss"]) == float(m2["loss"]) \
        and all(torch.equal(a, b) for k in ("params", "opt", "sync")
                for a, b in zip(T.leaves(s1[k]), T.leaves(s2[k])))
    out["local"] = local_out

    # the CLI with a model axis, once per family (``cli_argv``: name →
    # argv); each run but the last keeps the world it would leave
    out["cli"] = {}
    leave = torch.distributed.destroy_process_group
    for i, (name, argv) in enumerate(cli_argv.items()):
        buf = io.StringIO()
        torch.distributed.destroy_process_group = (
            leave if i == len(cli_argv) - 1 else (lambda *a, **k: None))
        try:
            with contextlib.redirect_stdout(buf):
                TR.main(argv)
        finally:
            torch.distributed.destroy_process_group = leave
        out["cli"][name] = buf.getvalue()
    return out


# ---------------------------------------------------------------------------
# training the SSM, hybrid, VLM and audio families on a (pod, data, model)
# mesh
# ---------------------------------------------------------------------------

def _family_cfg(kw, mesh_cfg, sync=None):
    """:func:`_train_cfg` with ``kw["model"]``'s overrides of the smoke
    config (e.g. an odd vocab) and ``kw["remat"]``."""
    import dataclasses
    cfg = _train_cfg(kw, mesh_cfg, sync)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **kw.get("model", {})),
        remat=kw.get("remat", "none"))


def _tensors(batch, lead=None):
    """A numpy batch as tensors: token leaves long, the extras as they are
    (f32); ``lead`` a function of the tensor picking this rank's rows."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        t = t.long() if t.dtype in (torch.int32, torch.int64) else t
        out[k] = lead(t) if lead is not None else t
    return out


def _grads_elsewhere(model, params, batch, rules):
    """The gradient of ``model.loss`` with its forward under ``rules`` in
    this thread and its backward (each checkpoint's recompute with it) on a
    thread whose context holds no rules, as autograd's own thread on the
    card does: a checkpointed function that reads the rules without
    carrying them in recomputes otherwise there."""
    import threading
    from repro_torch import sharding as S
    from repro_torch.models import layers as L
    stacks = [k for k in L.STACKS if k in params]

    def leaf(p):
        return p.detach().requires_grad_()
    view = T.map(leaf, {k: v for k, v in params.items() if k not in stacks})
    for key in stacks:
        view[key] = [T.map(leaf, lp) for lp in L.layer_list(params[key])]
    with torch.enable_grad(), S.use_rules(rules):
        loss, _ = model.loss(view, batch)
    flat, unflatten = T.flatten(view)
    got = {}

    def backward():
        try:
            got["grads"] = torch.autograd.grad(loss, flat)
        except Exception as exc:        # noqa: BLE001 - handed to the test
            got["error"] = repr(exc)
    thread = threading.Thread(target=backward)
    thread.start()
    thread.join()
    if "error" in got:
        return got["error"]
    grads = unflatten(list(got["grads"]))
    for key in stacks:
        grads[key] = T.map(lambda *xs: torch.stack(xs), *grads[key])
    return grads


class _RowTags:
    """While active, every pipeline batch's ``patches`` / ``frames`` row
    carries its data step and global row (``1000 · step + row`` in every
    value), and ``model.loss`` records the tokens and the tags it is
    handed."""

    def __init__(self, model):
        from repro_torch.data import pipeline
        self.pipeline, self.model, self.seen = pipeline, model, []
        self.orig_batch, self.orig_loss = (pipeline.DataPipeline._host_batch,
                                           model.loss)

    def __enter__(self):
        orig_batch, orig_loss = self.orig_batch, self.orig_loss

        def host_batch(pipe, step):
            batch = orig_batch(pipe, step)
            for key in ("patches", "frames"):
                if key in batch:
                    tag = 1000 * step + np.arange(batch[key].shape[0])
                    batch[key] = np.broadcast_to(
                        tag[:, None, None].astype(np.float32),
                        batch[key].shape).copy()
            return batch

        def loss(params, batch):
            extra = batch.get("patches", batch.get("frames"))
            self.seen.append((batch["tokens"].numpy().copy(),
                              extra[:, 0, 0].double().numpy().copy()))
            return orig_loss(params, batch)
        self.pipeline.DataPipeline._host_batch = host_batch
        self.model.loss = loss
        return self

    def __exit__(self, *exc):
        self.pipeline.DataPipeline._host_batch = self.orig_batch
        del self.model.loss


def _rows_of_extras(kw, shape, axes, sync, steps):
    """``build_trainer`` on a mesh of ``shape``/``axes`` with row-tagged
    extras, ``steps`` steps: per ``model.loss`` call the global rows its
    extras came from and whether its tokens are those rows of the global
    batch of that data step."""
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch.train import build_trainer
    mesh = M.make_mesh(shape, axes)
    cfg = _family_cfg(kw, M.mesh_config(shape, axes), sync)
    step, state, make_pipeline, model, _, _ = build_trainer(cfg, "cpu", mesh)
    with _RowTags(model) as tags:
        pipe = make_pipeline(0)
        for _ in range(steps):
            state, _ = step(state, next(pipe))
        whole = DataPipeline(cfg.data, cfg.model)
        calls = []
        for tokens, tag in tags.seen:
            data_step = int(tag[0]) // 1000
            rows = [int(t) - 1000 * data_step for t in tag]
            want = whole._host_batch(data_step)["tokens"][rows]
            calls.append({"step": data_step, "rows": rows,
                          "tokens_match": bool(np.array_equal(tokens, want))})
    return calls


def mesh_train_families(cases, locals_, inits, batches, ckpt, tags):
    """The trainer on the SSM, hybrid, VLM and audio families, from the
    reference's initial states (``interop.rank_train_state_from_jax``):
    per DDP case on (data 2, model 2) this rank's specs, loss, its blocks of
    the reduced gradient, the mesh's global norm, the gradient again with
    the backward on a thread without the rules, its params after one step,
    and the enc-dec loss taken directly on its shard of the table; per
    local-SGD case on (pod 2, data 1, model 2) the blocks' metrics, int8
    payloads and states; a checkpoint of the state of case ``ckpt[0]``
    written into directory ``ckpt[1]``, read back and stepped from; last
    the rows of the extras each loss saw (``tags``: DDP and local SGD
    through ``build_trainer``'s pipeline)."""
    import copy
    from repro_torch import interop
    from repro_torch import sharding as S
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.config import CheckpointConfig
    from repro_torch.core import compression as C
    from repro_torch.core import local_sgd as LS
    from repro_torch.models.registry import build_model
    torch.set_num_threads(1)
    mesh = M.make_mesh((2, 2), ("data", "model"))
    out = {"rank": mesh.rank(), "data": mesh.rank("data"),
           "model": mesh.rank("model"), "ddp": {}, "local": {}}
    for tag, kw in cases.items():
        cfg = _family_cfg(kw, M.mesh_config((2, 2), ("data", "model")))
        model = build_model(cfg.model, attn_impl="torch", ssd_impl="torch",
                            remat=cfg.remat)
        rules = S.training_rules(cfg, mesh)
        state = interop.rank_train_state_from_jax(inits[tag], cfg, rules,
                                                  mesh)
        batch = _tensors(batches[tag], lambda t: _data_rows(t, mesh))
        within = LS.Within(model, cfg, mesh, rules, replicated=False)
        got = {"specs": S.flat_keys(within.specs)}
        loss, _, grads = LS._grad_under(within, model, state["params"],
                                        batch)
        got["rank_loss"] = float(loss)
        elsewhere = _grads_elsewhere(model, state["params"], batch, rules)
        got["elsewhere"] = (elsewhere if isinstance(elsewhere, str) else all(
            torch.equal(a, b) for a, b in zip(T.leaves(grads),
                                              T.leaves(elsewhere))))
        within.reduce_(grads)
        got["grads"] = _np(grads)
        got["norm"] = float(within.norm(grads))
        whole = LS.gather_shards({"params": grads},
                                 {"params": within.specs}, mesh)
        got["whole_norm"] = float(torch.sqrt(sum(
            torch.sum(g.double() ** 2) for g in T.leaves(whole["params"]))))
        if cfg.model.family == "audio":
            # the loss on this rank's rows straight from its shards
            try:
                with S.use_rules(rules):
                    got["direct_loss"] = float(model.loss(state["params"],
                                                          batch)[0])
            except Exception as exc:    # noqa: BLE001 - handed to the test
                got["direct_loss"] = repr(exc)
        state, metrics = LS.make_ddp_step(model, cfg, mesh=mesh)(state,
                                                                 batch)
        got["metrics"] = {k: float(v) for k, v in metrics.items()}
        got["final"] = _np(state["params"])
        out["ddp"][tag] = got

    mesh3 = M.make_mesh((2, 1, 2), ("pod", "data", "model"))
    for tag, kw in locals_.items():
        cfg = _family_cfg(kw, M.mesh_config((2, 1, 2),
                                            ("pod", "data", "model")),
                          kw["sync"])
        model = build_model(cfg.model, attn_impl="torch", ssd_impl="torch",
                            remat=cfg.remat)
        rules = S.training_rules(cfg, mesh3)
        state = interop.rank_train_state_from_jax(inits[f"local/{tag}"], cfg,
                                                  rules, mesh3)
        block_fn = LS.make_local_sgd_block(model, cfg, mesh=mesh3)
        rows = kw["rows"] // 2
        lo = mesh3.rank("pod") * rows
        specs = LS.rank_state_specs(model, cfg, mesh3, state)
        payloads, orig = [], C.compress_tree

        def keep(*args, **kw_):
            got = orig(*args, **kw_)
            payloads.append({"q": _np(got[0]), "scale": _np(got[1])})
            return got
        C.compress_tree = keep
        local_out = {"metrics": [], "specs": specs}
        try:
            for b, blk in enumerate(batches[f"local/{tag}"]):
                mine = _tensors(blk, lambda t: t[:, lo:lo + rows])
                state, metrics = block_fn(state, mine)
                local_out["metrics"].append({k: float(v)
                                             for k, v in metrics.items()})
                if b == 0:
                    local_out["first"] = T.map(np.copy, _np(
                        {k: state[k] for k in ("params", "opt", "sync")}))
        finally:
            C.compress_tree = orig
        local_out["payloads"] = payloads
        local_out["final"] = _np({k: state[k] for k in ("params", "opt",
                                                         "sync")})
        if tag == ckpt[0]:
            # the one-process file from the model mesh; read back, it steps
            # as the state it was written from
            manager = CheckpointManager(
                CheckpointConfig(directory=ckpt[1]), mesh=mesh3, axis="pod",
                specs=specs)
            manager.save(int(state["step"]), state, fingerprint="mesh")
            back, _ = manager.restore(state)
            local_out["restored_equal"] = back["step"] == state["step"] \
                and all(torch.equal(a, b)
                        for k in ("params", "opt", "sync")
                        for a, b in zip(T.leaves(back[k]),
                                        T.leaves(state[k])))
            mine = _tensors(batches[f"local/{tag}"][0],
                            lambda t: t[:, lo:lo + rows])
            s1, m1 = block_fn(copy.deepcopy(state), mine)
            s2, m2 = block_fn(back, mine)
            local_out["replay_bitwise"] = (
                float(m1["loss"]) == float(m2["loss"])
                and all(torch.equal(a, b) for k in ("params", "opt", "sync")
                        for a, b in zip(T.leaves(s1[k]), T.leaves(s2[k]))))
        out["local"][tag] = local_out

    out["tags"] = {
        "ddp": _rows_of_extras(tags["ddp"], (2, 2), ("data", "model"), None,
                               1),
        "local": _rows_of_extras(tags["local"], (2, 1, 2),
                                 ("pod", "data", "model"), tags["sync"], 1)}
    return out
