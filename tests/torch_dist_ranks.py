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
            params, new_state = TS.sync_point(*mine, cfg, mesh=mesh,
                                              axis="pod")
            wire = None
            if "ef" in mine[2]:
                values = (T.map(lambda e, s: e - s, mine[1], mine[0])
                          if cfg.topology == "all" else mine[1])
                q, s, _ = TC.compress_tree(values, mine[2]["ef"], rows=True)
                wire = (_np(q), _np(s))
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
    """``sync.adaptive`` on a replica strategy with a mesh: the ladder runs
    on one process only, so ``build_trainer`` raises."""
    from repro_torch.config import MeshConfig, SyncConfig, TrainConfig
    from repro_torch.launch.train import build_trainer
    mesh = M.make_mesh((1,), ("pod",))
    cfg = TrainConfig(model=model_cfg,
                      mesh=MeshConfig(shape=(1,), axis_names=("pod",),
                                      replica_axis="pod"),
                      sync=SyncConfig(strategy="periodic", period=2,
                                      adaptive=True, adapt_ladder=(1, 2)))
    build_trainer(cfg, mesh=mesh)
