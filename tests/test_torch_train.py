"""The port's LM trainer (``repro_torch.core.local_sgd``,
``repro_torch.launch.train``, ``DecoderLM.loss``) against the reference on
the CPU, on the smollm smoke config in f32.

One subprocess (``conftest.run_with_devices``, K = 4 fake devices on the
replica axis ``pod``) runs the reference's jitted ``make_local_sgd_block``
for 3 blocks of H = 2 in every mode of none/int8 × none/delayed/chunked ×
all/ring (one with ``eval_at_sync``), and 2 ``make_ddp_step`` steps, from
``init_state`` on the same ``DataPipeline`` batches, and dumps the initial
state, the batches, the losses, the final state and its ``finalize_state``
to one npz. The port starts from the same state
(``interop.lm_train_state_from_jax``) and takes the same batches.

Tolerances. ``DecoderLM.loss`` and its gradients: rtol 1e-4 / atol 1e-6 (the
same f32 arithmetic summed in another order, through two layers). Losses of
every block: rtol 1e-4. Params and optimizer moments after 3 blocks: rtol
1e-4 / atol 1e-5 uncompressed. Under int8 an int8 value can flip by one
step between the two (a replica's delta differs by an ulp after a block,
and the jitted reference rounds its scale one ulp off its eager oracle at
times, ``tests/test_torch_sync.py``), so the params and sync buffers are
held to atol one quant step of their leaf (twice its largest error-feedback
residual, which is at most half a step), and the moments, which the
perturbed params' later gradients feed, to atol 1e-3 of their largest
value.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro.configs import smollm_360m as jconfigs
from repro.models.registry import build_model as jbuild
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.config import (DataConfig, MeshConfig, OptimizerConfig,
                                SyncConfig, TrainConfig)
from repro_torch.configs import smollm_360m as tconfigs
from repro_torch.core import local_sgd as LS
from repro_torch.data import DataPipeline
from repro_torch.launch import train as ttrain
from repro_torch.models.registry import build_model as tbuild

torch.set_num_threads(1)

K, H, BLOCKS = 4, 2, 3
MODES = [dict(compression=comp, overlap=ov, topology=topo)
         for comp in ("none", "int8")
         for ov in ("none", "delayed", "chunked")
         for topo in ("all", "ring")]
MODES[4] = dict(MODES[4], eval_at_sync=True)     # chunked / all / none
OPT = dict(name="adamw", learning_rate=3e-3, schedule="cosine",
           total_steps=20, weight_decay=0.01)
DATA = dict(seq_len=16, global_batch=8)

REFERENCE = r"""
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.config import (DataConfig, MeshConfig, OptimizerConfig,
                          SyncConfig, TrainConfig, get_smoke)
from repro.core import local_sgd as LS
from repro.data.pipeline import DataPipeline
from repro.models.registry import build_model

K, H, BLOCKS = __K__, __H__, __BLOCKS__
MODES = json.loads('''__MODES__''')
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
mesh = jax.make_mesh((K, 1, 1), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
mesh_cfg = MeshConfig(shape=(K, 1, 1), axis_names=("pod", "data", "model"),
                      replica_axis="pod")
pipe = DataPipeline(DataConfig(**DATA), model_cfg)
mbs = [pipe.next_host() for _ in range(H * BLOCKS)]
blocks = [{k: np.stack([m[k] for m in mbs[b * H:(b + 1) * H]]) for k in mbs[0]}
          for b in range(BLOCKS)]
for b, blk in enumerate(blocks):
    dump(f"batch/{b}", blk)
model = build_model(model_cfg)

def run(tag, sync, replicas, batches, make):
    cfg = TrainConfig(model=model_cfg, mesh=mesh_cfg, sync=sync,
                      optimizer=OptimizerConfig(**OPT),
                      data=DataConfig(**DATA))
    with jax.set_mesh(mesh):
        state = LS.init_state(model, cfg, jax.random.key(0),
                              replicas=replicas)
        dump(f"{tag}/init", state)
        # placed as the step's outputs are, so the second call does not
        # compile the step again
        spec = lambda x: P("pod") if replicas and x.ndim else P()
        state = jax.tree.map(
            lambda x: jax.device_put(x, NamedSharding(mesh, spec(x))), state)
        step = jax.jit(make(model, cfg, mesh))
        for b, batch in enumerate(batches):
            state, metrics = step(state, jax.tree.map(jnp.asarray, batch))
            dump(f"{tag}/metrics/{b}", metrics)
        dump(f"{tag}/final", state)
        dump(f"{tag}/finalized", LS.finalize_state(state, cfg))

for i, mode in enumerate(MODES):
    run(f"m{i}", SyncConfig(strategy="periodic", period=H, chunks=3, **mode),
        K, blocks, LS.make_local_sgd_block)
run("ddp", SyncConfig(), 0, [{k: v[0] for k, v in blk.items()}
                            for blk in blocks[:2]], LS.make_ddp_step)
np.savez("__OUT__", **out)
print("OK")
"""


def _np(t):
    return t.detach().float().numpy()


def _model_cfgs():
    return (dataclasses.replace(jconfigs.smoke(), dtype="float32",
                                ce_chunk=8),
            dataclasses.replace(tconfigs.smoke(), dtype="float32",
                                ce_chunk=8))


def _train_cfg(sync, replicas=K):
    return TrainConfig(model=_model_cfgs()[1],
                       mesh=MeshConfig(shape=(replicas, 1, 1),
                                       axis_names=("pod", "data", "model"),
                                       replica_axis="pod"),
                       sync=sync, optimizer=OptimizerConfig(**OPT),
                       data=DataConfig(**DATA))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("train") / "reference.npz"
    code = (REFERENCE.replace("__MODES__", json.dumps(MODES))
            .replace("__OPT__", json.dumps(OPT))
            .replace("__DATA__", json.dumps(DATA))
            .replace("__K__", str(K)).replace("__H__", str(H))
            .replace("__BLOCKS__", str(BLOCKS)).replace("__OUT__", str(path)))
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


def _run_port(reference, tag, sync, replicas, make, batches):
    cfg = _train_cfg(sync, replicas or K)
    if not replicas:
        cfg = dataclasses.replace(cfg, mesh=MeshConfig())
    init = {"opt": {}, "sync": {}, **_subtree(reference, f"{tag}/init")}
    state = interop.lm_train_state_from_jax(init, cfg)
    step = make(tbuild(cfg.model, attn_impl="torch"), cfg)
    losses = []
    for batch in batches:
        state, metrics = step(state, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
        losses.append({k: float(v) for k, v in metrics.items()})
    return cfg, state, losses


def _check_losses(reference, tag, losses):
    for b, got in enumerate(losses):
        want = _subtree(reference, f"{tag}/metrics/{b}")
        assert sorted(got) == sorted(want), (got, want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       err_msg=f"{tag} block {b} {key}")


def _tol(sync, ef, part, key, want):
    """rtol 1e-4 / atol 1e-5; under int8 a params or sync leaf to atol one
    quant step of its param leaf (twice its largest residual), and a moment
    to atol 1e-3 of its largest value."""
    if sync.compression != "int8":
        return dict(rtol=1e-4, atol=1e-5)
    if part == "opt":
        return dict(rtol=1e-4, atol=max(1e-5, 1e-3 * float(
            np.abs(want).max())))
    leaf = key if part == "params" else "/" + key.split("/", 2)[-1]
    step = 2 * float(np.abs(ef[leaf]).max()) if leaf in ef else 0.0
    return dict(rtol=1e-4, atol=max(1e-5, step))


@pytest.mark.parametrize("i", range(len(MODES)),
                         ids=[json.dumps(m, sort_keys=True) for m in MODES])
def test_local_sgd_blocks_match_reference(reference, i):
    sync = SyncConfig(strategy="periodic", period=H, chunks=3, **MODES[i])
    batches = [_subtree(reference, f"batch/{b}") for b in range(BLOCKS)]
    cfg, state, losses = _run_port(reference, f"m{i}", sync, K,
                                   LS.make_local_sgd_block, batches)
    _check_losses(reference, f"m{i}", losses)
    want = {"sync": {}, **_subtree(reference, f"m{i}/final")}
    assert int(want["step"]) == state["step"] == BLOCKS * H
    ef = _flat(want["sync"].get("ef", {}))
    for part in ("params", "opt", "sync"):
        got_f, want_f = _flat(T.map(_np, state[part])), _flat(want[part])
        assert sorted(got_f) == sorted(want_f), part
        for key in want_f:
            np.testing.assert_allclose(
                got_f[key], np.asarray(want_f[key], np.float32),
                err_msg=f"{part}{key}",
                **_tol(sync, ef, part, key, want_f[key]))
    fin = LS.finalize_state(state, cfg)
    want_fin = _flat(_subtree(reference, f"m{i}/finalized")["params"])
    for key, got in _flat(T.map(_np, fin["params"])).items():
        np.testing.assert_allclose(got, want_fin[key],
                                   **_tol(sync, ef, "params", key, got))
        if sync.overlap != "none" or sync.topology != "all":
            assert (got == got[:1]).all(), f"{key}: replicas not collapsed"


def test_ddp_steps_match_reference(reference):
    blocks = [_subtree(reference, f"batch/{b}") for b in range(2)]
    batches = [{k: v[0] for k, v in blk.items()} for blk in blocks]
    want = {"opt": {}, **_subtree(reference, "ddp/final")}
    for accum in (1, 2):
        _, state, losses = _run_port(
            reference, "ddp", SyncConfig(), 0,
            lambda m, c: LS.make_ddp_step(m, c, grad_accum=accum), batches)
        _check_losses(reference, "ddp", losses)
        assert state["step"] == int(want["step"]) == 2
        for part in ("params", "opt"):
            got_f, want_f = _flat(T.map(_np, state[part])), _flat(want[part])
            for key in want_f:
                np.testing.assert_allclose(got_f[key], want_f[key], rtol=1e-4,
                                           atol=1e-5, err_msg=f"{part}{key}")


def test_loss_and_grads_match_reference():
    jcfg, tcfg = _model_cfgs()
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.key(3))
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (2, 16)),
             "targets": rng.integers(0, jcfg.vocab_size, (2, 16)),
             "loss_mask": (rng.random((2, 16)) > 0.2).astype(np.float32)}
    jbatch = jax.tree.map(jnp.asarray, batch)
    (want, _), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(jp, jbatch)
    tm = tbuild(tcfg, attn_impl="torch")
    tp = T.map(lambda a: torch.from_numpy(np.array(a)),
               jax.tree.map(np.asarray, jp))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics, grads = LS.value_and_grad(tm, tp, tbatch)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-4)
    assert float(metrics["ce"]) == float(loss)
    for got, w in zip(T.leaves(grads), jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(_np(got), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)
    # the serving layout (per-layer modules) gives the same loss
    sd = interop.lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    with torch.no_grad():
        served = tm.loss(tm.load(sd, "cpu"), tbatch)[0]
    np.testing.assert_allclose(float(served), float(want), rtol=1e-4)


def test_loss_refuses_the_forward_only_kernel():
    _, tcfg = _model_cfgs()
    tm = tbuild(tcfg)           # attn_impl="kernel", the serving default
    params = tm.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.zeros(1, 4, dtype=torch.long),
             "targets": torch.zeros(1, 4, dtype=torch.long)}
    with pytest.raises(ValueError, match="plain attention"):
        tm.loss(params, batch)


def test_init_state_layout_and_batches():
    """The port's own init: the reference's leaf layout with a replica dim,
    K equal copies; blocks of H microbatches byte-identical to the
    reference's pipeline."""
    cfg = _train_cfg(SyncConfig(strategy="periodic", period=H,
                                compression="int8", overlap="chunked"))
    model = tbuild(cfg.model, attn_impl="torch")
    state = LS.init_state(model, cfg, torch.Generator().manual_seed(0), K)
    jm = jbuild(_model_cfgs()[0])
    shapes = jax.tree.map(lambda p: (K,) + p.shape,
                          jax.eval_shape(jm.init, jax.random.key(0)))
    assert [tuple(x.shape) for x in T.leaves(state["params"])] == \
        jax.tree.leaves(shapes, is_leaf=lambda x: isinstance(x, tuple))
    for leaf in T.leaves(state["params"]):
        assert torch.equal(leaf[0], leaf[-1])
    assert tuple(state["sync"]["chunk_idx"].shape) == (K,)
    _, _, make_pipeline, _, telemetry, ladder = ttrain.build_trainer(
        cfg, "cpu")
    assert telemetry is None and ladder is None
    block = next(make_pipeline(0))
    assert tuple(block["tokens"].shape) == (H, DATA["global_batch"],
                                            DATA["seq_len"])
    pipe = DataPipeline(cfg.data, cfg.model)
    first = pipe.next_host()
    assert block["tokens"][0].numpy().tobytes() == first["tokens"].tobytes()


def test_lm_train_state_from_jax_rejects_bad_layouts(reference):
    cfg = _train_cfg(SyncConfig(strategy="periodic", period=H))
    init = {"sync": {}, **_subtree(reference, "m0/init")}
    with pytest.raises(ValueError, match="replica"):
        interop.lm_train_state_from_jax(init, _train_cfg(cfg.sync, 2))
    with pytest.raises(KeyError):
        interop.lm_train_state_from_jax(
            {k: v for k, v in init.items() if k != "step"}, cfg)
    state = interop.lm_train_state_from_jax(init, cfg)
    assert state["params"]["layers"]["mlp"]["w_up"].shape[:2] == (K, 2)


def test_hierarchical_not_ported():
    cfg = _train_cfg(SyncConfig(strategy="hierarchical", period=H))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LS.make_local_sgd_block(tbuild(cfg.model, attn_impl="torch"), cfg)


def test_train_cli_on_cpu(capsys):
    ttrain.main(["--arch", "smollm-360m", "--smoke", "--device", "cpu",
                 "--replicas", "2", "--steps", "2",
                 "--set", "sync.strategy=periodic", "--set", "sync.period=2",
                 "--set", "sync.compression=int8",
                 "--set", "data.seq_len=16"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["arch"] == "smollm-smoke" and out["device"] == "cpu"
    assert out["steps"] == 2 and out["wall_s"] >= 0
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])


def test_entry_points_need_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _train_cfg(SyncConfig(strategy="periodic", period=H))
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.build_trainer(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["--smoke", "--steps", "1"])
