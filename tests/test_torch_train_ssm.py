"""Training the SSM and hybrid families through the port's trainer
(``SSMModel.loss``, ``HybridModel.loss``, ``repro_torch.core.local_sgd``,
``repro_torch.launch.train``) and the port's activation checkpointing
(``remat`` of all three families, the checkpointed chunks of
``ssd_chunked``), against the reference on the CPU, at smoke width in f32.

A subprocess a family (``conftest.run_with_devices``, K = 2 fake devices
on the replica axis ``pod``; the two run at once) runs the reference's
jitted loss and gradient, eager ``compress_tree`` of each replica's row of
a delta, and jitted ``make_local_sgd_block``
for 2 blocks of H = 2 in the modes none/int8 × none/delayed, and 2
``make_ddp_step`` steps, for mamba2-smoke and zamba2-smoke, from
``init_state`` on the same ``DataPipeline`` batches, and dumps the initial
state, the batches, the losses, the final state and its ``finalize_state``
to one npz. The port starts from the same state
(``interop.lm_train_state_from_jax``, the hybrid's non-stacked ``shared``
subtree beside ``layers``) and takes the same batches.

Tolerances are ``tests/test_torch_train.py``'s: the loss and its gradients
rtol 1e-4 / atol 1e-6; losses of every block rtol 1e-4; params, moments and
sync buffers through ``test_torch_train._tol`` (rtol 1e-4 / atol 1e-5, and
under int8 one quant step of the leaf, the moments 1e-3 of their largest
value), where the int8 step is the largest scale the port's syncs used
when that exceeds ``_tol``'s estimate of it (twice the largest residual):
at this width an int8 value flips by one step between the two, and moves
its residual by a whole step, a hair over that estimate. Activation
checkpointing changes no value: every ``remat`` is held bitwise to
``"none"``.
"""
import collections
import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

from conftest import run_with_devices
from repro.models import ssm as JS
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.config import (DataConfig, MeshConfig, OptimizerConfig,
                                SyncConfig, TrainConfig, get_smoke)
from repro_torch.core import compression as TC
from repro_torch.core import local_sgd as LS
from repro_torch.launch import train as ttrain
from repro_torch.models import ssm as S
from repro_torch.models import transformer as TF
from repro_torch.models.registry import build_model as tbuild

from test_torch_train import _check_losses, _flat, _np, _subtree, _tol

torch.set_num_threads(1)

ARCHS = ("mamba2-2.7b", "zamba2-1.2b")
K, H, BLOCKS = 2, 2, 2
MODES = [dict(compression=comp, overlap=ov)
         for comp in ("none", "int8") for ov in ("none", "delayed")]
OPT = dict(name="adamw", learning_rate=3e-3, schedule="cosine",
           total_steps=20, weight_decay=0.01)
DATA = dict(seq_len=16, global_batch=4)

REFERENCE = r"""
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.config import (DataConfig, MeshConfig, OptimizerConfig,
                          SyncConfig, TrainConfig, get_smoke)
from repro.core import compression as C
from repro.core import local_sgd as LS
from repro.data.pipeline import DataPipeline
from repro.models.registry import build_model

arch = __ARCH__
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

mesh = jax.make_mesh((K, 1, 1), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
mesh_cfg = MeshConfig(shape=(K, 1, 1), axis_names=("pod", "data", "model"),
                      replica_axis="pod")
model_cfg = dataclasses.replace(get_smoke(arch), dtype="float32", ce_chunk=8)
model = build_model(model_cfg)

# one loss and gradient at fresh params
params = model.init(jax.random.key(3))
rng = np.random.default_rng(3)
batch = {k: rng.integers(0, model_cfg.vocab_size, (2, 16))
         for k in ("tokens", "targets")}
(loss, metrics), grads = jax.jit(jax.value_and_grad(model.loss, has_aux=True))(
    params, jax.tree.map(jnp.asarray, batch))
dump("grad/params", params)
dump("grad/batch", batch)
dump("grad/metrics", {"loss": loss, **metrics})
dump("grad/grads", grads)

# the int8 wire on every leaf, a zero one among them: each replica's row
# compressed eagerly (the jitted one rounds a scale one ulp off at times)
shapes = jax.eval_shape(model.init, jax.random.key(0))
rng = np.random.default_rng(1)
delta = jax.tree.map(lambda p: (rng.standard_normal((K,) + p.shape)
                                * 1e-3).astype(np.float32), shapes)
ef = jax.tree.map(lambda p: (rng.standard_normal((K,) + p.shape)
                             * 1e-5).astype(np.float32), shapes)
delta["layers"]["mamba"]["conv_x_b"][:] = 0.0
ef["layers"]["mamba"]["conv_x_b"][:] = 0.0
dump("wire/delta", delta)
dump("wire/ef", ef)
for r in range(K):
    q, s, new_ef = C.compress_tree(
        jax.tree.map(lambda x: jnp.asarray(x[r]), delta),
        jax.tree.map(lambda x: jnp.asarray(x[r]), ef))
    dump(f"wire/{r}/q", q)
    dump(f"wire/{r}/scale", s)
    dump(f"wire/{r}/ef", new_ef)

pipe = DataPipeline(DataConfig(**DATA), model_cfg)
mbs = [pipe.next_host() for _ in range(H * BLOCKS)]
blocks = [{k: np.stack([m[k] for m in mbs[b * H:(b + 1) * H]])
           for k in mbs[0]} for b in range(BLOCKS)]
for b, blk in enumerate(blocks):
    dump(f"batch/{b}", blk)

def run(tag, sync, replicas, batches, make):
    cfg = TrainConfig(model=model_cfg, mesh=mesh_cfg, sync=sync,
                      optimizer=OptimizerConfig(**OPT),
                      data=DataConfig(**DATA))
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
        dump(f"{tag}/finalized", LS.finalize_state(state, cfg))

for i, mode in enumerate(MODES):
    run(f"m{i}", SyncConfig(strategy="periodic", period=H, **mode), K,
        blocks, LS.make_local_sgd_block)
run("ddp", SyncConfig(), 0,
    [{k: v[0] for k, v in blk.items()} for blk in blocks], LS.make_ddp_step)
np.savez("__OUT__", **out)
print("OK")
"""


def _model_cfg(arch):
    return dataclasses.replace(get_smoke(arch), dtype="float32", ce_chunk=8)


def _train_cfg(arch, sync, replicas=K):
    return TrainConfig(model=_model_cfg(arch),
                       mesh=MeshConfig(shape=(replicas, 1, 1),
                                       axis_names=("pod", "data", "model"),
                                       replica_axis="pod"),
                       sync=sync, optimizer=OptimizerConfig(**OPT),
                       data=DataConfig(**DATA))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's runs of both families, one subprocess a family,
    the two at once."""
    tmp = tmp_path_factory.mktemp("train_ssm")

    def run(arch):
        path = tmp / f"{arch}.npz"
        code = (REFERENCE.replace("__ARCH__", json.dumps(arch))
                .replace("__MODES__", json.dumps(MODES))
                .replace("__OPT__", json.dumps(OPT))
                .replace("__DATA__", json.dumps(DATA))
                .replace("__K__", str(K)).replace("__H__", str(H))
                .replace("__BLOCKS__", str(BLOCKS))
                .replace("__OUT__", str(path)))
        assert "OK" in run_with_devices(code, n_devices=K, timeout=900)
        with np.load(path) as data:
            return {key: data[key] for key in data.files}
    with ThreadPoolExecutor(len(ARCHS)) as pool:
        return dict(zip(ARCHS, pool.map(run, ARCHS)))


def _run_port(reference, arch, tag, sync, replicas, make, batches):
    """(cfg, final state, losses, steps): ``steps`` is each leaf's largest
    int8 quant step (scale) over the run's syncs, by ``_flat`` key."""
    cfg = _train_cfg(arch, sync)
    if not replicas:
        cfg = dataclasses.replace(cfg, mesh=MeshConfig())
    init = {"opt": {}, "sync": {},
            **_subtree(reference[arch], f"{tag}/init")}
    state = interop.lm_train_state_from_jax(init, cfg)
    model = tbuild(cfg.model, attn_impl="torch", ssd_impl="torch")
    step = make(model, cfg)
    losses, steps, inner = [], {}, TC.compress_tree

    def compress(*args, **kw):
        out = inner(*args, **kw)
        for key, scale in _flat(T.map(_np, out[1])).items():
            steps[key] = max(steps.get(key, 0.0), float(scale.max()))
        return out
    TC.compress_tree = compress
    try:
        for batch in batches:
            state, metrics = step(state, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
            losses.append({k: float(v) for k, v in metrics.items()})
    finally:
        TC.compress_tree = inner
    return cfg, state, losses, steps


def _tol_int8(sync, ef, part, key, want, steps):
    """``test_torch_train._tol``, whose int8 bound for a params or sync
    leaf is one quant step estimated as twice the leaf's largest residual;
    here the step the syncs used (the largest scale) where it is larger,
    since a residual is at most half a step and an int8 value that flips
    moves its leaf by a whole one."""
    tol = _tol(sync, ef, part, key, want)
    if sync.compression == "int8" and part in ("params", "sync"):
        leaf = key if part == "params" else "/" + key.split("/", 2)[-1]
        tol["atol"] = max(tol["atol"], steps.get(leaf, 0.0))
    return tol


def _batch(cfg, seed, b=2, s=16):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)),
            "targets": rng.integers(0, cfg.vocab_size, (b, s))}


def _stacked_params(model, seed=0):
    from repro_torch.models import layers as L
    params = L.init_params(model.param_defs(),
                           torch.Generator().manual_seed(seed), torch.float32)
    params["layers"] = T.map(lambda *xs: torch.stack(xs), *params["layers"])
    return params


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(reference, arch):
    ref = reference[arch]
    tm = tbuild(_model_cfg(arch), attn_impl="torch", ssd_impl="torch")
    params = T.map(torch.from_numpy, _subtree(ref, "grad/params"))
    batch = T.map(torch.from_numpy, _subtree(ref, "grad/batch"))
    loss, metrics, grads = LS.value_and_grad(tm, params, batch)
    want = _subtree(ref, "grad/metrics")
    np.testing.assert_allclose(float(loss), want["loss"], rtol=1e-4)
    assert sorted(metrics) == ["ce"] and sorted(want) == ["ce", "loss"]
    assert float(metrics["ce"]) == float(loss)
    want_g = _flat(_subtree(ref, "grad/grads"))
    got_g = _flat(T.map(_np, grads))
    assert sorted(got_g) == sorted(want_g)
    for key in want_g:
        np.testing.assert_allclose(got_g[key], want_g[key], rtol=1e-4,
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("i", range(len(MODES)),
                         ids=[json.dumps(m, sort_keys=True) for m in MODES])
def test_local_sgd_blocks_match_reference(reference, arch, i):
    sync = SyncConfig(strategy="periodic", period=H, **MODES[i])
    ref, tag = reference[arch], f"m{i}"
    batches = [_subtree(ref, f"batch/{b}") for b in range(BLOCKS)]
    cfg, state, losses, steps = _run_port(reference, arch, tag, sync, K,
                                          LS.make_local_sgd_block, batches)
    _check_losses(ref, tag, losses)
    want = {"sync": {}, **_subtree(ref, f"{tag}/final")}
    assert int(want["step"]) == state["step"] == BLOCKS * H
    ef = _flat(want["sync"].get("ef", {}))
    for part in ("params", "opt", "sync"):
        got_f, want_f = _flat(T.map(_np, state[part])), _flat(want[part])
        assert sorted(got_f) == sorted(want_f), part
        for key in want_f:
            np.testing.assert_allclose(
                got_f[key], np.asarray(want_f[key], np.float32),
                err_msg=f"{part}{key}",
                **_tol_int8(sync, ef, part, key, want_f[key], steps))
    fin = LS.finalize_state(state, cfg)
    want_fin = _flat(_subtree(ref, f"{tag}/finalized")["params"])
    for key, got in _flat(T.map(_np, fin["params"])).items():
        np.testing.assert_allclose(got, want_fin[key],
                                   **_tol_int8(sync, ef, "params", key, got,
                                               steps))
        if sync.overlap != "none":
            assert (got == got[:1]).all(), f"{key}: replicas not collapsed"
    if arch == "zamba2-1.2b":
        # the shared block: one leaf group with its replica dim, beside the
        # layer stack
        wq = state["params"]["shared"]["attn"]["wq"]
        assert wq.shape[0] == K and wq.dim() == 4


@pytest.mark.parametrize("arch", ARCHS)
def test_ddp_steps_match_reference(reference, arch):
    ref = reference[arch]
    blocks = [_subtree(ref, f"batch/{b}") for b in range(2)]
    batches = [{k: v[0] for k, v in blk.items()} for blk in blocks]
    want = {"opt": {}, **_subtree(ref, "ddp/final")}
    _, state, losses, _ = _run_port(reference, arch, "ddp",
                                    SyncConfig(), 0, LS.make_ddp_step,
                                    batches)
    _check_losses(ref, "ddp", losses)
    assert state["step"] == int(want["step"]) == 2
    for part in ("params", "opt"):
        got_f, want_f = _flat(T.map(_np, state[part])), _flat(want[part])
        assert sorted(got_f) == sorted(want_f), part
        for key in want_f:
            np.testing.assert_allclose(got_f[key], want_f[key], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{part}{key}")


@pytest.mark.parametrize("arch,impls,match", [
    ("mamba2-2.7b", dict(ssd_impl="kernel"), "ssd_impl='torch'"),
    ("zamba2-1.2b", dict(attn_impl="kernel", ssd_impl="torch"),
     "attn_impl='torch'"),
    ("zamba2-1.2b", dict(attn_impl="torch", ssd_impl="kernel"),
     "ssd_impl='torch'")])
def test_loss_refuses_the_forward_only_kernels(arch, impls, match):
    cfg = _model_cfg(arch)
    model = tbuild(cfg, **impls)
    params = model.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.zeros(1, 4, dtype=torch.long),
             "targets": torch.zeros(1, 4, dtype=torch.long)}
    with pytest.raises(ValueError, match=match):
        model.loss(params, batch)


def _saved_bytes(model, params, batch) -> int:
    """Bytes autograd keeps for the backward of ``model.loss``: the
    activations a checkpoint drops are not among them."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t
    view = T.map(lambda p: p.detach().requires_grad_(), params)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model.loss(view, batch)
    return total[0]


class _CountOps(TorchDispatchMode):
    """The aten ops that run, by name."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


def _backward_ops(model, params, batch) -> collections.Counter:
    """The aten ops of the backward of ``model.loss`` (a recomputed forward
    among them)."""
    flat, unflatten = T.flatten(params)
    flat = [p.detach().requires_grad_() for p in flat]
    loss, _ = model.loss(unflatten(flat), batch)
    with _CountOps() as count:
        torch.autograd.grad(loss, flat)
    return count.ops


@pytest.mark.parametrize("arch,remat", [
    ("mamba2-2.7b", "full"), ("zamba2-1.2b", "full"),
    ("smollm-360m", "full"), ("smollm-360m", "dots")])
def test_remat_is_bitwise(arch, remat):
    """Each remat setting gives the loss and every gradient of
    ``"none"`` bitwise. ``"full"`` keeps fewer bytes for the backward;
    ``"dots"`` recomputes the batched products (bmm) in the backward and
    no 2-D product (mm), whose outputs it kept, where ``"full"`` recomputes
    both."""
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32", ce_chunk=8)
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg, 5, 2, 32).items()}
    models = {r: tbuild(cfg, attn_impl="torch", ssd_impl="torch", remat=r)
              for r in ("none", "full", remat)}
    params = _stacked_params(models["none"])
    base = LS.value_and_grad(models["none"], params, batch)
    got = LS.value_and_grad(models[remat], params, batch)
    assert torch.equal(got[0], base[0])
    for key, (a, b) in enumerate(zip(T.leaves(got[2]), T.leaves(base[2]))):
        assert torch.equal(a, b), key
    if remat == "full":
        saved = {r: _saved_bytes(models[r], params, batch)
                 for r in ("none", "full")}
        assert saved["full"] < saved["none"], saved
    else:
        ops = {r: _backward_ops(m, params, batch) for r, m in models.items()}
        assert ops["full"]["mm"] > ops["dots"]["mm"] == ops["none"]["mm"], ops
        assert ops["dots"]["bmm"] > ops["none"]["bmm"], ops
    # serving takes the plain layers: prefill under no_grad is unchanged
    with torch.no_grad():
        served = models[remat].prefill(params, {"tokens": batch["tokens"]})[0]
        plain = models["none"].prefill(params, {"tokens": batch["tokens"]})[0]
    assert torch.equal(served, plain)


def test_unknown_remat_checks_nothing_as_the_reference():
    """The reference's ``_maybe_remat`` leaves a dense layer unchecked for
    a value it does not know; the SSM families checkpoint for any value
    but ``"none"``."""
    fn = TF.layer_fwd
    assert TF.remat_layer(fn, "none") is fn
    assert TF.remat_layer(fn, "offload") is fn
    assert TF.remat_layer(fn, "full") is not fn
    cfg = dataclasses.replace(get_smoke("mamba2-2.7b"), dtype="float32")
    assert tbuild(cfg, ssd_impl="torch", remat="offload").remat == "offload"


def test_ssd_chunked_checkpoint_is_bitwise():
    """The checkpointed chunks against the plain loop (a forward under
    ``no_grad`` takes it): y, the state and the gradients bitwise, and each
    chunk recomputed once in the backward. At a chunk of 64 with a large
    decay the unmasked exponent of the upper triangle overflows; the mask
    before the exp keeps every gradient finite. The forward is held to the
    reference's chunked scan (rtol 1e-4 / atol 1e-5)."""
    rng = np.random.default_rng(7)
    b, l, h, p, n, chunk = 2, 128, 3, 8, 4, 64
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = (rng.random((b, l, h)) * 2.0 + 1.0).astype(np.float32)
    a = -np.array([4.0, 6.0, 8.0], np.float32)
    bm = rng.standard_normal((b, l, n)).astype(np.float32)
    cm = rng.standard_normal((b, l, n)).astype(np.float32)
    # the upper triangle's exponent reaches 63 · 3 · 8 ≫ log(f32 max)
    assert 63 * dt.min() * 8.0 > 89.0
    inputs = [torch.from_numpy(v).requires_grad_() for v in (x, dt, a, bm,
                                                              cm)]
    calls = [0]
    real = S._chunk

    def counted(*args):
        calls[0] += 1
        return real(*args)
    S._chunk = counted
    try:
        y, state = S.ssd_chunked(*inputs, chunk)
        assert calls[0] == 2
        gy = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
        gs = torch.from_numpy(
            rng.standard_normal(state.shape).astype(np.float32))
        grads = torch.autograd.grad((y * gy).sum() + (state * gs).sum(),
                                    inputs)
        assert calls[0] == 4          # each chunk recomputed once
    finally:
        S._chunk = real
    with torch.no_grad():
        y0, s0 = S.ssd_chunked(*[t.detach() for t in inputs], chunk)
    assert torch.equal(y.detach(), y0) and torch.equal(state.detach(), s0)
    # the unchecked loop: the same chunks, autograd keeping every one
    plain = [t.detach().requires_grad_() for t in inputs]
    S.checkpoint = lambda fn, *args, **kw: fn(*args)
    try:
        yp, sp = S.ssd_chunked(*plain, chunk)
    finally:
        S.checkpoint = checkpoint
    want = torch.autograd.grad((yp * gy).sum() + (sp * gs).sum(), plain)
    for got, w in zip(grads, want):
        assert torch.equal(got, w)
        assert torch.isfinite(got).all()
    jy, js = JS.ssd_chunked(x, dt, a, bm, cm, chunk)
    np.testing.assert_allclose(y0.numpy(), np.asarray(jy), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(s0.numpy(), np.asarray(js), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_wire_on_the_new_leaves(reference, arch):
    """The int8 payloads of a sync of every leaf of the family, the
    per-head vectors, conv weights and a zero bias among them, bitwise the
    reference's ``compress_tree`` of each replica's row (the reference
    quantizes inside ``shard_map``, one ``max(amax, 1e-12) / 127`` scale a
    replica), the residual as ``tests/test_torch_quant.py`` holds it."""
    ref = reference[arch]
    delta = T.map(torch.from_numpy, _subtree(ref, "wire/delta"))
    ef = T.map(torch.from_numpy, _subtree(ref, "wire/ef"))
    q, s, new_ef = TC.compress_tree(delta, ef, rows=True, impl="torch")
    for r in range(K):
        for part, got in (("q", q), ("scale", s)):
            got_f = _flat(T.map(lambda t: t[r].numpy(), got))
            want_f = _flat(_subtree(ref, f"wire/{r}/{part}"))
            assert sorted(got_f) == sorted(want_f)
            for key in want_f:
                np.testing.assert_array_equal(got_f[key], want_f[key],
                                              f"{part}{key} row {r}")
        got_f = _flat(T.map(lambda t: t[r].numpy(), new_ef))
        for key, want in _flat(_subtree(ref, f"wire/{r}/ef")).items():
            np.testing.assert_allclose(got_f[key], want, rtol=1e-6,
                                       atol=1e-9, err_msg=key)
    scale = s["layers"]["mamba"]
    assert torch.equal(scale["conv_x_b"],
                       torch.full((K,), 1e-12, dtype=torch.float32) / 127)
    assert not q["layers"]["mamba"]["conv_x_b"].any()
    for name in ("dt_bias", "a_log", "d_skip", "conv_x_w", "conv_b_w"):
        assert tuple(scale[name].shape) == (K,)


@pytest.mark.parametrize("arch", ARCHS)
def test_adaptive_ladder_and_restarts_through_the_cli(arch, capsys,
                                                      tmp_path):
    """``build_trainer`` with ``sync.adaptive`` builds a live ladder for the
    family and the fault-tolerant runner drives it: H moves from 2 to 1
    after 2 blocks (the drift cap binds it), a fault injected at step 3
    restores the checkpoint and replays, and no kernel is loaded after the
    warmup."""
    ttrain.main(["--arch", arch, "--smoke", "--device", "cpu",
                 "--replicas", "2", "--steps", "4",
                 "--set", "sync.strategy=periodic", "--set", "sync.period=2",
                 "--set", "sync.adaptive=true", "--set", "sync.adapt_every=2",
                 "--set", "sync.adapt_ladder=1,2",
                 "--set", "sync.compression=int8",
                 "--set", "sync.adapt_max_drift=0.001",
                 "--set", "data.seq_len=16", "--set", "remat=full",
                 "--set", "checkpoint.interval_steps=2",
                 "--set", "fault.inject_failure_at=3",
                 "--set", f"checkpoint.directory={tmp_path}"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ad = rec["adaptive"]
    assert rec["arch"] == get_smoke(arch).name and rec["steps"] == 4
    assert rec["restarts"] == 1
    assert ad["h_trajectory"][:2] == [[0, 2], [2, 1]]
    assert ad["compiles_after_warmup"] == 0
    assert np.isfinite(rec["first_loss"]) and np.isfinite(rec["last_loss"])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_on_cpu(arch, capsys):
    ttrain.main(["--arch", arch, "--smoke", "--device", "cpu",
                 "--replicas", "2", "--steps", "2",
                 "--set", "sync.strategy=periodic", "--set", "sync.period=2",
                 "--set", "sync.compression=int8", "--set", "remat=full",
                 "--set", "data.seq_len=16"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["arch"] == get_smoke(arch).name and out["device"] == "cpu"
    assert out["steps"] == 2
    assert np.isfinite(out["first_loss"]) and np.isfinite(out["last_loss"])


def test_build_trainer_takes_the_training_path():
    """The trainer builds each family with the plain attention and the
    chunked scan, and ``cfg.remat``."""
    for arch in ARCHS:
        cfg = dataclasses.replace(
            _train_cfg(arch, SyncConfig(strategy="periodic", period=H)),
            remat="full")
        _, state, _, model, _, _ = ttrain.build_trainer(cfg, "cpu")
        assert model.ssd_impl == "torch" and model.remat == "full"
        assert getattr(model, "attn_impl", "torch") == "torch"
        assert all(x.shape[0] == K for x in T.leaves(state["params"]))


@pytest.mark.parametrize("mode", [dict(), dict(compression="int8"),
                                  dict(compression="int16"),
                                  dict(compression="int8", slowmo=0.5)],
                         ids=["none", "int8", "int16", "int8-slowmo"])
def test_donated_sync_is_bitwise(mode):
    """The blocking ``sync_point`` writes the params it returns into
    ``params_end``'s leaves, which it is handed (an f32 leaf holding its
    delta on the way, a bf16 one not), bitwise the values of the same steps
    as pure functions; the start params and the sync state are left as
    they were."""
    from repro_torch.core import sync as TS
    cfg = SyncConfig(strategy="periodic", period=H, **mode)
    rng = np.random.default_rng(4)

    def tree(scale):
        return {"a": torch.from_numpy((rng.standard_normal((K, 5, 7))
                                       * scale).astype(np.float32)),
                "b": {"w": torch.from_numpy(
                    (rng.standard_normal((K, 33)) * scale).astype(
                        np.float32)).to(torch.bfloat16)}}
    start = T.map(lambda x: x[:1].expand(x.shape).contiguous(), tree(1.0))
    end = T.map(lambda s, d: (s.float() + d.float()).to(s.dtype), start,
                tree(1e-2))
    state = T.map(lambda x: x.unsqueeze(0).repeat((K,) + (1,) * x.dim()),
                  TS.init_sync_state(cfg, T.map(lambda x: x[0], start)))
    if "ef" in state:
        state["ef"] = T.map(lambda e: torch.from_numpy(
            (rng.standard_normal(tuple(e.shape)) * 1e-4).astype(np.float32)),
            state["ef"])
    kept = T.map(torch.clone, {"start": start, "state": state})
    # the same steps as pure functions: a new delta, a new result
    delta = TS._f32_delta(end, start)
    want_s = dict(state)
    mean, ef = TS._exchange_mean(delta, state.get("ef"), cfg, impl="torch")
    if ef is not None:
        want_s["ef"] = ef
    want_p = TS._apply_f32(start, TS._slowmo_step(mean, state, want_s, cfg))
    got_p, got_s = TS.sync_point(start, end, state, cfg, impl="torch")
    assert got_p is end
    for a, b in zip(T.leaves(got_p) + T.leaves(got_s),
                    T.leaves(want_p) + T.leaves(want_s)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(T.leaves({"start": start, "state": state}),
                    T.leaves(kept)):
        assert torch.equal(a, b)
