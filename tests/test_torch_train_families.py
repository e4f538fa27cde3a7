"""Training the MoE, VLM and audio families through the port's trainer
(``DecoderLM.loss`` with the load-balance term, ``PrefixVLM.loss``,
``EncDecModel.loss``, ``repro_torch.core.local_sgd`` over every layer stack,
``repro_torch.launch.train`` and the pipeline's stub inputs), against the
reference on the CPU, at smoke width in f32.

One subprocess (``conftest.run_with_devices``, K = 2 fake devices on the
replica axis ``pod``) runs, for phi3.5-moe, paligemma-3b and whisper-base,
the reference's jitted loss and gradient, eager ``compress_tree`` of each
replica's row of a delta over the MoE's leaves (its (E, D, F) expert leaves
among them), and jitted ``make_local_sgd_block`` for 2 blocks of H = 2 in
the modes none/int8 × none/delayed, and 2 ``make_ddp_step`` steps, from
``init_state`` on the same ``DataPipeline`` tokens, the VLM's ``patches``
and the audio ``frames`` drawn from a seed beside them (the reference's own
pipeline yields tokens alone; its dry-run specs feed these keys, ROADMAP
§3). The port starts from the same state (``interop.lm_train_state_from_jax``,
the enc-dec's ``enc_layers`` and ``dec_layers`` stacks beside each other)
and takes the same batches.

Tolerances are ``tests/test_torch_train_ssm.py``'s: the loss, the MoE's
aux and the gradients rtol 1e-4 / atol 1e-6; losses of every block rtol
1e-4; params, moments and sync buffers rtol 1e-4 / atol 1e-5, under int8
one quant step (``test_torch_train_ssm._tol_int8``). A routing that flips
between the two packages moves a gradient far past those bounds
(:func:`test_a_routing_flip_fails_the_bound`). Activation checkpointing
changes no value: every ``remat`` is held bitwise to ``"none"``.
"""
import collections
import dataclasses
import json

import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.config import (DataConfig, MeshConfig, OptimizerConfig,
                                SyncConfig, TrainConfig, get_smoke,
                                list_archs)
from repro_torch.core import compression as TC
from repro_torch.core import local_sgd as LS
from repro_torch.data.pipeline import DataPipeline
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as L
from repro_torch.models import moe as TM
from repro_torch.models.registry import build_model as tbuild

from test_torch_train import _check_losses, _flat, _np, _subtree
from test_torch_train_ssm import _backward_ops, _saved_bytes, _tol_int8

torch.set_num_threads(1)

MOE, VLM, AUDIO = "phi3.5-moe-42b-a6.6b", "paligemma-3b", "whisper-base"
ARCHS = (MOE, VLM, AUDIO)
K, H, BLOCKS = 2, 2, 2
MODES = [dict(compression=comp, overlap=ov)
         for comp in ("none", "int8") for ov in ("none", "delayed")]
# AdamW's eps at 1e-6, not the default 1e-8: a gradient element that
# cancels to about eps (phi3.5-moe-smoke's embedding[58, 20] takes -1.7e-8
# in its second block) turns the f32 rounding of its sum (~1e-9 in either
# package) into ~4e-5 of a state's value, past atol 1e-5 (the port against
# itself moves 3.2e-5 there when its start params move by 1e-7 relative).
# At 1e-6 such an element moves its state by < 1e-6; a routing flip still
# moves whole gradients, and the states with them, far past the bound.
OPT = dict(name="adamw", learning_rate=3e-3, schedule="cosine",
           total_steps=20, weight_decay=0.01, eps=1e-6)
DATA = dict(seq_len=16, global_batch=4)
GRAD_ROWS = 2

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

ARCHS = json.loads('''__ARCHS__''')
K, H, BLOCKS, GRAD_ROWS = __K__, __H__, __BLOCKS__, __GRAD_ROWS__
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

def stubs(cfg, lead, rng):
    # the stub frontends' inputs, as the reference's input_layout("train")
    d = cfg.d_model
    if cfg.family == "vlm":
        return {"patches": rng.standard_normal(
            lead + (cfg.num_image_tokens, d)).astype(np.float32)}
    if cfg.family == "audio":
        return {"frames": rng.standard_normal(
            lead + (cfg.n_audio_frames, d)).astype(np.float32)}
    return {}

mesh = jax.make_mesh((K, 1, 1), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
mesh_cfg = MeshConfig(shape=(K, 1, 1), axis_names=("pod", "data", "model"),
                      replica_axis="pod")

for arch in ARCHS:
    model_cfg = dataclasses.replace(get_smoke(arch), dtype="float32",
                                    ce_chunk=8)
    model = build_model(model_cfg)

    # one loss and gradient at fresh params, and the loss at other stubs
    params = model.init(jax.random.key(3))
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, model_cfg.vocab_size, (GRAD_ROWS, 16))
             for k in ("tokens", "targets")}
    batch.update(stubs(model_cfg, (GRAD_ROWS,), rng))
    (loss, metrics), grads = jax.jit(
        jax.value_and_grad(model.loss, has_aux=True))(
            params, jax.tree.map(jnp.asarray, batch))
    dump(f"{arch}/grad/params", params)
    dump(f"{arch}/grad/batch", batch)
    dump(f"{arch}/grad/metrics", {"loss": loss, **metrics})
    dump(f"{arch}/grad/grads", grads)
    other = dict(batch, **stubs(model_cfg, (GRAD_ROWS,), rng))
    dump(f"{arch}/alt/batch", other)
    dump(f"{arch}/alt/loss", {"loss": jax.jit(model.loss)(
        params, jax.tree.map(jnp.asarray, other))[0]})

    if model_cfg.family == "moe":
        # the int8 wire on every leaf, the (E, D, F) expert leaves among
        # them: each replica's row compressed eagerly
        shapes = jax.eval_shape(model.init, jax.random.key(0))
        rng = np.random.default_rng(1)
        delta = jax.tree.map(lambda p: (rng.standard_normal((K,) + p.shape)
                                        * 1e-3).astype(np.float32), shapes)
        ef = jax.tree.map(lambda p: (rng.standard_normal((K,) + p.shape)
                                     * 1e-5).astype(np.float32), shapes)
        dump(f"{arch}/wire/delta", delta)
        dump(f"{arch}/wire/ef", ef)
        for r in range(K):
            q, s, new_ef = C.compress_tree(
                jax.tree.map(lambda x: jnp.asarray(x[r]), delta),
                jax.tree.map(lambda x: jnp.asarray(x[r]), ef))
            dump(f"{arch}/wire/{r}/q", q)
            dump(f"{arch}/wire/{r}/scale", s)
            dump(f"{arch}/wire/{r}/ef", new_ef)

    pipe = DataPipeline(DataConfig(**DATA), model_cfg)
    mbs = [pipe.next_host() for _ in range(H * BLOCKS)]
    rng = np.random.default_rng(5)
    blocks = []
    for b in range(BLOCKS):
        blk = {k: np.stack([m[k] for m in mbs[b * H:(b + 1) * H]])
               for k in mbs[0]}
        blk.update(stubs(model_cfg, (H, DATA["global_batch"]), rng))
        blocks.append(blk)
        dump(f"{arch}/batch/{b}", blk)

    def run(tag, sync, replicas, batches, make):
        cfg = TrainConfig(model=model_cfg, mesh=mesh_cfg, sync=sync,
                          optimizer=OptimizerConfig(**OPT),
                          data=DataConfig(**DATA))
        with jax.set_mesh(mesh):
            state = LS.init_state(model, cfg, jax.random.key(0),
                                  replicas=replicas)
            dump(f"{arch}/{tag}/init", state)
            spec = lambda x: P("pod") if replicas and x.ndim else P()
            state = jax.tree.map(
                lambda x: jax.device_put(x, NamedSharding(mesh, spec(x))),
                state)
            step = jax.jit(make(model, cfg, mesh))
            for b, batch in enumerate(batches):
                state, metrics = step(state, jax.tree.map(jnp.asarray, batch))
                dump(f"{arch}/{tag}/metrics/{b}", metrics)
            dump(f"{arch}/{tag}/final", state)
            dump(f"{arch}/{tag}/finalized", LS.finalize_state(state, cfg))

    for i, mode in enumerate(MODES):
        run(f"m{i}", SyncConfig(strategy="periodic", period=H, **mode), K,
            blocks, LS.make_local_sgd_block)
    run("ddp", SyncConfig(), 0,
        [{k: v[0] for k, v in blk.items()} for blk in blocks],
        LS.make_ddp_step)
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
    """The reference's runs of the three families, one subprocess."""
    path = tmp_path_factory.mktemp("train_families") / "ref.npz"
    code = (REFERENCE.replace("__ARCHS__", json.dumps(ARCHS))
            .replace("__MODES__", json.dumps(MODES))
            .replace("__OPT__", json.dumps(OPT))
            .replace("__DATA__", json.dumps(DATA))
            .replace("__K__", str(K)).replace("__H__", str(H))
            .replace("__BLOCKS__", str(BLOCKS))
            .replace("__GRAD_ROWS__", str(GRAD_ROWS))
            .replace("__OUT__", str(path)))
    assert "OK" in run_with_devices(code, n_devices=K, timeout=900)
    with np.load(path) as data:
        return {arch: {key[len(arch) + 1:]: data[key] for key in data.files
                       if key.startswith(arch + "/")} for arch in ARCHS}


def _tensors(tree):
    return T.map(torch.from_numpy, tree)


def _run_port(ref, arch, tag, sync, replicas, make, batches):
    """(cfg, final state, losses, steps): ``steps`` is each leaf's largest
    int8 quant step (scale) over the run's syncs, by ``_flat`` key."""
    cfg = _train_cfg(arch, sync)
    if not replicas:
        cfg = dataclasses.replace(cfg, mesh=MeshConfig())
    init = {"opt": {}, "sync": {}, **_subtree(ref, f"{tag}/init")}
    state = interop.lm_train_state_from_jax(init, cfg)
    step = make(tbuild(cfg.model, attn_impl="torch"), cfg)
    losses, steps, inner = [], {}, TC.compress_tree

    def compress(*args, **kw):
        out = inner(*args, **kw)
        for key, scale in _flat(T.map(_np, out[1])).items():
            steps[key] = max(steps.get(key, 0.0), float(scale.max()))
        return out
    TC.compress_tree = compress
    try:
        for batch in batches:
            state, metrics = step(state, _tensors(batch))
            losses.append({k: float(v) for k, v in metrics.items()})
    finally:
        TC.compress_tree = inner
    return cfg, state, losses, steps


def _grads(arch, params, batch, remat="none"):
    model = tbuild(_model_cfg(arch), attn_impl="torch", remat=remat)
    return LS.value_and_grad(model, params, batch)


def _hold_grads(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=1e-6, err_msg=key)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(reference, arch):
    """The loss, its metrics (the MoE's ``ce`` and ``aux`` too, the total
    ce + 0.01 · aux) and every gradient against the reference's
    ``jax.value_and_grad`` of ``model.loss``; the layer stacks' gradients
    stacked as the reference's (whisper's ``enc_layers`` and
    ``dec_layers``)."""
    ref = reference[arch]
    params = _tensors(_subtree(ref, "grad/params"))
    batch = _tensors(_subtree(ref, "grad/batch"))
    loss, metrics, grads = _grads(arch, params, batch)
    want = _subtree(ref, "grad/metrics")
    np.testing.assert_allclose(float(loss), want["loss"], rtol=1e-4)
    assert sorted(want) == sorted(["loss", *metrics])
    for key, value in metrics.items():
        np.testing.assert_allclose(float(value), want[key], rtol=1e-4,
                                   err_msg=key)
    cfg = _model_cfg(arch)
    if cfg.is_moe:
        assert sorted(metrics) == ["aux", "ce"]
        assert float(metrics["aux"]) > 0.5
        assert torch.equal(loss, metrics["ce"] + cfg.moe.load_balance_coef
                           * metrics["aux"])
    else:
        assert sorted(metrics) == ["ce"] and torch.equal(loss, metrics["ce"])
    _hold_grads(_flat(T.map(_np, grads)), _flat(_subtree(ref, "grad/grads")))
    if arch == AUDIO:
        assert grads["enc_layers"]["attn"]["wq"].shape[0] == \
            cfg.n_encoder_layers
        assert grads["dec_layers"]["cross_attn"]["wq"].shape[0] == cfg.n_layers


def test_aux_gradient_reaches_the_router_through_the_gate_mass(reference):
    """The load-balance term's gradient: the router's gradient moves with
    ``load_balance_coef``, and ``load_balance`` differentiated alone is the
    gradient of E · Σ_e (mean gate mass of e) · (routed share of e) with
    the share a constant: the routed share carries none, as in the
    reference."""
    ref = reference[MOE]
    params = _tensors(_subtree(ref, "grad/params"))
    batch = _tensors(_subtree(ref, "grad/batch"))
    base = _grads(MOE, params, batch)[2]["layers"]["moe"]["router"]
    cfg = _model_cfg(MOE)
    heavy = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, load_balance_coef=1.0))
    model = tbuild(heavy, attn_impl="torch")
    moved = LS.value_and_grad(model, params, batch)[2]["layers"]["moe"]
    assert not torch.allclose(moved["router"], base, rtol=1e-3, atol=0)
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(12, cfg.moe.num_experts, generator=gen,
                         requires_grad=True)
    _, indices = TM.top_k_routing(logits.detach(), cfg.moe.top_k)
    got, = torch.autograd.grad(TM.load_balance(logits, indices, cfg), logits)
    share = torch.zeros(cfg.moe.num_experts).index_add_(
        0, indices.reshape(-1), torch.ones(indices.numel())) / indices.numel()
    want, = torch.autograd.grad(cfg.moe.num_experts * torch.sum(
        torch.softmax(logits, -1).mean(0) * share), logits)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-9)


def test_a_routing_flip_fails_the_bound(reference, monkeypatch):
    """One token's first expert swapped for one it did not pick moves the
    gradients past the bound the tests hold the port to: a flip between
    the two packages cannot pass."""
    ref = reference[MOE]
    params = _tensors(_subtree(ref, "grad/params"))
    batch = _tensors(_subtree(ref, "grad/batch"))
    real = TM.top_k_routing

    def flipped(logits, k):
        weights, indices = real(logits, k)
        unpicked = [e for e in range(logits.shape[-1])
                    if e not in indices[0].tolist()][0]
        indices = indices.clone()
        indices[0, 0] = unpicked
        return weights, indices
    monkeypatch.setattr(TM, "top_k_routing", flipped)
    grads = _grads(MOE, params, batch)[2]
    with pytest.raises(AssertionError):
        _hold_grads(_flat(T.map(_np, grads)),
                    _flat(_subtree(ref, "grad/grads")))


@pytest.mark.parametrize("arch", (VLM, AUDIO))
def test_loss_moves_with_the_stub_inputs(reference, arch):
    """The VLM's loss moves with its patches and the audio loss with its
    frames (the reference's ``test_models.py`` checks), each held to the
    reference's at both draws."""
    ref = reference[arch]
    params = _tensors(_subtree(ref, "grad/params"))
    model = tbuild(_model_cfg(arch), attn_impl="torch")
    with torch.no_grad():
        first = model.loss(params, _tensors(_subtree(ref, "grad/batch")))[0]
        other = model.loss(params, _tensors(_subtree(ref, "alt/batch")))[0]
    np.testing.assert_allclose(float(first),
                               _subtree(ref, "grad/metrics")["loss"],
                               rtol=1e-4)
    np.testing.assert_allclose(float(other),
                               _subtree(ref, "alt/loss")["loss"], rtol=1e-4)
    assert abs(float(first) - float(other)) > 1e-4


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("i", range(len(MODES)),
                         ids=[json.dumps(m, sort_keys=True) for m in MODES])
def test_local_sgd_blocks_match_reference(reference, arch, i):
    sync = SyncConfig(strategy="periodic", period=H, **MODES[i])
    ref, tag = reference[arch], f"m{i}"
    batches = [_subtree(ref, f"batch/{b}") for b in range(BLOCKS)]
    cfg, state, losses, steps = _run_port(ref, arch, tag, sync, K,
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


@pytest.mark.parametrize("arch", ARCHS)
def test_ddp_steps_match_reference(reference, arch):
    ref = reference[arch]
    blocks = [_subtree(ref, f"batch/{b}") for b in range(BLOCKS)]
    batches = [{k: v[0] for k, v in blk.items()} for blk in blocks]
    want = {"opt": {}, **_subtree(ref, "ddp/final")}
    _, state, losses, _ = _run_port(ref, arch, "ddp", SyncConfig(), 0,
                                    LS.make_ddp_step, batches)
    _check_losses(ref, "ddp", losses)
    if _model_cfg(arch).is_moe:
        assert sorted(losses[0]) == ["aux", "ce", "loss"]
    assert state["step"] == int(want["step"]) == 2
    for part in ("params", "opt"):
        got_f, want_f = _flat(T.map(_np, state[part])), _flat(want[part])
        assert sorted(got_f) == sorted(want_f), part
        for key in want_f:
            np.testing.assert_allclose(got_f[key], want_f[key], rtol=1e-4,
                                       atol=1e-5, err_msg=f"{part}{key}")


def test_int8_wire_on_the_expert_leaves(reference):
    """The int8 payloads of a sync of every MoE leaf, the stacked (L, E, D,
    F) expert leaves and the router among them, bitwise the reference's
    ``compress_tree`` of each replica's row, the residual to rtol 1e-6."""
    ref = reference[MOE]
    delta = _tensors(_subtree(ref, "wire/delta"))
    ef = _tensors(_subtree(ref, "wire/ef"))
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
    cfg = _model_cfg(MOE)
    experts = q["layers"]["moe"]["w_up"]
    assert tuple(experts.shape) == (K, cfg.n_layers, cfg.moe.num_experts,
                                    cfg.d_model, cfg.d_ff)
    assert tuple(s["layers"]["moe"]["w_up"].shape) == (K,)


REMAT_CASES = [(MOE, "full"), (MOE, "dots"), (VLM, "full"), (VLM, "dots"),
               (AUDIO, "full"), (AUDIO, "dots")]


@pytest.mark.parametrize("arch,remat", REMAT_CASES)
def test_remat_is_bitwise(reference, arch, remat):
    """Each remat gives the loss, the metrics and every gradient of
    ``"none"`` bitwise, the MoE's aux through each layer's checkpoint.
    ``"full"`` keeps fewer bytes for the backward. For the MoE and the VLM
    ``"dots"`` keeps the 2-D products' outputs and recomputes the batched
    ones (the expert ``bmm``s); for the enc-dec it is the reference's plain
    checkpoint of each layer, the backward of ``"full"`` op for op."""
    ref = reference[arch]
    params = _tensors(_subtree(ref, "grad/params"))
    batch = _tensors(_subtree(ref, "grad/batch"))
    base = _grads(arch, params, batch)
    got = _grads(arch, params, batch, remat)
    assert torch.equal(got[0], base[0])
    assert sorted(got[1]) == sorted(base[1])
    for key in base[1]:
        assert torch.equal(got[1][key], base[1][key]), key
    for key, (a, b) in enumerate(zip(T.leaves(got[2]), T.leaves(base[2]))):
        assert torch.equal(a, b), key
    models = {r: tbuild(_model_cfg(arch), attn_impl="torch", remat=r)
              for r in ("none", "full", "dots")}
    if remat == "full":
        saved = {r: _saved_bytes(models[r], params, batch)
                 for r in ("none", "full")}
        assert saved["full"] < saved["none"], saved
        return
    ops = {r: _backward_ops(m, params, batch) for r, m in models.items()}
    if arch == AUDIO:
        assert ops["dots"] == ops["full"]
        assert ops["full"]["mm"] > ops["none"]["mm"], ops
    else:
        assert ops["full"]["mm"] > ops["dots"]["mm"] == ops["none"]["mm"], ops
        assert ops["dots"]["bmm"] > ops["none"]["bmm"], ops


def test_interop_checks_the_enc_dec_stacks(reference):
    """``lm_train_state_from_jax`` holds ``enc_layers`` to
    ``n_encoder_layers`` and ``dec_layers`` to ``n_layers``, as it holds
    ``layers``."""
    sync = SyncConfig(strategy="periodic", period=H)
    cfg = _train_cfg(AUDIO, sync)
    init = {"opt": {}, "sync": {}, **_subtree(reference[AUDIO], "m0/init")}
    state = interop.lm_train_state_from_jax(init, cfg)
    assert state["params"]["enc_layers"]["mlp"]["w_up"].shape[:2] == \
        (K, cfg.model.n_encoder_layers)
    for stack in ("enc_layers", "dec_layers"):
        bad = {**init, "params": {**init["params"], stack: T.map(
            lambda x: x[:, :1], init["params"][stack])}}
        with pytest.raises(ValueError, match=stack):
            interop.lm_train_state_from_jax(bad, cfg)


@pytest.mark.parametrize("arch", list_archs())
def test_build_trainer_builds_every_arch(arch):
    """``build_trainer`` builds all ten archs with the plain attention and
    chunked scan, every layer stack stacked with the replica dim first."""
    cfg = _train_cfg(arch, SyncConfig(strategy="periodic", period=H))
    cfg = dataclasses.replace(cfg, model=get_smoke(arch))
    _, state, make_pipeline, model, _, _ = ttrain.build_trainer(cfg, "cpu")
    assert getattr(model, "attn_impl", "torch") == "torch"
    assert all(x.shape[0] == K for x in T.leaves(state["params"]))
    for key in L.STACKS:
        if key in state["params"]:
            assert isinstance(state["params"][key], dict)
    batch = next(make_pipeline(0))
    stub = {"vlm": "patches", "audio": "frames"}.get(cfg.model.family)
    assert sorted(batch) == sorted({"tokens", "targets"} | (
        {stub} if stub else set()))


@pytest.mark.parametrize("arch", (VLM, AUDIO))
def test_pipeline_feeds_the_stub_inputs(arch):
    """The pipeline's ``patches`` / ``frames``: zeros of the reference's
    ``input_layout("train")`` shape in the model's dtype, beside the
    reference's tokens (byte for byte the tokens alone would be), blocked
    (H, B, …) as the tokens are."""
    cfg = get_smoke(arch)
    pipe = DataPipeline(DataConfig(**DATA), cfg)
    batch = next(pipe)
    key = "patches" if arch == VLM else "frames"
    rows = cfg.num_image_tokens if arch == VLM else cfg.n_audio_frames
    assert tuple(batch[key].shape) == (DATA["global_batch"], rows,
                                       cfg.d_model)
    assert batch[key].dtype == getattr(torch, cfg.dtype)
    assert not batch[key].any()
    assert batch["tokens"].dtype == torch.int32
    blocked = next(ttrain._Blocked(DataPipeline(DataConfig(**DATA), cfg), H))
    assert tuple(blocked[key].shape) == (H,) + tuple(batch[key].shape)
    assert torch.equal(blocked["tokens"][0], batch["tokens"])


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


def test_moe_adaptive_ladder_and_restarts_through_the_cli(capsys, tmp_path):
    """The MoE through ``build_trainer`` with ``sync.adaptive``: a live
    ladder moves H from 2 to 1 after 2 blocks (the drift cap binds), a
    fault injected at step 3 restores the checkpoint and replays, and no
    kernel is loaded after the warmup."""
    ttrain.main(["--arch", MOE, "--smoke", "--device", "cpu",
                 "--replicas", "2", "--steps", "4",
                 "--set", "sync.strategy=periodic", "--set", "sync.period=2",
                 "--set", "sync.adaptive=true", "--set", "sync.adapt_every=2",
                 "--set", "sync.adapt_ladder=1,2",
                 "--set", "sync.compression=int8",
                 "--set", "sync.adapt_max_drift=0.001",
                 "--set", "data.seq_len=16", "--set", "remat=dots",
                 "--set", "checkpoint.interval_steps=2",
                 "--set", "fault.inject_failure_at=3",
                 "--set", f"checkpoint.directory={tmp_path}"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ad = rec["adaptive"]
    assert rec["arch"] == get_smoke(MOE).name and rec["steps"] == 4
    assert rec["restarts"] == 1
    assert ad["h_trajectory"][:2] == [[0, 2], [2, 1]]
    assert ad["compiles_after_warmup"] == 0
    assert np.isfinite(rec["first_loss"]) and np.isfinite(rec["last_loss"])


def test_block_is_deterministic_with_drops(monkeypatch):
    """Two MoE blocks from copies of one state give bitwise-equal params
    when slots are dropped: at a capacity factor of 0.25 each expert takes
    8 of the 32 tokens' 64 slots a replica step, and the dispatch's
    backward adds only zeros for the dropped ones."""
    cfg = _train_cfg(MOE, SyncConfig(strategy="periodic", period=H,
                                     compression="int8"))
    model = tbuild(cfg.model, attn_impl="torch")
    state = LS.init_state(model, cfg, torch.Generator().manual_seed(2), K)
    kept = T.map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x,
                 state)
    batch = next(ttrain._Blocked(DataPipeline(cfg.data, cfg.model), H))
    counts = collections.Counter()
    real = TM.routing

    def tight(logits, c, capacity_factor=TM.CAPACITY_FACTOR):
        out = real(logits, c, 0.25)
        counts["slots"] += out[2].numel()
        counts["dropped"] += int((out[2] >= out[3]).sum())
        counts["capacity"] = out[3]
        return out
    monkeypatch.setattr(TM, "routing", tight)
    step = LS.make_local_sgd_block(model, cfg)
    first, _ = step(state, batch)
    assert counts["capacity"] == 8
    assert 0 < counts["dropped"] < counts["slots"], counts
    second, _ = step(kept, batch)
    for a, b in zip(T.leaves(first["params"]), T.leaves(second["params"])):
        assert torch.equal(a, b)
