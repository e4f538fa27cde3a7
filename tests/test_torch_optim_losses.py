"""The port's chunked cross entropy (``repro_torch.models.losses``) and
optimizers (``repro_torch.optim``) against the reference on the CPU, on
numpy-seeded inputs.

Tolerances, all in f32. ``ce_loss`` and its gradients: rtol 1e-5 (the same
products and log-sum-exp, summed in another order). The schedules and
``apply_updates``: rtol 1e-6, atol 1e-7 (the same elementwise f32
arithmetic, in the reference's order of operations; the learning rate is an
f32 scalar in both).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import base as jbase
from repro.models.losses import ce_loss as j_ce_loss
from repro.optim import optimizers as jopt
from repro_torch import tree as T
from repro_torch.config import base as tbase
from repro_torch.models.losses import ce_loss as t_ce_loss
from repro_torch.optim import optimizers as topt

torch.set_num_threads(1)


def _np(t):
    return t.detach().numpy()


@pytest.mark.parametrize("chunk,masked", [(0, False), (8, False), (8, True),
                                          (5, False), (32, True)])
def test_ce_loss_and_grad(chunk, masked):
    """Value and gradients in x and the table; ``chunk`` 5 does not divide
    S = 32 and 32 is not below it, so both take the unchunked path, as in the
    reference."""
    rng = np.random.default_rng(chunk + 10 * masked)
    b, s, d, v = 3, 32, 16, 50
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    table = (0.3 * rng.normal(size=(v, d))).astype(np.float32)
    targets = rng.integers(0, v, size=(b, s)).astype(np.int32)
    mask = (rng.random((b, s)) > 0.3).astype(np.float32) if masked else None

    def jloss(xx, tt):
        return j_ce_loss(xx, tt, jnp.asarray(targets),
                         mask=None if mask is None else jnp.asarray(mask),
                         chunk=chunk)
    want, (gx_want, gt_want) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(table))

    tx = torch.from_numpy(x).requires_grad_()
    tt = torch.from_numpy(table).requires_grad_()
    got = t_ce_loss(tx, tt, torch.from_numpy(targets),
                    mask=None if mask is None else torch.from_numpy(mask),
                    chunk=chunk)
    got.backward()
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(_np(tx.grad), np.asarray(gx_want), rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_allclose(_np(tt.grad), np.asarray(gt_want), rtol=1e-5,
                               atol=1e-8)


@pytest.mark.parametrize("kw", [
    dict(schedule="constant"),
    dict(schedule="paper_inverse", learning_rate=1.0),
    dict(schedule="cosine", total_steps=100),
    dict(schedule="cosine", warmup_steps=10, total_steps=50,
         learning_rate=3e-4),
])
def test_schedules(kw):
    jsched = jopt.make_schedule(jbase.OptimizerConfig(**kw))
    tsched = topt.make_schedule(tbase.OptimizerConfig(**kw))
    for step in (0, 1, 5, 9, 10, 11, 37, 49, 50, 120):
        want = np.asarray(jsched(jnp.int32(step)))
        got = _np(tsched(step))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-10)
    with pytest.raises(ValueError):
        topt.make_schedule(tbase.OptimizerConfig(schedule="step"))


def _tree(rng):
    return {"embed": {"embedding": rng.normal(size=(12, 4))},
            "layers": {"w": rng.normal(size=(2, 4, 6)),
                       "scale": rng.normal(size=(2, 6))},
            "final_norm": {"scale": rng.normal(size=(4,))}}


def _as(tree, fn):
    return jax.tree.map(lambda a: fn(np.asarray(a, np.float32)), tree)


@pytest.mark.parametrize("kw", [
    dict(name="sgd"),
    dict(name="sgd", weight_decay=0.1, grad_clip=0.5),
    dict(name="momentum", momentum=0.8),
    dict(name="momentum", weight_decay=0.05, grad_clip=2.0),
    dict(name="adamw"),
    dict(name="adamw", weight_decay=0.1, grad_clip=1.0, schedule="cosine",
         warmup_steps=2, total_steps=20),
    dict(name="adamw", moment_dtype="bfloat16"),
])
def test_apply_updates(kw):
    """Three steps from numpy-seeded params, moments and gradients."""
    jcfg = jbase.OptimizerConfig(learning_rate=0.05, **kw)
    tcfg = tbase.OptimizerConfig(learning_rate=0.05, **kw)
    rng = np.random.default_rng(7)
    params = _tree(rng)
    jp, tp = _as(params, jnp.asarray), _as(params, torch.from_numpy)
    js, ts = jopt.init_opt_state(jcfg, jp), topt.init_opt_state(tcfg, tp)
    assert jax.tree.structure(js) == jax.tree.structure(T.map(_np_any, ts))
    for step in range(3):
        grads = _tree(rng)
        jp, js = jopt.apply_updates(jcfg, _as(grads, jnp.asarray), js, jp,
                                    jnp.int32(step))
        tp, ts = topt.apply_updates(tcfg, _as(grads, torch.from_numpy), ts,
                                    tp, step)
    for got, want in zip(T.leaves(tp) + T.leaves(ts),
                         jax.tree.leaves(jp) + jax.tree.leaves(js)):
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(_np_any(got), want, rtol=1e-6, atol=1e-7)


def _np_any(t):
    return t.detach().float().numpy()


def test_global_norm_and_clip():
    rng = np.random.default_rng(3)
    g = _tree(rng)
    want = jopt._global_norm(_as(g, jnp.asarray))
    got = topt._global_norm(_as(g, torch.from_numpy))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)
    clipped = topt._maybe_clip(_as(g, torch.from_numpy), 0.5)
    np.testing.assert_allclose(_np(topt._global_norm(clipped)), 0.5,
                               rtol=1e-6)
    assert topt._maybe_clip(g, 0.0) is g


def test_optimizer_config_matches_reference():
    assert ([(f.name, f.default) for f in
             dataclasses.fields(tbase.OptimizerConfig)]
            == [(f.name, f.default) for f in
                dataclasses.fields(jbase.OptimizerConfig)])
    with pytest.raises(ValueError):
        topt.init_opt_state(tbase.OptimizerConfig(name="lion"), {})
