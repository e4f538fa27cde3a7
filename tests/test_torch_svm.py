"""The port's SGD-SVM (``repro_torch.core.svm``) against the reference
(``repro.core.svm``) on the CPU, on the ijcnn1 stand-in at n=4000.

Tolerances: a single ``block_grad`` rtol 1e-5 / atol 1e-6 (one product in a
different summation order). A trained model ≤ 1e-4 absolute: the two
frameworks sum in different orders, and a rounding difference can flip a
hinge that sits at the kink, after which the runs differ by one point's
update, scaled by α. In float64 (one subprocess, ``jax_enable_x64``) the
same comparisons hold to rtol 1e-10.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from conftest import run_with_devices
from repro.core import svm as jsvm
from repro_torch import interop
from repro_torch.core import svm as tsvm
from repro_torch.data import make_svm_dataset

torch.set_num_threads(1)

MODEL_ATOL = 1e-4
MODES = ([(ov, topo, False) for ov in ("none", "delayed", "chunked")
          for topo in ("all", "ring", "pairwise")]
         + [("none", "ring", True), ("none", "pairwise", True)])


@pytest.fixture(scope="module")
def ds():
    return make_svm_dataset("ijcnn1", seed=0, n_override=4000)


def _np(t):
    return t.detach().cpu().numpy()


def test_objective_accuracy_block_grad(ds):
    rng = np.random.default_rng(1)
    w = rng.normal(size=ds.features).astype(np.float32)
    x, y = ds.x_train, ds.y_train
    tw, tx, ty = map(torch.from_numpy, (w, x, y))
    jw, jx, jy = map(jnp.asarray, (w, x, y))
    np.testing.assert_allclose(_np(tsvm.hinge_objective(tw, tx, ty, 0.5)),
                               np.asarray(jsvm.hinge_objective(jw, jx, jy, 0.5)),
                               rtol=1e-5)
    np.testing.assert_allclose(_np(tsvm.accuracy(tw, tx, ty)),
                               np.asarray(jsvm.accuracy(jw, jx, jy)),
                               rtol=1e-6)
    for impl in ("kernel", "torch"):
        got = tsvm.block_grad(tw, tx[:64], ty[:64], 1.0, impl=impl)
        want = jsvm.block_grad(jw, jx[:64], jy[:64], 1.0)
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        tsvm.block_grad(tw, tx[:64], ty[:64], 1.0, impl="pallas")


@pytest.mark.parametrize("correct", [2001, 2004, 2007])
def test_accuracy_bitwise_equal(correct):
    """At n=4000 these counts give float32(count/n) one ulp away from the
    reference's count·float32(1/n); the port must give the reference's bits."""
    rng = np.random.default_rng(correct)
    x = rng.normal(size=(4000, 3)).astype(np.float32)
    w = rng.normal(size=3).astype(np.float32)
    pred = np.where(x @ w >= 0, 1.0, -1.0).astype(np.float32)
    y = -pred
    y[:correct] = pred[:correct]
    got = _np(tsvm.accuracy(*map(torch.from_numpy, (w, x, y))))
    want = np.asarray(jsvm.accuracy(*map(jnp.asarray, (w, x, y))))
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes(), (got, want)


def test_seq_sgd(ds):
    d = ds.features
    x, y = ds.x_train[:1000], ds.y_train[:1000]
    got = tsvm.seq_sgd(torch.zeros(d), x, y, epochs=2, device="cpu")
    want = jsvm.seq_sgd(jnp.zeros(d), jnp.asarray(x), jnp.asarray(y), epochs=2)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=MODEL_ATOL)


@pytest.mark.parametrize("with_history,eval_every_sync", [
    (False, False), (True, False), (False, True)])
def test_srdms(ds, with_history, eval_every_sync):
    d = ds.features
    kw = dict(epochs=3, block_size=64, with_history=with_history,
              eval_every_sync=eval_every_sync)
    got = tsvm.srdms(torch.zeros(d), ds.x_train, ds.y_train, x_cv=ds.x_cv,
                     y_cv=ds.y_cv, device="cpu", **kw)
    want = jsvm.srdms(jnp.zeros(d), jnp.asarray(ds.x_train),
                      jnp.asarray(ds.y_train), x_cv=jnp.asarray(ds.x_cv),
                      y_cv=jnp.asarray(ds.y_cv), **kw)
    if not (with_history or eval_every_sync):
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=MODEL_ATOL)
        return
    (gw, (gobj, gacc)), (ww, (wobj, wacc)) = got, want
    np.testing.assert_allclose(_np(gw), np.asarray(ww), atol=MODEL_ATOL)
    assert gobj.shape == gacc.shape == (3,)
    np.testing.assert_allclose(_np(gobj), np.asarray(wobj), rtol=1e-5)
    np.testing.assert_allclose(_np(gacc), np.asarray(wacc), atol=1e-6)


def test_srdms_history_without_cv_is_nan(ds):
    _, (obj, acc) = tsvm.srdms(torch.zeros(ds.features), ds.x_train,
                               ds.y_train, epochs=2, block_size=256,
                               with_history=True, device="cpu")
    assert torch.isfinite(obj).all() and torch.isnan(acc).all()


@pytest.mark.parametrize("overlap,topology,gossip_async", MODES)
def test_dms_vmap_modes(ds, overlap, topology, gossip_async):
    d = ds.features
    kw = dict(workers=4, epochs=2, block_size=8, overlap=overlap,
              topology=topology, gossip_async=gossip_async)
    got = tsvm.dms(torch.zeros(d), ds.x_train, ds.y_train, device="cpu", **kw)
    want = jsvm.dms(jnp.zeros(d), ds.x_train, ds.y_train, **kw)
    assert got.shape == (d,) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=MODEL_ATOL)


def test_async_ring_diverges_like_reference():
    """Async gossip is ``w ← (M − αI)·w + α·g``; at α = 1 (epoch 0) an even
    ring has an eigenvalue 1/3 − 2/3 of M, so a mode grows by 4/3 a block
    and a long epoch overflows float32 — in the reference, and so in the
    port. Pairwise (radius 1) stays finite. ``chip_smoke.py``'s webspam
    ring/async run (546 blocks) relies on this."""
    ds = make_svm_dataset("ijcnn1", seed=0)     # 28,000 train: 437 blocks
    d = ds.features
    for topology, finite in (("ring", False), ("pairwise", True)):
        kw = dict(workers=8, epochs=1, block_size=8, topology=topology,
                  gossip_async=True)
        got = tsvm.dms(torch.zeros(d), ds.x_train, ds.y_train, device="cpu",
                       **kw)
        want = np.asarray(jsvm.dms(jnp.zeros(d), ds.x_train, ds.y_train,
                                   **kw))
        assert bool(torch.isfinite(got).all()) is finite, topology
        assert bool(np.isfinite(want).all()) is finite, topology
        if finite:
            np.testing.assert_allclose(_np(got), want, atol=MODEL_ATOL)


def _interleave(x, y, k, sb):
    """Reorder data so SRDMS(K·sb) sees the same block unions as
    DMS(K, sb) on contiguous worker shards (a copy of
    ``tests/test_svm_core.py::_interleave``)."""
    n = (x.shape[0] // (k * sb)) * (k * sb)
    x, y = x[:n], y[:n]
    xs = x.reshape(k, n // k, -1)
    ys = y.reshape(k, n // k)
    nb = (n // k) // sb
    xi = np.concatenate([
        np.stack([xs[w, b * sb:(b + 1) * sb] for w in range(k)]
                 ).reshape(k * sb, -1) for b in range(nb)])
    yi = np.concatenate([
        np.stack([ys[w, b * sb:(b + 1) * sb] for w in range(k)]
                 ).reshape(k * sb) for b in range(nb)])
    return x, y, xi, yi


@pytest.mark.parametrize("k,sb", [(2, 1), (4, 2), (8, 4), (2, 8)])
def test_dms_equals_srdms_identity(k, sb):
    """The paper's validation device, on the port alone: DMS(K, s_b) ≡
    SRDMS(K·s_b), to ``tests/test_svm_core.py``'s tolerance."""
    rng = np.random.default_rng(k * 10 + sb)
    n, d = 256, 10
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.where(rng.random(n) > 0.5, 1.0, -1.0).astype(np.float32)
    x, y, xi, yi = _interleave(x, y, k, sb)
    wd = tsvm.dms(torch.zeros(d), x, y, workers=k, epochs=2, block_size=sb,
                  device="cpu")
    wr = tsvm.srdms(torch.zeros(d), xi, yi, epochs=2, block_size=k * sb,
                    device="cpu")
    np.testing.assert_allclose(_np(wd), _np(wr), rtol=1e-5, atol=1e-6)


BAD_DMS = [
    dict(topology="all", gossip_async=True),
    dict(topology="ring", overlap="delayed", gossip_async=True),
    dict(overlap="stale"),
    dict(topology="star"),
    dict(topology="pairwise", workers=3),
    dict(backend="pmap"),
]


@pytest.mark.parametrize("kw", BAD_DMS)
def test_dms_raises_value_error_like_reference(ds, kw):
    kw = {"workers": 4, **kw}
    x, y = ds.x_train[:256], ds.y_train[:256]
    d = ds.features
    with pytest.raises(ValueError):
        tsvm.dms(torch.zeros(d), x, y, epochs=1, block_size=8, device="cpu",
                 **kw)
    with pytest.raises(ValueError):
        jsvm.dms(jnp.zeros(d), x, y, epochs=1, block_size=8, **kw)


def test_dms_rejects_unknown_overlap_under_gossip(ds):
    """The port validates ``overlap`` for every topology; the reference
    lets an unknown value through under gossip (ROADMAP §3)."""
    with pytest.raises(ValueError, match="overlap"):
        tsvm.dms(torch.zeros(ds.features), ds.x_train[:256], ds.y_train[:256],
                 workers=4, epochs=1, block_size=8, topology="ring",
                 overlap="stale", device="cpu")


def test_dms_dist_refuses_graphs_and_a_missing_mesh(ds):
    """``backend="dist"`` (the reference's ``shard_map``, held across
    processes by ``tests/test_torch_dist_svm.py``) runs eagerly and needs a
    mesh; a mesh of the wrong size raises there."""
    kw = dict(workers=4, epochs=1, block_size=8, backend="dist",
              device="cpu")
    x, y = ds.x_train[:256], ds.y_train[:256]
    with pytest.raises(ValueError, match="runs eagerly"):
        tsvm.dms(torch.zeros(ds.features), x, y, graphs=True, **kw)
    with pytest.raises(ValueError, match="needs a mesh"):
        tsvm.dms(torch.zeros(ds.features), x, y, **kw)


def test_entry_points_need_cuda_by_default(ds):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    d = ds.features
    x, y = ds.x_train[:64], ds.y_train[:64]
    with pytest.raises(RuntimeError, match="CUDA"):
        tsvm.dms(torch.zeros(d), x, y, workers=2, epochs=1, block_size=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsvm.srdms(torch.zeros(d), x, y, epochs=1, block_size=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsvm.seq_sgd(torch.zeros(d), x, y, epochs=1)


def test_interop_round_trip(ds):
    """A model JAX trained, carried over by ``interop``, is the same start
    for both packages: one more epoch gives the same model."""
    d = ds.features
    jx, jy = jnp.asarray(ds.x_train), jnp.asarray(ds.y_train)
    w_jax = np.asarray(jsvm.srdms(jnp.zeros(d), jx, jy, epochs=2,
                                  block_size=64))
    w0 = interop.svm_state_to_torch(w_jax, "cpu")
    assert w0.dtype == torch.float32 and np.array_equal(_np(w0), w_jax)
    got = tsvm.dms(w0, ds.x_train, ds.y_train, workers=4, epochs=1,
                   block_size=16, device="cpu")
    want = jsvm.dms(jnp.asarray(w_jax), ds.x_train, ds.y_train, workers=4,
                    epochs=1, block_size=16)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=MODEL_ATOL)
    got = tsvm.srdms(w0, ds.x_train, ds.y_train, epochs=1, block_size=64,
                     device="cpu")
    want = jsvm.srdms(jnp.asarray(w_jax), jx, jy, epochs=1, block_size=64)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=MODEL_ATOL)

    carry = {"w": np.tile(w_jax, (4, 1)), "pending": np.zeros((4, d)),
             "cnt": np.int32(5)}
    tcarry = interop.svm_state_to_torch(carry, "cpu")
    assert tcarry["cnt"].dtype == torch.int32 and int(tcarry["cnt"]) == 5
    assert tcarry["pending"].dtype == torch.float64
    assert np.array_equal(_np(tcarry["w"]), carry["w"])
    with pytest.raises(KeyError):
        interop.svm_state_to_torch({"momentum": np.zeros(3)}, "cpu")


def test_float64_parity_subprocess():
    """Every comparison above in float64, in one x64 subprocess, to rtol
    1e-10 — plus the DMS ≡ SRDMS identity of the port. Chunked DMS is held
    to an independent numpy run there, since the reference's chunked path
    does not run under x64 (ROADMAP §3)."""
    code = """
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp, numpy as np, torch
torch.set_num_threads(1)
from repro.core import svm as J
from repro_torch.core import svm as T
from repro_torch.data import make_svm_dataset

ds = make_svm_dataset("ijcnn1", seed=0, n_override=4000)
x, y = ds.x_train.astype(np.float64), ds.y_train.astype(np.float64)
xcv, ycv = ds.x_cv.astype(np.float64), ds.y_cv.astype(np.float64)
d = x.shape[1]
tz, jz = torch.zeros(d, dtype=torch.float64), jnp.zeros(d, jnp.float64)

def close(name, got, want, rtol=1e-10):
    # rtol of each entry, and of the largest entry for those near zero,
    # which carry the cancellation error of the rest (gossip's M·w − w)
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max(), err_msg=name)
    print("OK", name)

w = np.random.default_rng(1).normal(size=d)
close("block_grad", T.block_grad(torch.from_numpy(w), torch.from_numpy(x[:64]),
                                 torch.from_numpy(y[:64]), 1.0),
      J.block_grad(jnp.asarray(w), jnp.asarray(x[:64]), jnp.asarray(y[:64]),
                   1.0))
close("objective", T.hinge_objective(torch.from_numpy(w), torch.from_numpy(x),
                                     torch.from_numpy(y)),
      J.hinge_objective(jnp.asarray(w), jnp.asarray(x), jnp.asarray(y)))
close("seq_sgd", T.seq_sgd(tz, x[:1000], y[:1000], epochs=2, device="cpu"),
      J.seq_sgd(jz, jnp.asarray(x[:1000]), jnp.asarray(y[:1000]), epochs=2))
gw, (gobj, gacc) = T.srdms(tz, x, y, epochs=3, block_size=64, x_cv=xcv,
                           y_cv=ycv, eval_every_sync=True, device="cpu")
ww, (wobj, wacc) = J.srdms(jz, jnp.asarray(x), jnp.asarray(y), epochs=3,
                           block_size=64, x_cv=jnp.asarray(xcv),
                           y_cv=jnp.asarray(ycv), eval_every_sync=True)
close("srdms", gw, ww)
close("srdms objective", gobj, wobj)
# accuracy is float32 in both packages under x64 too (JAX's mean of a bool
# array), the count times float32(1/n) in both
close("srdms accuracy", gacc, wacc, rtol=0)
def chunked_fp64(k, bs, epochs, topo, chunks=4, c=1.0):
    # independent numpy chunked DMS: the reference's chunked path raises
    # under x64 (int32 round counter against int64 slice indices)
    from repro.core import costmodel
    n = (len(x) // k) * k
    xs, ys = x[:n].reshape(k, n // k, d), y[:n].reshape(k, n // k)
    dp = -(-d // chunks) * chunks
    seg = dp // chunks
    mats = costmodel.mixing_matrices(k, topo)
    wk, cnt = np.zeros((k, dp)), 0
    for t in range(epochs):
        alpha = 1.0 / (1.0 + t)
        for b in range((n // k) // bs):
            for i in range(k):
                xb, yb = xs[i, b * bs:(b + 1) * bs], ys[i, b * bs:(b + 1) * bs]
                wv = wk[i, :d]
                viol = (1.0 - yb * (xb @ wv) > 0).astype(np.float64)
                wk[i, :d] = wv - alpha * (wv - c * ((viol * yb) @ xb) / bs)
            sl = slice((cnt % chunks) * seg, (cnt % chunks + 1) * seg)
            m = mats[(cnt // chunks) % len(mats)]
            wk[:, sl] = m @ wk[:, sl]
            cnt += 1
    return wk.mean(0)[:d]

for ov, topo, asy in __MODES__:
    kw = dict(workers=4, epochs=2, block_size=8, overlap=ov, topology=topo,
              gossip_async=asy)
    want = (chunked_fp64(4, 8, 2, topo) if ov == "chunked"
            else J.dms(jz, x, y, **kw))
    close(f"dms {ov}/{topo}/{asy}", T.dms(tz, x, y, device="cpu", **kw), want)

k, sb = 4, 2
n = (x.shape[0] // (k * sb)) * (k * sb)
xs, ys = x[:n].reshape(k, n // k, d), y[:n].reshape(k, n // k)
idx = [(wk, b * sb + j) for b in range((n // k) // sb) for wk in range(k)
       for j in range(sb)]
xi = np.stack([xs[a, b] for a, b in idx]); yi = np.array([ys[a, b] for a, b in idx])
close("dms == srdms", T.dms(tz, x[:n], y[:n], workers=k, epochs=2,
                            block_size=sb, device="cpu"),
      T.srdms(tz, xi, yi, epochs=2, block_size=k * sb, device="cpu"))
print("ALL OK")
""".replace("__MODES__", repr(MODES))
    out = run_with_devices(code, n_devices=1, timeout=600)
    assert "ALL OK" in out, out
