"""The port's int8 compression (``repro_torch.core.compression``, and the
quant kernel's plain version) against the reference on the CPU.

Bounds: the int8 payload and the scale bitwise equal to
``repro.core.compression.quantize`` (the oracle: both divide by the scale and
round half to even in f32); the error-feedback residual to rtol 1e-6; and,
against the Pallas kernel in interpret mode (which multiplies by the
inverse scale), ``tests/test_kernels.py::TestQuant``'s bounds: int8 equal,
scale and dequantized values to rtol 1e-6, error at most scale/2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as JC
from repro.kernels.quant import ops as jops
from repro_torch import tree as T
from repro_torch.core import compression as TC

torch.set_num_threads(1)

SHAPES = [(100,), (33, 7), (2, 3, 5), (4096,), (128, 128)]
IMPLS = ["kernel", "torch"]


def _x(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a)).tobytes()


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_quantize_bitwise_oracle(shape, scale, impl):
    x = _x(len(shape) + int(scale), shape, scale)
    qj, sj = JC.quantize(jnp.asarray(x))
    qt, st = TC.quantize(torch.from_numpy(x), impl=impl)
    assert qt.dtype == torch.int8 and qt.shape == shape and st.dim() == 0
    assert _bits(qt.numpy()) == _bits(qj)
    assert _bits(st.numpy()) == _bits(sj)
    np.testing.assert_array_equal(
        TC.dequantize(qt, st, impl=impl).numpy(), np.asarray(
            JC.dequantize(qj, sj)))


@pytest.mark.parametrize("shape", SHAPES)
def test_against_pallas_interpret(shape):
    """tests/test_kernels.py::TestQuant's comparison and bounds, the port's
    kernel wrapper (its plain version on the CPU) against the Pallas
    kernel."""
    x = _x(11, shape)
    qa, sa = jops.quantize(jnp.asarray(x), interpret=True)
    qb, sb = TC.quantize(torch.from_numpy(x))
    assert np.array_equal(np.asarray(qa), qb.numpy())
    np.testing.assert_allclose(float(sa), float(sb), rtol=1e-6)
    da = jops.dequantize(qa, sa, interpret=True)
    db = TC.dequantize(qb, sb)
    np.testing.assert_allclose(np.asarray(da), db.numpy(), rtol=1e-6)


def test_quantization_error_bound():
    x = torch.from_numpy(_x(5, (1000,)))
    q, s = TC.quantize(x)
    err = (TC.dequantize(q, s) - x).abs()
    assert float(err.max()) <= float(s) / 2 + 1e-6
    q0, s0 = TC.quantize(torch.zeros(16))
    assert bool((q0 == 0).all()) and float(s0) > 0


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("k", [2, 4])
def test_rows_match_per_replica_quantize(k, impl):
    """A stacked (K, …) leaf quantized row by row is each replica's own
    quantization in the reference, bitwise."""
    x = _x(k, (k, 9, 13), 0.1)
    q, s = TC.quantize(torch.from_numpy(x), rows=True, impl=impl)
    assert s.shape == (k,)
    for r in range(k):
        qj, sj = JC.quantize(jnp.asarray(x[r]))
        assert _bits(q[r].numpy()) == _bits(qj)
        assert _bits(s[r].numpy()) == _bits(sj)


@pytest.mark.parametrize("impl", IMPLS)
def test_compress_tree(impl):
    rng = np.random.default_rng(2)
    delta = {"b": {"w": rng.normal(size=(5, 7)).astype(np.float32)},
             "a": rng.normal(size=(33,)).astype(np.float32)}
    ef = {"b": {"w": (0.01 * rng.normal(size=(5, 7))).astype(np.float32)},
          "a": (0.01 * rng.normal(size=(33,))).astype(np.float32)}
    jq, js, jef = JC.compress_tree(jax.tree.map(jnp.asarray, delta),
                                   jax.tree.map(jnp.asarray, ef))
    tq, ts, tef = TC.compress_tree(T.map(torch.from_numpy, delta),
                                   T.map(torch.from_numpy, ef), impl=impl)
    for got, want in zip(T.leaves(tq) + T.leaves(ts),
                         T.leaves(jq) + T.leaves(js)):
        assert _bits(got.numpy()) == _bits(want)
    for got, want in zip(T.leaves(tef), T.leaves(jef)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-9)
    assert T.leaves(TC.init_error_feedback(tq))[0].dtype == torch.float32


def test_allgather_mean_dequant_is_replica_mean():
    """On one card the gather is the stacked leaf: the mean over dim 0 of
    the dequantized rows, as every replica of the reference computes it."""
    x = torch.from_numpy(_x(8, (4, 6, 5)))
    q, s = TC.quantize(x, rows=True)
    mean = TC.allgather_mean_dequant({"w": q}, {"w": s})["w"]
    assert mean.shape == (1, 6, 5)
    want = np.mean([np.asarray(JC.dequantize(*JC.quantize(jnp.asarray(
        x[r].numpy())))) for r in range(4)], axis=0)
    np.testing.assert_allclose(mean[0].numpy(), want, rtol=1e-6)


def test_unknown_impl_raises():
    with pytest.raises(ValueError):
        TC.quantize(torch.zeros(3), impl="pallas")


NONFINITE = [np.nan, np.inf, -np.inf]


def _poisoned(seed, shape, bad, where):
    x = _x(seed, shape, 0.1)
    x.reshape(-1)[where] = bad
    return x


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("bad", NONFINITE, ids=["nan", "inf", "-inf"])
@pytest.mark.parametrize("shape,where", [((100,), 37), ((33, 7), 0),
                                         ((4096,), 4095)])
def test_nonfinite_leaf_matches_oracle(shape, where, bad, impl):
    """A leaf holding a NaN or an infinity: the scale is NaN or inf, every
    q is 0 and the leaf dequantizes to NaN, as in the reference (NaN
    compared as NaN)."""
    x = _poisoned(20 + where, shape, bad, where)
    qj, sj = JC.quantize(jnp.asarray(x))
    qt, st = TC.quantize(torch.from_numpy(x), impl=impl)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert bool((qt == 0).all())
    assert np.isnan(float(st)) == np.isnan(bad) and not np.isfinite(float(st))
    deq = TC.dequantize(qt, st, impl=impl).numpy()
    np.testing.assert_array_equal(deq, np.asarray(JC.dequantize(qj, sj)))
    assert np.isnan(deq).all()


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("bad", NONFINITE, ids=["nan", "inf", "-inf"])
def test_nonfinite_row_among_good_rows(bad, impl):
    """rows=True with one bad row: that row as the reference quantizes it
    alone (scale NaN or inf, q 0), the other rows untouched; the error-
    feedback residual NaN on the bad row only."""
    x = _x(31, (4, 9, 13), 0.1)
    x[2, 4, 5] = bad
    q, s = TC.quantize(torch.from_numpy(x), rows=True, impl=impl)
    for r in range(4):
        qj, sj = JC.quantize(jnp.asarray(x[r]))
        np.testing.assert_array_equal(q[r].numpy(), np.asarray(qj))
        np.testing.assert_array_equal(s[r].numpy(), np.asarray(sj))
    assert bool((q[2] == 0).all()) and not np.isfinite(float(s[2]))
    assert bool(torch.isfinite(s[[0, 1, 3]]).all())
    delta = {"w": torch.from_numpy(x)}
    ef = {"w": torch.zeros(4, 9, 13)}
    _, _, new_ef = TC.compress_tree(delta, ef, rows=True, impl=impl)
    res = new_ef["w"]
    assert bool(torch.isnan(res[2]).all())
    assert bool(torch.isfinite(res[[0, 1, 3]]).all())
