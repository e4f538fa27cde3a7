"""The port's SSD scans (``repro_torch.kernels.ssd``, ``repro_torch.models.
ssm.ssd_chunked``) against the reference's (``repro.kernels.ssd``,
``repro.models.ssm.ssd_chunked``) on the CPU, the same numpy-seeded inputs
through both.

Bounds. The exact recurrence against the reference's recurrence and against
its Pallas kernel (interpret mode, as ``tests/test_kernels.py::TestSSD`` runs
it): rtol 1e-3 / atol 2e-4, TestSSD's own bound (the Pallas kernel is the
chunked form, which sums and exponentiates in another order). The chunked
twin against the reference's chunked scan: both do the same f32 arithmetic
in the same chunks and differ only in the order of the products' sums, so
rtol 1e-5 / atol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd import ops as jops
from repro.kernels.ssd import ref as jref
from repro.models import ssm as jssm
from repro_torch.kernels.ssd import ops, ref
from repro_torch.models import ssm as tssm

torch.set_num_threads(1)

TESTSSD_TOL = dict(rtol=1e-3, atol=2e-4)
CHUNKED_TOL = dict(rtol=1e-5, atol=1e-6)
# tests/test_kernels.py::TestSSD: (b, l, h, p, n, chunk), unaligned L = 200
SHAPES = [(1, 128, 2, 64, 128, 64), (2, 256, 4, 64, 128, 128),
          (1, 200, 2, 64, 64, 128), (1, 512, 1, 128, 128, 256),
          (2, 64, 3, 32, 16, 32)]


def _draw(seed, b, l, h, p, n):
    """TestSSD's draws, as numpy f32: x, B, C normal, Δ in [0.001, 0.1],
    A in [−2, −0.5]."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.normal(size=(b, l, h, p)).astype(f),
            rng.uniform(0.001, 0.1, size=(b, l, h)).astype(f),
            (-rng.uniform(0.5, 2.0, size=(h,))).astype(f),
            rng.normal(size=(b, l, n)).astype(f),
            rng.normal(size=(b, l, n)).astype(f))


def _t(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("shape", SHAPES)
def test_recurrence_matches_reference_and_pallas(shape):
    b, l, h, p, n, chunk = shape
    arrays = _draw(0, b, l, h, p, n)
    y, s = ref.ssd_scan(*_t(arrays))
    assert y.shape == (b, l, h, p) and s.shape == (b, h, n, p)
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    jy, js = jref.ssd_scan(*map(jnp.asarray, arrays))
    _close(y, jy, TESTSSD_TOL)
    _close(s, js, TESTSSD_TOL)
    py, ps = jops.ssd_scan(*map(jnp.asarray, arrays), chunk=chunk,
                           interpret=True)
    _close(y, py, TESTSSD_TOL)
    _close(s, ps, TESTSSD_TOL)


def test_recurrence_init_state_and_dtype():
    """A given initial state, and y in x's dtype (bf16) with an f32 state."""
    arrays = _draw(1, 2, 40, 3, 16, 8)
    s0 = np.random.default_rng(2).normal(size=(2, 3, 8, 16)).astype(np.float32)
    y, s = ref.ssd_scan(*_t(arrays), init_state=torch.from_numpy(s0))
    jy, js = jref.ssd_scan(*map(jnp.asarray, arrays),
                           init_state=jnp.asarray(s0))
    _close(y, jy, TESTSSD_TOL)
    _close(s, js, TESTSSD_TOL)
    x, dt, a, bm, cm = _t(arrays)
    yb, sb = ref.ssd_scan(x.bfloat16(), dt, a, bm.bfloat16(), cm.bfloat16())
    assert yb.dtype == torch.bfloat16 and sb.dtype == torch.float32


@pytest.mark.parametrize("l,chunk,init", [(96, 32, False), (96, 32, True),
                                          (200, 64, False), (200, 64, True),
                                          (5, 8, False), (24, 24, True)])
def test_chunked_matches_reference_chunked(l, chunk, init):
    """The plain chunked twin against the reference's, f32, with and
    without an initial state, L a chunk multiple or not, L below a chunk."""
    b, h, p, n = 2, 3, 16, 8
    arrays = _draw(3, b, l, h, p, n)
    s0 = (np.random.default_rng(4).normal(size=(b, h, n, p)).astype(np.float32)
          if init else None)
    y, s = tssm.ssd_chunked(*_t(arrays), chunk,
                            init_state=None if s0 is None
                            else torch.from_numpy(s0))
    jy, js = jssm.ssd_chunked(*map(jnp.asarray, arrays), chunk,
                              init_state=None if s0 is None
                              else jnp.asarray(s0))
    assert y.shape == (b, l, h, p) and s.shape == (b, h, n, p)
    _close(y, jy, CHUNKED_TOL)
    _close(s, js, CHUNKED_TOL)
    # and the chunked form against the exact recurrence, TestSSD's bound
    yr, sr = ref.ssd_scan(*_t(arrays), init_state=None if s0 is None
                          else torch.from_numpy(s0))
    _close(y, yr.numpy(), TESTSSD_TOL)
    _close(s, sr.numpy(), TESTSSD_TOL)


def test_chunked_bf16_rounds_only_y():
    """bf16 x, B, C: y in bf16, the state f32, as the reference's."""
    x, dt, a, bm, cm = _t(_draw(5, 1, 40, 2, 16, 8))
    y, s = tssm.ssd_chunked(x.bfloat16(), dt, a, bm.bfloat16(),
                            cm.bfloat16(), 16)
    yf, sf = tssm.ssd_chunked(x.bfloat16().float(), dt, a,
                              bm.bfloat16().float(), cm.bfloat16().float(), 16)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert torch.equal(y, yf.bfloat16()) and torch.equal(s, sf)


@pytest.mark.parametrize("shape", SHAPES)
def test_ops_on_cpu_is_the_plain_version(shape):
    """``ops.ssd_scan`` on CPU tensors: the exact recurrence, bit for bit,
    whatever the chunk, no launch counted."""
    b, l, h, p, n, chunk = shape
    args = _t(_draw(6, b, l, h, p, n))
    before = ops.LAUNCHES
    y, s = ops.ssd_scan(*args, chunk=chunk)
    yr, sr = ref.ssd_scan(*args)
    assert torch.equal(y, yr) and torch.equal(s, sr)
    assert ops.LAUNCHES == before


def test_decode_step_matches_reference():
    """One recurrence step of the decode path against the reference's."""
    rng = np.random.default_rng(7)
    f = np.float32
    state = rng.normal(size=(2, 3, 8, 16)).astype(f)
    xt = rng.normal(size=(2, 3, 16)).astype(f)
    dtt = rng.uniform(0.001, 0.1, size=(2, 3)).astype(f)
    a = (-rng.uniform(0.5, 2.0, size=(3,))).astype(f)
    bt, ct = (rng.normal(size=(2, 8)).astype(f) for _ in range(2))
    y, s = tssm.ssd_decode_step(*_t((state, xt, dtt, a, bt, ct)))
    jy, js = jssm.ssd_decode_step(*map(jnp.asarray,
                                       (state, xt, dtt, a, bt, ct)))
    _close(y, jy, CHUNKED_TOL)
    _close(s, js, CHUNKED_TOL)


@pytest.mark.parametrize("l", [1, 2, 3, 10])
def test_causal_conv_and_tail_match_reference(l):
    """The depthwise causal conv as ``conv1d`` against ``conv_general_
    dilated``, and the conv decode step; the tail of a prompt shorter than
    W − 1 is zero-padded in front, as the conv pads it."""
    rng = np.random.default_rng(8)
    f = np.float32
    x = rng.normal(size=(2, l, 6)).astype(f)
    w = rng.normal(size=(4, 6)).astype(f)
    b = rng.normal(size=(6,)).astype(f)
    got = tssm.causal_conv(*_t((x, w, b)))
    _close(got, jssm.causal_conv(*map(jnp.asarray, (x, w, b))), CHUNKED_TOL)
    assert got.is_contiguous()
    tail = tssm.conv_tail(torch.from_numpy(x), 4)
    padded = np.concatenate([np.zeros((2, 3, 6), f), x], axis=1)[:, -3:]
    np.testing.assert_array_equal(tail.numpy(), padded)
    xt = rng.normal(size=(2, 6)).astype(f)
    yt, cache = tssm.conv_decode_step(*_t((padded, xt, w, b)))
    jyt, jcache = jssm.conv_decode_step(*map(jnp.asarray,
                                             (padded, xt, w, b)))
    _close(yt, jyt, CHUNKED_TOL)
    _close(cache, jcache, CHUNKED_TOL)
    # the decode step on the tail continues the conv of the whole sequence
    whole = tssm.causal_conv(torch.from_numpy(np.concatenate(
        [x, xt[:, None]], axis=1)), *_t((w, b)))
    _close(yt, whole[:, -1].numpy(), CHUNKED_TOL)
