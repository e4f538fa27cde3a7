"""The port's hinge block-subgradient against the reference: the plain
version against ``repro.kernels.hinge.ref`` and the Pallas kernel (interpret
mode on the CPU) and the batched forms against ``jax.vmap`` of the
reference. The wrapper's dispatch and the CUDA kernel itself are held in
``test_torch_hinge_cuda.py``, which imports no JAX.

Bounds are ``tests/test_kernels.py::TestHinge``'s: rtol 1e-4 / atol 1e-5.
The sums are taken in other orders than XLA's, so a margin within rounding
of the hinge kink could flip; with normal data none lies that close.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.hinge import ops as jops
from repro.kernels.hinge import ref as jref
from repro_torch.kernels.hinge import ops, ref

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
SHAPES = [(8, 8), (100, 22), (257, 254), (512, 2000), (64, 128), (33, 7)]
CASES = [(n, d, 1.0) for n, d in SHAPES] + [(64, 16, c) for c in (0.1, 1.0, 10.0)]


def _inputs(seed, *shape_x, w_shape=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape_x).astype(np.float32)
    y = np.where(rng.random(shape_x[:-1]) > 0.5, 1.0, -1.0).astype(np.float32)
    w = rng.normal(size=w_shape or shape_x[-1:]).astype(np.float32)
    return w, x, y


@pytest.mark.parametrize("n,d,c", CASES)
def test_plain_matches_reference_and_pallas(n, d, c):
    w, x, y = _inputs(n * 1000 + d, n, d)
    got = ops.hinge_block_grad(torch.from_numpy(w), torch.from_numpy(x),
                               torch.from_numpy(y), c).numpy()
    want = np.asarray(jref.hinge_block_grad(jnp.asarray(w), jnp.asarray(x),
                                            jnp.asarray(y), c))
    pallas = np.asarray(jops.hinge_block_grad(jnp.asarray(w), jnp.asarray(x),
                                              jnp.asarray(y), c))
    assert got.shape == (d,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k,n,d", [(3, 17, 10), (4, 64, 254), (2, 33, 7)])
@pytest.mark.parametrize("shared_w", [True, False])
def test_batched_matches_vmap(k, n, d, shared_w):
    w, x, y = _inputs(k + n + d, k, n, d, w_shape=(d,) if shared_w else (k, d))
    got = ref.hinge_block_grad(torch.from_numpy(w), torch.from_numpy(x),
                               torch.from_numpy(y), 0.7).numpy()
    in_axes = (None if shared_w else 0, 0, 0)
    want = np.asarray(jax.vmap(lambda ww, xx, yy: jref.hinge_block_grad(
        ww, xx, yy, 0.7), in_axes=in_axes)(jnp.asarray(w), jnp.asarray(x),
                                          jnp.asarray(y)))
    assert got.shape == (k, d)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
