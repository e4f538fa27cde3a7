"""The hinge kernel's wrapper and, on a card, the CUDA kernel against its
plain version. No JAX here, so the card tests run where JAX is absent:

    PYTHONPATH=src python -m pytest -q tests/test_torch_hinge_cuda.py

Without a card the kernel tests skip; the wrapper's CPU dispatch and shape
checks run anywhere. Bound: rtol 1e-4 / atol 1e-5, the reference's
``TestHinge`` bound (the kernel sums in another order than the plain
version's matrix products).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hinge kernel has no CPU mode")
    return torch.device("cuda")


def test_cpu_path_never_builds_or_counts():
    """A CPU tensor takes the plain version: no build, no launch counted."""
    w, x, y = _inputs(0, 4, 16, 8)
    before, lib = ops.LAUNCHES, ops._LIB
    out = ops.hinge_block_grad(torch.from_numpy(w), torch.from_numpy(x),
                               torch.from_numpy(y), 1.0)
    assert out.shape == (4, 8)
    assert ops.LAUNCHES == before
    assert ops._LIB is lib


def test_modules_import_without_nvcc(tmp_path):
    """Importing the port builds nothing: with no nvcc on PATH or under
    CUDA_HOME the modules import and only a build would raise."""
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               PYTHONPATH=src)
    code = ("import repro_torch.core.svm, repro_torch.kernels.hinge.ops\n"
            "from repro_torch.kernels import nvcc\n"
            "try:\n    nvcc.nvcc_path()\nexcept RuntimeError:\n"
            "    print('no nvcc')\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "no nvcc"


@pytest.mark.parametrize("w_shape,x_shape,y_shape", [
    ((8,), (16, 8), (15,)),          # y does not match x
    ((9,), (16, 8), (16,)),          # w width
    ((3, 8), (16, 8), (16,)),        # per-worker w needs batched x
    ((2, 8), (3, 16, 8), (3, 16)),   # per-worker w count
    ((8,), (16,), (16,)),            # x rank
    ((8,), (0, 8), (0,)),            # empty block
])
def test_wrapper_rejects_bad_shapes(w_shape, x_shape, y_shape):
    with pytest.raises(ValueError):
        ops.hinge_block_grad(torch.zeros(w_shape), torch.zeros(x_shape),
                             torch.zeros(y_shape), 1.0)


def test_cuda_kernel_matches_plain(cuda):
    """On the card: the kernel against the plain version at the TestHinge
    shapes and the batched shapes of the main path, including worker-major
    strided views; bitwise repeatable; one launch counted per call."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [((n, d), (d,), c) for n, d, c in CASES] + [
        ((32, 64, 2000), (2000,), 1.0), ((32, 64, 2000), (32, 2000), 1.0),
        ((8, 512, 254), (254,), 1.0)]
    for i, (x_shape, w_shape, c) in enumerate(cases):
        w, x, y = (torch.from_numpy(a).to(cuda)
                   for a in _inputs(i, *x_shape, w_shape=w_shape))
        before = ops.LAUNCHES
        got = ops.hinge_block_grad(w, x, y, c)
        again = ops.hinge_block_grad(w, x, y, c)
        torch.cuda.synchronize()
        assert ops.LAUNCHES == before + 2
        assert torch.equal(got, again)
        torch.testing.assert_close(got, ref.hinge_block_grad(w, x, y, c),
                                   rtol=RTOL, atol=ATOL)
    # worker-major view of (K, nb, bs, d) data and a w[:, :d] carry slice
    _, x, y = (torch.from_numpy(a).to(cuda) for a in _inputs(7, 4, 3, 16, 30))
    wide = torch.from_numpy(_inputs(8, 4, 1, 32, w_shape=(4, 32))[0]).to(cuda)
    xv, yv, wv = x[:, 1], y[:, 1], wide[:, :30]
    torch.testing.assert_close(ops.hinge_block_grad(wv, xv, yv, 1.0),
                               ref.hinge_block_grad(wv, xv, yv, 1.0),
                               rtol=RTOL, atol=ATOL)


def test_cuda_wrapper_rejects_float64(cuda):
    w, x, y = (torch.from_numpy(a).to(cuda, torch.float64)
               for a in _inputs(0, 16, 8))
    with pytest.raises(TypeError):
        ops.hinge_block_grad(w, x, y, 1.0)
