"""The hinge kernels' wrapper and, on a card, the CUDA kernels against their
plain version. No JAX here, so the card tests run where JAX is absent:

    PYTHONPATH=src python -m pytest -q tests/test_torch_hinge_cuda.py

Without a card the kernel tests skip; the wrapper's CPU dispatch, shape
checks and the plain version's matmul precision run anywhere. Bound: rtol
1e-4 / atol 1e-5, the reference's ``TestHinge`` bound (the kernels sum in
other orders than the plain version's matrix products). Float32 rows of at
most 2,048 columns with 16-byte rows, bases and worker strides take the
cluster kernel (``hinge_cluster.cu``), other rows ``hinge.cu``
(``ops.kernel_for``).
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
    before = ops.LAUNCHES, ops.CLUSTER_LAUNCHES
    libs = ops._LIB, ops._CLUSTER_LIB
    out = ops.hinge_block_grad(torch.from_numpy(w), torch.from_numpy(x),
                               torch.from_numpy(y), 1.0)
    assert out.shape == (4, 8)
    assert (ops.LAUNCHES, ops.CLUSTER_LAUNCHES) == before
    assert (ops._LIB, ops._CLUSTER_LIB) == libs


@pytest.fixture
def matmul_precision():
    before = torch.get_float32_matmul_precision()
    yield
    torch.set_float32_matmul_precision(before)


@pytest.mark.parametrize("precision", ["highest", "high", "medium"])
def test_plain_version_restores_matmul_precision(precision, matmul_precision):
    """The plain version computes its products in full float32 and leaves
    the caller's float32 matmul precision, and with it
    ``torch.backends.cuda.matmul.allow_tf32``, as it found them."""
    torch.set_float32_matmul_precision(precision)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    w, x, y = (torch.from_numpy(a) for a in _inputs(0, 4, 16, 8))
    ref.hinge_block_grad(w, x, y, 1.0)
    assert torch.get_float32_matmul_precision() == precision
    assert torch.backends.cuda.matmul.allow_tf32 == tf32


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
    """On the card: the kernels against the plain version at the TestHinge
    shapes and the batched shapes of the main path, including worker-major
    strided views; bitwise repeatable; one launch counted per call, in
    CLUSTER_LAUNCHES too where ``kernel_for`` names the cluster kernel."""
    cases = [((n, d), (d,), c) for n, d, c in CASES] + [
        ((32, 64, 2000), (2000,), 1.0), ((32, 64, 2000), (32, 2000), 1.0),
        ((8, 512, 254), (254,), 1.0)]
    for i, (x_shape, w_shape, c) in enumerate(cases):
        w, x, y = (torch.from_numpy(a).to(cuda)
                   for a in _inputs(i, *x_shape, w_shape=w_shape))
        before = ops.LAUNCHES, ops.CLUSTER_LAUNCHES
        got = ops.hinge_block_grad(w, x, y, c)
        again = ops.hinge_block_grad(w, x, y, c)
        torch.cuda.synchronize()
        cluster = 2 * (ops.kernel_for(w, x, y) == "cluster")
        assert (ops.LAUNCHES, ops.CLUSTER_LAUNCHES) == (before[0] + 2,
                                                       before[1] + cluster)
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


def _main_path_case(name, cuda):
    """(w, x, y) on the card as the SVM paths hand them to the kernel: the
    worker-major block view xb[:, 1] of (K, n_local, d) data (svm.py), with
    a shared w, a per-worker w, the delayed mode's stride-0 ``w0.expand``,
    or the chunked/gossip carry slice ``wk[:, :d]``; or srdms's block."""
    k, d, carry = {"epsilon": (32, 2000, 2000), "webspam": (8, 254, 256),
                   "ijcnn1": (1, 22, 22)}[name.split()[0]]
    rng = np.random.default_rng(len(name))
    if k == 1:      # srdms: xb[1] of (nb, 512, d)
        x = torch.from_numpy(rng.normal(size=(3, 512, d)).astype(np.float32))
        y = torch.from_numpy(np.where(rng.random((3, 512)) > 0.5, 1.0, -1.0
                                      ).astype(np.float32))
        return torch.from_numpy(rng.normal(size=d).astype(np.float32)).to(
            cuda), x.to(cuda)[1], y.to(cuda)[1]
    xs = torch.from_numpy(rng.normal(size=(k, 212, d)).astype(np.float32))
    ys = torch.from_numpy(np.where(rng.random((k, 212)) > 0.5, 1.0, -1.0
                                   ).astype(np.float32))
    x = xs.to(cuda)[:, :192].reshape(k, 3, 64, d)[:, 1]
    y = ys.to(cuda)[:, :192].reshape(k, 3, 64)[:, 1]
    wide = torch.from_numpy(rng.normal(size=(k, carry)).astype(np.float32)
                            ).to(cuda)
    kind = name.split()[1]
    w = {"shared": wide[0, :d], "per-worker": wide[:, :d].contiguous(),
         "stride-0": wide[0, :d].expand(k, d), "carry": wide[:, :d]}[kind]
    return w, x, y


MAIN_PATH = [("epsilon shared", "cluster"), ("epsilon per-worker", "cluster"),
             ("epsilon stride-0", "cluster"), ("webspam shared", "simt"),
             ("webspam per-worker", "simt"), ("webspam stride-0", "simt"),
             ("webspam carry", "simt"), ("ijcnn1 shared", "simt")]


@pytest.mark.parametrize("name,route", MAIN_PATH)
def test_cluster_kernel_on_main_path_blocks(cuda, name, route):
    """Every block the SVM paths give the kernel takes its route: epsilon's
    16-byte rows the cluster kernel, webspam's 254 and ijcnn1's 22 columns
    hinge.cu; within the bound of the plain version, two launches bitwise
    equal, each counted once (in CLUSTER_LAUNCHES too on the cluster
    route)."""
    w, x, y = _main_path_case(name, cuda)
    assert ops.kernel_for(w, x, y) == route
    before = ops.LAUNCHES, ops.CLUSTER_LAUNCHES
    got = ops.hinge_block_grad(w, x, y, 1.0)
    again = ops.hinge_block_grad(w, x, y, 1.0)
    torch.cuda.synchronize()
    cluster = 2 * (route == "cluster")
    assert (ops.LAUNCHES, ops.CLUSTER_LAUNCHES) == (before[0] + 2,
                                                   before[1] + cluster)
    assert torch.equal(got, again)
    torch.testing.assert_close(got, ref.hinge_block_grad(w, x, y, 1.0),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case,route", [
    ("x base 4 bytes off", "simt"), ("d=2048", "cluster"),
    ("rows past the ring", "cluster")])
def test_kernel_edges(cuda, case, route):
    """An x whose base lies 4 bytes past 16 (no bulk copy can move it: it
    takes hinge.cu), the widest row the cluster kernel takes, and a block
    that cycles the 2-stage ring many times with short last runs."""
    shape = {"x base 4 bytes off": (4, 64, 16), "d=2048": (2, 24, 2048),
             "rows past the ring": (2, 1001, 1000)}[case]
    w, x, y = (torch.from_numpy(a).to(cuda)
               for a in _inputs(3, *shape, w_shape=shape[:1] + shape[2:]))
    if case == "x base 4 bytes off":
        flat = torch.empty(x.numel() + 1, device=cuda)
        flat[1:] = x.reshape(-1)
        x = flat[1:].view(shape)
    assert ops.kernel_for(w, x, y) == route
    got = ops.hinge_block_grad(w, x, y, 0.5)
    torch.testing.assert_close(got, ref.hinge_block_grad(w, x, y, 0.5),
                               rtol=RTOL, atol=ATOL)


def test_simt_route_for_wide_rows_and_on_request(cuda):
    """Rows wider than the cluster kernel takes go to hinge.cu; hinge.cu
    also runs on the epsilon block through ``run_kernel("simt", ...)``;
    both within the bound, counted in LAUNCHES only; naming "cluster" for
    rows it does not take raises, before any launch."""
    w, x, y = (torch.from_numpy(a).to(cuda)
               for a in _inputs(5, 3, 40, 5000, w_shape=(5000,)))
    assert ops.kernel_for(w, x, y) == "simt"
    before = ops.LAUNCHES, ops.CLUSTER_LAUNCHES
    got = ops.hinge_block_grad(w, x, y, 1.0)
    torch.testing.assert_close(got, ref.hinge_block_grad(w, x, y, 1.0),
                               rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError):
        ops.run_kernel("cluster", w, x, y, 1.0)
    w, x, y = _main_path_case("epsilon per-worker", cuda)
    simt = ops.run_kernel("simt", w, x, y, 1.0)
    cluster = ops.hinge_block_grad(w, x, y, 1.0)
    torch.cuda.synchronize()
    assert (ops.LAUNCHES, ops.CLUSTER_LAUNCHES) == (before[0] + 3,
                                                   before[1] + 1)
    want = ref.hinge_block_grad(w, x, y, 1.0)
    torch.testing.assert_close(simt, want, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(cluster, want, rtol=RTOL, atol=ATOL)


def test_plain_version_restores_precision_on_the_card(cuda,
                                                      matmul_precision):
    torch.set_float32_matmul_precision("high")
    w, x, y = (torch.from_numpy(a).to(cuda) for a in _inputs(0, 4, 16, 8))
    ref.hinge_block_grad(w, x, y, 1.0)
    assert torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "high"
