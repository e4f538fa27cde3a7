"""The cluster hinge kernel (``repro_torch/kernels/hinge/csrc/hinge_cluster.cu``)
on the CPU: its dispatch rule (``ops.kernel_for``), its plan
(``ops.cluster_plan``) and a float32 emulation of its summation order, held
to the reference (``repro.kernels.hinge.ref``) and to the Pallas kernel in
interpret mode.

The emulation follows the kernel: each worker's rows split into contiguous
runs, one a CTA of the cluster (``cluster_plan``); thread t owns the float4
columns q = t + 256·j, j < 2 (the kernel takes d % 4 == 0; the emulation
pads other rows with zero columns, which add nothing); a row's margin is
each thread's share (its columns in j, then component order), an
xor-shuffle tree within each warp of 32 threads, then the 8 warps' sums in
warp order; the coefficient y·1{1 − y·m > 0} times the
row is added to the CTA's column sums in row order (the stages hold
consecutive rows, so stage order is row order); the cluster adds the CTAs'
sums in rank order and writes w − (C·Σ)/n. The kernel contracts each step
into an FMA; the emulation rounds the product and the sum apart, one
rounding a step either way.

Bound: rtol 1e-4 / atol 1e-5, ``tests/test_kernels.py::TestHinge``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.hinge import ops as jops
from repro.kernels.hinge import ref as jref
from repro_torch.kernels.hinge import ops

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
THREADS, WARP, QUADS = 256, 32, 2
TEST_HINGE = [(n, d, 1.0) for n, d in [(8, 8), (100, 22), (257, 254),
                                       (512, 2000), (64, 128), (33, 7)]]
TEST_HINGE += [(64, 16, c) for c in (0.1, 1.0, 10.0)]
# (K, n, d): test_torch_hinge.py's batched shapes, then the main paths'
# blocks: epsilon dms (K=32, block 64) and webspam dms (K=8, block 64)
BATCHED = [(3, 17, 10), (4, 64, 254), (2, 33, 7), (32, 64, 2000),
           (8, 64, 254)]


def _inputs(seed, *shape_x, w_shape=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape_x).astype(np.float32)
    y = np.where(rng.random(shape_x[:-1]) > 0.5, 1.0, -1.0).astype(np.float32)
    w = rng.normal(size=w_shape or shape_x[-1:]).astype(np.float32)
    return w, x, y


def emulate(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
            c: float) -> torch.Tensor:
    """The cluster kernel's arithmetic in its order, float32. x ``(K, n,
    d)``, y ``(K, n)``, w ``(d,)`` or ``(K, d)`` → ``(K, d)``."""
    k, n, d = x.shape
    g, rows, _, _ = ops.cluster_plan(n, d)
    cols = 4 * THREADS * QUADS
    assert d <= cols
    # zero-padded to every thread's float4 columns: (K, n, j, thread, 4)
    xq = F.pad(x, (0, cols - d)).reshape(k, n, QUADS, THREADS, 4)
    wq = F.pad(w.expand(k, d), (0, cols - d)).reshape(k, 1, QUADS, THREADS, 4)
    part = torch.zeros(k, n, THREADS)
    for j in range(QUADS):
        for e in range(4):
            part = part + xq[..., j, :, e] * wq[..., j, :, e]
    lanes = part.reshape(k, n, THREADS // WARP, WARP)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes[..., :off] + lanes[..., off:2 * off]
    warps = lanes[..., 0]
    m = warps[..., 0]
    for v in range(1, THREADS // WARP):
        m = m + warps[..., v]
    coef = torch.where(1.0 - y * m > 0, y, torch.zeros_like(y))
    # CTA r sums its rows r·rows … in order
    acc = torch.zeros(k, g, d)
    for i in range(rows):
        idx = [r * rows + i for r in range(g)]
        live = [r for r, row in enumerate(idx) if row < n]
        if not live:
            break
        rr = torch.tensor([idx[r] for r in live])
        acc[:, live] = acc[:, live] + coef[:, rr, None] * x[:, rr]
    total = acc[:, 0]
    for r in range(1, g):
        total = total + acc[:, r]
    return w - (c * total) / n


def _reference(w, x, y, c, shared):
    """(plain JAX reference, Pallas interpret) for (K, n, d) numpy inputs."""
    axes = (None if shared else 0, 0, 0)
    args = tuple(jnp.asarray(a) for a in (w, x, y))
    want = jax.vmap(lambda a, b, e: jref.hinge_block_grad(a, b, e, c),
                    in_axes=axes)(*args)
    pallas = jax.vmap(lambda a, b, e: jops.hinge_block_grad(a, b, e, c),
                      in_axes=axes)(*args)
    return np.asarray(want), np.asarray(pallas)


@pytest.mark.parametrize("n,d,c", TEST_HINGE)
def test_emulated_order_matches_reference_and_pallas(n, d, c):
    w, x, y = _inputs(n * 1000 + d, n, d)
    got = emulate(torch.from_numpy(w), torch.from_numpy(x)[None],
                  torch.from_numpy(y)[None], c)[0].numpy()
    want, pallas = _reference(w, x[None], y[None], c, True)
    np.testing.assert_allclose(got, want[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, pallas[0], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k,n,d", BATCHED)
@pytest.mark.parametrize("shared_w", [True, False])
def test_emulated_order_batched(k, n, d, shared_w):
    w, x, y = _inputs(k + n + d, k, n, d, w_shape=(d,) if shared_w else (k, d))
    got = emulate(torch.from_numpy(w), torch.from_numpy(x),
                  torch.from_numpy(y), 0.7).numpy()
    want, pallas = _reference(w, x, y, 0.7, shared_w)
    assert got.shape == (k, d)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, pallas, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("n,d,plan", [
    (64, 2000, (8, 8, 4, 1)),     # epsilon block: 2 stages of 32 KB
    (512, 2000, (8, 64, 4, 1)),   # 16 stages, one in flight
    (64, 1000, (8, 8, 4, 2)),     # 16 KB stages, both in flight
    (64, 16, (8, 8, 4, 2)),       # TestHinge's C cases
    (512, 16, (8, 64, 4, 4)),     # 16 stages through the 4-stage ring
    (33, 8, (7, 5, 4, 2)),        # 7 runs of 5 rows, the last of 3
    (8, 8, (8, 1, 1, 1)),
    (3, 12, (3, 1, 1, 1)),        # fewer rows than the cluster limit
    (64, 2048, (8, 8, 4, 1)),     # the widest row the cluster kernel takes
    (64, 4000, None),             # wider: hinge.cu
])
def test_cluster_plan(n, d, plan):
    if plan is None:
        assert d > ops.MAX_CLUSTER_COLS
        return
    assert ops.cluster_plan(n, d) == plan
    g, rows, stage_rows, slots = plan
    assert g <= ops.CLUSTER and (g - 1) * rows < n <= g * rows
    assert stage_rows <= ops.MAX_STAGE_ROWS
    assert slots <= ops.MAX_SLOTS and slots <= -(-rows // stage_rows)
    assert slots * stage_rows * 4 * d <= ops.RING_BYTES


def _epsilon_block():
    """Block 1 of the epsilon dms path as svm.py views it (xs (K, n_local,
    d) → xb (K, nb, bs, d), block xb[:, 1]), with a remainder past the last
    block as the real n_local = 12,500 = 195·64 + 20 has."""
    xs = torch.empty(32, 3 * 64 + 20, 2000)
    return xs[:, :192].reshape(32, 3, 64, 2000)[:, 1]


def _webspam_block():
    """The same for webspam (K=8, n_local = 43,750 = 683·64 + 38)."""
    xs = torch.empty(8, 3 * 64 + 38, 254)
    return xs[:, :192].reshape(8, 3, 64, 254)[:, 2]


# name → (w, x) built at the test's run, and the route
ROUTES = {
    "epsilon shared w": (
        lambda: (torch.empty(2000), _epsilon_block()), "cluster"),
    "epsilon per-worker w": (
        lambda: (torch.empty(32, 2000), _epsilon_block()), "cluster"),
    "epsilon delayed stride-0 w": (
        lambda: (torch.empty(2000).expand(32, 2000), _epsilon_block()),
        "cluster"),
    "TestHinge n=64 d=16": (
        lambda: (torch.empty(16), torch.empty(64, 16)), "cluster"),
    "webspam shared w (d % 4 != 0)": (
        lambda: (torch.empty(254), _webspam_block()), "simt"),
    "webspam chunked carry w[:, :254]": (
        lambda: (torch.empty(8, 256)[:, :254], _webspam_block()), "simt"),
    "srdms ijcnn1 (512, 22)": (
        lambda: (torch.empty(22), torch.empty(512, 22)), "simt"),
    "x base 4 bytes off": (
        lambda: (torch.empty(16), torch.empty(64 * 16 + 1)[1:].view(64, 16)),
        "simt"),
    "w base 4 bytes off": (
        lambda: (torch.empty(17)[1:], torch.empty(64, 16)), "simt"),
    "x worker stride 129 floats": (
        lambda: (torch.empty(16), torch.empty(4 * 129).as_strided(
            (4, 8, 16), (129, 16, 1))), "simt"),
    "w worker stride 17 floats": (
        lambda: (torch.empty(4 * 17).as_strided((4, 16), (17, 1)),
                 torch.empty(4, 8, 16)), "simt"),
    "float64": (
        lambda: (torch.empty(16, dtype=torch.float64),
                 torch.empty(64, 16, dtype=torch.float64)), "simt"),
    "widest cluster row d=2048": (
        lambda: (torch.empty(2048), torch.empty(2, 8, 2048)), "cluster"),
    "too wide for the registers d=2052": (
        lambda: (torch.empty(2052), torch.empty(2, 8, 2052)), "simt"),
    "too wide d=20000": (
        lambda: (torch.empty(20000), torch.empty(8, 20000)), "simt"),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_kernel_for_routes(name):
    make, route = ROUTES[name]
    w, x = make()
    assert ops.kernel_for(w, x, torch.empty(x.shape[:-1])) == route
