"""The SSD kernel's wrapper and, on a card, the CUDA kernel against its plain
versions. No JAX here, so the card tests run where JAX is absent:

    PYTHONPATH=src python -m pytest -q tests/test_torch_ssd_cuda.py

Without a card the kernel tests skip; the wrapper's CPU dispatch and checks
run anywhere. Bounds: in f32, rtol 1e-3 / atol 2e-4 against the exact
recurrence, the reference's ``TestSSD`` bound (the chunked form sums and
exponentiates in another order than the recurrence). In bf16 (x, B, C and
y; Δ, A and the state f32) the kernel is held to the plain chunked scan on
the same inputs, which also computes in f32 and rounds only y: y within
rtol 2**-7 (one bf16 ulp of any value, a rounding flip) / atol 2e-4, the
state within the f32 bound. bf16 inputs that TMA can describe take the
tensor-core kernel (``ssd_tc.cu``); it is also held to the exact recurrence
on the same bf16 inputs at the same bounds (y rtol 2**-7 / atol 2e-4, the
state rtol 1e-3 / atol 2e-4): it keeps its f32 operands as bf16 hi + lo
pairs (tests/test_torch_ssd_tc.py emulates that on the CPU).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd import ops, ref
from repro_torch.models.ssm import ssd_chunked

torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-3, atol=2e-4)
BF16_Y_TOL = dict(rtol=2 ** -7, atol=2e-4)
# tests/test_kernels.py::TestSSD's shapes (b, l, h, p, n, chunk), then a
# chunk below the 64-row tile, one chunk longer than L, L of one step, and
# a ragged N and P
SHAPES = [(1, 128, 2, 64, 128, 64), (2, 256, 4, 64, 128, 128),
          (1, 200, 2, 64, 64, 128), (1, 512, 1, 128, 128, 256),
          (2, 64, 3, 32, 16, 32),
          (1, 100, 2, 16, 8, 8), (2, 40, 3, 64, 128, 256), (1, 1, 2, 64, 64, 1),
          (1, 300, 2, 80, 100, 96)]
# the serving prefills: mamba2-2.7b and zamba2-1.2b, 4 prompts of 1,920
PREFILL = [(4, 1920, 80, 64, 128, 256), (4, 1920, 64, 64, 64, 256)]


def _inputs(seed, b, l, h, p, n, dtype=torch.float32, device="cpu"):
    """TestSSD's draws: x, B, C normal, Δ uniform in [0.001, 0.1], A in
    [−2, −0.5]; x, B, C in ``dtype``, Δ and A float32."""
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, dt)
    return (t(rng.normal(size=(b, l, h, p)), dtype),
            t(rng.uniform(0.001, 0.1, size=(b, l, h))),
            t(-rng.uniform(0.5, 2.0, size=(h,))),
            t(rng.normal(size=(b, l, n)), dtype),
            t(rng.normal(size=(b, l, n)), dtype))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the SSD kernel has no CPU mode")
    return torch.device("cuda")


def test_cpu_path_never_builds_or_counts():
    """A CPU tensor takes the plain recurrence: no build, no launch."""
    args = _inputs(0, 2, 24, 3, 8, 4)
    before, lib = ops.LAUNCHES, ops._LIB
    y, s = ops.ssd_scan(*args, chunk=8)
    yr, sr = ref.ssd_scan(*args)
    assert torch.equal(y, yr) and torch.equal(s, sr)
    assert y.shape == (2, 24, 3, 8) and s.shape == (2, 3, 4, 8)
    assert s.dtype == torch.float32
    assert ops.LAUNCHES == before and ops._LIB is lib


def test_wrapper_rejects_bad_inputs():
    x, dt, a, bm, cm = _inputs(1, 1, 16, 2, 8, 4)
    with pytest.raises(ValueError):
        ops.ssd_scan(x[0], dt, a, bm, cm)                   # x not 4-D
    with pytest.raises(ValueError):
        ops.ssd_scan(x, dt[:, :8], a, bm, cm)               # L disagrees
    with pytest.raises(ValueError):
        ops.ssd_scan(x, dt, a[:1], bm, cm)                  # H disagrees
    with pytest.raises(ValueError):
        ops.ssd_scan(x, dt, a, bm, cm[..., :3])             # N disagrees
    with pytest.raises(ValueError):
        ops.ssd_scan(x, dt, a, bm, cm, chunk=257)
    with pytest.raises(ValueError):
        ops.ssd_scan(x, dt, a, bm, cm, chunk=0)
    with pytest.raises(ValueError):
        ops.ssd_scan(*_inputs(1, 1, 16, 2, 130, 4))         # P > 128
    with pytest.raises(ValueError):
        ops.ssd_scan(x[:, :0], dt[:, :0], a, bm[:, :0], cm[:, :0])
    with pytest.raises(TypeError):
        ops.ssd_scan(x.bfloat16(), dt, a, bm, cm)           # mixed types
    with pytest.raises(TypeError):
        ops.ssd_scan(x.half(), dt, a, bm.half(), cm.half())
    with pytest.raises(TypeError):
        ops.ssd_scan(x, dt.double(), a, bm, cm)
    with pytest.raises(ValueError):
        ops.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, a,
                     bm, cm)                                 # P stride ≠ 1


def test_import_builds_nothing():
    """The module imports without nvcc: the build is at the first launch."""
    assert ops.SOURCE.is_file() and ops.SOURCE.suffix == ".cu"
    assert "ssd_scan_fwd" in ops.SOURCE.read_text()


@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_kernel_matches_recurrence(cuda, shape):
    b, l, h, p, n, chunk = shape
    args = _inputs(2, b, l, h, p, n, device=cuda)
    before = ops.LAUNCHES
    y, s = ops.ssd_scan(*args, chunk=chunk)
    y2, s2 = ops.ssd_scan(*args, chunk=chunk)
    yr, sr = ref.ssd_scan(*args)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 2
    assert y.shape == yr.shape and y.dtype == torch.float32
    assert s.shape == (b, h, n, p) and s.dtype == torch.float32
    assert torch.equal(y, y2) and torch.equal(s, s2)
    torch.testing.assert_close(y, yr, **F32_TOL)
    torch.testing.assert_close(s, sr, **F32_TOL)


@pytest.mark.parametrize("shape", SHAPES[:5] + PREFILL)
def test_cuda_kernel_bf16_matches_chunked(cuda, shape):
    """bf16 x, B, C against the plain chunked scan on the same inputs."""
    b, l, h, p, n, chunk = shape
    args = _inputs(3, b, l, h, p, n, torch.bfloat16, cuda)
    y, s = ops.ssd_scan(*args, chunk=chunk)
    y2, s2 = ops.ssd_scan(*args, chunk=chunk)
    yc, sc = ssd_chunked(*args, chunk)
    torch.cuda.synchronize()
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert torch.equal(y, y2) and torch.equal(s, s2)
    torch.testing.assert_close(y.float(), yc.float(), **BF16_Y_TOL)
    torch.testing.assert_close(s, sc, **F32_TOL)


def test_cuda_reads_strided_views(cuda):
    """x as one head group of a wider tensor, B and C as halves of one
    (B, L, 2N) projection, Δ transposed: read in place, the same result as
    contiguous copies."""
    b, l, h, p, n = 2, 150, 3, 32, 16
    x, dt, a, bm, cm = _inputs(4, b, l, 2 * h, p, n, device=cuda)
    bc = torch.cat([bm, cm], dim=-1)
    dtt = dt.transpose(1, 2).contiguous().transpose(1, 2)
    xv, dv, av = x[:, :, h:], dtt[:, :, :h], a[:h]
    bv, cv = bc[..., :n], bc[..., n:]
    y, s = ops.ssd_scan(xv, dv, av, bv, cv, chunk=64)
    yc, sc = ops.ssd_scan(xv.contiguous(), dv.contiguous(), av, bm, cm,
                          chunk=64)
    torch.cuda.synchronize()
    assert torch.equal(y, yc) and torch.equal(s, sc)


def test_cuda_refuses_grad(cuda):
    """The kernel writes outside autograd: an input that requires grad is
    refused under grad mode, accepted under no_grad."""
    x, dt, a, bm, cm = _inputs(5, 1, 32, 2, 16, 8, device=cuda)
    x.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        ops.ssd_scan(x, dt, a, bm, cm, chunk=16)
    with torch.no_grad():
        y, _ = ops.ssd_scan(x, dt, a, bm, cm, chunk=16)
    assert not y.requires_grad


def test_cuda_rejects_mixed_devices(cuda):
    x, dt, a, bm, cm = _inputs(6, 1, 16, 2, 8, 4, device=cuda)
    with pytest.raises(ValueError):
        ops.ssd_scan(x, dt.cpu(), a, bm, cm)


def _counts():
    return ops.LAUNCHES, ops.TC_LAUNCHES


@pytest.mark.parametrize("shape", SHAPES[:5] + PREFILL)
def test_cuda_tc_kernel_matches_recurrence(cuda, shape):
    """bf16 x, B, C on the tensor-core kernel against the exact recurrence
    on the same inputs; one launch counted on each counter a call; two
    launches bitwise equal."""
    b, l, h, p, n, chunk = shape
    args = _inputs(7, b, l, h, p, n, torch.bfloat16, cuda)
    assert ops.kernel_for(args[0], args[3], args[4]) == "tc"
    before = _counts()
    y, s = ops.ssd_scan(*args, chunk=chunk)
    y2, s2 = ops.ssd_scan(*args, chunk=chunk)
    yr, sr = ref.ssd_scan(*args)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 2, before[1] + 2)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert s.shape == (b, h, n, p)
    assert torch.equal(y, y2) and torch.equal(s, s2)
    torch.testing.assert_close(y.float(), yr.float(), **BF16_Y_TOL)
    torch.testing.assert_close(s, sr, **F32_TOL)


def test_cuda_f32_takes_simt_and_bf16_takes_tc(cuda):
    """f32 goes to the CUDA-core kernel (TC_LAUNCHES unmoved), bf16 to the
    tensor-core one."""
    args = _inputs(8, 1, 100, 2, 64, 64, device=cuda)
    before = _counts()
    ops.ssd_scan(*args, chunk=64)
    assert _counts() == (before[0] + 1, before[1])
    x, dt, a, bm, cm = args
    ops.ssd_scan(x.bfloat16(), dt, a, bm.bfloat16(), cm.bfloat16(), chunk=64)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 2, before[1] + 1)


def test_cuda_tc_reads_strided_views(cuda):
    """bf16 on the tensor-core kernel: x as one head group of a wider
    tensor, B and C as halves of one (B, L, 2N) projection, Δ transposed,
    read in place: the same bits as contiguous copies."""
    b, l, h, p, n = 2, 300, 3, 64, 64
    x, dt, a, bm, cm = _inputs(9, b, l, 2 * h, p, n, torch.bfloat16, cuda)
    bc = torch.cat([bm, cm], dim=-1)
    dtt = dt.transpose(1, 2).contiguous().transpose(1, 2)
    xv, dv, av = x[:, :, h:], dtt[:, :, :h], a[:h]
    bv, cv = bc[..., :n], bc[..., n:]
    assert ops.kernel_for(xv, bv, cv) == "tc"
    y, s = ops.ssd_scan(xv, dv, av, bv, cv, chunk=128)
    yc, sc = ops.ssd_scan(xv.contiguous(), dv.contiguous(), av, bm, cm,
                          chunk=128)
    torch.cuda.synchronize()
    assert torch.equal(y, yc) and torch.equal(s, sc)


def test_cuda_tc_model_conv_views(cuda):
    """The model's prefill inputs: x a (B, L, H·P) conv output viewed per
    head, B and C contiguous conv outputs, Δ from the softplus; the kernel
    against the plain chunked scan."""
    b, l, h, p, n = 2, 520, 8, 64, 128
    rng = np.random.default_rng(10)
    flat = torch.from_numpy(rng.normal(size=(b, l, h * p)).astype(
        np.float32)).to(cuda, torch.bfloat16)
    x = flat.reshape(b, l, h, p)
    _, dt, a, bm, cm = _inputs(10, b, l, h, p, n, torch.bfloat16, cuda)
    assert ops.kernel_for(x, bm, cm) == "tc"
    y, s = ops.ssd_scan(x, dt, a, bm, cm, chunk=256)
    yc, sc = ssd_chunked(x, dt, a, bm, cm, 256)
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), yc.float(), **BF16_Y_TOL)
    torch.testing.assert_close(s, sc, **F32_TOL)
