"""The flash-attention kernel's wrapper and, on a card, the CUDA kernel
against its plain version. No JAX here, so the card tests run where JAX is
absent:

    PYTHONPATH=src python -m pytest -q tests/test_torch_flash_cuda.py

Without a card the kernel tests skip; the wrapper's CPU dispatch and checks
run anywhere. Bounds: rtol 1e-4 / atol 2e-5 in f32, the reference's
``TestFlashAttention`` bound (the kernel sums in another order than the
plain version's products). In bf16 both compute in f32 and round only the
output, so they differ by a rounding flip: rtol 2**-7 (at least one bf16
ulp of any value) / atol 1e-4 (near zero, where the two f32 sums differ by
~1e-7). SDPA, which rounds the probabilities to bf16, fails that limit.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ops, ref

torch.set_num_threads(1)

# tests/test_kernels.py::TestFlashAttention's shapes and its bf16 case, the
# non-causal prefix mode, a ragged dh at each kernel width, and the
# serving path's prefill (smollm-360m at 1,920 tokens, bf16)
CASES = [
    (1, 128, 128, 4, 2, 64, True, 0, torch.float32),
    (2, 256, 256, 8, 8, 128, True, 0, torch.float32),
    (1, 200, 200, 6, 2, 64, True, 0, torch.float32),
    (1, 128, 128, 4, 1, 64, True, 32, torch.float32),
    (2, 64, 300, 4, 4, 64, False, 0, torch.float32),
    (1, 512, 512, 2, 2, 32, True, 0, torch.float32),
    (1, 128, 128, 4, 2, 64, True, 0, torch.bfloat16),
    (1, 64, 256, 4, 2, 64, False, 50, torch.float32),
    (1, 100, 70, 4, 2, 200, True, 0, torch.float32),
    (1, 70, 100, 3, 3, 96, False, 0, torch.bfloat16),
    (4, 1920, 1920, 15, 5, 64, True, 0, torch.bfloat16),
]


def _inputs(seed, b, sq, sk, h, kv, dh, dtype=torch.float32, device="cpu"):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 .to(device, dtype)
                 for s in ((b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash-attention kernel has no "
                    "CPU mode")
    return torch.device("cuda")


def test_cpu_path_never_builds_or_counts():
    """A CPU tensor takes the plain version: no build, no launch counted."""
    q, k, v = _inputs(0, 2, 16, 16, 4, 2, 8)
    before, lib = ops.LAUNCHES, ops._LIB
    out = ops.flash_attention(q, k, v)
    assert out.shape == q.shape
    torch.testing.assert_close(out, ref.flash_attention(q, k, v))
    assert ops.LAUNCHES == before
    assert ops._LIB is lib


def test_modules_import_without_nvcc(tmp_path):
    """Importing the serving path builds nothing: with no nvcc on PATH or
    under CUDA_HOME the modules import and only a build would raise."""
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path),
               PYTHONPATH=src)
    code = ("import repro_torch.launch.serve, "
            "repro_torch.kernels.flash_attention.ops\n"
            "from repro_torch.kernels import nvcc\n"
            "try:\n    nvcc.nvcc_path()\nexcept RuntimeError:\n"
            "    print('no nvcc')\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "no nvcc"


@pytest.mark.parametrize("q_shape,k_shape,v_shape", [
    ((1, 8, 4, 16), (1, 8, 2, 16), (1, 9, 2, 16)),    # k and v differ
    ((1, 8, 4, 16), (1, 8, 3, 16), (1, 8, 3, 16)),    # H not a multiple of KV
    ((1, 8, 4, 16, 1), (1, 8, 2, 16), (1, 8, 2, 16)),  # rank
    ((1, 8, 2, 257), (1, 8, 2, 257), (1, 8, 2, 257)),  # head_dim > 256
    ((1, 8, 2, 16), (1, 0, 2, 16), (1, 0, 2, 16)),    # no keys
])
def test_wrapper_rejects_bad_shapes(q_shape, k_shape, v_shape):
    with pytest.raises(ValueError):
        ops.flash_attention(torch.zeros(q_shape), torch.zeros(k_shape),
                            torch.zeros(v_shape))


def test_wrapper_rejects_bad_strides_and_prefix():
    q, k, v = _inputs(1, 1, 8, 8, 2, 2, 16)
    with pytest.raises(ValueError):
        ops.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                            k, v)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, prefix_len=-1)
    with pytest.raises(TypeError):
        ops.flash_attention(q.double(), k.double(), v.double())


def test_cuda_kernel_matches_plain(cuda):
    """On the card: the kernel against the plain version at every case;
    bitwise repeatable; one launch counted per call; strided (non
    contiguous) q, k and v read in place."""
    for i, (b, sq, sk, h, kv, dh, causal, pref, dtype) in enumerate(CASES):
        q, k, v = _inputs(i, b, sq, sk, h, kv, dh, dtype, cuda)
        before = ops.LAUNCHES
        got = ops.flash_attention(q, k, v, causal=causal, prefix_len=pref)
        again = ops.flash_attention(q, k, v, causal=causal, prefix_len=pref)
        torch.cuda.synchronize()
        assert ops.LAUNCHES == before + 2
        assert got.dtype == dtype and got.shape == q.shape
        assert torch.equal(got, again)
        tol = (dict(rtol=1e-4, atol=2e-5) if dtype == torch.float32
               else dict(rtol=2 ** -7, atol=1e-4))
        want = ref.flash_attention(q, k, v, causal=causal,
                                   prefix_len=pref).float()
        torch.testing.assert_close(got.float(), want, **tol)
        if sq == 1920:
            # the bf16 limit tells bf16 probabilities from f32 ones
            lib = torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True).transpose(1, 2)
            assert not torch.allclose(lib.float(), want, **tol)
    # q, k, v as head slices of one fused (B, S, H + 2·KV, dh) projection
    qkv = _inputs(99, 2, 80, 80, 8, 8, 64, torch.float32, cuda)[0]
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    torch.testing.assert_close(ops.flash_attention(q, k, v),
                               ref.flash_attention(q, k, v),
                               rtol=1e-4, atol=2e-5)


def test_cuda_wrapper_rejects_mixed_devices(cuda):
    q, k, v = _inputs(0, 1, 8, 8, 2, 2, 16)
    with pytest.raises(ValueError):
        ops.flash_attention(q.to(cuda), k, v)


def test_cuda_wrapper_refuses_grad(cuda):
    """The kernel writes outside autograd: a CUDA input that requires grad
    is refused under grad mode (it would silently get no gradient), and
    taken under ``torch.no_grad()``."""
    q, k, v = _inputs(0, 1, 16, 16, 2, 2, 16, torch.float32, cuda)
    for t in (q, k, v):
        t.requires_grad_()
        with pytest.raises(RuntimeError, match="no gradient"):
            ops.flash_attention(q, k, v)
        with torch.no_grad():
            out = ops.flash_attention(q, k, v)
        assert out.grad_fn is None and not out.requires_grad
        t.requires_grad_(False)
