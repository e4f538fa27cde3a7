"""The flash-attention kernel's wrapper and, on a card, the CUDA kernel
against its plain version. No JAX here, so the card tests run where JAX is
absent:

    PYTHONPATH=src python -m pytest -q tests/test_torch_flash_cuda.py

Without a card the kernel tests skip; the wrapper's CPU dispatch and checks,
the dispatch rule (``ops.kernel_for``) and an emulation of the bf16
tensor-core kernel's arithmetic run anywhere (the split-TF32 kernel's is
emulated in ``tests/test_torch_flash_tc32.py``, against the reference).
Bounds: rtol 1e-4 / atol 2e-5 in f32, the
reference's ``TestFlashAttention`` bound (the kernel sums in another order
than the plain version's products). In bf16 both compute in f32 and round
only the output, so they differ by a rounding flip: rtol 2**-7 (at least one
bf16 ulp of any value) / atol 1e-4 (near zero, where the two f32 sums differ
by ~1e-7). SDPA, which rounds the probabilities to bf16, fails that limit;
the tensor-core kernel, whose products take bf16 operands, keeps the
probabilities as two bf16 parts (P_hi + P_lo) to pass it.
"""
import ctypes
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import nvcc
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


# bf16 cases of the tensor-core kernel: the two serving prefills (smollm-360m
# and zamba2-1.2b), ragged S/T, GQA groups 1, 3 and 4, causal ∪ prefix and
# non-causal prefix, and dh 32, 64, 96, 128 and 256
TC_CASES = [
    (4, 1920, 1920, 15, 5, 64, True, 0),
    (4, 1920, 1920, 32, 32, 64, True, 0),
    (1, 200, 300, 4, 2, 64, False, 0),
    (1, 1000, 1000, 6, 2, 64, True, 0),
    (2, 256, 256, 8, 8, 64, True, 0),
    (1, 384, 384, 12, 4, 64, True, 0),
    (1, 300, 300, 9, 3, 64, True, 0),
    (1, 256, 256, 4, 1, 64, True, 40),
    (1, 192, 320, 4, 2, 64, False, 100),
    (1, 512, 512, 2, 2, 32, True, 0),
    (1, 70, 100, 3, 3, 96, False, 0),
    (2, 256, 256, 8, 8, 128, True, 0),
    (1, 300, 300, 4, 1, 256, True, 0),
]
BF16_TOL = dict(rtol=2 ** -7, atol=1e-4)
LOG2E = 1.4426950408889634


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


def _counts():
    return ops.LAUNCHES, ops.TC_LAUNCHES, ops.TC32_LAUNCHES


def _hold(q, k, v, causal, pref, kind, tol):
    """Two launches on the card: the kernel ``kind`` counted, the two
    bitwise equal and within ``tol`` of the plain version."""
    assert ops.kernel_for(q, k, v) == kind
    before = _counts()
    got = ops.flash_attention(q, k, v, causal=causal, prefix_len=pref)
    again = ops.flash_attention(q, k, v, causal=causal, prefix_len=pref)
    torch.cuda.synchronize()
    assert _counts() == (before[0] + 2, before[1] + 2 * (kind == "tc"),
                         before[2] + 2 * (kind == "tc32"))
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.equal(got, again)
    want = ref.flash_attention(q, k, v, causal=causal,
                               prefix_len=pref).float()
    torch.testing.assert_close(got.float(), want, **tol)
    return want


@pytest.mark.parametrize("case", TC_CASES)
def test_cuda_tc_kernel_matches_plain(cuda, case):
    """bf16 on the card: the tensor-core kernel takes every case, within
    the bf16 limit; at the main shape SDPA (bf16 probabilities) fails it."""
    b, sq, sk, h, kv, dh, causal, pref = case
    q, k, v = _inputs(sq + h + dh, b, sq, sk, h, kv, dh, torch.bfloat16,
                      cuda)
    want = _hold(q, k, v, causal, pref, "tc", BF16_TOL)
    if case == TC_CASES[0]:
        lib = torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2)
        assert not torch.allclose(lib.float(), want, **BF16_TOL)


def test_cuda_tc_kernel_reads_fused_heads(cuda):
    """bf16 q, k, v as head slices of one fused (B, S, H + 2·KV, dh)
    projection: TMA reads them in place."""
    qkv = _inputs(98, 2, 200, 200, 12, 12, 64, torch.bfloat16, cuda)[0]
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    _hold(q, k, v, True, 0, "tc", BF16_TOL)


def test_cuda_tma_unaligned_bf16_takes_simt(cuda):
    """bf16 with a row stride of 140 bytes (dh 70): TMA cannot describe
    it, so the f32 CUDA-core kernel takes it, within the same limit."""
    q, k, v = _inputs(97, 1, 130, 130, 4, 2, 70, torch.bfloat16, cuda)
    _hold(q, k, v, True, 0, "simt", BF16_TOL)


# f32 cases of the split-TF32 kernel: the three full-width f32 prefills
# (zamba2-1.2b, smollm-360m, llama32-3b), ragged S/T/dh, GQA groups 1–4 and
# 6, causal ∪ prefix and non-causal prefix, dh 32, 40, 64, 96 and 128
TC32_CASES = [
    (4, 1920, 1920, 32, 32, 64, True, 0),
    (4, 1920, 1920, 15, 5, 64, True, 0),
    (4, 1920, 1920, 24, 8, 128, True, 0),
    (1, 200, 300, 4, 2, 64, False, 0),
    (1, 1000, 1000, 6, 2, 64, True, 0),
    (1, 300, 300, 9, 3, 64, True, 0),
    (1, 256, 256, 4, 1, 64, True, 40),
    (1, 192, 320, 4, 2, 64, False, 100),
    (1, 512, 512, 2, 2, 32, True, 0),
    (1, 100, 70, 6, 2, 40, True, 0),
    (1, 70, 100, 3, 3, 96, False, 0),
    (2, 256, 256, 12, 2, 128, True, 0),
]
F32_TOL = dict(rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("case", TC32_CASES)
def test_cuda_tc32_kernel_matches_plain(cuda, case):
    """f32 on the card: the split-TF32 kernel takes every case, within the
    f32 limit, two launches bitwise equal and counted on it."""
    b, sq, sk, h, kv, dh, causal, pref = case
    q, k, v = _inputs(sq + h + dh, b, sq, sk, h, kv, dh, torch.float32, cuda)
    _hold(q, k, v, causal, pref, "tc32", F32_TOL)


def test_cuda_tc32_kernel_reads_fused_heads(cuda):
    """f32 q, k, v as head slices of one fused (B, S, H + 2·KV, dh)
    projection: TMA reads them in place."""
    qkv = _inputs(96, 2, 200, 200, 12, 12, 64, torch.float32, cuda)[0]
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    _hold(q, k, v, True, 0, "tc32", F32_TOL)


def test_cuda_unaligned_f32_takes_simt(cuda):
    """f32 q 4 bytes into a fused projection, and f32 at dh 200: the CUDA-
    core kernel takes both, within the f32 limit; ``run_kernel`` runs it on
    inputs the split-TF32 kernel would take, and refuses the tensor-core
    kernels for inputs they do not take."""
    qkv = _inputs(95, 1, 130, 130, 1, 1, 8 * 64 + 1, torch.float32,
                  cuda)[0][:, :, 0]
    heads = qkv[..., 1:].unflatten(-1, (8, 64))
    _hold(heads[:, :, :4], heads[:, :, 4:6], heads[:, :, 6:], True, 0,
          "simt", F32_TOL)
    q, k, v = _inputs(94, 1, 100, 70, 4, 2, 200, torch.float32, cuda)
    _hold(q, k, v, True, 0, "simt", F32_TOL)
    q, k, v = _inputs(93, 1, 128, 128, 4, 2, 64, torch.float32, cuda)
    before = _counts()
    got = ops.run_kernel("simt", q, k, v)
    assert _counts() == (before[0] + 1, before[1], before[2])
    torch.testing.assert_close(got, ref.flash_attention(q, k, v), **F32_TOL)
    for kind in ("tc", "nope"):
        with pytest.raises(ValueError):
            ops.run_kernel(kind, q, k, v)


def _variants():
    """``scripts/flash_tc32_variants.py`` as a module: its variants of the
    split-TF32 kernel and its scans of their machine code."""
    path = Path(__file__).resolve().parents[1] / "scripts" / \
        "flash_tc32_variants.py"
    spec = importlib.util.spec_from_file_location("flash_tc32_variants",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _sass(lib):
    cuobjdump = Path(nvcc.nvcc_path()).parent / "cuobjdump"
    return subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout


def test_cuda_tc32_fragments_survive_the_kv_loop(cuda, tmp_path):
    """The split-TF32 kernel as this machine's nvcc builds it keeps its
    wgmma register operands: none is touched while its wgmma is in flight,
    and no A fragment held across the KV loop (Q_lo) is overwritten later
    in the loop. A build that breaks the second rule is wrong: ptxas did so
    in the 64-key-tile build at dh 64 (``bk64`` of the variants script),
    whose every KV tile after the first then read P's lo parts as three of
    the eight Q_lo slices. The scan is held to the numbers: that build
    misses the f32 limit exactly when the scan finds the clobber in it."""
    variants = _variants()
    shipped = _sass(nvcc.build("flash_attention_tc32", [ops.TC32_SOURCE]))
    assert variants.wgmma_hazards(shipped)[0] == []
    assert variants.loop_clobbers(shipped) == []
    src = tmp_path / "tc32_bk64.cu"
    src.write_text(variants.variant_source(ops.TC32_SOURCE.read_text(),
                                           "bk64"))
    lib = tmp_path / "tc32_bk64.so"
    variants._nvcc(src, lib)
    clobbered = any("fwdILi64ELi2E" in func
                    for func, *_ in variants.loop_clobbers(_sass(lib)))
    fn = ctypes.CDLL(str(lib)).flash_attention_tc32_fwd
    fn.argtypes = ops._ARGS + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    q, k, v = _inputs(91, 1, 128, 128, 4, 1, 64, torch.float32, cuda)
    out = torch.empty_like(q)
    err = fn(q.data_ptr(), *q.stride()[:3], k.data_ptr(), *k.stride()[:3],
             v.data_ptr(), *v.stride()[:3], out.data_ptr(), 1, 128, 128, 4,
             1, 64, 1, 32, 64 ** -0.5, torch.cuda.current_stream().cuda_stream)
    assert err == 0
    want = ref.flash_attention(q, k, v, causal=True, prefix_len=32)
    assert torch.allclose(out, want, **F32_TOL) != clobbered


# ---------------------------------------------------------------------------
# the dispatch rule and the tensor-core kernel's arithmetic, on the CPU
# ---------------------------------------------------------------------------

def _bf16(shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _offset(t, elems):
    """``t``'s shape and strides, ``elems`` elements into a larger buffer."""
    buf = torch.zeros(t.numel() + elems, dtype=t.dtype)
    return buf.as_strided(t.shape, t.stride(), elems)


_FUSED = _bf16((2, 16, 8, 64))
_FUSED32 = torch.zeros(2, 16, 8 * 64 + 4)
_KERNEL_FOR = [
    ("f32", [torch.zeros(1, 8, 4, 64), torch.zeros(1, 8, 2, 64),
             torch.zeros(1, 8, 2, 64)], "tc32"),
    ("f32 dh 128", [torch.zeros(1, 8, 6, 128), torch.zeros(1, 8, 2, 128),
                    torch.zeros(1, 8, 2, 128)], "tc32"),
    ("f32 dh 4", [torch.zeros(1, 8, 2, 4), torch.zeros(1, 8, 2, 4),
                  torch.zeros(1, 8, 2, 4)], "tc32"),
    ("f32 fused heads", [_FUSED32[..., :512].unflatten(-1, (8, 64))[:, :, :4],
                         _FUSED32[..., :512].unflatten(-1, (8, 64))[:, :, 4:6],
                         _FUSED32[..., :512].unflatten(-1, (8, 64))[:, :, 6:]],
     "tc32"),
    ("f32 fused heads 4 bytes in", [
        _FUSED32[..., 1:513].unflatten(-1, (8, 64))[:, :, :4],
        _FUSED32[..., 1:513].unflatten(-1, (8, 64))[:, :, 4:6],
        _FUSED32[..., 1:513].unflatten(-1, (8, 64))[:, :, 6:]], "simt"),
    ("f32 dh 70: 280-byte rows", [torch.zeros(1, 8, 4, 70),
                                  torch.zeros(1, 8, 2, 70),
                                  torch.zeros(1, 8, 2, 70)], "simt"),
    ("f32 dh 200", [torch.zeros(1, 8, 4, 200), torch.zeros(1, 8, 2, 200),
                    torch.zeros(1, 8, 2, 200)], "simt"),
    ("f32 k base off by 4 bytes", [torch.zeros(1, 8, 4, 64),
                                   _offset(torch.zeros(1, 8, 2, 64), 1),
                                   torch.zeros(1, 8, 2, 64)], "simt"),
    ("bf16 contiguous", [_bf16((1, 8, 4, 64)), _bf16((1, 8, 2, 64)),
                         _bf16((1, 8, 2, 64))], "tc"),
    ("bf16 dh 32", [_bf16((2, 8, 4, 32)), _bf16((2, 8, 4, 32)),
                    _bf16((2, 8, 4, 32))], "tc"),
    ("bf16 fused heads", [_FUSED[:, :, :4], _FUSED[:, :, 4:6],
                          _FUSED[:, :, 6:]], "tc"),
    ("bf16 heads-first view", [_bf16((1, 4, 8, 64)).transpose(1, 2),
                               _bf16((1, 2, 8, 64)).transpose(1, 2),
                               _bf16((1, 2, 8, 64)).transpose(1, 2)], "tc"),
    ("bf16 dh 70: 140-byte rows", [_bf16((1, 8, 4, 70)),
                                   _bf16((1, 8, 2, 70)),
                                   _bf16((1, 8, 2, 70))], "simt"),
    ("bf16 q base off by one element", [_offset(_bf16((1, 8, 4, 64)), 1),
                                        _bf16((1, 8, 2, 64)),
                                        _bf16((1, 8, 2, 64))], "simt"),
    ("bf16 v base off by 8 bytes", [_bf16((1, 8, 4, 64)),
                                    _bf16((1, 8, 2, 64)),
                                    _offset(_bf16((1, 8, 2, 64)), 4)],
     "simt"),
    ("bf16 k rows 264 bytes apart", [
        _bf16((1, 8, 4, 64)), _bf16((1, 8, 132))[:, :, :128]
        .unflatten(-1, (2, 64)), _bf16((1, 8, 2, 64))], "simt"),
]


@pytest.mark.parametrize("qkv,kind", [c[1:] for c in _KERNEL_FOR],
                         ids=[c[0] for c in _KERNEL_FOR])
def test_kernel_for(qkv, kind):
    """The dispatch rule: inputs whose strides and bases TMA can describe
    (multiples of 16 bytes) go to the bf16 tensor-core kernel in bf16 and
    to the split-TF32 one in f32 up to dh 128; everything else to the
    CUDA-core one."""
    assert ops.kernel_for(*qkv) == kind


@pytest.mark.parametrize("dh,width,keys", [
    (1, 32, 64), (4, 32, 64), (8, 32, 64), (31, 32, 64), (32, 32, 64),
    (33, 64, 32), (40, 64, 32), (64, 64, 32), (96, 128, 32),
    (128, 128, 32)])
def test_tc32_tiles(dh, width, keys):
    """The split-TF32 kernel's tiles: dh padded to 32, 64 or 128, KV tiles
    of 64 keys at width 32 and 32 otherwise, never as wide as the operand
    tiles."""
    assert ops.tc32_tiles(dh) == (width, keys)
    assert keys != width


def _emulate(q, k, v, causal, prefix_len, probs, bk=128):
    """The tensor-core kernel's arithmetic in plain PyTorch: S from bf16
    q, k in f32 (exact products), scale and log2(e) in one multiply, an
    online softmax over KV tiles of ``bk`` keys with exp2, l summed from
    the f32 p, and P·V with P as ``probs`` says: "f32", one "bf16"
    rounding, or "split" P_hi + P_lo; the output o / max(l, 1e-30) in q's
    dtype."""
    b, s, h, dh = q.shape
    t, group = k.shape[1], h // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.float().transpose(1, 2).repeat_interleave(group, 1)
    vf = v.float().transpose(1, 2).repeat_interleave(group, 1)
    vis = ref.visible(s, t, causal, prefix_len)
    m = torch.full((b, h, s, 1), ref.NEG_INF)
    l = torch.zeros(b, h, s, 1)
    o = torch.zeros(b, h, s, dh)
    for k0 in range(0, t, bk):
        sc = qf @ kf[:, :, k0:k0 + bk].transpose(-1, -2)
        sc = torch.where(vis[:, k0:k0 + bk], sc * (LOG2E / dh ** 0.5),
                         torch.tensor(ref.NEG_INF))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        m = m_new
        p = torch.exp2(sc - m)
        l = l * corr + p.sum(-1, keepdim=True)
        vt = vf[:, :, k0:k0 + bk]
        if probs == "f32":
            pv = p @ vt
        elif probs == "bf16":
            pv = p.bfloat16().float() @ vt
        else:
            hi = p.bfloat16().float()
            pv = hi @ vt + (p - hi).bfloat16().float() @ vt
        o = o * corr + pv
    return (o / l.clamp_min(1e-30)).to(q.dtype).transpose(1, 2)


EMULATED = [(1, 256, 256, 4, 2, 64, True, 0),
            (2, 128, 128, 4, 2, 64, True, 0),
            (1, 200, 300, 4, 2, 64, False, 0),
            (1, 256, 256, 4, 1, 64, True, 40)]


@pytest.mark.parametrize("probs,passes", [("f32", True), ("split", True),
                                          ("bf16", False)])
@pytest.mark.parametrize("case", EMULATED)
def test_split_probabilities_hold_the_bf16_limit(case, probs, passes):
    """Against the plain f32 version: f32 p and split P_hi + P_lo pass the
    bf16 limit; one bf16 rounding of P (SDPA's, a plain FA2/FA3 kernel's)
    fails it, so the limit can tell the two apart."""
    b, sq, sk, h, kv, dh, causal, pref = case
    q, k, v = _inputs(sq + sk + pref, b, sq, sk, h, kv, dh, torch.bfloat16)
    want = ref.flash_attention(q, k, v, causal=causal,
                               prefix_len=pref).float()
    got = _emulate(q, k, v, causal, pref, probs).float()
    assert torch.allclose(got, want, **BF16_TOL) == passes
