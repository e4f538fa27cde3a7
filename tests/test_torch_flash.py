"""The port's flash-attention plain version and wrapper
(``repro_torch.kernels.flash_attention``) against the reference's oracle
``repro.kernels.flash_attention.ref.attention`` and its Pallas kernel in
interpret mode (``ops.flash_attention``), on the CPU.

Bounds are ``tests/test_kernels.py::TestFlashAttention``'s: rtol 1e-4 /
atol 2e-5 in f32 (the same f32 softmax, summed in another order), 5e-2 in
bf16 (one bf16 rounding of the output, 2⁻⁸ relative, on values of order 1).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention import ref as jref
from repro_torch.kernels.flash_attention import ops, ref

torch.set_num_threads(1)

# tests/test_kernels.py::TestFlashAttention's shapes, and the kernel's
# non-causal prefix mode at an aligned T (the reference wrapper sets
# prefix_len = T when it pads T, so only an aligned T keeps the prefix)
SHAPES = [
    (1, 128, 128, 4, 2, 64, True, 0),
    (2, 256, 256, 8, 8, 128, True, 0),
    (1, 200, 200, 6, 2, 64, True, 0),        # unaligned seq
    (1, 128, 128, 4, 1, 64, True, 32),       # MQA + prefix-LM
    (2, 64, 300, 4, 4, 64, False, 0),        # cross attn, padded keys
    (1, 512, 512, 2, 2, 32, True, 0),        # dh below lane width
]
PREFIX_ONLY = (1, 64, 256, 4, 2, 64, False, 50)


def _inputs(seed, b, sq, sk, h, kv, dh, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32).astype(dtype)
                 for s in ((b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh)))


def _bhsd(a):
    return a.transpose(0, 2, 1, 3)


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,pref", SHAPES)
def test_plain_matches_reference_oracle(b, sq, sk, h, kv, dh, causal, pref):
    q, k, v = _inputs(sq + dh, b, sq, sk, h, kv, dh)
    want = jref.attention(*(jnp.asarray(_bhsd(a)) for a in (q, k, v)),
                          causal=causal, prefix_len=pref)
    got = ref.attention(*(torch.from_numpy(_bhsd(a)) for a in (q, k, v)),
                        causal=causal, prefix_len=pref)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal,pref",
                         SHAPES + [PREFIX_ONLY])
def test_wrapper_matches_pallas_interpret(b, sq, sk, h, kv, dh, causal, pref):
    """The wrapper on CPU tensors (the plain version, model layout) against
    the Pallas kernel run in interpret mode."""
    q, k, v = _inputs(sq + dh, b, sq, sk, h, kv, dh)
    want = jops.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                prefix_len=pref, interpret=True)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, prefix_len=pref)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=2e-5)


def test_bf16():
    q, k, v = _inputs(3, 1, 128, 128, 4, 2, 64)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    for want in (jops.flash_attention(jq, jk, jv, causal=True,
                                      interpret=True),
                 _bhsd(jref.attention(*map(_bhsd, (jq, jk, jv)),
                                      causal=True))):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("q_shape,k_shape,v_shape", [
    ((1, 8, 4, 16), (1, 8, 2, 16), (1, 8, 2, 8)),     # k and v differ
    ((1, 8, 4, 16), (2, 8, 2, 16), (2, 8, 2, 16)),    # batch
    ((1, 8, 4, 16), (1, 8, 2, 8), (1, 8, 2, 8)),      # head_dim
    ((1, 8, 4, 16), (1, 8, 3, 16), (1, 8, 3, 16)),    # H not a multiple of KV
    ((8, 4, 16), (8, 2, 16), (8, 2, 16)),             # rank
    ((1, 8, 2, 320), (1, 8, 2, 320), (1, 8, 2, 320)),  # head_dim > 256
    ((1, 0, 2, 16), (1, 8, 2, 16), (1, 8, 2, 16)),    # empty q
])
def test_wrapper_rejects_bad_shapes(q_shape, k_shape, v_shape):
    with pytest.raises(ValueError):
        ops.flash_attention(torch.zeros(q_shape), torch.zeros(k_shape),
                            torch.zeros(v_shape))


@pytest.mark.parametrize("dtypes", [
    (torch.float64,) * 3, (torch.float16,) * 3,
    (torch.float32, torch.bfloat16, torch.bfloat16)])
def test_wrapper_rejects_bad_dtypes(dtypes):
    shapes = ((1, 8, 4, 16), (1, 8, 2, 16), (1, 8, 2, 16))
    with pytest.raises(TypeError):
        ops.flash_attention(*(torch.zeros(s, dtype=d)
                              for s, d in zip(shapes, dtypes)))
