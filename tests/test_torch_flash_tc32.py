"""The split-TF32 flash-attention kernel's arithmetic
(``csrc/flash_attention_tc32.cu``), emulated on the CPU, against the
reference's Pallas kernel in interpret mode
(``repro.kernels.flash_attention.ops.flash_attention``), as
``tests/test_torch_flash.py`` runs it.

The emulation does what the kernel does, in f32: a TF32 operand is an f32
value with its low 13 mantissa bits dropped (the tensor cores truncate
them; ``scripts/flash_tc32_variants.py``'s probe), each f32 operand is
split as x = hi + lo with hi = x & ~0x1fff, each product is taken three
times (hi·hi + hi·lo + lo·hi, lo itself read as TF32), and the online
softmax runs over the kernel's KV tiles (``ops.tc32_tiles``, the rule the
kernel's ``Tile::BK`` follows) with exp2. Bound: rtol 1e-4 /
atol 2e-5, ``tests/test_kernels.py::TestFlashAttention``'s f32 bound. The
split passes it; one unsplit TF32 pass of either product fails it, so the
bound tells a kernel that splits from one that does not.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops
from repro_torch.kernels.flash_attention import ops, ref

torch.set_num_threads(1)

# tests/test_kernels.py::TestFlashAttention's shapes, the kernel's
# non-causal prefix mode at an aligned T, and a ragged dh (40: S's k-steps
# stop at 40, P·V runs 64 wide)
SHAPES = [
    (1, 128, 128, 4, 2, 64, True, 0),
    (2, 256, 256, 8, 8, 128, True, 0),
    (1, 200, 200, 6, 2, 64, True, 0),        # unaligned seq
    (1, 128, 128, 4, 1, 64, True, 32),       # MQA + prefix-LM
    (2, 64, 300, 4, 4, 64, False, 0),        # cross attn, padded keys
    (1, 512, 512, 2, 2, 32, True, 0),        # dh below lane width
    (1, 64, 256, 4, 2, 64, False, 50),       # non-causal prefix
    (1, 96, 96, 6, 2, 40, True, 0),          # ragged dh, group 3
]
TOL = dict(rtol=1e-4, atol=2e-5)
LOG2E = 1.4426950408889634


def tf32(x: torch.Tensor) -> torch.Tensor:
    """What the tensor cores read of an f32 operand: its low 13 mantissa
    bits dropped (truncated)."""
    return (x.contiguous().view(torch.int32) & -8192).view(torch.float32)


def split(x: torch.Tensor):
    """x = hi + lo, hi exact in TF32, lo = x − hi exact in f32."""
    hi = tf32(x)
    return hi, x - hi


def product(a: torch.Tensor, b: torch.Tensor, split_it: bool):
    """a @ b as the kernel takes it: three TF32 products, or one."""
    if not split_it:
        return tf32(a) @ tf32(b)
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    return a_hi @ b_hi + a_hi @ tf32(b_lo) + tf32(a_lo) @ b_hi


def emulate(q, k, v, causal, prefix_len, split_s=True, split_pv=True,
            bk=None):
    """The kernel's arithmetic in plain PyTorch on f32 (B, S, H, dh) q and
    (B, T, KV, dh) k, v: S in split TF32, scale and log2(e) in one
    multiply, an online softmax over KV tiles of ``bk`` keys (the kernel's,
    ``ops.tc32_tiles``, by default) with exp2, l summed from the f32 p, P·V
    in split TF32, o / max(l, 1e-30)."""
    b, s, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    group, bk = h // kv, bk or ops.tc32_tiles(dh)[1]
    qf = q.transpose(1, 2)
    kf = k.transpose(1, 2).repeat_interleave(group, 1)
    vf = v.transpose(1, 2).repeat_interleave(group, 1)
    vis = ref.visible(s, t, causal, prefix_len)
    m = torch.full((b, h, s, 1), ref.NEG_INF)
    l = torch.zeros(b, h, s, 1)
    o = torch.zeros(b, h, s, dh)
    for k0 in range(0, t, bk):
        sc = product(qf, kf[:, :, k0:k0 + bk].transpose(-1, -2), split_s)
        sc = torch.where(vis[:, k0:k0 + bk], sc * (LOG2E / dh ** 0.5),
                         torch.tensor(ref.NEG_INF))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        corr = torch.exp2(m - m_new)
        m = m_new
        p = torch.exp2(sc - m)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + product(p, vf[:, :, k0:k0 + bk], split_pv)
    return (o / l.clamp_min(1e-30)).transpose(1, 2)


def _inputs(seed, b, sq, sk, h, kv, dh):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh)))


@functools.lru_cache(maxsize=None)
def _case(shape):
    """(q, k, v) as torch tensors and the Pallas kernel's output (interpret
    mode) as numpy, for one shape."""
    b, sq, sk, h, kv, dh, causal, pref = shape
    q, k, v = _inputs(sq + dh, b, sq, sk, h, kv, dh)
    want = np.asarray(jops.flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal, prefix_len=pref,
        interpret=True))
    return tuple(map(torch.from_numpy, (q, k, v))), want


def _close(got, want) -> bool:
    return np.allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_split_tf32_matches_pallas(shape):
    """Three TF32 products for each of Q·Kᵀ and P·V hold the f32 bound
    against the Pallas kernel."""
    (q, k, v), want = _case(shape)
    got = emulate(q, k, v, shape[6], shape[7])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_split_tf32_holds_at_tiles_as_wide_as_d(shape):
    """The same arithmetic over KV tiles as wide as the operand tiles (the
    layout the kernel does not use) holds the bound too: the tile changes
    only the order of the softmax's rescalings, so a card that fails there
    fails for another cause than the arithmetic."""
    (q, k, v), want = _case(shape)
    got = emulate(q, k, v, shape[6], shape[7],
                  bk=ops.tc32_tiles(shape[5])[0])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("unsplit", ["S", "PV"])
@pytest.mark.parametrize("shape", SHAPES)
def test_one_tf32_pass_fails_the_bound(shape, unsplit):
    """One unsplit TF32 pass of either product (the other split) misses
    the f32 bound: the bound can tell the split kernel from one that does
    not split."""
    (q, k, v), want = _case(shape)
    got = emulate(q, k, v, shape[6], shape[7], split_s=unsplit != "S",
                  split_pv=unsplit != "PV")
    assert not _close(got, want)


def test_split_is_exact_and_tf32_drops_13_bits():
    """hi keeps 10 explicit mantissa bits and hi + lo gives x back
    exactly; TF32 truncates (1 + 2⁻¹⁰ − 2⁻²³ reads as 1)."""
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=1000).astype(np.float32))
    hi, lo = split(x)
    assert torch.equal(hi + lo, x)
    assert not (hi.view(torch.int32) & 8191).any()
    assert (lo.abs() <= x.abs() * 2.0 ** -10).all()
    one_minus = torch.tensor([0x3F801FFF], dtype=torch.int32).view(
        torch.float32)
    assert float(tf32(one_minus)) == 1.0


@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_takes_the_f32_shapes(shape):
    """Every f32 shape here, contiguous, is the split-TF32 kernel's on a
    card."""
    (q, k, v), _ = _case(shape)
    assert ops.kernel_for(q, k, v) == "tc32"
