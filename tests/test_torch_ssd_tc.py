"""The tensor-core SSD kernel (``repro_torch/kernels/ssd/csrc/ssd_tc.cu``) on
the CPU: its dispatch rule (``ops.kernel_for``) and a plain-PyTorch
emulation of its arithmetic, held to the reference's exact recurrence
(``repro.kernels.ssd.ref.ssd_scan``, JAX, f32) on the same bf16 inputs.

The emulation follows the kernel's three launches tile by tile: the chunk
states S_c = (B ∘ w)ᵀ X per (chunk, head), the state passing in f32, and the
chunk scan in row tiles of 64 with C Bᵀ computed once per (row tile, source
tile) and shared by every head, G = (C Bᵀ) ∘ L ∘ Δ. Rows past L read as 0
(TMA's zero fill); rows of a 64-row tile past the chunk are the next chunk's
rows with weight 0. Products take bf16 operands and sum in f32; the three
f32 operands (G, the weighted B ∘ w, S_in) go in as bf16 hi + lo pairs.

Bounds, those the kernel is held to on the card: the state rtol 1e-3 /
atol 2e-4 (TestSSD's), y rtol 2**-7 / atol 2e-4 (one bf16 ulp of y). With
the splits the emulation passes both at every TestSSD shape; one bf16
rounding of any of the three operands instead fails them at every shape.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.ssd import ref as jref
from repro_torch.kernels.ssd import ops

torch.set_num_threads(1)

STATE_TOL = dict(rtol=1e-3, atol=2e-4)
Y_TOL = dict(rtol=2 ** -7, atol=2e-4)
# tests/test_kernels.py::TestSSD: (b, l, h, p, n, chunk)
SHAPES = [(1, 128, 2, 64, 128, 64), (2, 256, 4, 64, 128, 128),
          (1, 200, 2, 64, 64, 128), (1, 512, 1, 128, 128, 256),
          (2, 64, 3, 32, 16, 32)]
OPERANDS = ("g", "w", "s")
TILE = 64


def _draw(seed, b, l, h, p, n):
    """TestSSD's draws; x, B, C rounded to bf16 (as f32 arrays holding bf16
    values, so that the reference sees the kernel's inputs exactly)."""
    rng = np.random.default_rng(seed)
    f = np.float32

    def bf(a):
        return torch.from_numpy(a.astype(f)).bfloat16().float().numpy()
    return (bf(rng.normal(size=(b, l, h, p))),
            rng.uniform(0.001, 0.1, size=(b, l, h)).astype(f),
            (-rng.uniform(0.5, 2.0, size=(h,))).astype(f),
            bf(rng.normal(size=(b, l, n))), bf(rng.normal(size=(b, l, n))))


def _parts(v, rounding):
    """v as the kernel feeds it to a product: ``"split"`` bf16 hi + lo,
    ``"bf16"`` one rounding."""
    hi = v.bfloat16().float()
    return [hi, (v - hi).bfloat16().float()] if rounding == "split" else [hi]


def emulate(x, dt, a, bm, cm, chunk, rounding=None):
    """The kernel's arithmetic. x (B, L, H, P), bm/cm (B, L, N) float32
    holding bf16 values, dt (B, L, H), a (H,). ``rounding`` maps each of
    "g", "w", "s" to "split" (the kernel's) or "bf16". Returns (y bf16,
    state f32)."""
    rounding = {k: "split" for k in OPERANDS} | dict(rounding or {})
    b, l, h, p = x.shape
    n = bm.shape[-1]
    q, nc = chunk, -(-l // chunk)
    rows = nc * q + TILE                       # TMA's zero fill past L
    xz = F.pad(x, (0, 0, 0, 0, 0, rows - l))
    bz = F.pad(bm, (0, 0, 0, rows - l))
    cz = F.pad(cm, (0, 0, 0, rows - l))
    dz = F.pad(dt, (0, 0, 0, rows - l))
    tiles = -(-q // TILE)

    # 1. chunk states: cum, and S_c = (B ∘ w)ᵀ X over the source tiles
    cum = torch.zeros(b, nc, q, h)
    sc = torch.zeros(b, nc, h, n, p)
    for c in range(nc):
        c0 = c * q
        d = dz[:, c0:c0 + q]                     # (b, q, h), 0 past L
        cum[:, c] = torch.cumsum(d * a, dim=1)
        total = cum[:, c, -1]
        w = F.pad(d * torch.exp(total[:, None] - cum[:, c]),
                  (0, 0, 0, tiles * TILE - q))   # weight 0 past the chunk
        for j in range(tiles):
            r0 = c0 + TILE * j
            bw = bz[:, r0:r0 + TILE, None, :] * w[:, TILE * j:TILE * (j + 1),
                                                  :, None]   # (b, 64, h, n)
            for part in _parts(bw, rounding["w"]):
                sc[:, c] += torch.einsum("bshn,bshp->bhnp", part,
                                         xz[:, r0:r0 + TILE])

    # 2. state passing, f32, in chunk order
    s_in = torch.zeros(b, nc, h, n, p)
    s = torch.zeros(b, h, n, p)
    for c in range(nc):
        s_in[:, c] = s
        s = torch.exp(cum[:, c, -1])[..., None, None] * s + sc[:, c]

    # 3. chunk scan: row tiles of 64, C Bᵀ once for all heads
    y = torch.zeros(b, l, h, p)
    for c in range(nc):
        c0 = c * q
        valid = min(q, l - c0)
        cum_c = F.pad(cum[:, c], (0, 0, 0, tiles * TILE - q))  # 0 past q
        d_c = F.pad(dz[:, c0:c0 + q], (0, 0, 0, tiles * TILE - q))
        for rt in range(tiles):
            t0 = TILE * rt
            if t0 >= valid:
                continue
            ct = cz[:, c0 + t0:c0 + t0 + TILE]                  # (b, 64, n)
            cum_t = cum_c[:, t0:t0 + TILE]                      # (b, 64, h)
            acc = torch.zeros(b, TILE, h, p)
            if c > 0:
                for part in _parts(s_in[:, c], rounding["s"]):
                    acc += torch.einsum("btn,bhnp->bthp", ct, part)
                acc = acc * torch.exp(cum_t)[..., None]
            t_idx = t0 + torch.arange(TILE)
            for j in range(rt + 1):
                r0 = c0 + TILE * j
                cb = torch.einsum("btn,bsn->bts", ct, bz[:, r0:r0 + TILE])
                s_idx = TILE * j + torch.arange(TILE)
                tri = (s_idx[None, :] <= t_idx[:, None])[None, :, :, None]
                cum_s = cum_c[:, TILE * j:TILE * (j + 1)]
                arg = cum_t[:, :, None] - cum_s[:, None]        # (b, t, s, h)
                g = torch.where(tri, cb[..., None] * torch.exp(arg)
                                * d_c[:, None, TILE * j:TILE * (j + 1)],
                                torch.zeros(()))
                for part in _parts(g, rounding["g"]):
                    acc += torch.einsum("btsh,bshp->bthp", part,
                                        xz[:, r0:r0 + TILE])
            keep = min(TILE, valid - t0)
            y[:, c0 + t0:c0 + t0 + keep] = acc[:, :keep]
    return y.bfloat16(), s


_REF = {}


def _case(shape):
    """The shape's inputs (torch) and the reference's (y, state), once."""
    if shape not in _REF:
        b, l, h, p, n, _ = shape
        arrays = _draw(sum(shape), b, l, h, p, n)
        jy, js = jref.ssd_scan(*map(jnp.asarray, arrays))
        _REF[shape] = (tuple(torch.from_numpy(v) for v in arrays),
                       torch.from_numpy(np.array(jy)),
                       torch.from_numpy(np.array(js)))
    return _REF[shape]


def _holds(shape, rounding=None):
    args, jy, js = _case(shape)
    y, s = emulate(*args, shape[-1], rounding)
    return (torch.allclose(y.float(), jy, **Y_TOL),
            torch.allclose(s, js, **STATE_TOL))


@pytest.mark.parametrize("shape", SHAPES)
def test_split_operands_hold_the_bounds(shape):
    """The kernel's arithmetic (G, B ∘ w and S_in as bf16 hi + lo) against
    the reference's f32 recurrence: y and the state within their bounds."""
    assert _holds(shape) == (True, True)


@pytest.mark.parametrize("operand", OPERANDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_one_bf16_rounding_fails_the_bounds(shape, operand):
    """One bf16 rounding of G, of B ∘ w or of S_in, the others split: the
    bounds fail (y for each; the state too for B ∘ w, which makes it), so
    they tell a kernel that splits from one that does not."""
    y_ok, s_ok = _holds(shape, {operand: "bf16"})
    assert not y_ok
    assert s_ok == (operand != "w")


def _bf16(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32)).bfloat16()


def _model_views():
    """The model's prefill inputs: x a (B, L, H·P) conv output viewed per
    head, B and C contiguous (B, L, N) conv outputs."""
    flat = _bf16((2, 40, 8 * 64))
    return flat.reshape(2, 40, 8, 64), _bf16((2, 40, 128)), _bf16((2, 40, 128))


_KERNEL_FOR = [
    ("bf16 contiguous", lambda: (_bf16((2, 40, 3, 64)), _bf16((2, 40, 16)),
                                 _bf16((2, 40, 16))), "tc"),
    ("model conv views", _model_views, "tc"),
    ("f32", lambda: tuple(t.float() for t in _model_views()), "simt"),
    ("mixed f32 B", lambda: (_model_views()[0], _model_views()[1].float(),
                             _model_views()[2]), "simt"),
    ("unaligned base", lambda: (_bf16((2, 40, 3, 64)),
                                _bf16((2, 40, 17))[..., 1:],
                                _bf16((2, 40, 16))), "simt"),
    ("odd head stride", lambda: (_bf16((2, 40, 3, 66))[..., :64],
                                 _bf16((2, 40, 16)), _bf16((2, 40, 16))),
     "simt"),
    ("odd row stride of C", lambda: (_bf16((2, 40, 3, 64)),
                                     _bf16((2, 40, 16)),
                                     _bf16((2, 40, 20))[..., :16]), "simt"),
    ("head group and B/C halves", lambda: (
        _bf16((2, 40, 6, 64))[:, :, 3:], _bf16((2, 40, 256))[..., :128],
        _bf16((2, 40, 256))[..., 128:]), "tc"),
]


@pytest.mark.parametrize("make,kind", [c[1:] for c in _KERNEL_FOR],
                         ids=[c[0] for c in _KERNEL_FOR])
def test_kernel_for(make, kind):
    """The dispatch rule: bf16 whose strides and bases TMA can describe
    (multiples of 16 bytes) goes to the tensor-core kernel, everything else
    to the CUDA-core one."""
    assert ops.kernel_for(*make()) == kind


def test_cpu_path_ignores_the_rule():
    """On CPU tensors either kind runs the plain recurrence and counts no
    launch of either kernel."""
    x, bm, cm = _model_views()
    dt = torch.full((2, 40, 8), 0.05)
    a = -torch.ones(8)
    before = (ops.LAUNCHES, ops.TC_LAUNCHES)
    y, s = ops.ssd_scan(x, dt, a, bm, cm, chunk=16)
    assert y.dtype == torch.bfloat16 and s.shape == (2, 8, 128, 64)
    assert (ops.LAUNCHES, ops.TC_LAUNCHES) == before
    assert ops._TC_LIB is None
