"""The int8 quant kernels' wrapper and, on a card, the CUDA kernels against
their plain version. No JAX here, so the card tests run where JAX is absent:

    PYTHONPATH=src python -m pytest -q tests/test_torch_quant_cuda.py

Without a card the kernel tests skip; the wrapper's CPU dispatch and checks
run anywhere. Bound: bitwise. Both divide by the scale with IEEE rounding and
round half to even, and a max is exact in any order, so the int8 payload,
the scales, the residual and the dequantized values are the same bits.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.quant import ops, ref

torch.set_num_threads(1)

# tests/test_kernels.py::TestQuant's shapes (one scale each), then stacked
# rows with a scale each: the sync's (K, leaf) payloads, a ragged row length
# and a row length that is not a multiple of four
SHAPES = [(100,), (33, 7), (2, 3, 5), (4096,), (128, 128)]
ROW_SHAPES = [(4, 1_000_003), (4, 33, 7), (2, 4096), (3, 1), (5, 6)]


def _x(seed, shape, device="cpu", scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.normal(size=shape) * scale)
                            .astype(np.float32)).to(device)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the quant kernels have no CPU mode")
    return torch.device("cuda")


def test_cpu_path_never_builds_or_counts():
    """A CPU tensor takes the plain version: no build, no launch counted."""
    x = _x(0, (4, 33))
    before, lib = ops.LAUNCHES, ops._LIB
    q, s, res = ops.quantize(x, rows=True, residual=True)
    qr, sr = ref.quantize(x, rows=True)
    assert torch.equal(q, qr) and torch.equal(s, sr) and s.shape == (4,)
    assert torch.equal(res, x - ref.dequantize(qr, sr))
    assert torch.equal(ops.dequantize(q, s), ref.dequantize(qr, sr))
    q1, s1 = ops.quantize(x)
    assert s1.dim() == 0 and q1.shape == x.shape
    assert ops.LAUNCHES == before
    assert ops._LIB is lib


@pytest.mark.parametrize("shape", ROW_SHAPES)
def test_rows_are_each_quantized_alone(shape):
    """A per-row scale is the per-tensor quantization of each row."""
    x = _x(1, shape, scale=3.0)
    q, s = ops.quantize(x, rows=True)
    for r in range(shape[0]):
        qr, sr = ref.quantize(x[r])
        assert torch.equal(q[r], qr) and torch.equal(s[r], sr)


def test_wrapper_rejects_bad_inputs():
    with pytest.raises(ValueError):
        ops.quantize(torch.zeros(0))
    with pytest.raises(ValueError):
        ops.quantize(torch.zeros(4, 6).T)               # not contiguous
    with pytest.raises(ValueError):
        ops.quantize(torch.zeros(4, 6, 2).transpose(1, 2), rows=True)
    with pytest.raises(ValueError):
        ops.quantize(torch.zeros(()), rows=True)
    q = torch.zeros(4, 3, dtype=torch.int8)
    with pytest.raises(ValueError):
        ops.dequantize(q, torch.ones(3))                # one scale per row
    with pytest.raises(ValueError):
        ops.dequantize(q, torch.ones(4, 1))


def test_row_stride_is_free():
    """Rows of a wider tensor are read in place (the stride is free)."""
    wide = _x(2, (3, 50))
    x = wide[:, :40]
    q, s = ops.quantize(x, rows=True)
    qr, sr = ref.quantize(x.contiguous(), rows=True)
    assert torch.equal(q, qr) and torch.equal(s, sr)


def test_cuda_kernel_matches_plain(cuda):
    """On the card: q, scale, residual and dequantized values bitwise the
    plain version's at every shape; two launches bitwise equal; one launch
    counted per call; the round-trip error at most scale/2."""
    cases = [(s, False) for s in SHAPES] + [(s, True) for s in ROW_SHAPES]
    for i, (shape, rows) in enumerate(cases):
        x = _x(10 + i, shape, cuda, scale=0.01 * (i + 1))
        before = ops.LAUNCHES
        q, s, res = ops.quantize(x, rows=rows, residual=True)
        q2, s2 = ops.quantize(x, rows=rows)
        deq = ops.dequantize(q, s)
        torch.cuda.synchronize()
        assert ops.LAUNCHES == before + 3
        qr, sr = ref.quantize(x, rows=rows)
        deqr = ref.dequantize(qr, sr)
        assert q.dtype == torch.int8 and q.shape == x.shape
        assert torch.equal(q, qr), shape
        assert torch.equal(s, sr), shape
        assert torch.equal(q2, q) and torch.equal(s2, s)
        assert torch.equal(deq, deqr), shape
        assert torch.equal(res, x - deqr), shape
        half = (s.reshape(s.shape + (1,) * (x.dim() - s.dim())) / 2)
        assert bool(((deq - x).abs() <= half + 1e-6).all())


def test_cuda_strided_and_unaligned_rows(cuda):
    """Row slices of a wider tensor (the vector path) and rows that start
    off a 16-byte boundary (the scalar path) give the plain version's bits;
    a zero row takes the 1e-12 floor."""
    wide = _x(3, (4, 4100), cuda)
    wide[2] = 0.0
    for x in (wide[:, :4096], wide[:, 1:4097], wide[:, 3:]):
        q, s, res = ops.quantize(x, rows=True, residual=True)
        qr, sr = ref.quantize(x, rows=True)
        assert torch.equal(q, qr) and torch.equal(s, sr)
        assert torch.equal(res, x - ref.dequantize(qr, sr))
        assert torch.equal(ops.dequantize(q, s), ref.dequantize(qr, sr))
        assert bool((q[2] == 0).all())
    qs = torch.randint(-127, 128, (3, 4101), dtype=torch.int8, device=cuda)
    sc = torch.rand(3, device=cuda)
    for q in (qs[:, :4096], qs[:, 1:4097]):
        assert torch.equal(ops.dequantize(q, sc), ref.dequantize(q, sc))


def test_cuda_refuses_grad_and_mixed_devices(cuda):
    x = _x(4, (8, 16), cuda).requires_grad_()
    with pytest.raises(RuntimeError, match="grad"):
        ops.quantize(x)
    with torch.no_grad():
        q, s = ops.quantize(x)
    with pytest.raises(ValueError):
        ops.dequantize(q, s.cpu().reshape(1).expand(8).contiguous())
    with pytest.raises(TypeError):
        ops.quantize(x.detach().double())


def _same(a, b):
    """Bitwise equal where finite or infinite, NaN where the other is NaN."""
    nan = torch.isnan(a)
    return (a.shape == b.shape and torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan], b[~nan]))


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), float("-inf")],
                         ids=["nan", "inf", "-inf"])
@pytest.mark.parametrize("shape,rows", [((100,), False), ((4096,), False),
                                        ((4, 1_000_003), True), ((5, 6), True)])
def test_cuda_nonfinite_matches_plain(cuda, shape, rows, bad):
    """A NaN or an infinity in a leaf (or in one row among good ones): the
    kernel's q, scale, residual and dequantized values are the plain
    version's (NaN as NaN), with and without the fused residual; the bad
    leaf or row has scale NaN or inf, q 0, and dequantizes to NaN."""
    x = _x(40, shape, cuda, scale=0.1)
    flat = x.view(-1) if not rows else x[1]
    flat[min(7, flat.numel() - 1)] = bad
    q, s, res = ops.quantize(x, rows=rows, residual=True)
    q2, s2 = ops.quantize(x, rows=rows)
    deq = ops.dequantize(q, s)
    torch.cuda.synchronize()
    qr, sr = ref.quantize(x, rows=rows)
    deqr = ref.dequantize(qr, sr)
    assert torch.equal(q, qr) and torch.equal(q2, qr)
    assert _same(s, sr) and _same(s2, sr)
    assert _same(deq, deqr) and _same(res, x - deqr)
    bad_q, bad_s = (q[1], s[1]) if rows else (q, s)
    assert bool((bad_q == 0).all()) and not bool(torch.isfinite(bad_s))
    assert bool(torch.isnan(deq[1] if rows else deq).all())
    if rows:
        good = [r for r in range(shape[0]) if r != 1]
        assert bool(torch.isfinite(s[good]).all())
        assert bool(torch.isfinite(deq[good]).all())


def test_sizes_are_64_bit_across_the_c_interface():
    """Leaves past 2³¹ values (qwen3-moe's expert leaf is 805 M a replica,
    2.4 G at K = 3) are not wrapped on the way to the kernels: the wrapper
    reads sizes and row strides as Python ints (a meta tensor of 2³¹ + 3
    values a row, no memory), every ``long long`` of ``quant.cu``'s C entry
    points is a ``c_longlong`` in the ctypes signature, and a call with more
    rows than the grid's y dim holds is refused."""
    import ctypes
    import re
    n = 2 ** 31 + 3
    assert ops._rows_of(torch.empty((3, n), device="meta"), True) == (3, n, n)
    assert ops._rows_of(torch.empty((n,), device="meta"), False) == (1, n, n)
    ctype = {"long long": ctypes.c_longlong, "int": ctypes.c_int}
    source = ops.SOURCE.read_text()
    for name, argtypes in ops.ARGTYPES.items():
        params = re.search(rf'extern "C" int {name}\(([^)]*)\)',
                           source).group(1)
        want = [ctype.get(" ".join(p.split()[:-1]), ctypes.c_void_p)
                if "*" not in p else ctypes.c_void_p
                for p in params.split(",")]
        assert argtypes == want, name
    with pytest.raises(ValueError, match="65535"):
        ops._check_rows(ops.MAX_ROWS + 1)
    ops._check_rows(ops.MAX_ROWS)


@pytest.mark.parametrize("shape", [(1, 2 ** 31 + 4100), (3, 805_306_368)],
                         ids=["row-past-2^31", "rows-past-2^31"])
def test_cuda_leaf_past_2_31_values(cuda, shape):
    """On the card: one row of more than 2³¹ values, and three rows of
    qwen3-moe's expert leaf (805 M each, 2.4 G in all, the last row's start
    past 2³¹). The largest |x| of each row sits at its end, past 2³¹ in the
    leaf; the scale finds it, and q, the residual and the dequantized
    values are the plain version's at the head, across 2³¹ and at the tail
    (the plain version on those slices, at the kernel's scale)."""
    r, n = shape
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn(shape, generator=gen, device=cuda)
    x[:, -1] = 1000.0 + torch.arange(r, device=cuda)
    q, s, res = ops.quantize(x, rows=True, residual=True)
    deq = ops.dequantize(q, s)
    torch.cuda.synchronize()
    want_s = (x[:, -1] / torch.full((r,), 127.0, device=cuda))
    assert torch.equal(s, want_s)
    flat = (x.view(-1), q.view(-1), res.view(-1), deq.view(-1))
    for lo in (0, 2 ** 31 - 2048, r * n - 4096):
        idx = torch.arange(lo, lo + 4096, device=cuda)
        xs, qs, rs, ds = (t[idx] for t in flat)
        sc = s[idx // n]
        qr = torch.clamp(torch.round(xs / sc), -127, 127).to(torch.int8)
        assert torch.equal(qs, qr), lo
        assert torch.equal(ds, qr.float() * sc), lo
        assert torch.equal(rs, xs - qr.float() * sc), lo


# ---------------------------------------------------------------------------
# the shard path's entry points: amax, and the pack given the amax
# ---------------------------------------------------------------------------

def test_shard_entry_points_are_bound_with_64_bit_sizes():
    """The trainer on a model mesh packs a leaf's block with the whole
    leaf's scale through two more C entry points; both are in the ctypes
    signatures the check above holds to ``quant.cu``."""
    for name in ("quant_amax_f32", "quant_int8_given_amax_f32"):
        assert name in ops.ARGTYPES
        assert f'extern "C" int {name}(' in ops.SOURCE.read_text()


@pytest.mark.parametrize("shape", ROW_SHAPES)
def test_cpu_shard_path_is_the_plain_version(shape):
    """On the CPU: ``amax`` and ``quantize_given_amax`` are the plain
    versions, no launch counted; the pack given a tensor's own amax is its
    ``quantize``, and two halves of a row packed with their maxed amax are
    the whole row's payload, bitwise."""
    x = _x(7, shape, scale=2.0)
    before = (ops.LAUNCHES, ops.AMAX_LAUNCHES, ops.GIVEN_LAUNCHES)
    a = ops.amax(x, rows=True)
    assert torch.equal(a, ref.amax(x, rows=True)) and a.shape == shape[:1]
    q, s, res = ops.quantize_given_amax(x, a, rows=True, residual=True)
    qr, sr = ref.quantize(x, rows=True)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert torch.equal(res, x - ref.dequantize(qr, sr))
    assert ops.amax(x[0]).dim() == 0
    if shape[-1] > 1:
        halves = [h.contiguous() for h in x.chunk(2, -1)]
        whole = torch.maximum(*[ops.amax(h, rows=True) for h in halves])
        parts = [ops.quantize_given_amax(h, whole, rows=True)
                 for h in halves]
        assert torch.equal(torch.cat([p[0] for p in parts], -1), qr)
        assert all(torch.equal(p[1], sr) for p in parts)
    assert (ops.LAUNCHES, ops.AMAX_LAUNCHES, ops.GIVEN_LAUNCHES) == before
    with pytest.raises(ValueError, match="one per row"):
        ops.quantize_given_amax(x, a[:1] if shape[0] > 1 else a[0],
                                rows=True)


@pytest.mark.parametrize("shape", ROW_SHAPES)
def test_cuda_shard_path_matches_plain(cuda, shape):
    """On the card: the amax kernel and the pack given it bitwise their
    plain versions (payload, scale, residual), each launch counted once on
    its own counter; halves of each row packed with their maxed amax are
    the whole row's payload."""
    x = _x(8, shape, cuda, scale=2.0)
    before = (ops.LAUNCHES, ops.AMAX_LAUNCHES, ops.GIVEN_LAUNCHES)
    a = ops.amax(x, rows=True)
    q, s, res = ops.quantize_given_amax(x, a, rows=True, residual=True)
    assert (ops.LAUNCHES - before[0], ops.AMAX_LAUNCHES - before[1],
            ops.GIVEN_LAUNCHES - before[2]) == (1, 1, 1)
    assert torch.equal(a, ref.amax(x, rows=True))
    qr, sr = ref.quantize_given_amax(x, a)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert torch.equal(res, x - ref.dequantize(qr, sr))
    wq, ws = ops.quantize(x, rows=True)
    assert torch.equal(q, wq) and torch.equal(s, ws)
    if shape[-1] > 1:
        halves = [h.contiguous() for h in x.chunk(2, -1)]
        whole = torch.maximum(*[ops.amax(h, rows=True) for h in halves])
        parts = [ops.quantize_given_amax(h, whole, rows=True)
                 for h in halves]
        assert torch.equal(torch.cat([p[0] for p in parts], -1), wq)
        assert all(torch.equal(p[1], ws) for p in parts)
