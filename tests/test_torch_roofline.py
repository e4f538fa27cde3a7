"""repro_torch.launch.roofline, specs and dryrun: the counter's product
FLOPs against the reference's loop-aware HLO count of the same step, the
kernels' work records, the shape cells against the reference's, and the
dry run of one smoke cell a family on the meta device."""
import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import TrainConfig as JTrainConfig
from repro.config import get_arch as jget_arch
from repro.config import get_smoke as jget_smoke
from repro.config import list_archs
from repro.launch import specs as JSP
from repro.launch.mesh import production_mesh_config
from repro.launch.roofline import analyze_hlo
from repro.models.registry import build_model as jbuild

from repro_torch.config import TrainConfig, get_arch, get_smoke
from repro_torch.core import local_sgd as LS
from repro_torch.kernels import work as W
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.hinge import ops as hinge_ops
from repro_torch.kernels.quant import ops as quant_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as R
from repro_torch.launch import specs as SP
from repro_torch.models import layers as TL
from repro_torch.models.registry import build_model as tbuild

META = torch.device("meta")


def _hlo_flops(fn, *args) -> float:
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text(), 1).flops


def _ref_inputs(kind, b, s):
    tok = jax.ShapeDtypeStruct((b, s), jnp.int32)
    return {"tokens": tok, "targets": tok} if kind == "train" \
        else {"tokens": tok}


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_product_flops_match_reference_hlo(kind):
    """A smoke-width dense prefill and a train step's loss and gradient,
    both on the plain attention: the counter's product FLOPs within 1% of
    the reference's ``analyze_hlo`` dot FLOPs of the same step, jitted on
    one CPU device."""
    b, s = 2, 64
    jcfg, tcfg = jget_smoke("smollm-360m"), get_smoke("smollm-360m")
    jm = jbuild(jcfg, scan_layers=True, remat="none", attn_impl="jnp")
    params = jax.eval_shape(lambda: jm.init(jax.random.key(0)))
    if kind == "prefill":
        want = _hlo_flops(lambda p, x: jm.prefill(p, x), params,
                          _ref_inputs(kind, b, s))
    else:
        want = _hlo_flops(jax.grad(lambda p, x: jm.loss(p, x)[0]), params,
                          _ref_inputs(kind, b, s))
    tm = tbuild(tcfg, attn_impl="torch", ssd_impl="torch")
    tparams = TL.empty_params(tm.param_defs(), torch.float32, META)
    tok = torch.zeros((b, s), dtype=torch.long, device=META)
    counter = R.WorkCounter()
    with counter:
        if kind == "prefill":
            with torch.no_grad():
                tm.prefill(tparams, {"tokens": tok})
        else:
            state = LS.state_of(tparams, TrainConfig(model=tcfg))
            LS.value_and_grad(tm, state["params"],
                              {"tokens": tok, "targets": tok})
    got = counter.product_flops
    assert set(counter.flops) == {tcfg.dtype}
    assert abs(got - want) / want < 0.01, (got, want)
    assert counter.bytes > 0 and counter.peak_bytes > 0


def test_loop_of_matmuls_multiplies_flops():
    """tests/test_losses_roofline.py's scanned matmul: ten products count
    ten times one, and one is 2·M³."""
    m = 256
    x = torch.zeros((m, m), device=META)
    ws = torch.zeros((10, m, m), device=META)
    _, one = R.count(torch.mm, x, ws[0])

    def looped(x, ws):
        for w in ws:
            x = x @ w
        return x
    _, ten = R.count(looped, x, ws)
    assert one.product_flops == 2 * m ** 3
    assert ten.product_flops / one.product_flops == 10
    # bytes: each product reads two M×M and writes one; views move none
    assert one.bytes == 3 * 4 * m * m


def test_bytes_count_what_a_tensor_spans():
    """An expanded (stride-0) input is read once a distinct element; a
    strided slice at its own elements."""
    m = 64
    x = torch.zeros((m, m), device=META)
    row = torch.zeros((1, m), device=META)
    _, c = R.count(torch.add, x, row.expand(m, m))
    assert c.bytes == 4 * (m * m + m + m * m)
    _, c = R.count(torch.neg, x[:, ::2])
    assert c.bytes == 4 * (m * m // 2 + m * m // 2)


def test_kernel_records_replace_their_plain_ops():
    """Under the counter a kernel call records its work once, and the plain
    version that stands in for it on the CPU adds no ops; on the meta
    device it returns the right shapes; outside a counter meta raises."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(1, 64, 4, 32)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 64, 2, 32)).astype(np.float32))
    out, c = R.count(flash_ops.flash_attention, q, k, k)
    # recorded on the route the card would take: f32 on the TF32 tensor cores
    assert flash_ops.kernel_for(q, k, k) == "tc32"
    want = flash_ops.flash_work(1, 64, 64, 4, 2, 32, True, 0, torch.float32,
                                tf32=True)
    assert list(want.flops) == ["tf32"]
    assert c.kernels == {"flash_attention": 1} and c.ops == 0
    assert c.flops == want.flops and c.bytes == want.bytes
    torch.testing.assert_close(out, flash_ops.flash_attention(q, k, k))
    qm, km = q.to(META), k.to(META)
    out, c = R.count(flash_ops.flash_attention, qm, km, km)
    assert out.shape == q.shape and out.device == META
    with pytest.raises(ValueError, match="work counter"):
        flash_ops.flash_attention(qm, km, km)

    x = torch.zeros((4, 8, 16), device=META)
    y = torch.zeros((4, 8), device=META)
    w = torch.zeros(16, device=META)
    out, c = R.count(hinge_ops.hinge_block_grad, w.expand(4, 16), x, y)
    assert out.shape == (4, 16) and c.kernels == {"hinge_block_grad": 1}
    assert c.bytes == hinge_ops.hinge_work(4, 8, 16, 1).bytes
    with pytest.raises(ValueError, match="work counter"):
        hinge_ops.hinge_block_grad(w, x[0], y[0])

    leaf = torch.zeros((3, 100), device=META)
    (q8, scale, res), c = R.count(quant_ops.quantize, leaf, rows=True,
                                  residual=True)
    assert (q8.dtype, scale.shape, res.shape) == (torch.int8, (3,), (3, 100))
    back, c2 = R.count(quant_ops.dequantize, q8, scale)
    assert back.shape == (3, 100)
    assert c.bytes == 300 * 9 and c2.bytes == 300 * 5
    with pytest.raises(ValueError, match="work counter"):
        quant_ops.quantize(leaf)

    xs = torch.zeros((1, 64, 2, 16), device=META)
    dt = torch.zeros((1, 64, 2), device=META)
    (ys, st), c = R.count(ssd_ops.ssd_scan, xs, dt, torch.zeros(2,
                                                                device=META),
                          torch.zeros((1, 64, 8), device=META),
                          torch.zeros((1, 64, 8), device=META), chunk=32)
    assert ys.shape == xs.shape and st.shape == (1, 2, 8, 16)
    assert c.kernels == {"ssd_scan": 1}
    assert W.COUNTERS == []


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_bounds_from_the_work_functions():
    """chip_smoke.py's kernels line bounds, from the kernels' work
    functions at the main-path shapes: hinge 4.9720 µs, quant 1.3146 ms,
    bf16 flash 28.6414 µs, SSD 51.9887 µs (each over its H100 term)."""
    cs = _chip_smoke()
    assert (cs.BF16_FLOPS_PER_S, cs.FP32_FLOPS_PER_S) == (R.BF16_FLOPS,
                                                          R.F32_FLOPS)
    assert (R.HBM_BW, R.BF16_FLOPS, R.F32_FLOPS, R.TF32_FLOPS) == (
        3.35e12, 989e12, 67e12, 494.7e12)
    assert R.PEAKS["tf32"] == R.TF32_FLOPS
    ms, by = cs.hinge_bound((32, 64, 2000), (32, 0))
    assert (round(ms * 1e3, 4), by) == (4.9720, "bytes")
    q, d = cs.quant_bound(cs.QUANT_MAIN[0][0] * cs.QUANT_MAIN[0][1], True)
    assert round(q + d, 4) == 1.3146
    ms, by = cs.flash_bound(cs.FLASH_MAIN, 2)
    assert (round(ms * 1e3, 4), by) == (28.6414, "operations")
    ms, by = cs.ssd_bound(cs.SSD_MAIN, 2)
    assert (round(ms * 1e3, 4), by) == (51.9887, "bytes")
    # the split-TF32 route's bound at zamba2's f32 prefill (PERF.md: 122.1537)
    assert round(cs.flash_bound_tc32(cs.FLASH_HYBRID)[0] * 1e3, 4) == 122.1537
    # a counter prices that kernel's record at the same rate
    rec = cs._flash_work(cs.FLASH_HYBRID, torch.float32, tf32=True)
    assert 1e3 * R.compute_s(rec.flops) == cs.flash_bound_tc32(
        cs.FLASH_HYBRID)[0]


def test_chip_smoke_simsync_digests_are_the_cpus():
    """Phase tooling (t2) holds the card's replay digests of the built-in
    profiles to these: the CPU's."""
    from repro_torch import simsync
    cs = _chip_smoke()
    assert {n: cs.simsync_digest(p) for n, p in
            simsync.PROFILES.items()} == cs.SIMSYNC_DIGESTS


def test_visible_pairs_match_the_mask():
    for sq, sk, causal, prefix in [(64, 64, True, 0), (70, 100, False, 0),
                                   (192, 320, False, 100), (256, 256, True,
                                                            40),
                                   (300, 200, True, 256), (5, 9, True, 7)]:
        rows = np.arange(sq)
        seen = (np.minimum(sk, np.maximum(rows + 1, prefix)) if causal
                else np.full(sq, min(sk, prefix) if prefix else sk))
        assert flash_ops.visible_pairs(sq, sk, causal, prefix) == seen.sum()


def test_compute_terms():
    cost = R.StepCost(flops={"bfloat16": 989e12, "float32": 67e12},
                      hbm_bytes=3.35e12, ib=50e9, nvlink=450e9)
    t = R.compute_terms(cost, total_devices=2, model_flops=989e12)
    assert (t.compute_s, t.memory_s, t.collective_s) == (2.0, 1.0, 2.0)
    assert t.dominant == "compute" and t.bound_s() == 2.0
    assert t.mfu_bound == pytest.approx(0.25)
    assert t.useful_ratio == pytest.approx(989 / (2 * 1056))
    assert R.mfu(989e12, 2.0) == 0.5
    sizes = {"pod": 2, "data": 16, "model": 16}
    assert R.link_for_axis(sizes, "model") == "ib"
    assert R.link_for_axis({"data": 2, "model": 4}, "data") == "nvlink"


@pytest.mark.parametrize("arch", list_archs())
def test_cells_match_reference(arch):
    """SHAPE_CELLS, cell_runnable, model_flops_estimate and
    make_train_config against the reference, for the four cells."""
    jcfg, tcfg = jget_arch(arch), get_arch(arch)
    assert {k: dataclasses.astuple(v) for k, v in SP.SHAPE_CELLS.items()} \
        == {k: dataclasses.astuple(v) for k, v in JSP.SHAPE_CELLS.items()}
    for name, cell in SP.SHAPE_CELLS.items():
        assert SP.cell_runnable(tcfg, name) == JSP.cell_runnable(jcfg, name)
        assert SP.model_flops_estimate(
            tcfg, cell.kind, cell.batch, cell.seq) == JSP.model_flops_estimate(
                jcfg, cell.kind, cell.batch, cell.seq)
    for multi in (False, True):
        jm = production_mesh_config(multi_pod=multi)
        tm = SP.MESHES["2x16x16" if multi else "16x16"]
        assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
        cell = SP.SHAPE_CELLS["train_4k"]
        got = dataclasses.asdict(SP.make_train_config(tcfg, tm, cell))
        want = dataclasses.asdict(JSP.make_train_config(
            jcfg, jm, JSP.SHAPE_CELLS["train_4k"]))
        assert got == want
    assert isinstance(SP.make_train_config(tcfg, tm, cell), TrainConfig)
    assert JTrainConfig is not TrainConfig


FAMILY_ARCHS = ["smollm-360m", "phi3.5-moe-42b-a6.6b", "paligemma-3b",
                "mamba2-2.7b", "zamba2-1.2b", "whisper-base"]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_dry_run_of_a_smoke_cell(arch, monkeypatch):
    """One smoke cell a family on the meta device: every kind on its mesh,
    no error, the kernels recorded where the serving path takes them."""
    monkeypatch.setattr(SP, "get_arch", get_smoke)
    monkeypatch.setattr(dryrun, "get_arch", get_smoke)
    cfg = get_smoke(arch)
    small = {"train_4k": SP.ShapeCell("train", 32, 64),
             "prefill_32k": SP.ShapeCell("prefill", 64, 32),
             "decode_32k": SP.ShapeCell("decode", 64, 32),
             "long_500k": SP.ShapeCell("decode", 96, 1)}
    monkeypatch.setattr(SP, "SHAPE_CELLS", small)
    monkeypatch.setattr(dryrun, "SHAPE_CELLS", small)
    # the local-SGD block on the multi-pod mesh for the attention families,
    # DDP on 16x16 for the SSM ones (their chunked scans are slow on meta)
    train = "16x16" if cfg.family in ("ssm", "hybrid") else "2x16x16"
    for shape, mesh in [("train_4k", train), ("prefill_32k", "1"),
                        ("decode_32k", "16x16"), ("long_500k", "1")]:
        rec = dryrun.run_cell(arch, shape, mesh, verbose=False)
        if shape == "long_500k" and not cfg.subquadratic:
            assert rec["status"] == "skip"
            continue
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["roofline"]["dominant"] in ("compute", "memory",
                                               "collective")
        assert rec["activation_peak_bytes"] > 0 and rec["hbm_bytes"] > 0
        if shape == "prefill_32k" and cfg.family != "ssm":
            assert rec["kernel_records"]["flash_attention"] >= 1
        if shape == "prefill_32k" and cfg.family in ("ssm", "hybrid"):
            assert rec["kernel_records"]["ssd_scan"] == cfg.n_layers
        if shape == "train_4k" and mesh == "2x16x16":
            assert rec["opt_steps_per_call"] == 8
            assert rec["batch_per_card"] == 2
            assert set(rec["roofline"]["collectives"]) == {
                "grad_all_reduce", "replica_sync"}


def test_block_counted_as_one_step_and_repeats():
    """The dry run counts a local-SGD block of H steps as the block of one
    microbatch plus H − 1 more steps: the products and kernel records of
    the whole block exactly, its bytes within the losses' bookkeeping."""
    cfg = get_smoke("smollm-360m")
    mesh = SP.MESHES["2x16x16"]
    built = SP.build_cell("smollm-360m", "train_4k", mesh, cfg_override=cfg,
                          sync=dataclasses.replace(
                              SP.make_train_config(
                                  cfg, mesh, SP.SHAPE_CELLS["train_4k"]).sync,
                              strategy="hierarchical", period=3))
    got = built.count()
    # the whole block, as the trainer runs it
    tcfg = SP.make_train_config(cfg, mesh, SP.SHAPE_CELLS["train_4k"])
    tcfg = dataclasses.replace(
        tcfg, sync=dataclasses.replace(tcfg.sync, strategy="periodic",
                                       period=3),
        mesh=SP.MESHES["1"])
    model = tbuild(cfg, attn_impl="torch", ssd_impl="torch", remat="full")
    state = LS.state_of(TL.empty_params(model.param_defs(), torch.float32,
                                        META), tcfg, replicas=1)
    tok = torch.zeros((3, built.batch_per_card, 4096), dtype=torch.long,
                      device=META)
    _, want = R.count(LS.make_local_sgd_block(model, tcfg), state,
                      {"tokens": tok, "targets": tok})
    assert built.opt_steps == 3
    assert dict(got.flops) == dict(want.flops)
    assert got.kernels == want.kernels
    assert abs(got.bytes - want.bytes) / want.bytes < 1e-6


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_train_cell_counts_the_state_a_rank_holds(mesh):
    """A train cell on a mesh with a model axis counts its state at the
    shapes a rank holds it in, every leaf as ``spec_for`` splits it, with
    its moments and sync state: phi3.5-moe's query and output projections
    (32 heads over the 16 model ranks, d_model over the 16 data ranks),
    router and expert tables (16 experts over model, d_model over data)
    and its embedding and output tables (vocab over model, d_model over
    data) a 256th each; its KV projections (8 KV heads, held whole over
    model) and its norms' scales a 16th (d_model over data). On one card
    all of it is whole."""
    arch = "phi3.5-moe-42b-a6.6b"
    mesh_cfg = SP.MESHES[mesh]
    cell = SP.SHAPE_CELLS["train_4k"]
    built = SP.build_cell(arch, "train_4k", mesh_cfg)
    one = SP.build_cell(arch, "train_4k", SP.MESHES["1"])
    cfg = get_arch(arch)
    tcfg = SP.make_train_config(cfg, mesh_cfg, cell)
    replicated = mesh == "2x16x16"
    model = tbuild(cfg, attn_impl="torch", ssd_impl="torch", remat="full")
    state = LS.state_of(TL.empty_params(model.param_defs(), torch.float32,
                                        META), tcfg,
                        replicas=1 if replicated else 0)
    over_data = {"wk", "wv", "scale"}

    def held(tree, path=()):
        if isinstance(tree, dict):
            return sum(held(v, path + (k,)) for k, v in tree.items())
        n = tree.numel() * tree.element_size()
        return n // 16 if path[-1] in over_data else n // 256
    want = sum(held(state[k]) for k in ("params", "opt", "sync"))
    h = tcfg.sync.period if replicated else 1
    batch = built.state_bytes - want
    assert batch == h * built.batch_per_card * cell.seq * 8 * 2
    assert built.state_bytes < one.state_bytes
