"""The port's MSF tuner and telemetry (``repro_torch.core.autotune``,
``repro_torch.core.telemetry``) against the reference's on the CPU.

Both are pure Python over each package's cost model, so every case runs the
same inputs through both: ``choose_period``, ``drift_cap`` and the
controller's H give the same integers, and ``sync_time_s``,
``predicted_step_time``, ``report`` and the telemetry's estimates agree to
rtol 1e-12 (the same float operations in the same order). The inputs are
``tests/test_autotune.py``'s grid and its hypothesis properties; then the
timed paths of the port (the SVM's ``dms_timed_steps`` and the local-SGD
block) feed a ``BlockTelemetry``.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:   # optional dev dep: property tests skip
    from conftest import given, settings, st

from repro.config import SyncConfig as JSyncConfig
from repro.core import autotune as JA
from repro.core import telemetry as JT
from repro_torch.config import (DataConfig, MeshConfig, OptimizerConfig,
                                SyncConfig, TrainConfig, get_smoke)
from repro_torch.core import autotune as TA
from repro_torch.core import telemetry as TT

torch.set_num_threads(1)

RTOL = 1e-12
SYNCS = [dict(),
         dict(strategy="hierarchical"),
         dict(compression="int8"),
         dict(compression="int16"),
         dict(overlap="delayed"),
         dict(overlap="chunked", chunks=4),
         dict(topology="ring"),
         dict(topology="pairwise"),
         dict(topology="ring", gossip_async=True),
         dict(topology="pairwise", gossip_async=True, compression="int8")]


def _inputs(**kw):
    return (JA.TuneInputs(**kw), TA.TuneInputs(**kw))


def _qwen3_2pod():
    """``tests/test_autotune.py``'s cell-C numbers."""
    return dict(param_bytes_per_chip=int(235e9 * 4 / 256), replicas=2,
                step_time_s=0.090, link_bw=6.25e9, grad_norm=1.0,
                param_norm=100.0, lr=3e-4)


GRID = [_qwen3_2pod(),
        dict(param_bytes_per_chip=10**9, replicas=2, step_time_s=1e-4,
             link_bw=6.25e9, grad_norm=10.0, param_norm=1.0, lr=1e-2),
        dict(param_bytes_per_chip=10**9, replicas=8, step_time_s=1e-3,
             link_bw=6.25e9, grad_norm=1e-6, param_norm=1.0, lr=1e-6),
        dict(param_bytes_per_chip=10**9, replicas=8, step_time_s=1e-6,
             link_bw=1e6, grad_norm=1.0, param_norm=1.0, lr=1e-4),
        dict(param_bytes_per_chip=4 * 361821120 // 4, replicas=4,
             step_time_s=1.5, link_bw=JA.DCN_BW, lr=1e-3)]


def test_link_constants_match():
    assert (TA.DCN_BW, TA.ICI_BW) == (JA.DCN_BW, JA.ICI_BW)


@pytest.mark.parametrize("g", range(len(GRID)))
@pytest.mark.parametrize("sync", SYNCS, ids=[str(s) for s in SYNCS])
def test_solver_matches_reference(g, sync):
    ji, ti = _inputs(**GRID[g])
    jc, tc = JSyncConfig(**sync), SyncConfig(**sync)
    np.testing.assert_allclose(TA.sync_time_s(ti, tc), JA.sync_time_s(ji, jc),
                               rtol=RTOL)
    for drift in (0.01, 0.05, 1.0, 10.0):
        assert TA.drift_cap(ti, drift) == JA.drift_cap(ji, drift)
        for target in (0.05, 0.1):
            for override in (None, 1e-3, 0.7):
                kw = dict(target_overhead=target, max_drift=drift,
                          sync_time_override=override)
                assert TA.choose_period(ti, tc, **kw) == \
                    JA.choose_period(ji, jc, **kw)
    for ov in ("none", "delayed", "chunked"):
        assert TA.choose_period(ti, tc, overlap=ov) == \
            JA.choose_period(ji, jc, overlap=ov)
    for h in (1, 2, 8, 64, 1000):
        np.testing.assert_allclose(TA.predicted_step_time(ti, tc, h),
                                   JA.predicted_step_time(ji, jc, h),
                                   rtol=RTOL)


@pytest.mark.parametrize("g", range(len(GRID)))
def test_report_matches_reference(g):
    ji, ti = _inputs(**GRID[g])
    got, want = TA.report(ti), JA.report(ji)
    assert got["chosen_h"] == want["chosen_h"]
    assert got["drift_cap"] == want["drift_cap"]
    np.testing.assert_allclose(got["sync_time_s"], want["sync_time_s"],
                               rtol=RTOL)
    assert sorted(got["ladder"]) == sorted(want["ladder"])
    for h, row in want["ladder"].items():
        for key, value in row.items():
            np.testing.assert_allclose(got["ladder"][h][key], value,
                                       rtol=RTOL, atol=1e-300)


def test_default_config_is_hierarchical():
    ji, ti = _inputs(**GRID[0])
    assert TA.choose_period(ti) == JA.choose_period(ji)
    assert TA.choose_period(ti) == TA.choose_period(
        ti, SyncConfig(strategy="hierarchical"))


@settings(deadline=None, max_examples=50)
@given(p=st.integers(10**6, 10**11), half_k=st.integers(1, 32),
       step=st.floats(1e-3, 10.0), bw=st.sampled_from([6.25e9, 50e9]),
       mode=st.sampled_from(range(len(SYNCS))))
def test_choose_period_properties_match(p, half_k, step, bw, mode):
    """``test_choose_period_properties``'s inputs in every sync mode (an
    even K, which pairwise gossip needs): the same H in both packages, and
    the overhead target met where the drift cap does not bind."""
    k = 2 * half_k
    ji, ti = _inputs(param_bytes_per_chip=p, replicas=k, step_time_s=step,
                     link_bw=bw, grad_norm=1e-6, param_norm=1.0, lr=1e-6)
    jc, tc = JSyncConfig(**SYNCS[mode]), SyncConfig(**SYNCS[mode])
    h = TA.choose_period(ti, tc, target_overhead=0.1, max_drift=0.5)
    assert h == JA.choose_period(ji, jc, target_overhead=0.1, max_drift=0.5)
    assert h >= 1
    if mode == 0:
        assert TA.sync_time_s(ti, tc) / h / step <= 0.1 * 1.001


@settings(deadline=None, max_examples=40)
@given(p=st.integers(10**7, 10**11), k=st.integers(2, 64),
       step=st.floats(1e-4, 1.0), bw_lo=st.sampled_from([1e9, 6.25e9]),
       scale=st.floats(1.0, 100.0))
def test_h_non_increasing_in_bandwidth_matches(p, k, step, bw_lo, scale):
    hs = []
    for bw in (bw_lo, bw_lo * scale):
        ji, ti = _inputs(param_bytes_per_chip=p, replicas=k,
                         step_time_s=step, link_bw=bw, grad_norm=1e-6,
                         param_norm=1.0, lr=1e-6)
        h = TA.choose_period(ti, SyncConfig(), max_drift=10.0)
        assert h == JA.choose_period(ji, JSyncConfig(), max_drift=10.0)
        hs.append(h)
    assert hs[1] <= hs[0]


@settings(deadline=None, max_examples=40)
@given(p=st.integers(10**6, 10**11), k=st.integers(2, 64),
       step=st.floats(1e-3, 10.0), bw=st.sampled_from([6.25e9, 50e9]))
def test_delayed_h_le_blocking_h_matches(p, k, step, bw):
    ji, ti = _inputs(param_bytes_per_chip=p, replicas=k, step_time_s=step,
                     link_bw=bw, grad_norm=1e-6, param_norm=1.0, lr=1e-6)
    hs = {}
    for ov in ("none", "delayed"):
        hs[ov] = TA.choose_period(ti, SyncConfig(overlap=ov), max_drift=10.0)
        assert hs[ov] == JA.choose_period(ji, JSyncConfig(overlap=ov),
                                          max_drift=10.0)
    assert hs["delayed"] <= hs["none"]


@pytest.mark.parametrize("topology", ["ring", "pairwise"])
def test_gossip_cap_by_spectral_gap(topology):
    from repro_torch.core import costmodel
    ji, ti = _inputs(**GRID[3])
    h = TA.choose_period(ti, SyncConfig(topology=topology), max_drift=0.05)
    assert h == JA.choose_period(ji, JSyncConfig(topology=topology),
                                 max_drift=0.05)
    assert h == max(1, int(TA.drift_cap(ti, 0.05)
                           * costmodel.spectral_gap(8, topology)))


@pytest.mark.parametrize("h,ladder", [
    (1, (1, 2, 4, 8, 16)), (3, (1, 2, 4, 8, 16)), (6, (1, 2, 4, 8, 16)),
    (100, (1, 2, 4, 8, 16)), (4, (2, 8)), (0, (3, 9, 27)), (5, (1, 3, 9)),
    (12, (32, 64, 128)), (90, (32, 64, 128)), (91, (32, 64, 128))])
def test_snap_to_ladder_matches(h, ladder):
    assert TA.snap_to_ladder(h, ladder) == JA.snap_to_ladder(h, ladder)
    with pytest.raises(ValueError):
        TA.snap_to_ladder(h, ())


# ---------------------------------------------------------------------------
# telemetry and the adaptive controller, fed the same synthetic times
# ---------------------------------------------------------------------------

def _feed(tel, rng, kinds):
    for kind in kinds:
        if kind == "step":
            tel.record_step_time(float(rng.uniform(1e-4, 1e-2)),
                                 steps=int(rng.integers(1, 9)))
        elif kind == "sync":
            tel.record_sync_time(float(rng.uniform(1e-4, 1e-2)))
        else:
            h = int(rng.choice([1, 2, 4, 8]))
            sync = float(rng.uniform(1e-3, 5e-3)) if kind == "block+sync" \
                else None
            tel.record_block(h, h * float(rng.uniform(1e-3, 2e-3)) + 4e-3,
                             sync)


@pytest.mark.parametrize("kinds", [["step", "sync"] * 6, ["block"] * 12,
                                   ["block+sync"] * 8,
                                   ["block"] * 5 + ["step", "sync"] * 3,
                                   ["block"]])
@pytest.mark.parametrize("warmup", [0, 1])
def test_block_telemetry_matches(kinds, warmup):
    got, want = TT.BlockTelemetry(warmup=warmup), JT.BlockTelemetry(
        warmup=warmup)
    _feed(got, np.random.default_rng(len(kinds)), kinds)
    _feed(want, np.random.default_rng(len(kinds)), kinds)
    g, w = got.to_dict(), want.to_dict()
    assert sorted(g) == sorted(w)
    for key in w:
        if isinstance(w[key], float):
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL)
        else:
            assert g[key] == w[key], key
    assert got.per_step_s() == pytest.approx(want.per_step_s(), rel=RTOL) \
        if want.per_step_s() is not None else got.per_step_s() is None


def test_block_regression_separates_step_and_sync():
    t = TT.BlockTelemetry(warmup=0)
    for h in (4, 32):
        for _ in range(3):
            t.record_block(h, h * 1e-3 + 8e-3)
    est = t.estimates()
    assert est[0] == pytest.approx(1e-3, rel=1e-6)
    assert est[1] == pytest.approx(8e-3, rel=1e-6)
    single = TT.BlockTelemetry(warmup=0)
    single.record_block(8, 1.0)
    assert single.estimates() is None
    ema = TT.EMA(0.5)
    assert ema.value is None and ema.update(2.0) == 2.0
    assert ema.update(4.0) == 3.0


def _controllers(cfg_kw, **kw):
    kw.setdefault("param_bytes_per_chip", 10**8)
    kw.setdefault("replicas", 8)
    kw.setdefault("lr", 1e-6)
    return (TA.AdaptiveController(SyncConfig(**cfg_kw), **kw),
            JA.AdaptiveController(JSyncConfig(**cfg_kw), **kw))


CONTROLLERS = [
    (dict(strategy="periodic"), dict(h0=1, adapt_every=4)),
    (dict(strategy="periodic"), dict(h0=100, adapt_every=1,
                                     hysteresis=0.25)),
    (dict(strategy="periodic", topology="ring"),
     dict(h0=1, adapt_every=1, lr=1e-2, max_drift=0.05)),
    (dict(strategy="periodic"), dict(h0=1, adapt_every=1, h_max=64)),
    (dict(strategy="periodic"), dict(h0=8, adapt_every=2,
                                     ladder=(1, 2, 4, 8, 16, 32, 64))),
    (dict(strategy="periodic"), dict(h0=24, adapt_every=1,
                                     ladder=(1, 2, 4, 8, 16, 32),
                                     rung_hysteresis=2)),
    (dict(strategy="periodic", period=4, adapt_every=2),
     dict(ladder=(1, 2, 4), param_bytes_per_chip=10**4)),
    (dict(strategy="periodic", period=64, overlap="delayed"),
     dict(ladder=(32, 64, 128), adapt_every=3)),
]


@pytest.mark.parametrize("c", range(len(CONTROLLERS)))
@pytest.mark.parametrize("feed", ["direct", "blocks", "blocks+sync"])
def test_controller_history_matches(c, feed):
    """Both packages' controllers, fed the same block times (block walls
    at the current H, with or without the sync's time, or separately timed
    steps and syncs, with norms), move H alike: the same history."""
    cfg_kw, kw = CONTROLLERS[c]
    got, want = _controllers(cfg_kw, **kw)
    rng = np.random.default_rng(c)
    for i in range(24):
        t_step = float(rng.uniform(1e-4, 2e-3))
        t_sync = float(rng.choice([1e-4, 1e-3, 2e-2, 1.0]))
        kw = dict(grad_norm=float(rng.uniform(0.1, 2.0)),
                  param_norm=float(rng.uniform(1.0, 10.0))) if i % 3 else {}
        if feed == "direct":
            kw.update(step_s=t_step, sync_s=t_sync)
        else:
            kw["block_s"] = want.h * t_step + t_sync
            if feed == "blocks+sync":
                kw["sync_s"] = t_sync
        assert got.observe_block(**kw) == want.observe_block(**kw)
    assert got.history == want.history
    gd, wd = got.to_dict(), want.to_dict()
    assert gd["h"] == wd["h"] and gd["blocks"] == wd["blocks"]
    assert gd["history"] == wd["history"]


def test_controller_moves_only_onto_rungs():
    got, _ = _controllers(dict(strategy="periodic"), h0=1, adapt_every=1,
                          ladder=(1, 2, 4))
    got.telemetry._skip_step = got.telemetry._skip_sync = 0
    got.observe_block(step_s=1e-6, sync_s=10.0)
    assert got.h == 4                   # top rung, not h_max=1024
    fresh, _ = _controllers(dict(strategy="periodic"), h0=4, adapt_every=1)
    fresh.observe_block(block_s=1.0)     # single H: split underdetermined
    assert fresh.h == 4


# ---------------------------------------------------------------------------
# the port's timed paths feed the telemetry
# ---------------------------------------------------------------------------

def test_svm_timed_steps_feed_split_estimates():
    from repro_torch.core import svm
    tel = TT.BlockTelemetry(warmup=1)
    rng = np.random.default_rng(0)
    xb = torch.from_numpy(rng.normal(size=(1, 4, 8)).astype(np.float32))
    yb = torch.ones((1, 4))
    w0 = torch.zeros(8)
    compute, sync = svm.dms_timed_steps(block_size=4, telemetry=tel)
    for _ in range(3):
        sync(compute(w0, xb, yb, 0.5))
    est = tel.estimates()
    assert est is not None and est[0] > 0 and est[1] > 0
    assert tel.n_syncs == 2 and tel.n_steps == 8


@pytest.mark.parametrize("strategy", ["sync_every_step", "periodic"])
def test_local_sgd_train_step_records_blocks(strategy):
    """Three steps with telemetry: the warmup drops the first and the rest
    are recorded at H; the local-SGD block also records its sync's time."""
    from repro_torch.core import local_sgd as LS
    from repro_torch.models.registry import build_model
    k = 2 if strategy == "periodic" else 0
    cfg = TrainConfig(
        model=dataclasses.replace(get_smoke("smollm-360m"), dtype="float32"),
        mesh=MeshConfig(shape=(max(1, k),), axis_names=("pod",),
                        replica_axis="pod"),
        sync=SyncConfig(strategy=strategy, period=2),
        optimizer=OptimizerConfig(name="sgd", learning_rate=0.1),
        data=DataConfig(seq_len=8, global_batch=2))
    model = build_model(cfg.model, attn_impl="torch")
    tel = TT.BlockTelemetry(warmup=1)
    state = LS.init_state(model, cfg, torch.Generator().manual_seed(0), k)
    step = LS.make_train_step(model, cfg, telemetry=tel)
    rng = np.random.default_rng(0)
    shape = (2, 2, 8) if k else (2, 8)
    batch = {n: torch.from_numpy(rng.integers(0, 64, shape).astype(np.int32))
             for n in ("tokens", "targets")}
    for _ in range(3):
        state, _ = step(state, batch)
    assert tel.n_blocks == 2
    assert tel.n_syncs == (2 if k else 0)
    if k:
        t_step, t_sync = tel.estimates()
        assert t_step > 0 and t_sync > 0 and math.isfinite(t_sync)
