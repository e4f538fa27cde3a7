"""repro_torch.simsync against repro.simsync: the same profiles, schedules,
results, block stats, timelines, Chrome traces, oracle H and adaptive
histories, bitwise, for every built-in profile in every mode the reference
accepts; and the same refusals."""
import dataclasses
import itertools
import json

import pytest

from repro.config import SyncConfig as JSyncConfig
from repro.core.autotune import AdaptiveController as JController
import repro.simsync as J

from repro_torch.config.base import SyncConfig as TSyncConfig
from repro_torch.core.autotune import AdaptiveController as TController
import repro_torch.simsync as S

PROFILE_NAMES = sorted(J.PROFILES)
# every topology × overlap × compression × async combination; the ones a
# package refuses are held to the same refusal
MODES = [dict(topology=t, overlap=o, compression=c, gossip_async=a)
         for t, o, c, a in itertools.product(
             ("all", "ring", "pairwise"), ("none", "delayed", "chunked"),
             ("none", "int8", "int16"), (False, True))]


def _cfgs(mode):
    kw = dict(strategy="periodic", chunks=3, **mode)
    return JSyncConfig(**kw), TSyncConfig(**kw)


def _odd(pkg):
    return pkg.uniform_profile("odd", 3, step_time=1e-3, jitter=0.0,
                               bandwidth=1e9, latency=0.0, param_bytes=1000)


def test_profiles_are_the_reference_numbers():
    assert sorted(S.PROFILES) == PROFILE_NAMES
    for name in PROFILE_NAMES:
        assert S.get_profile(name).to_dict() == J.get_profile(name).to_dict()
        back = S.ClusterProfile.from_dict(J.PROFILES[name].to_dict())
        assert back == S.PROFILES[name]
    assert (S.profiles.DCN_LATENCY, S.profiles.ICI_LATENCY) == (
        J.profiles.DCN_LATENCY, J.profiles.ICI_LATENCY)
    with pytest.raises(KeyError):
        S.get_profile("h100")


@pytest.mark.parametrize("name", PROFILE_NAMES)
def test_every_mode_bitwise(name):
    """For each accepted mode: the summary, every BlockStats, the timeline
    and the Chrome trace equal; a refused mode refused by both alike."""
    jp, tp = J.PROFILES[name], S.PROFILES[name]
    ran = 0
    for i, mode in enumerate(MODES):
        jcfg, tcfg = _cfgs(mode)
        outcomes = []
        for pkg, prof, cfg in ((J, jp, jcfg), (S, tp, tcfg)):
            try:
                sim = pkg.ClusterSim(prof, cfg, seed=i, record_timeline=True)
            except ValueError as e:
                outcomes.append(("refused", str(e)))
                continue
            stats = [dataclasses.astuple(sim.run_block(h))
                     for h in (1, 4, 4, 8, 2, 16)]
            res = sim.result(8)
            outcomes.append((
                res.summary(), stats,
                [dataclasses.astuple(s) for s in res.timeline],
                json.dumps(pkg.chrome_trace(res)),
                pkg.sync_wire_time_s(prof, cfg)))
        assert outcomes[0] == outcomes[1], (name, mode)
        ran += outcomes[0][0] != "refused"
    # async under "all" refused; the rest run (the 8 workers are even)
    assert ran == len(MODES) - 9


def test_refusals_match():
    for pkg, cfg_cls in ((J, JSyncConfig), (S, TSyncConfig)):
        with pytest.raises(ValueError, match="even"):
            pkg.ClusterSim(_odd(pkg), cfg_cls(strategy="periodic",
                                              topology="pairwise"))
        with pytest.raises(ValueError, match="gossip topology"):
            pkg.ClusterSim(pkg.PROFILES["dcn_default"],
                           cfg_cls(strategy="periodic", gossip_async=True))
        with pytest.raises(ValueError, match="steps= or blocks="):
            pkg.simulate(pkg.PROFILES["dcn_default"], h=4)


@pytest.mark.parametrize("name", PROFILE_NAMES)
def test_simulate_and_oracle_bitwise(name):
    jcfg, tcfg = _cfgs(dict(topology="ring", overlap="delayed"))
    for jc, tc in ((None, None), (jcfg, tcfg)):
        a = J.simulate(J.PROFILES[name], jc, h=6, steps=600, seed=2)
        b = S.simulate(S.PROFILES[name], tc, h=6, steps=600, seed=2)
        assert a.summary() == b.summary()
        assert J.oracle_h(J.PROFILES[name], jc, steps=512) == S.oracle_h(
            S.PROFILES[name], tc, steps=512)


@pytest.mark.parametrize("name", PROFILE_NAMES)
def test_adaptive_history_bitwise(name):
    """simulate_adaptive with the port's controller against the reference's
    with the reference's: the same (block, H) history and result."""
    out = []
    for pkg, ctrl_cls, cfg in ((J, JController, JSyncConfig(
            strategy="periodic")), (S, TController, TSyncConfig(
                strategy="periodic"))):
        prof = pkg.PROFILES[name]
        ctrl = ctrl_cls(cfg, param_bytes_per_chip=prof.param_bytes,
                        replicas=prof.world, link_bw=prof.link.bandwidth,
                        h0=1, adapt_every=4, lr=1e-6, h_max=64)
        res, hist = pkg.simulate_adaptive(prof, cfg, ctrl, blocks=48, seed=1,
                                          record_timeline=True)
        out.append((res.summary(), hist, json.dumps(pkg.chrome_trace(res))))
    assert out[0] == out[1]
    assert len(out[0][1]) >= 2          # the controller moved


def test_save_chrome_trace(tmp_path):
    res = S.simulate(S.PROFILES["dcn_straggler"], h=4, blocks=3,
                     record_timeline=True)
    path = S.save_chrome_trace(str(tmp_path / "t.json"), res)
    with open(path) as f:
        doc = json.load(f)
    want = J.chrome_trace(J.simulate(J.PROFILES["dcn_straggler"], h=4,
                                     blocks=3, record_timeline=True))
    assert doc == json.loads(json.dumps(want))
