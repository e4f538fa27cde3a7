"""The port's numpy-only modules against the reference: the SVM data
generator (byte-identical), the dataset and sync configs, and the cost
model (exactly equal)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.config import base as jbase
from repro.configs import svm_datasets as jdatasets
from repro.core import costmodel as jcost
from repro.data import synthetic as jsynth
from repro_torch.config import base as tbase
from repro_torch.configs import svm_datasets as tdatasets
from repro_torch.core import costmodel as tcost
from repro_torch.data import synthetic as tsynth

torch.set_num_threads(1)

ARRAYS = ("x_train", "y_train", "x_cv", "y_cv", "x_test", "y_test")


@pytest.mark.parametrize("name,n_override", [
    ("ijcnn1", None), ("ijcnn1", 4000), ("webspam", 3000), ("webspam", 777),
    ("epsilon", 600), ("epsilon", 1001)])
@pytest.mark.parametrize("seed", [0, 3])
def test_make_svm_dataset_byte_identical(name, n_override, seed):
    want = jsynth.make_svm_dataset(name, seed=seed, n_override=n_override)
    got = tsynth.make_svm_dataset(name, seed=seed, n_override=n_override)
    assert got.name == want.name
    for field in ARRAYS:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert a.tobytes() == b.tobytes(), field
    assert tsynth.PAPER_DATASETS == jsynth.PAPER_DATASETS


def test_unknown_dataset_raises():
    with pytest.raises(KeyError):
        tsynth.make_svm_dataset("mnist")


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("cls", ["DataConfig", "SyncConfig", "MoEConfig",
                                 "SSMConfig", "ModelConfig"])
def test_config_fields_and_defaults(cls):
    assert _fields(getattr(tbase, cls)) == _fields(getattr(jbase, cls))
    # the defaults made by a factory (ModelConfig.moe/ssm) too
    assert (dataclasses.asdict(getattr(tbase, cls)())
            == dataclasses.asdict(getattr(jbase, cls)()))


@pytest.mark.parametrize("kw", [{}, {"head_dim": 48}, {"d_model": 960,
                                                      "n_heads": 15},
                                {"moe": {"num_experts": 4}}])
def test_model_config_properties(kw):
    def make(base):
        extra = ({"moe": base.MoEConfig(**kw["moe"])} if "moe" in kw
                 else kw)
        return base.ModelConfig(**extra)
    got, want = make(tbase), make(jbase)
    assert got.resolved_head_dim == want.resolved_head_dim
    assert got.is_moe == want.is_moe


def test_svm_dataset_configs():
    assert tdatasets.SVM_DATASETS.keys() == jdatasets.SVM_DATASETS.keys()
    for name, cfg in jdatasets.SVM_DATASETS.items():
        assert (dataclasses.asdict(tdatasets.SVM_DATASETS[name])
                == dataclasses.asdict(cfg))
    for attr in ("IJCNN1", "WEBSPAM", "EPSILON"):
        assert (dataclasses.asdict(getattr(tdatasets, attr))
                == dataclasses.asdict(getattr(jdatasets, attr)))


SYNC_CASES = [
    {},
    {"strategy": "periodic", "period": 16},
    {"period": 48, "adapt_h_max": 32, "ladder_base": 3},
    {"period": 5, "adapt_ladder": (2, 8, 4, 8)},
    {"period": 0, "adapt_h_max": 0},
    {"overlap": "delayed", "topology": "ring", "compression": "int8"},
    {"overlap": "chunked", "chunks": 8, "adaptive": True},
    {"topology": "pairwise", "gossip_async": True, "period": 64},
]


@pytest.mark.parametrize("kw", SYNC_CASES)
def test_sync_config_methods(kw):
    want, got = jbase.SyncConfig(**kw), tbase.SyncConfig(**kw)
    assert got.ladder_rungs() == want.ladder_rungs()
    assert got.msf_label == want.msf_label


@pytest.mark.parametrize("world", [2, 4, 8, 16])
@pytest.mark.parametrize("topology", ["all", "ring", "pairwise"])
def test_costmodel_exact(world, topology):
    for a, b in zip(tcost.mixing_matrices(world, topology),
                    jcost.mixing_matrices(world, topology), strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tcost.gossip_lambda2(world, topology) == jcost.gossip_lambda2(
        world, topology)
    assert tcost.spectral_gap(world, topology) == jcost.spectral_gap(
        world, topology)
    for s in (0, 1, 3):
        assert (tcost.effective_spectral_gap(world, topology, staleness=s)
                == jcost.effective_spectral_gap(world, topology, staleness=s))
    assert tcost.gossip_degree(topology) == jcost.gossip_degree(topology)
    for compression in ("none", "int8", "int16"):
        for overlap in ("none", "delayed", "chunked"):
            for gossip_async in ((False, True) if topology != "all"
                                 else (False,)):
                kw = dict(topology=topology, compression=compression,
                          overlap=overlap, chunks=3, gossip_async=gossip_async)
                tcfg, jcfg = tbase.SyncConfig(**kw), jbase.SyncConfig(**kw)
                assert (tcost.wire_bytes_per_sync(4_000_000, world, tcfg)
                        == jcost.wire_bytes_per_sync(4_000_000, world, jcfg))
                for h in (0, 1, 7, 64):
                    assert (tcost.overlapped_step_time(1e-3, 2.5e-2, h, tcfg)
                            == jcost.overlapped_step_time(1e-3, 2.5e-2, h,
                                                          jcfg))


@pytest.mark.parametrize("world", [3, 5])
def test_costmodel_pairwise_odd_world_raises(world):
    with pytest.raises(ValueError, match="even"):
        tcost.mixing_matrices(world, "pairwise")
    with pytest.raises(ValueError, match="even"):
        jcost.mixing_matrices(world, "pairwise")


def test_costmodel_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError):
        tcost.mixing_matrices(4, "star")
    with pytest.raises(ValueError):
        tcost.effective_spectral_gap(4, "ring", staleness=-1)
