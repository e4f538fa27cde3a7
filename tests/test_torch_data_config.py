"""The port's numpy-only modules against the reference: the SVM data
generator and the LM token stream and pipeline (byte-identical), the
configs and their override layer, and the cost model (exactly equal); and
the port's import without JAX."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.config import base as jbase
from repro.config import cli as jcli
from repro.configs import smollm_360m as jsmollm
from repro.configs import svm_datasets as jdatasets
from repro.core import costmodel as jcost
from repro.data import pipeline as jpipeline
from repro.data import synthetic as jsynth
from repro_torch.config import base as tbase
from repro_torch.config import cli as tcli
from repro_torch.configs import smollm_360m as tsmollm
from repro_torch.configs import svm_datasets as tdatasets
from repro_torch.core import costmodel as tcost
from repro_torch.data import pipeline as tpipeline
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
                                 "SSMConfig", "ModelConfig", "MeshConfig",
                                 "OptimizerConfig", "CheckpointConfig",
                                 "FaultToleranceConfig", "TrainConfig"])
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


@pytest.mark.parametrize("step,seed,batch,seq,vocab", [
    (0, 0, 8, 64, 512), (3, 0, 8, 64, 512), (7, 5, 2, 2048, 49152),
    (123, 1, 5, 17, 1000)])
def test_synthetic_lm_batch_byte_identical(step, seed, batch, seq, vocab):
    kw = dict(global_batch=batch, seq_len=seq, vocab_size=vocab, seed=seed)
    want = jsynth.synthetic_lm_batch(step, **kw)
    got = tsynth.synthetic_lm_batch(step, **kw)
    assert sorted(got) == sorted(want) == ["targets", "tokens"]
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert got[k].tobytes() == want[k].tobytes()


def test_data_pipeline_byte_identical():
    data = dict(seq_len=32, global_batch=4, seed=2)
    jp = jpipeline.DataPipeline(jbase.DataConfig(**data), jsmollm.smoke(),
                                start_step=3)
    tp = tpipeline.DataPipeline(tbase.DataConfig(**data), tsmollm.smoke(),
                                start_step=3)
    assert tp.peek_shapes() == jp.peek_shapes()
    for _ in range(2):
        want, got = jp.next_host(), tp.next_host()
        assert all(got[k].tobytes() == want[k].tobytes() for k in want)
    assert tp.state() == jp.state() == {"step": 5}
    batch = next(tp)
    assert batch["tokens"].dtype == torch.int32
    assert batch["tokens"].numpy().tobytes() == next(jp)["tokens"].tobytes()
    tp.restore({"step": 3})
    jp.restore({"step": 3})
    assert tp.next_host()["targets"].tobytes() == \
        jp.next_host()["targets"].tobytes()


def test_train_config_replace_asdict_fingerprint():
    def make(base, cli, model):
        cfg = base.TrainConfig(model=model, steps=7)
        cfg = base.replace(cfg, **{"sync.period": 4, "optimizer.name": "adamw",
                                   "seed": 3})
        return cli.apply_overrides(cfg, ["sync.strategy=periodic",
                                         "sync.compression=int8",
                                         "data.seq_len=2048",
                                         "optimizer.learning_rate=0.001",
                                         "sync.gossip_async=false"])
    got = make(tbase, tcli, tsmollm.full())
    want = make(jbase, jcli, jsmollm.full())
    assert tbase.asdict(got) == jbase.asdict(want)
    assert tbase.config_fingerprint(got) == jbase.config_fingerprint(want)
    assert got.sync.period == 4 and got.data.seq_len == 2048
    assert tbase.MeshConfig((4, 2), ("pod", "data")).axis_size("pod") == 4
    assert tbase.MeshConfig((4, 2), ("pod", "data")).num_devices == 8
    with pytest.raises(ValueError):
        tcli.apply_overrides(got, ["sync.period"])
    args = tcli.build_parser("t").parse_args(["--set", "a=1", "--arch", "x"])
    want_args = jcli.build_parser("t").parse_args(["--set", "a=1", "--arch",
                                                   "x"])
    assert vars(args) == vars(want_args)


def test_port_imports_without_jax():
    """Every module of the port imports with JAX and the reference package
    made unimportable."""
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    code = (
        "import importlib, pkgutil, sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'repro_torch.core.local_sgd' in names, names\n"
        "assert 'repro_torch.kernels.quant.ops' in names, names\n"
        "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=src))
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 30
