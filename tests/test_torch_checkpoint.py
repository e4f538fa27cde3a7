"""The port's checkpoint manager and elastic reshaping
(``repro_torch.checkpoint``) on the CPU: ``tests/test_checkpoint.py``'s
manager and elastic cases on the port's state trees, a bf16 leaf round-
tripped bitwise, the on-disk layout read across packages (a checkpoint the
port writes restores in the reference's manager, and the reverse, bitwise),
the elastic helpers against the reference's, and a mid-stream resume of
live sync state bitwise equal to the uninterrupted run.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint import elastic as JE
from repro.config import CheckpointConfig as JCheckpointConfig
from repro_torch import tree as T
from repro_torch.checkpoint import CheckpointManager, rescale_replicated_state
from repro_torch.checkpoint.elastic import add_replica_dim, drop_replica_dim
from repro_torch.config import CheckpointConfig, SyncConfig
from repro_torch.core import sync as S

torch.set_num_threads(1)


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": torch.from_numpy(rng.normal(size=(4, 8)).astype(
                       np.float32)),
                   "b": torch.from_numpy(rng.normal(size=(8,)).astype(
                       np.float32)),
                   "layers": [{"h": torch.from_numpy(rng.normal(
                       size=(2, 3)).astype(np.float32))} for _ in range(2)]},
        "opt": {"mu": {"w": torch.zeros((4, 8)), "b": torch.zeros(8)},
                "count": torch.tensor(3, dtype=torch.int32)},
        "step": 7,
    }


def _equal(a, b):
    for x, y in zip(T.leaves(a), T.leaves(b)):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x, y)
        else:
            assert type(x) is type(y) and x == y


def _mgr(tmp_path, **kw):
    return CheckpointManager(CheckpointConfig(directory=str(tmp_path), **kw))


class TestManager:
    def test_roundtrip(self, tmp_path):
        mgr = _mgr(tmp_path)
        s = _state()
        mgr.save(7, s, extra={"data": {"step": 7}})
        restored, extra = mgr.restore(T.map(
            lambda x: torch.zeros_like(x) if isinstance(x, torch.Tensor)
            else 0, s))
        _equal(s, restored)
        assert extra == {"data": {"step": 7}}

    def test_layout(self, tmp_path):
        mgr = _mgr(tmp_path)
        mgr.save(12, _state())
        assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_000000012"]
        assert open(tmp_path / "LATEST").read() == "step_000000012"
        with open(tmp_path / "step_000000012" / "manifest.json") as f:
            manifest = json.load(f)
        assert manifest["keys"][:3] == ["opt/count", "opt/mu/b", "opt/mu/w"]
        assert "params/layers/1/h" in manifest["keys"]
        assert manifest["dtypes"]["opt/count"] == "int32"
        assert manifest["shapes"]["params/w"] == [4, 8]

    def test_latest_and_keep_last(self, tmp_path):
        mgr = _mgr(tmp_path, keep_last=2)
        for step in (1, 2, 3, 4):
            mgr.save(step, _state(step))
        assert mgr.latest_step() == 4
        assert mgr.all_steps() == [3, 4]

    def test_async_write(self, tmp_path):
        mgr = _mgr(tmp_path, async_write=True)
        s = _state()
        mgr.save(1, s)
        mgr.wait()
        restored, _ = mgr.restore(s)
        _equal(s, restored)

    def test_fingerprint_mismatch_raises(self, tmp_path):
        mgr = _mgr(tmp_path)
        mgr.save(1, _state(), fingerprint="abc")
        with pytest.raises(ValueError, match="fingerprint"):
            mgr.restore(_state(), expected_fingerprint="def")
        mgr.restore(_state(), expected_fingerprint="abc")

    def test_no_tmp_dirs_left(self, tmp_path):
        mgr = _mgr(tmp_path)
        mgr.save(1, _state())
        assert not [d for d in os.listdir(tmp_path) if d.startswith(".")]

    def test_missing_checkpoint_raises(self, tmp_path):
        mgr = _mgr(tmp_path / "none")
        assert mgr.all_steps() == [] and mgr.latest_step() is None
        assert not os.path.exists(tmp_path / "none")   # made at first save
        with pytest.raises(FileNotFoundError):
            mgr.restore(_state())

    def test_missing_key_raises(self, tmp_path):
        mgr = _mgr(tmp_path)
        mgr.save(1, {"a": torch.zeros(2)})
        with pytest.raises(KeyError, match="missing"):
            mgr.restore({"a": torch.zeros(2), "b": torch.zeros(2)})

    def test_bf16_leaf_bitwise(self, tmp_path):
        """numpy has no bf16: the leaf is stored as its uint16 bits and
        comes back bitwise, NaN, inf and subnormal bits included."""
        rng = np.random.default_rng(5)
        bits = rng.integers(0, 2 ** 16, size=(3, 257)).astype(np.uint16)
        bits[0, :4] = [0x7FC0, 0x7F80, 0xFF80, 0x0001]
        x = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
        state = {"x": x, "y": x.float()[:, :5]}
        mgr = _mgr(tmp_path)
        mgr.save(1, state)
        with open(tmp_path / "step_000000001" / "manifest.json") as f:
            assert json.load(f)["dtypes"]["x"] == "bfloat16"
        with np.load(tmp_path / "step_000000001" / "arrays.npz") as npz:
            assert npz["x"].dtype == np.uint16
            np.testing.assert_array_equal(npz["x"], bits)
        back, _ = mgr.restore({"x": torch.zeros(3, 257, dtype=torch.bfloat16),
                               "y": torch.zeros(3, 5)})
        assert back["x"].dtype == torch.bfloat16
        assert torch.equal(back["x"].view(torch.int16), x.view(torch.int16))
        assert torch.equal(back["y"].view(torch.int32),
                           state["y"].view(torch.int32))

    def test_restore_onto_like_devices(self, tmp_path):
        mgr = _mgr(tmp_path)
        mgr.save(1, {"a": torch.ones(2)})
        back, _ = mgr.restore({"a": torch.zeros(2)}, device="cpu")
        assert back["a"].device.type == "cpu" and float(back["a"][0]) == 1.0


class TestAcrossPackages:
    """The same on-disk layout: each package restores the other's
    checkpoint bitwise (f32 and int32 leaves; a bf16 leaf is the port's
    own encoding)."""

    def test_port_writes_reference_reads(self, tmp_path):
        s = _state(3)
        _mgr(tmp_path).save(5, s, extra={"data": {"step": 5}},
                            fingerprint="fp")
        like = {"params": {"w": jnp.zeros((4, 8)), "b": jnp.zeros(8),
                           "layers": [{"h": jnp.zeros((2, 3))}] * 2},
                "opt": {"mu": {"w": jnp.zeros((4, 8)), "b": jnp.zeros(8)},
                        "count": jnp.int32(0)},
                "step": jnp.int32(0)}
        got, extra = JManager(JCheckpointConfig(
            directory=str(tmp_path))).restore(like, expected_fingerprint="fp")
        assert extra == {"data": {"step": 5}}
        assert int(got["step"]) == 7
        for a, b in zip(jax.tree.leaves(got), T.leaves(s)):
            if isinstance(b, torch.Tensor):
                np.testing.assert_array_equal(np.asarray(a), b.numpy())

    def test_reference_writes_port_reads(self, tmp_path):
        rng = np.random.default_rng(4)
        w = rng.normal(size=(4, 8)).astype(np.float32)
        JManager(JCheckpointConfig(directory=str(tmp_path))).save(
            9, {"params": {"w": jnp.asarray(w)}, "step": jnp.int32(9)},
            extra={"ladder": {"h": 2, "blocks": 3}})
        mgr = _mgr(tmp_path)
        assert mgr.latest_step() == 9
        got, extra = mgr.restore({"params": {"w": torch.zeros(4, 8)},
                                  "step": 0})
        assert extra["ladder"] == {"h": 2, "blocks": 3}
        assert got["step"] == 9 and isinstance(got["step"], int)
        assert got["params"]["w"].numpy().tobytes() == w.tobytes()


class TestElastic:
    def test_shrink_averages(self):
        s = {"w": torch.stack([torch.ones(4), 3 * torch.ones(4)])}
        out = rescale_replicated_state(s, 2, 1)
        np.testing.assert_allclose(out["w"].numpy(), 2 * np.ones((1, 4)))

    def test_grow_broadcasts_average(self):
        s = {"w": torch.stack([torch.ones(4), 3 * torch.ones(4)])}
        out = rescale_replicated_state(s, 2, 4)
        assert tuple(out["w"].shape) == (4, 4) and out["w"].is_contiguous()
        np.testing.assert_allclose(out["w"].numpy(), 2.0)

    def test_add_then_drop_is_identity(self):
        s = {"w": torch.arange(6.0).reshape(2, 3)}
        up = add_replica_dim(s, 4)
        assert tuple(up["w"].shape) == (4, 2, 3)
        np.testing.assert_allclose(drop_replica_dim(up)["w"].numpy(),
                                   s["w"].numpy())

    def test_scalar_leaves_pass_through(self):
        s = {"step": 5, "cnt": torch.tensor(5, dtype=torch.int32),
             "w": torch.ones((2, 3))}
        out = rescale_replicated_state(s, 2, 3)
        assert out["step"] == 5 and int(out["cnt"]) == 5
        assert tuple(out["w"].shape) == (3, 3)
        assert rescale_replicated_state(s, 2, 2) is s

    @pytest.mark.parametrize("old,new", [(4, 2), (2, 8), (3, 3)])
    def test_matches_reference(self, old, new):
        rng = np.random.default_rng(old * 10 + new)
        arrays = {"w": rng.normal(size=(old, 5, 3)).astype(np.float32),
                  "b": rng.normal(size=(old, 7)).astype(np.float32),
                  "other": rng.normal(size=(old + 1, 2)).astype(np.float32)}
        got = rescale_replicated_state(
            {k: torch.from_numpy(v) for k, v in arrays.items()}, old, new)
        want = JE.rescale_replicated_state(
            {k: jnp.asarray(v) for k, v in arrays.items()}, old, new)
        for k in arrays:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7)
        down = drop_replica_dim({"w": torch.from_numpy(arrays["w"])})
        np.testing.assert_allclose(
            down["w"].numpy(),
            np.asarray(JE.drop_replica_dim({"w": jnp.asarray(
                arrays["w"])})["w"]), rtol=1e-6, atol=1e-7)


SYNC_CFGS = [
    SyncConfig(strategy="periodic", overlap="delayed", compression="int8",
               slowmo=0.6, slowmo_lr=0.9),
    SyncConfig(strategy="periodic", overlap="delayed", compression="int16",
               topology="ring"),
    SyncConfig(strategy="periodic", overlap="chunked", chunks=2, slowmo=0.5),
    SyncConfig(strategy="periodic", overlap="chunked", chunks=2,
               compression="int8", topology="pairwise"),
    SyncConfig(strategy="periodic", topology="ring", gossip_async=True,
               compression="int8"),
]


@pytest.mark.parametrize("cfg", SYNC_CFGS,
                         ids=[c.msf_label for c in SYNC_CFGS])
def test_mid_stream_resume_bitexact(cfg, tmp_path):
    """``tests/test_checkpoint.py``'s mid-stream resume on the port's sync
    engine: live overlap state (pending, EF residual, slowmo momentum,
    counters nonzero, replicas divergent) checkpointed after 2 boundaries,
    restored and continued, bitwise the uninterrupted run."""
    k, d, nb = 4, 16, 5
    rng = np.random.default_rng(0)
    w0 = torch.from_numpy(rng.normal(size=(d,)).astype(np.float32))
    upds = torch.from_numpy(rng.normal(size=(nb, k, d)).astype(np.float32))

    def step(p, st, u):
        return S.sync_point(p, {"w": p["w"] + u}, st, cfg, impl="torch")

    p = {"w": w0.expand(k, d).clone()}
    st = T.map(lambda x: x.unsqueeze(0).repeat((k,) + (1,) * x.dim()),
               S.init_sync_state(cfg, {"w": w0}))
    for t in range(2):
        p, st = step(p, st, upds[t])
    mgr = _mgr(tmp_path)
    mgr.save(2, {"params": p, "sync": st})
    pa, sa = p, st
    for t in range(2, nb):
        pa, sa = step(pa, sa, upds[t])
    like = T.map(torch.zeros_like, {"params": p, "sync": st})
    restored, _ = mgr.restore(like)
    pb, sb = restored["params"], restored["sync"]
    for t in range(2, nb):
        pb, sb = step(pb, sb, upds[t])
    _equal(pa, pb)
    _equal(sa, sb)
    for key in ("pending", "ef", "slowmo_m", "mixbuf"):
        if key in st:
            assert float(st[key]["w"].abs().max()) > 0, key
    if "chunk_idx" in st:
        assert int(st["chunk_idx"][0]) == 2
