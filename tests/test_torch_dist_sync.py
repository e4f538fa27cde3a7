"""The port's sync engine across processes (``sync_point(…, mesh=…)``, one
replica a rank) against the reference's ``sync_point`` inside
``jax.shard_map`` on K fake CPU devices.

One subprocess runs ``tests/test_torch_sync.py``'s reference script over
this file's modes (every overlap × topology, both wires, async gossip,
slowmo, and the int16 wire at K ∈ {2, 4, 8}) and dumps inputs and outputs;
one ``repro_torch.launch.mesh.spawn`` of 8 gloo CPU ranks runs them all
(K = 2 and 4 on meshes whose ``pod`` axis has that many ranks), each rank
fed its replica's row of the reference's inputs at each boundary. Each mode
is a test case here.

Bounds: ``tests/test_torch_sync.py``'s: params and sync leaves rtol 1e-6 /
atol 1e-7, the error-feedback residual and the pending correction atol
5e-7, counters equal; the int8 payload each rank quantizes bitwise the
reference's, its scale to one ulp. The int16 wire's sum runs on int32
across ranks; with the ``32767 // K`` guard it is the reference's int16
``psum`` exactly.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import run_with_devices
from repro.config import SyncConfig as JSyncConfig
from repro.core import sync as JS
from repro_torch.launch import mesh as M
from test_torch_sync import (ATOL, DIFF_ATOL, REFERENCE, RTOL, SHAPES,
                             _flat, _subtree)

import torch_dist_ranks as R

MODES = [dict(compression=comp) for comp in ("none", "int8", "int16")]
MODES += [dict(overlap="delayed", compression="int8"),
          dict(overlap="delayed", topology="ring"),
          dict(overlap="delayed", topology="pairwise", compression="int16"),
          dict(overlap="chunked"),
          dict(overlap="chunked", compression="int16"),
          dict(overlap="chunked", topology="ring", compression="int8"),
          dict(overlap="chunked", topology="pairwise"),
          dict(topology="ring", compression="int8"),
          dict(topology="pairwise", compression="int16"),
          dict(topology="ring", gossip_async=True),
          dict(topology="pairwise", gossip_async=True, compression="int8"),
          dict(slowmo=0.5, slowmo_lr=0.8),
          dict(slowmo=0.5, overlap="delayed", compression="int8"),
          dict(slowmo=0.5, overlap="chunked", compression="int8"),
          dict(compression="int16", k=2),
          dict(compression="int16", k=8),
          dict(compression="int8", k=8),
          dict(topology="pairwise", compression="int8", k=2),
          dict(overlap="chunked", topology="ring", compression="int16", k=8)]
FLUSH_MODES = [dict(overlap="delayed", compression="int8"),
               dict(overlap="chunked"), dict(topology="ring"),
               dict(topology="pairwise", gossip_async=True,
                    compression="int16")]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("dist_sync") / "reference.npz"
    code = (REFERENCE.replace("__MODES__", json.dumps(MODES))
            .replace("__SHAPES__", json.dumps(SHAPES))
            .replace("__OUT__", str(path)))
    assert "OK" in run_with_devices(code, n_devices=8, timeout=600)
    with np.load(path) as data:
        return {key: data[key] for key in data.files}


def _np_subtree(data, prefix):
    return jax.tree.map(lambda t: t.numpy(), _subtree(data, prefix))


@pytest.fixture(scope="module")
def ranks(reference):
    inputs = [[tuple(_np_subtree(reference, f"m{i}/b{b}/in/{part}")
                     for part in ("start", "end", "sync"))
               for b in range(2)] for i in range(len(MODES))]
    return M.spawn(R.sync_modes, 8, backend="gloo", device="cpu",
                   args=(MODES, inputs), timeout_s=600)


@pytest.mark.parametrize("i", range(len(MODES)),
                         ids=[json.dumps(m, sort_keys=True) for m in MODES])
def test_sync_point_across_ranks_matches_reference(reference, ranks, i):
    k = MODES[i].get("k", 4)
    for b in range(2):
        tag = f"m{i}/b{b}"
        want_p = _flat(_subtree(reference, f"{tag}/out/params"))
        want_s = _flat(_subtree(reference, f"{tag}/out/sync"))
        wire = _subtree(reference, f"{tag}/out/wire")
        for r in range(k):
            params, state, got_wire = ranks[r][i][b]
            got_p, got_s = _flat(params), _flat(state)
            assert sorted(got_p) == sorted(want_p)
            assert sorted(got_s) == sorted(want_s)
            for key, want in want_p.items():
                want = want.numpy()[r:r + 1]
                assert got_p[key].shape == want.shape, key
                np.testing.assert_allclose(got_p[key], want, rtol=RTOL,
                                           atol=ATOL,
                                           err_msg=f"{tag} rank {r} {key}")
            for key, want in want_s.items():
                want = want.numpy()[r:r + 1]
                got = got_s[key]
                assert got.shape == want.shape and got.dtype == want.dtype
                np.testing.assert_allclose(
                    got, want, rtol=RTOL,
                    atol=(DIFF_ATOL if key.startswith(("/ef/", "/pending/"))
                          else ATOL), err_msg=f"{tag} rank {r} sync{key}")
            if wire:
                q, scale = got_wire
                for key, want in _flat(wire["q"]).items():
                    got = _flat(q)[key]
                    want = want.numpy()[r:r + 1].reshape(got.shape)
                    assert got.dtype == want.dtype == np.int8
                    assert got.tobytes() == want.tobytes(), \
                        f"{tag} rank {r} wire q{key}"
                for key, want in _flat(wire["scale"]).items():
                    got = _flat(scale)[key]
                    np.testing.assert_allclose(
                        got, want.numpy()[r:r + 1].reshape(got.shape),
                        rtol=RTOL)


@pytest.fixture(scope="module")
def flushed():
    rng = np.random.default_rng(3)
    k = 4
    params = {"w": rng.normal(size=(k, 5, 3)).astype(np.float32),
              "v": {"s": rng.normal(size=(k, 7)).astype(np.float32)}}
    states, wants = [], []
    for mode in FLUSH_MODES:
        jcfg = JSyncConfig(strategy="periodic", **mode)
        state = jax.tree.map(
            lambda x: np.broadcast_to(np.asarray(x), (k,) + x.shape),
            JS.init_sync_state(jcfg, jax.tree.map(lambda x: x[0], params)))
        state = jax.tree.map(
            lambda x: np.array(x) if x.dtype == np.int32 else
            (x + 0.01 * rng.normal(size=x.shape)).astype(np.float32), state)
        states.append(state)
        wants.append(jax.tree.map(np.asarray, JS.flush_overlap(
            jax.tree.map(jnp.asarray, params),
            jax.tree.map(jnp.asarray, state), jcfg)))
    got = M.spawn(R.flush_modes, 4, backend="gloo", device="cpu",
                  args=(FLUSH_MODES, params, states), timeout_s=300)
    return got, wants


@pytest.mark.parametrize("j", range(len(FLUSH_MODES)),
                         ids=[json.dumps(m, sort_keys=True)
                              for m in FLUSH_MODES])
def test_flush_overlap_across_ranks_matches_reference(flushed, j):
    got, wants = flushed
    for r in range(4):
        for g, w in zip(jax.tree.leaves(got[r][j]),
                        jax.tree.leaves(wants[j])):
            np.testing.assert_allclose(g, w[r:r + 1], rtol=RTOL, atol=ATOL)
