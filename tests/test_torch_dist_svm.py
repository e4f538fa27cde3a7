"""The port's SVM across processes (``dms(backend="dist")``, the timed pair,
the stepper and ladder with a mesh) against the reference's
``dms(backend="shard_map")`` on fake CPU devices.

One subprocess (``conftest.run_with_devices``, 8 devices) runs the
reference in every mode and dumps the models to one npz; one
``repro_torch.launch.mesh.spawn`` of 8 gloo CPU ranks runs the port in every
mode (K = 8, and K = 2 and 4 for pairwise on meshes whose ``data`` axis has
that many ranks); each mode is then a test case here.

Bound: the reference's own for ``shard_map`` against ``vmap``, rtol 1e-5 /
atol 1e-6 (``tests/test_gossip.py``); the data are random normal rows, so no
hinge sits at its kink. Under the blocking mean every rank returns the same
model, bitwise.
"""
import json

import numpy as np
import pytest

from conftest import run_with_devices
from repro_torch.launch import mesh as M

import torch_dist_ranks as R

RTOL, ATOL = 1e-5, 1e-6
N, D, EPOCHS, BS = 256, 12, 3, 4
LADDER = (4, 8)
MODES = ([dict(k=8, overlap=ov, topology=topo)
          for ov in ("none", "delayed", "chunked")
          for topo in ("all", "ring", "pairwise")]
         + [dict(k=8, topology="ring", gossip_async=True),
            dict(k=8, topology="pairwise", gossip_async=True)]
         + [dict(k=k, overlap=ov, topology="pairwise")
            for k in (2, 4) for ov in ("none", "delayed", "chunked")])
TIMED = {"none": 0, "delayed": 3, "chunked": 6, "ring": 1,
         "pairwise_async": 10}

REFERENCE = r"""
import json
import jax, jax.numpy as jnp, numpy as np
from repro.core import svm

MODES = json.loads('''__MODES__''')
N, D, EPOCHS, BS = __N__, __D__, __EPOCHS__, __BS__
SMALL, LARGE = __LADDER__
rng = np.random.default_rng(0)
x = rng.normal(size=(N, D)).astype(np.float32)
y = np.where(rng.random(N) > 0.5, 1.0, -1.0).astype(np.float32)
out = {"x": x, "y": y}

def mesh_of(k):
    return jax.make_mesh((k,), ("data",), devices=jax.devices()[:k],
                         axis_types=(jax.sharding.AxisType.Auto,))

for i, mode in enumerate(MODES):
    mode = dict(mode)
    k = mode.pop("k")
    mesh = mesh_of(k)
    with jax.set_mesh(mesh):
        w = svm.dms(jnp.zeros(D), x, y, workers=k, epochs=EPOCHS,
                    block_size=BS, backend="shard_map", mesh=mesh, **mode)
    out[f"dms/{i}"] = np.asarray(w)

# the ladder: epoch 0 at the small block, a switch, epoch 1 at the large
mesh = mesh_of(8)
xs, ys = svm._shard_data(x, y, 8)
with jax.set_mesh(mesh):
    step = jax.jit(svm.dms_block_stepper(mesh, "data", d=D,
                                         overlap="delayed"))
    carry = svm.dms_stepper_init(jnp.zeros(D), 8, overlap="delayed")
    for t, bs in enumerate((SMALL, LARGE)):
        if t:
            carry = svm.dms_ladder_switch(carry, overlap="delayed")
        alpha = jnp.float32(1.0) / (1.0 + t)
        for i in range(xs.shape[1] // bs):
            carry = step(carry, jnp.asarray(xs[:, i * bs:(i + 1) * bs]),
                         jnp.asarray(ys[:, i * bs:(i + 1) * bs]), alpha)
    out["ladder"] = np.asarray(jnp.mean(carry["w"], axis=0))
np.savez("__OUT__", **out)
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("dist_svm") / "reference.npz"
    code = (REFERENCE.replace("__MODES__", json.dumps(MODES))
            .replace("__N__", str(N)).replace("__D__", str(D))
            .replace("__EPOCHS__", str(EPOCHS)).replace("__BS__", str(BS))
            .replace("__LADDER__", repr(LADDER)).replace("__OUT__", str(path)))
    assert "OK" in run_with_devices(code, n_devices=8, timeout=600)
    with np.load(path) as data:
        return {key: data[key] for key in data.files}


@pytest.fixture(scope="module")
def ranks(reference):
    return M.spawn(R.svm_modes, 8, backend="gloo", device="cpu",
                   args=(reference["x"], reference["y"], MODES, EPOCHS, BS,
                         LADDER), timeout_s=600)


@pytest.mark.parametrize("i", range(len(MODES)),
                         ids=[json.dumps(m, sort_keys=True) for m in MODES])
def test_dms_dist_matches_shard_map(reference, ranks, i):
    want = reference[f"dms/{i}"]
    for rank, out in enumerate(ranks[:MODES[i]["k"]]):
        got = out["dms"][i]
        assert got.shape == (D,) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=f"rank {rank}")
    blocking = (MODES[i].get("overlap", "none") == "none"
                and MODES[i].get("topology", "all") == "all")
    if blocking:
        assert all(out["dms"][i].tobytes() == ranks[0]["dms"][i].tobytes()
                   for out in ranks)


@pytest.mark.parametrize("name", sorted(TIMED))
def test_timed_pair_reproduces_dms(reference, ranks, name):
    """``dms_timed_steps(mesh, axis)``'s compute and sync, called block by
    block, give ``dms``'s model; every call was timed (the first of each
    kind is the telemetry's warm-up), the times the max over the ranks."""
    want = reference[f"dms/{TIMED[name]}"]
    blocks = EPOCHS * (N // 8 // BS)
    for out in ranks:
        model, n_steps, n_syncs, positive, times = out["timed"][name]
        np.testing.assert_allclose(model, want, rtol=RTOL, atol=ATOL)
        assert n_steps == (blocks - 1) * BS and n_syncs == blocks - 1
        assert positive
        assert times == ranks[0]["timed"][name][4]   # reduced over ranks


def test_ladder_with_mesh_matches_reference(reference, ranks):
    for out in ranks:
        np.testing.assert_allclose(out["ladder"], reference["ladder"],
                                   rtol=RTOL, atol=ATOL)


def test_dist_raises_on_a_wrong_mesh_or_graphs(ranks):
    mismatch, graphs = ranks[0]["raises"]
    assert "has 8 ranks, but workers=4" in mismatch
    assert "runs eagerly" in graphs
