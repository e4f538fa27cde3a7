"""The port's sync engine (``repro_torch.core.sync``) against the reference's
``sync_point`` inside ``jax.shard_map`` on K fake CPU devices.

One subprocess (``conftest.run_with_devices``) runs the reference over every
mode of a covering set — overlap {none, delayed, chunked} × topology {all,
ring, pairwise} × compression {none, int8, int16}, async ring/pairwise,
slowmo, and K = 2 — at two consecutive boundaries, and dumps inputs and
outputs to one npz; each mode is then a test case here. Each boundary is fed
the reference's own inputs (the second one the reference's first outputs),
so it compares the function and not an accumulated drift.

Bounds: every params and sync-state leaf to rtol 1e-6 / atol 1e-7 (the
replica means and mixes sum in another order); the error-feedback residual
and the pending correction, small differences of values of magnitude ~1, to
atol 5e-7, four f32 ulps at that magnitude: jitted, XLA contracts the
reference's ``v − q·scale`` into one fused multiply-add, rounded once where
the eager oracle rounds twice, and its scales differ by an ulp (below); the
schedule counters equal. Where the wire carries ``compress_tree`` of the delta (blocking and
delayed under ``topology="all"``) or of the values (gossip), the int8
payload computed inside the reference's sync is bitwise the port's, and its
scales agree to one ulp (rtol 1e-6): jitted, XLA turns the division by 127
into a product with 1/127, while the eager oracle, which the port matches
bitwise (``tests/test_torch_quant.py``), divides.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_with_devices
from repro.config import SyncConfig as JSyncConfig
from repro.core import sync as JS
from repro_torch import tree as T
from repro_torch.config import SyncConfig
from repro_torch.core import compression as TC
from repro_torch.core import sync as TS

torch.set_num_threads(1)

RTOL, ATOL, DIFF_ATOL = 1e-6, 1e-7, 5e-7
MODES = [dict(overlap=ov, topology=topo, compression=comp)
         for ov in ("none", "delayed", "chunked")
         for topo in ("all", "ring", "pairwise")
         for comp in ("none", "int8", "int16")]
MODES += [dict(topology="ring", gossip_async=True),
          dict(topology="pairwise", gossip_async=True),
          dict(topology="ring", gossip_async=True, compression="int8"),
          dict(topology="pairwise", gossip_async=True, compression="int16"),
          dict(slowmo=0.5, slowmo_lr=0.8),
          dict(slowmo=0.5, overlap="delayed", compression="int8"),
          dict(slowmo=0.5, overlap="chunked", compression="int8"),
          dict(compression="int8", k=2),
          dict(topology="pairwise", compression="int8", k=2),
          dict(overlap="chunked", topology="ring", compression="int16", k=2)]
# one replica's leaves: five sizes, so a chunked sync has several shards
SHAPES = {"a": (8, 5), "b": {"c": (3,), "d": (4, 4)}, "e": (16,),
          "f": (2, 6)}

REFERENCE = r"""
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.config import SyncConfig
from repro.core import compression as C
from repro.core import sync as S

MODES = json.loads('''__MODES__''')
SHAPES = json.loads('''__SHAPES__''')
out = {}

def leaves_with_paths(tree, prefix):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], prefix + "/" + k)
    else:
        yield prefix, tree

def dump(tag, tree):
    for path, leaf in leaves_with_paths(tree, tag):
        out[path] = np.asarray(leaf)

def shaped(fn):
    def go(node):
        return ({k: go(v) for k, v in node.items()} if isinstance(node, dict)
                else fn(tuple(node)))
    return go(SHAPES)

for i, mode in enumerate(MODES):
    k = mode.pop("k", 4)
    cfg = SyncConfig(strategy="periodic", chunks=3, **mode)
    rng = np.random.default_rng(i)
    mesh = jax.make_mesh((k,), ("pod",), devices=jax.devices()[:k],
                         axis_types=(jax.sharding.AxisType.Auto,))
    start = shaped(lambda s: jnp.asarray(rng.normal(size=(k,) + s),
                                         jnp.float32))
    state = S.init_sync_state(cfg, jax.tree.map(lambda x: x[0], start))
    state = jax.tree.map(lambda x: jnp.broadcast_to(x, (k,) + x.shape),
                         state)
    # non-trivial carried state: noise in every float buffer, counters at 1
    state = jax.tree.map(
        lambda x: (jnp.ones_like(x) if x.dtype == jnp.int32 else
                   x + jnp.asarray(0.01 * rng.normal(size=x.shape),
                                   jnp.float32)), state)

    # the int8 wire's payload where it is compress_tree of one tree
    wire = None
    if cfg.compression == "int8" and not cfg.gossip_async:
        if cfg.topology == "all" and cfg.overlap != "chunked":
            wire = lambda st, en: S._f32_delta(en, st)
        elif cfg.topology != "all" and cfg.overlap != "chunked":
            wire = lambda st, en: jax.tree.map(
                lambda x: x.astype(jnp.float32), en)

    def body(start, end, st):
        un = lambda t: jax.tree.map(lambda x: x[0], t)
        re = lambda t: jax.tree.map(lambda x: x[None], t)
        p, s = S.sync_point(un(start), un(end), un(st), cfg, "pod")
        q = ({} if wire is None else
             C.compress_tree(wire(un(start), un(end)), un(st)["ef"])[:2])
        return re(p), re(s), re(q)

    f = jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P("pod"), P("pod"), P("pod")),
        out_specs=(P("pod"), P("pod"), P("pod")), axis_names={"pod"},
        check_vma=False))
    with jax.set_mesh(mesh):
        for b in range(2):
            end = jax.tree.map(
                lambda x: x + jnp.asarray(0.1 * rng.normal(size=x.shape),
                                          jnp.float32), start)
            dump(f"m{i}/b{b}/in/start", start)
            dump(f"m{i}/b{b}/in/end", end)
            dump(f"m{i}/b{b}/in/sync", state)
            start, state, payload = f(start, end, state)
            dump(f"m{i}/b{b}/out/params", start)
            dump(f"m{i}/b{b}/out/sync", state)
            if payload:
                dump(f"m{i}/b{b}/out/wire/q", payload[0])
                dump(f"m{i}/b{b}/out/wire/scale", payload[1])
np.savez("__OUT__", **out)
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("sync") / "reference.npz"
    code = (REFERENCE.replace("__MODES__", json.dumps(MODES))
            .replace("__SHAPES__", json.dumps(SHAPES))
            .replace("__OUT__", str(path)))
    assert "OK" in run_with_devices(code, n_devices=4, timeout=600)
    with np.load(path) as data:
        return {key: data[key] for key in data.files}


def _subtree(data, prefix):
    """The nested dict of tensors stored under ``prefix/…``."""
    tree = {}
    for key, arr in data.items():
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        parts = key[len(prefix) + 1:].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = torch.from_numpy(np.array(arr))
    return tree


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("i", range(len(MODES)),
                         ids=[json.dumps(m, sort_keys=True) for m in MODES])
def test_sync_point_matches_reference(reference, i):
    mode = dict(MODES[i])
    mode.pop("k", None)
    cfg = SyncConfig(strategy="periodic", chunks=3, **mode)
    for b in range(2):
        tag = f"m{i}/b{b}"
        start = _subtree(reference, f"{tag}/in/start")
        end = _subtree(reference, f"{tag}/in/end")
        state = _subtree(reference, f"{tag}/in/sync")
        before = {k: v.clone() for k, v in
                  _flat({"s": start, "e": end, "y": state}).items()}
        wire = _subtree(reference, f"{tag}/out/wire")
        if wire:
            # the payload of the inputs, taken before the sync is handed end
            values = (T.map(lambda e, s: e - s, end, start)
                      if cfg.topology == "all" else end)
            q, scale, _ = TC.compress_tree(values, state["ef"], rows=True)
        params, new_state = TS.sync_point(start, end, state, cfg)
        after = _flat({"s": start, "e": end, "y": state})
        # the blocking sync writes its params into end, which it is handed
        handed = (not cfg.gossip_async and cfg.topology == "all"
                  and cfg.overlap == "none")
        assert all(torch.equal(before[k], after[k]) for k in before
                   if not (handed and k.startswith("/e/"))), \
            "sync_point changed its inputs"
        assert not handed or params is end
        want_p = _flat(_subtree(reference, f"{tag}/out/params"))
        want_s = _flat(_subtree(reference, f"{tag}/out/sync"))
        got_p, got_s = _flat(params), _flat(new_state)
        assert sorted(got_p) == sorted(want_p)
        assert sorted(got_s) == sorted(want_s)
        for key in want_p:
            assert tuple(got_p[key].shape) == want_p[key].shape, key
            np.testing.assert_allclose(got_p[key].numpy(), want_p[key].numpy(),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{tag} params{key}")
        for key in want_s:
            got, want = got_s[key].numpy(), want_s[key].numpy()
            assert got.shape == want.shape and got.dtype == want.dtype, key
            np.testing.assert_allclose(
                got, want, rtol=RTOL,
                atol=(DIFF_ATOL if key.startswith(("/ef/", "/pending/"))
                      else ATOL),
                err_msg=f"{tag} sync{key}")
        if wire:
            for name, got in (("q", q), ("scale", scale)):
                for key, want in _flat(wire[name]).items():
                    got_leaf = _flat(got)[key].numpy()
                    want = want.numpy().reshape(got_leaf.shape)
                    assert got_leaf.dtype == want.dtype
                    if name == "q":
                        assert got_leaf.tobytes() == want.tobytes(), \
                            f"{tag} wire q{key}"
                    else:
                        np.testing.assert_allclose(got_leaf, want, rtol=RTOL)


@pytest.mark.parametrize("chunks", [1, 2, 3, 5])
def test_chunk_assignment_matches_reference(chunks):
    rng = np.random.default_rng(chunks)
    dtypes = [(np.float32, torch.float32), (np.int8, torch.int8),
              (jnp.bfloat16, torch.bfloat16)]
    shapes = [tuple(rng.integers(1, 9, size=rng.integers(1, 4)))
              for _ in range(12)] + [(4, 4), (4, 4), (16,)]
    picks = rng.integers(0, 3, size=len(shapes))
    jleaves = [jnp.zeros(s, dtypes[p][0]) for s, p in zip(shapes, picks)]
    tleaves = [torch.zeros(s, dtype=dtypes[p][1]) for s, p in zip(shapes, picks)]
    assert TS.chunk_assignment(tleaves, chunks) == JS.chunk_assignment(
        jleaves, chunks)


FLUSH_MODES = [dict(overlap="delayed", compression="int8"),
               dict(overlap="chunked"), dict(topology="ring"),
               dict(topology="pairwise", gossip_async=True,
                    compression="int16"),
               dict()]


@pytest.mark.parametrize("mode", FLUSH_MODES,
                         ids=[json.dumps(m, sort_keys=True)
                              for m in FLUSH_MODES])
def test_flush_overlap_matches_reference(mode):
    rng = np.random.default_rng(3)
    k = 4
    params = {"w": rng.normal(size=(k, 5, 3)).astype(np.float32),
              "v": {"s": rng.normal(size=(k, 7)).astype(np.float32)}}
    jcfg = JSyncConfig(strategy="periodic", **mode)
    tcfg = SyncConfig(strategy="periodic", **mode)
    state = jax.tree.map(
        lambda x: np.broadcast_to(np.asarray(x), (k,) + x.shape),
        JS.init_sync_state(jcfg, jax.tree.map(lambda x: x[0], params)))
    state = jax.tree.map(
        lambda x: x if x.dtype == np.int32 else
        (x + 0.01 * rng.normal(size=x.shape)).astype(np.float32), state)
    want = JS.flush_overlap(jax.tree.map(jnp.asarray, params),
                            jax.tree.map(jnp.asarray, state), jcfg)
    got = TS.flush_overlap(T.map(torch.from_numpy, params),
                           T.map(lambda x: torch.from_numpy(np.array(x)),
                                 state), tcfg)
    for g, w in zip(T.leaves(got), T.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("world", [2, 4, 8])
@pytest.mark.parametrize("mode", [dict(), dict(compression="int8"),
                                  dict(topology="ring"),
                                  dict(strategy="sync_every_step")])
def test_byte_accounting_matches_reference(world, mode):
    kw = {"strategy": "periodic", "period": 8, **mode}
    jcfg, tcfg = JSyncConfig(**kw), SyncConfig(**kw)
    for nbytes in (4_000, 1_447_000_000):
        assert (TS.collective_bytes_per_sync(nbytes, world, tcfg)
                == JS.collective_bytes_per_sync(nbytes, world, jcfg))
        assert (TS.amortized_bytes_per_step(nbytes, world, tcfg)
                == JS.amortized_bytes_per_step(nbytes, world, jcfg))


@pytest.mark.parametrize("mode", [dict(topology="ring", slowmo=0.5),
                                  dict(gossip_async=True),
                                  dict(topology="ring", gossip_async=True,
                                       overlap="delayed"),
                                  dict(overlap="stale"),
                                  dict(topology="star"),
                                  dict(overlap="chunked", chunks=0)])
def test_validate_rejects_what_the_reference_rejects(mode):
    with pytest.raises(ValueError):
        JS.validate(JSyncConfig(**mode))
    with pytest.raises(ValueError):
        TS.validate(SyncConfig(**mode))


def test_pairwise_needs_even_replicas_and_a_round():
    with pytest.raises(ValueError):
        TS.gossip_mix(torch.zeros(3, 2), "pairwise", 0)
    with pytest.raises(ValueError):
        TS.gossip_mix(torch.zeros(4, 2), "pairwise")
    x = torch.arange(4.0)[:, None]
    assert TS.gossip_mix(x, "pairwise", 0)[:, 0].tolist() == [0.5, 0.5,
                                                             2.5, 2.5]
    assert TS.gossip_mix(x, "pairwise", 1)[:, 0].tolist() == [1.5, 1.5,
                                                             1.5, 1.5]
    assert torch.allclose(TS.gossip_self_weight("ring") * x
                          + TS.gossip_recv(x, "ring"),
                          TS.gossip_mix(x, "ring"))
