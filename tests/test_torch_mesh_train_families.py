"""The port's trainer on the SSM, hybrid, VLM and audio families on a
(pod, data, model) process mesh against the reference's on fake CPU
devices.

Three subprocesses at once (``conftest.run_with_devices``, 4 devices
each) run the reference: ``make_ddp_step`` on a (data 2, model 2) mesh, with the
gradient of the loss under the mesh rules, and ``make_local_sgd_block`` on
(pod 2, data 1, model 2), int8 ``periodic``, momentum, two blocks; for
mamba2-2.7b, zamba2-1.2b, paligemma-3b and whisper-base at their smoke
widths in f32: whisper also with an odd vocab (509: held whole over model,
as the published 51,865 is; local SGD with it alone), mamba2's and
paligemma's DDP steps also at T = 64 × 512 = 32,768 tokens (the
vocab-parallel lookup, with its gradient; paligemma's patches before the
text), the others' at 8 × 32 (the masked lookup). The VLM's ``patches`` and
the audio ``frames`` are seeded normal draws beside the tokens. One
``repro_torch.launch.mesh.spawn`` of 4 gloo CPU ranks runs the port's from
the same initial states and batches (``interop.rank_train_state_from_jax``,
remat ``full``), the enc-dec loss straight from a rank's table shard, the
gradient with its backward on a thread without the rules, a checkpoint of
the enc-dec stacks written on the model mesh, and ``build_trainer``'s
pipeline with row-tagged extras; beside it the port's K = 2 block on one
process from the same states and batches.

Bounds, ``test_torch_mesh_train.py``'s: every gradient leaf under the mesh
rules and every param after the DDP step rtol 1e-3 / atol 1e-5, the loss
relative 1e-5; the local-SGD block's losses relative 1e-3, every params and
moments leaf within relative L2 1e-3, every ``ef`` value within its
replica's quantization step of the reference's, and after each block at
most 1e-4 of them off by more than 1e-2 of the step from the port's
one-process block run from the same state (the mesh's after the block
before: an int8 value may flip by one step where the mesh sums the
gradient in another order, and a flip carries into the next block). The
checkpoint, its replay and the gradient on another thread bitwise.
"""
import concurrent.futures
import json
import os

import numpy as np
import pytest

from conftest import run_with_devices
from repro_torch import sharding as S
from repro_torch import tree as T
from repro_torch.launch import mesh as M

import torch_dist_ranks as R

SGD = dict(name="sgd", learning_rate=0.1, grad_clip=0.05)
# test_torch_mesh_train.py's local-SGD optimizer. AdamW's update turns a
# gradient's last-bit differences into ~1e-6 of the delta, and with it 102
# of mamba2's 243,808 int8 values (4.2e-4) flip against the reference,
# past 1e-4: the same 102 on one process, so not the mesh's
MOMENTUM = dict(name="momentum", learning_rate=0.05)
SYNC = dict(strategy="periodic", period=2, compression="int8")
ODD = dict(vocab_size=509)
ARCHS = {"mamba2": "mamba2-2.7b", "zamba2": "zamba2-1.2b",
         "paligemma": "paligemma-3b", "whisper": "whisper-base",
         "whisper-odd": "whisper-base"}


def _case(tag, **kw):
    return dict(arch=ARCHS[tag.split("-t")[0]], remat="full",
                **({"model": ODD} if tag.endswith("odd") else {}), **kw)


# the DDP cases at 8 x 32 (the masked lookup)
CASES = {tag: _case(tag, rows=8, seq=32, seed=i, opt=SGD)
         for i, tag in enumerate(["zamba2", "paligemma", "whisper",
                                  "whisper-odd"])}
# mamba2 and paligemma at T = 64 x 512 = 32,768 tokens (the vocab-parallel
# lookup and its gradient; paligemma's patches before the text)
CASES.update({tag: _case(tag, rows=64, seq=512, seed=seed, opt=SGD)
              for tag, seed in [("mamba2-t32k", 9), ("paligemma-t32k", 14)]})
# whisper's local SGD at the odd vocab, whose table stays whole on (pod 2,
# data 1, model 2) as the published one does; two blocks (the twins start
# the second from the mesh's state after the first)
LOCALS = {tag: _case(tag, rows=4, seq=32, seed=10 + i, h=2, blocks=2,
                     sync=SYNC, opt=MOMENTUM)
          for i, tag in enumerate(["mamba2", "zamba2", "paligemma",
                                   "whisper-odd"])}
# the reference's four parts, run at once
PARTS = [("ddp", [t for t in CASES if not t.endswith("t32k")]),
         ("ddp", [t for t in CASES if t.endswith("t32k")]),
         ("local", ["mamba2", "zamba2"]),
         ("local", ["paligemma", "whisper-odd"])]
# the enc-dec stacks' checkpoint; the extras' rows through the pipeline
CKPT = "whisper-odd"
TAGS = {"ddp": dict(arch="paligemma-3b", rows=8, seq=16, opt=SGD),
        "local": dict(arch="whisper-base", rows=4, seq=16, opt=SGD),
        "sync": SYNC}
DDP_MESH = M.mesh_config((2, 2), ("data", "model"))
LOCAL_MESH = M.mesh_config((2, 1, 2), ("pod", "data", "model"))

REFERENCE = r"""
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.config import (DataConfig, MeshConfig, OptimizerConfig,
                          SyncConfig, TrainConfig, get_smoke)
from repro.core import local_sgd as LS
from repro.models.registry import build_model
from repro.sharding import rules_for, use_rules
from repro.launch.mesh import make_test_mesh

CASES = json.loads('''__CASES__''')
PART = "__PART__"
out = {}

def dump(tag, tree):
    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + "/" + k)
        else:
            out[prefix] = np.asarray(node)
    walk(tree, tag)

def model_cfg(c):
    return dataclasses.replace(get_smoke(c["arch"]), dtype="float32",
                               **c.get("model", {}))

def make_batch(rng, cfg, lead):
    b = {k: rng.integers(0, cfg.vocab_size, lead).astype(np.int32)
         for k in ("tokens", "targets")}
    extra = {"vlm": ("patches", cfg.num_image_tokens),
             "audio": ("frames", cfg.n_audio_frames)}.get(cfg.family)
    if extra:
        b[extra[0]] = rng.standard_normal(
            lead[:-1] + (extra[1], cfg.d_model)).astype(np.float32)
    return b

if PART == "ddp":
    mesh = make_test_mesh((2, 2), ("data", "model"))
    mesh_cfg = MeshConfig(shape=(2, 2), axis_names=("data", "model"))
    rules = rules_for(mesh_cfg, mesh)
    for tag, c in CASES.items():
        cfg = TrainConfig(model=model_cfg(c), mesh=mesh_cfg,
                          optimizer=OptimizerConfig(**c["opt"]),
                          data=DataConfig(seq_len=c["seq"],
                                          global_batch=c["rows"]))
        model = build_model(cfg.model)
        batch = make_batch(np.random.default_rng(c["seed"]), cfg.model,
                           (c["rows"], c["seq"]))
        dump(f"{tag}/batch", batch)
        with jax.set_mesh(mesh):
            state = LS.init_state(model, cfg, jax.random.key(c["seed"]))
            dump(f"{tag}/init", state)
            jb = jax.tree.map(jnp.asarray, batch)
            ddp = LS.make_ddp_step(model, cfg, mesh)

            def grads_and_step(state, b):
                with use_rules(rules):
                    _, g = jax.value_and_grad(
                        lambda p: model.loss(p, b), has_aux=True)(
                            state["params"])
                return g, ddp(state, b)
            g, (state, metrics) = jax.jit(grads_and_step)(state, jb)
            dump(f"{tag}/grads", g)
            dump(f"{tag}/metrics", metrics)
            dump(f"{tag}/final", state["params"])
else:
    mesh3 = jax.make_mesh((2, 1, 2), ("pod", "data", "model"),
                          axis_types=(jax.sharding.AxisType.Auto,) * 3)
    for tag, c in CASES.items():
        cfg = TrainConfig(model=model_cfg(c),
                          mesh=MeshConfig(shape=(2, 1, 2),
                                          axis_names=("pod", "data", "model"),
                                          replica_axis="pod"),
                          sync=SyncConfig(**c["sync"]),
                          optimizer=OptimizerConfig(**c["opt"]),
                          data=DataConfig(seq_len=c["seq"],
                                          global_batch=c["rows"]))
        model = build_model(cfg.model)
        rng = np.random.default_rng(c["seed"])
        blocks = [make_batch(rng, cfg.model, (c["h"], c["rows"], c["seq"]))
                  for _ in range(c["blocks"])]
        for b, blk in enumerate(blocks):
            dump(f"local/{tag}/batch/{b}", blk)
        with jax.set_mesh(mesh3):
            state = LS.init_state(model, cfg, jax.random.key(c["seed"]),
                                  replicas=2)
            dump(f"local/{tag}/init", state)
            spec = lambda x: P("pod") if x.ndim else P()
            state = jax.tree.map(
                lambda x: jax.device_put(x, NamedSharding(mesh3, spec(x))),
                state)
            step = jax.jit(LS.make_local_sgd_block(model, cfg, mesh3))
            for b, blk in enumerate(blocks):
                state, metrics = step(state, jax.tree.map(jnp.asarray, blk))
                dump(f"local/{tag}/metrics/{b}", metrics)
                if b == 0:
                    dump(f"local/{tag}/first", state)
            dump(f"local/{tag}/final", state)
np.savez("__OUT__", **out)
print("OK")
"""


def _subtree(data, prefix):
    tree = {}
    for key, arr in data.items():
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        parts = key[len(prefix) + 1:].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.array(arr)
    return tree


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train_families")

    def run(i, part, tags):
        path = tmp / f"{i}.npz"
        cases = {t: (CASES if part == "ddp" else LOCALS)[t] for t in tags}
        code = (REFERENCE.replace("__CASES__", json.dumps(cases))
                .replace("__PART__", part).replace("__OUT__", str(path)))
        assert "OK" in run_with_devices(code, n_devices=4, timeout=900)
        with np.load(path) as data:
            return {key: data[key] for key in data.files}
    with concurrent.futures.ThreadPoolExecutor(len(PARTS)) as pool:
        parts = [pool.submit(run, i, *p) for i, p in enumerate(PARTS)]
        return {k: v for part in parts for k, v in part.result().items()}


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("mesh_families_ckpt"))


@pytest.fixture(scope="module")
def ranks(reference, ckpt_dir):
    # an empty dict (sgd's moments, a sync state of nothing) dumps no key
    inits = {tag: {"opt": {}, "sync": {}, **_subtree(reference,
                                                     f"{tag}/init")}
             for tag in CASES}
    batches = {tag: _subtree(reference, f"{tag}/batch") for tag in CASES}
    for tag, kw in LOCALS.items():
        inits[f"local/{tag}"] = _subtree(reference, f"local/{tag}/init")
        batches[f"local/{tag}"] = [
            _subtree(reference, f"local/{tag}/batch/{b}")
            for b in range(kw["blocks"])]
    return M.spawn(R.mesh_train_families, 4, backend="gloo", device="cpu",
                   args=(CASES, LOCALS, inits, batches, (CKPT, ckpt_dir),
                         TAGS), timeout_s=900)


def _local_whole(ranks, tag, what):
    """The local-SGD state's params, opt and sync after block ``what``
    ("first" or "final"), the ranks' blocks put back together."""
    specs = {k: ranks[0]["local"][tag]["specs"][k]
             for k in ("params", "opt", "sync")}
    return S.unshard_tree([o["local"][tag][what] for o in ranks], {
        k: S.map_with_specs(lambda s, _: ("pod",) + tuple(s[1:])
                            if any(s) else ("pod",), v, v)
        for k, v in specs.items()}, LOCAL_MESH)


@pytest.fixture(scope="module")
def twins(reference, ranks):
    """The port's K = 2 local-SGD block on one process (no mesh), each
    block from the state the mesh started it from (the reference's initial
    state, then the mesh's after the first block, put back together) on
    the same batch: per case the ``ef`` leaves of both replicas after each
    block. On one thread, as each rank runs: the smoke models' small
    operators ran ~10x slower on a shared host's many threads."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {tag: _twin_blocks(reference, ranks, tag, kw)
                for tag, kw in LOCALS.items()}
    finally:
        torch.set_num_threads(threads)


def _twin_blocks(reference, ranks, tag, kw):
    import torch
    from repro_torch import interop
    from repro_torch.config import MeshConfig
    from repro_torch.core import local_sgd as LS
    from repro_torch.models.registry import build_model
    cfg = R._family_cfg(kw, MeshConfig(shape=(2,), axis_names=("pod",),
                                       replica_axis="pod"), kw["sync"])
    model = build_model(cfg.model, attn_impl="torch", ssd_impl="torch",
                        remat=cfg.remat)
    state = interop.lm_train_state_from_jax(
        _subtree(reference, f"local/{tag}/init"), cfg)
    block_fn = LS.make_local_sgd_block(model, cfg)
    out = []
    for b in range(kw["blocks"]):
        if b:
            state.update(T.map(lambda a: torch.from_numpy(np.array(a)),
                               _local_whole(ranks, tag, "first")))
        state, _ = block_fn(state, R._tensors(
            _subtree(reference, f"local/{tag}/batch/{b}")))
        out.append(S.flat_keys(T.map(lambda t: t.detach().numpy().copy(),
                                      state["sync"])))
    return out


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _nest(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = tuple(value)
    return tree


def _ddp_specs(ranks, tag):
    return S.map_with_specs(lambda _, s: s, ranks[0]["ddp"][tag]["final"],
                            _nest(ranks[0]["ddp"][tag]["specs"]))


def _rel_l2(got, want):
    want = np.asarray(want, np.float64)
    diff = np.linalg.norm(np.asarray(got, np.float64) - want)
    return diff / max(np.linalg.norm(want), 1e-30)


# the embedding table's spec a rank holds: vocab over model where it
# divides (the odd vocab whole), d_model over data where the mesh has one
DDP_TABLE = {"zamba2": ("model", "data"),
             "paligemma": ("model", "data"), "whisper": ("model", "data"),
             "whisper-odd": (None, "data"), "mamba2-t32k": ("model", "data"),
             "paligemma-t32k": ("model", "data")}
LOCAL_TABLE = {"mamba2": ("model",), "zamba2": ("model",),
               "paligemma": ("model",), "whisper-odd": ()}


@pytest.mark.parametrize("tag", sorted(CASES))
def test_ddp_loss_matches_reference(reference, ranks, tag):
    want = float(reference[f"{tag}/metrics/loss"])
    assert S.flat_keys(_ddp_specs(ranks, tag))["embed.embedding"] \
        == DDP_TABLE[tag]
    for o in ranks:
        got = o["ddp"][tag]["metrics"]["loss"]
        assert abs(got - want) <= 1e-5 * abs(want), (got, want)


@pytest.mark.parametrize("what", ["grads", "final"])
@pytest.mark.parametrize("tag", sorted(CASES))
def test_ddp_every_leaf_matches_reference(reference, ranks, tag, what):
    """Every leaf's gradient under the mesh rules (this rank's block of the
    reduced gradient) and every param after one clipped step, the ranks'
    blocks put back together, against the reference's whole leaves."""
    specs = _ddp_specs(ranks, tag)
    got = S.flat_keys(S.unshard_tree([o["ddp"][tag][what] for o in ranks],
                                     specs, DDP_MESH))
    want = S.flat_keys(_subtree(reference, f"{tag}/{what}"))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=1e-3, atol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("tag", sorted(CASES))
def test_ddp_global_norm_is_the_whole_trees(reference, ranks, tag):
    """grad_clip's norm over the mesh equals the norm of the gradient tree
    put back together and the reference's; the clip is active."""
    for o in ranks:
        got = o["ddp"][tag]
        assert abs(got["norm"] - got["whole_norm"]) \
            <= 1e-6 * got["whole_norm"]
    want = np.sqrt(sum(np.sum(np.square(g.astype(np.float64)))
                       for g in T.leaves(_subtree(reference,
                                                  f"{tag}/grads"))))
    assert abs(ranks[0]["ddp"][tag]["norm"] - want) <= 1e-4 * want
    assert want > CASES[tag]["opt"]["grad_clip"]


@pytest.mark.parametrize("tag", sorted(CASES))
def test_remat_recompute_without_the_callers_rules(ranks, tag):
    """Under remat ``full`` each checkpointed layer (and ``ssd_chunked``'s
    chunks inside a Mamba2 block) recomputes in the backward; run on a
    thread that does not hold the rules, as autograd's thread on the card,
    the gradient is bitwise the one taken in the caller's thread."""
    for o in ranks:
        assert o["ddp"][tag]["elsewhere"] is True, o["ddp"][tag]["elsewhere"]


@pytest.mark.parametrize("tag", ["whisper", "whisper-odd"])
def test_encdec_loss_on_a_mesh_takes_the_whole_table(ranks, tag):
    """``EncDecModel.loss`` under the mesh rules on a rank's shard of the
    tied table (vocab over model, d_model over data; the odd vocab whole
    over model) takes the whole table's CE, vocab-parallel on the shard
    (the d_model slice gathered over data): the loss of the rank's rows,
    as ``value_and_grad`` took it."""
    for o in ranks:
        got = o["ddp"][tag]
        assert isinstance(got["direct_loss"], float), got["direct_loss"]
        assert got["direct_loss"] == got["rank_loss"]


@pytest.mark.parametrize("what", ["first", "final"])
@pytest.mark.parametrize("tag", sorted(LOCALS))
def test_local_sgd_block_matches_reference(reference, ranks, twins, tag,
                                           what):
    """make_local_sgd_block on (pod 2, data 1, model 2), int8 periodic,
    momentum: params, moments and ef of both replicas, put back together,
    within the trainer's bound after each block (ef: every value within
    its step of the reference's, at most 1e-4 of them a step off the
    one-process block's from the same state); the losses at 1e-3."""
    local = ranks[0]["local"][tag]
    specs = {k: local["specs"][k] for k in ("params", "opt", "sync")}
    table = LOCAL_TABLE[tag]
    assert S.flat_keys(specs["params"])["embed.embedding"] \
        == ((None,) + table if table else ())
    got = _local_whole(ranks, tag, what)
    want = _subtree(reference, f"local/{tag}/{what}")
    block = 0 if what == "first" else LOCALS[tag]["blocks"] - 1
    scales = S.flat_keys(S.unshard_tree(
        [o["local"][tag]["payloads"][block]["scale"] for o in ranks],
        S.map_with_specs(lambda _, s: ("pod",), specs["params"],
                         specs["params"]), LOCAL_MESH))
    one = twins[tag][block]
    flips, values = 0, 0
    for part in ("params", "opt", "sync"):
        g, w = S.flat_keys(got[part]), S.flat_keys(want[part])
        assert sorted(g) == sorted(w), part
        for key in w:
            assert g[key].shape == w[key].shape, key
            if part != "sync":
                assert _rel_l2(g[key], w[key]) <= 1e-3, (part, key)
                continue
            # the residual where an int8 value flipped moves by that
            # replica's quantization step (its scale), and elsewhere by
            # at most 1e-2 of the step (f32 sums)
            step = np.broadcast_to(scales[key[len("ef."):]].reshape(
                (-1,) + (1,) * (w[key].ndim - 1)), w[key].shape)
            diff = np.abs(g[key].astype(np.float64) - w[key])
            assert np.all(diff <= step * (1 + 1e-5)), key
            off = np.abs(g[key].astype(np.float64) - one[key])
            flips += int((off > 1e-2 * step).sum())
            values += off.size
    assert flips <= 1e-4 * values, (flips, values)
    for b in range(LOCALS[tag]["blocks"]):
        want_l = float(reference[f"local/{tag}/metrics/{b}/loss"])
        for o in ranks:
            got_l = o["local"][tag]["metrics"][b]["loss"]
            assert abs(got_l - want_l) <= 1e-3 * abs(want_l)


@pytest.mark.parametrize("tag", sorted(LOCALS))
def test_local_sgd_payloads_are_the_whole_leafs(ranks, tag):
    """Every sync's int8 payloads: the two model ranks of a replica pack
    their blocks of a leaf with one scale, the whole leaf's; a leaf held
    whole (the odd vocab's table) packs alike on both."""
    for pod in (0, 1):
        a_ranks = ranks[2 * pod]["local"][tag]["payloads"]
        b_ranks = ranks[2 * pod + 1]["local"][tag]["payloads"]
        assert len(a_ranks) == LOCALS[tag]["blocks"]
        for a, b in zip(a_ranks, b_ranks):
            for sa, sb in zip(T.leaves(a["scale"]), T.leaves(b["scale"])):
                assert np.array_equal(sa, sb)


def test_checkpoint_of_the_encdec_stacks_is_the_one_process_file(
        reference, ranks, ckpt_dir):
    """The file rank 0 writes on the model mesh holds the whole leaves of
    the encoder and decoder stacks (both replicas stacked) under the
    one-process state's keys; read back each rank holds its blocks
    bitwise and steps from them bitwise as from the state it wrote."""
    latest = open(os.path.join(ckpt_dir, "LATEST")).read().strip()
    with np.load(os.path.join(ckpt_dir, latest, "arrays.npz")) as f:
        arrays = {k: f[k] for k in f.files}
    whole = _local_whole(ranks, CKPT, "final")
    want = {k.replace(".", "/"): v for k, v in S.flat_keys(whole).items()}
    init = {k.replace(".", "/"): v for k, v in S.flat_keys(
        {p: _subtree(reference, f"local/{CKPT}/init/{p}")
         for p in ("params", "opt", "sync")}).items()}
    assert sorted(arrays) == sorted(list(want) + ["step"])
    assert sorted(init) == sorted(want)
    assert any(k.startswith("params/enc_layers/") for k in want)
    assert any(k.startswith("params/dec_layers/") for k in want)
    for key, value in want.items():
        assert arrays[key].shape == init[key].shape, key
        assert np.array_equal(arrays[key], value), key
    for o in ranks:
        assert o["local"][CKPT]["restored_equal"]
        assert o["local"][CKPT]["replay_bitwise"]


@pytest.mark.parametrize("flavour", ["ddp", "local"])
def test_extras_ride_with_their_tokens(ranks, flavour):
    """Through ``build_trainer``'s pipeline (``DataPipeline(mesh=)``, and
    the (H, B, …) blocks of local SGD) each loss gets the ``patches`` /
    ``frames`` rows of its own tokens: under DDP the rank's data block of
    the batch (alike on its model ranks), under local SGD its replica's."""
    kw = TAGS[flavour]
    for o in ranks:
        calls = o["tags"][flavour]
        assert calls and all(c["tokens_match"] for c in calls), calls
        per = kw["rows"] // 2
        block = o["data"] if flavour == "ddp" else o["rank"] // 2
        for c in calls:
            assert c["rows"] == list(range(block * per, (block + 1) * per))
    if flavour == "local":
        assert sorted(c["step"] for c in ranks[0]["tags"]["local"]) \
            == [0, 1]
