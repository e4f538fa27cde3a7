"""The port's ``ServeEngine(mesh=)`` on the SSM, hybrid, VLM and audio
families against the reference's models on a (data 2, model 2) mesh.

One subprocess (``conftest.run_with_devices``, 4 devices) runs the
reference's models (``ServeEngine``'s jitted ``prefill`` and
``decode_step`` under its mesh rules) for mamba2-2.7b, zamba2-1.2b,
paligemma-3b and whisper-base at their smoke widths in f32: the prefill of
8 prompts of 32 tokens (paligemma with 8 seeded patch positions before
them, whisper over 16 seeded frames), its cache, and 4 greedy steps from
the prompt's end (P + S for the VLM, not through the reference's
``generate``, which decodes inside the image prefix); and dumps weights,
logits, caches and tokens to one npz. One ``repro_torch.launch.mesh.spawn``
of 4 gloo CPU ranks serves the same inputs with those weights
(``interop.rank_params_from_jax``), beside the one-process engine on the
same weights. Bounds: prefill and step logits rtol 1e-4 / atol 1e-5 of the
reference (``test_torch_mesh_serve.py``'s), ``generate``'s tokens
identical on every rank; a rank's cache leaves (its rows; its chunk of each
attention cache) within the same bound of the one-process cache's same rows
and positions (the products of 4 rows round otherwise than those of 8); the
split cross cache's attention within f32 rounding of the whole one's.
"""
import dataclasses

import numpy as np
import pytest

from conftest import run_with_devices
from repro_torch import sharding as S
from repro_torch.config import get_smoke
from repro_torch.launch import mesh as M

import torch_dist_ranks as R

ARCHS = ("mamba2-2.7b", "zamba2-1.2b", "paligemma-3b", "whisper-base")
B, SEQ, GEN = 8, 32, 4
MESH = M.mesh_config((2, 2), ("data", "model"))
# test_torch_mesh_serve.py's bound against the reference
RTOL, ATOL = 1e-4, 1e-5
# whisper at its published vocab's parity: an odd vocab is held whole
ODD = "whisper-base, vocab 511"

REFERENCE = r"""
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.config import get_smoke
from repro.launch.mesh import make_test_mesh, test_mesh_config
from repro.launch.serve import ServeEngine

mesh, mesh_cfg = make_test_mesh((2, 2)), test_mesh_config((2, 2))
out = {}


def flat(node, prefix):
    for k, v in node.items():
        if isinstance(v, dict):
            flat(v, prefix + k + "/")
        else:
            out[prefix + k] = np.asarray(v)


for arch, max_len, start, seed in __CASES__:
    cfg = dataclasses.replace(get_smoke(arch), dtype="float32")
    rng = np.random.default_rng(seed)
    prompts = rng.integers(1, cfg.vocab_size,
                           (__B__, __SEQ__)).astype(np.int32)
    batch = {"tokens": prompts}
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(size=(
            __B__, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.normal(size=(
            __B__, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)
    engine = ServeEngine(cfg, mesh, mesh_cfg, max_len=max_len,
                         dtype=jnp.float32)
    steps, tokens = [], []
    with jax.set_mesh(mesh):
        logits, cache = engine._prefill(
            engine.params, {k: jnp.asarray(v) for k, v in batch.items()})
        out[arch + "/prefill"] = np.asarray(logits)
        flat(cache, arch + "/cache/")
        cache = engine._grow_cache(cache, __B__)
        token = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        for i in range(__GEN__):
            tokens.append(np.asarray(token)[:, 0])
            logits, cache = engine._decode(
                engine.params, {"token": token, "cache": cache,
                                "index": jnp.int32(start + i)})
            steps.append(np.asarray(logits))
            token = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    out[arch + "/steps"] = np.stack(steps)
    out[arch + "/tokens"] = np.stack(tokens, axis=1)
    for k, v in batch.items():
        out[arch + "/batch/" + k] = v
    flat(engine.params, arch + "/params/")
np.savez("__OUT__", **out)
print("OK")
"""


def _cfg(arch):
    return dataclasses.replace(get_smoke(arch), dtype="float32")


def _start(cfg):
    return SEQ + (cfg.num_image_tokens if cfg.family == "vlm" else 0)


def _max_len(cfg):
    """The prompt's positions, the new tokens and one more, rounded up to
    a multiple of the model axis so the self cache splits."""
    n = _start(cfg) + GEN + 1
    return n + n % 2


class _Sized:
    """A mesh config seen as a live mesh's axes and shape (what
    ``serving_rules`` reads)."""

    def __init__(self, mesh_cfg):
        self.axes, self.shape = mesh_cfg.axis_names, mesh_cfg.shape


def _tree(ref, prefix):
    tree = {}
    for key, value in ref.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = tree
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = value
    return tree


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_families") / "reference.npz"
    cases = [(a, _max_len(_cfg(a)), _start(_cfg(a)), i)
             for i, a in enumerate(ARCHS)]
    code = REFERENCE
    for key, value in dict(CASES=cases, B=B, SEQ=SEQ, GEN=GEN,
                           OUT=path).items():
        code = code.replace(f"__{key}__", str(value))
    assert "OK" in run_with_devices(code, n_devices=4, timeout=600)
    with np.load(path) as data:
        return {key: data[key] for key in data.files}


def _cases(ref):
    cases = {}
    for arch in ARCHS:
        cfg = _cfg(arch)
        batch = _tree(ref, arch + "/batch/")
        cases[arch] = dict(cfg=cfg, params=_tree(ref, arch + "/params/"),
                           prompts=batch.pop("tokens"), extras=batch,
                           max_len=_max_len(cfg), start=_start(cfg))
    cfg = dataclasses.replace(_cfg("whisper-base"), vocab_size=511)
    rng = np.random.default_rng(9)
    cases[ODD] = dict(
        cfg=cfg, params=None, max_len=_max_len(cfg), start=_start(cfg),
        prompts=rng.integers(1, 511, (B, SEQ)).astype(np.int32),
        extras={"frames": rng.normal(size=(
            B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)})
    return cases


@pytest.fixture(scope="module")
def ranks(reference):
    return M.spawn(R.mesh_families, 4, backend="gloo", device="cpu",
                   args=(_cases(reference), GEN), timeout_s=600)


def _rows(ranks, arch, get):
    """The whole batch from the data ranks' rows (dim 0), the two model
    ranks of each data row holding theirs bitwise alike."""
    parts = [get(ranks[r][arch]) for r in range(4)]
    for r in (0, 2):
        assert np.array_equal(parts[r], parts[r + 1])
    return np.concatenate([parts[0], parts[2]])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_reference(reference, ranks, arch):
    got = _rows(ranks, arch, lambda o: o["mesh"]["prefill"])
    assert got.shape == (B, _cfg(arch).vocab_size)
    np.testing.assert_allclose(got, reference[arch + "/prefill"], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_step_logits_match_reference(reference, ranks, arch):
    got = np.concatenate([ranks[r][arch]["mesh"]["steps"] for r in (0, 2)],
                         axis=1)
    for r in (0, 2):
        assert np.array_equal(ranks[r][arch]["mesh"]["steps"],
                              ranks[r + 1][arch]["mesh"]["steps"])
    np.testing.assert_allclose(got, reference[arch + "/steps"], rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_tokens_identical_on_every_rank(reference, ranks, arch):
    for out in ranks:
        assert out[arch]["tokens"].shape == (B, GEN)
        assert np.array_equal(out[arch]["tokens"],
                              reference[arch + "/tokens"])


@pytest.mark.parametrize("arch", ARCHS)
def test_vocab_parallel_embedding_prefill_matches_reference(reference,
                                                            ranks, arch):
    """The prefill with the vocab-parallel lookup taken at this size (its
    threshold lowered): the same logits, the lookup being exact."""
    got = _rows(ranks, arch, lambda o: o["prefill_sharded_embed"])
    np.testing.assert_allclose(got, reference[arch + "/prefill"], rtol=RTOL,
                               atol=ATOL)


def _chunk_of(cfg, key):
    """(the dim a cache leaf is split along over model, the chunk length),
    or None (whole): the attention caches by their positions, the SSM
    state by its heads, the x conv tail by its columns."""
    name = key.split("/")[-1]
    if name == "ssm":
        return 2, cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim // 2
    if name == "conv_x":
        return 3, cfg.ssm.expand * cfg.d_model // 2
    if name in ("conv_b", "conv_c"):
        return None
    if key.startswith("cross_"):
        return 2, cfg.n_audio_frames // 2
    return 2, _max_len(cfg) // 2


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_chunks_match_one_process(reference, ranks, arch):
    """Each rank's cache after the prefill: its rows of every leaf, its
    chunk of each attention cache's positions, its heads of the SSM state
    and its columns of the x conv tail (the B and C tails whole, alike on
    both model ranks), against the one-process engine's cache and, where
    the prefill wrote, the reference's."""
    cfg = _cfg(arch)
    rows = B // 2
    one = ranks[0][arch]["one"]["cache"]
    for r, out in enumerate(ranks):
        d, m = divmod(r, 2)
        got = out[arch]["mesh"]["cache"]
        assert got.keys() == one.keys()
        for key, leaf in got.items():
            want = one[key][:, d * rows:(d + 1) * rows]
            ref = reference[f"{arch}/cache/{key}"][:, d * rows:(d + 1) * rows]
            split = _chunk_of(cfg, key)
            if split is None:
                assert leaf.shape == want.shape, key
                np.testing.assert_allclose(leaf, want, rtol=RTOL, atol=ATOL)
                np.testing.assert_allclose(leaf, ref, rtol=RTOL, atol=ATOL)
                if m:
                    assert np.array_equal(
                        leaf, ranks[r - 1][arch]["mesh"]["cache"][key]), key
                continue
            dim, sc = split
            assert leaf.shape[dim] == sc, (key, leaf.shape)
            np.testing.assert_allclose(
                leaf, np.take(want, range(m * sc, (m + 1) * sc), dim),
                rtol=RTOL, atol=ATOL, err_msg=key)
            written = np.take(ref, range(m * sc, min((m + 1) * sc,
                                                     ref.shape[dim])), dim)
            np.testing.assert_allclose(
                np.take(leaf, range(written.shape[dim]), dim), written,
                rtol=RTOL, atol=ATOL, err_msg=key)


def test_split_cross_cache_matches_the_whole_one(ranks):
    """whisper's cross attention over its frames split over model (each
    rank's chunk, the partials merged in f32) against the same cache held
    whole; a length that does not tile the axis stays whole."""
    for out in ranks:
        cross = out["cross"]
        assert cross["k"] == 2 and cross["odd"] is None
        np.testing.assert_allclose(cross["split"], cross["whole"],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ["paligemma-3b", "whisper-base"])
def test_engine_hands_the_model_each_extras_rank_rows(reference, ranks,
                                                      arch):
    name = "patches" if arch == "paligemma-3b" else "frames"
    whole = reference[f"{arch}/batch/{name}"]
    rows = B // 2
    for r, out in enumerate(ranks):
        handed = out[arch]["handed"]
        d = r // 2
        assert np.array_equal(handed[name],
                              whole[d * rows:(d + 1) * rows]), r
        assert np.array_equal(handed["tokens"],
                              reference[arch + "/batch/tokens"]
                              [d * rows:(d + 1) * rows])


# the leaves of each model held whole on a (2, 2) mesh: a dim of each
# other leaf divides its axis (B and C's projections and conv tails, of
# ssm_state, split only over data by their d_model, and their conv biases
# not at all)
WHOLE = {"mamba2-2.7b": ("conv_b_w", "conv_b_b", "conv_c_w", "conv_c_b"),
         "zamba2-1.2b": ("conv_b_w", "conv_b_b", "conv_c_w", "conv_c_b"),
         "paligemma-3b": (), "whisper-base": ()}


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_params_round_trip_bitwise(reference, ranks, arch):
    """The rank state dicts put back together are the reference's weights;
    every leaf is held as the serving rules' ``spec_for`` gives it: the
    attention's heads (paligemma's one KV head whole), the MLP's columns
    and the Mamba2 mixers' heads split over model, each d_model dim over
    data."""
    from repro_torch import interop
    from repro_torch.launch.serve import serving_rules
    from repro_torch.models.registry import build_model
    cfg = _cfg(arch)
    whole = interop.lm_params_from_jax(
        _tree(reference, arch + "/params/"), cfg)
    specs = ranks[0][arch]["specs"]
    rules = serving_rules(cfg, _Sized(MESH), _max_len(cfg))
    defs = S.flat_keys(build_model(cfg).param_defs())
    assert specs == {k: rules.spec_for(p.logical, p.shape)
                     for k, p in defs.items()}
    assert sorted({k.split(".")[-1] for k, s in specs.items()
                   if not any(s)}) == sorted(WHOLE[arch])
    split_model = [k for k, s in specs.items() if "model" in s]
    if cfg.family in ("ssm", "hybrid"):
        assert specs["layers.0.mamba.in_x"] == ("data", "model")
        assert specs["layers.0.mamba.a_log"] == ("model",)
    if cfg.family != "ssm":
        stack = "dec_layers" if cfg.family == "audio" else "layers"
        prefix = "shared" if cfg.family == "hybrid" else f"{stack}.0"
        attn = "self_attn" if cfg.family == "audio" else "attn"
        assert specs[f"{prefix}.{attn}.wq"] == ("data", "model")
        assert specs[f"{prefix}.{attn}.wk"] == (
            ("data",) if cfg.n_kv_heads == 1 else ("data", "model"))
        assert specs[f"{prefix}.mlp.w_down"] == ("model", "data")
    assert "embed.embedding" in split_model
    back = S.unshard_tree([o[arch]["shards"] for o in ranks], specs, MESH)
    assert back.keys() == whole.keys()
    for key, value in whole.items():
        assert np.array_equal(back[key], value.numpy()), key


def test_whole_vocab_enc_dec_matches_one_process(ranks):
    """whisper with an odd vocab (its published 51,865 is odd): the table
    held whole over vocab, split over d_model; logits and tokens as the
    one-process engine's on the same seeded weights."""
    cfg = dataclasses.replace(_cfg("whisper-base"), vocab_size=511)
    for out in ranks:
        assert out[ODD]["shards"]["embed.embedding"].shape == (
            511, cfg.d_model // 2)
        assert np.array_equal(out[ODD]["tokens"], ranks[0][ODD]["tokens"])
    rows = B // 2
    for r, out in enumerate(ranks):
        d = r // 2
        for key in ("prefill", "steps"):
            one = out[ODD]["one"][key]
            np.testing.assert_allclose(
                out[ODD]["mesh"][key],
                one[..., d * rows:(d + 1) * rows, :], rtol=1e-5, atol=1e-6)


def test_engine_draw_is_the_one_process_draw_bitwise(ranks):
    """``ServeEngine(mesh=)`` drawing its own weights (whisper, vocab 511):
    every leaf on every rank is its ``spec_for`` shard of the one-process
    engine's draw from the same seed, bitwise, the split ones too."""
    for out in ranks:
        same = out[ODD]["draw_bitwise"]
        assert same and all(same.values()), [k for k, v in same.items()
                                             if not v]
        assert sum(any(s) for s in out[ODD]["specs"].values()) > 1


def test_mesh_serves_every_family(ranks):
    """``ServeEngine(mesh=)`` builds for every family of the registry: each
    rank holds its (V/2, D/2) shard of the smoke model's table."""
    from repro_torch.models.registry import FAMILIES
    for out in ranks:
        assert sorted(out["engines"]) == sorted(FAMILIES)
        for family, (arch, shape) in out["engines"].items():
            cfg = get_smoke(arch)
            assert shape == (cfg.vocab_size // 2, cfg.d_model // 2), family
