"""The port's tensor- and sequence-parallel layers against the reference's
on a (data 2, model 2) mesh, layer by layer.

One subprocess (``conftest.run_with_devices``, 4 devices) runs the
reference's layers at smoke widths in f32 under its mesh rules, each weight
placed as ``spec_for`` shards it: the attention with dividing heads
(llama3.2-3b, 4 query / 2 KV heads), with heads held whole (smollm-360m,
3 / 1) and with one KV head (paligemma-3b, 4 / 1, prefix mask), whisper's
cross attention, the SwiGLU MLP, the RMS and layer norms, and the Mamba2
mixer (mamba2-2.7b, 8 heads) with its state; each prefill and one decode
step after it; and dumps inputs, weights and outputs to one npz. One
``repro_torch.launch.mesh.spawn`` of 4 gloo CPU ranks runs the port's
layers on each rank's shards (``serving_rules``; its data rows, its act_seq
chunk of a prefill's sequence). Bounds: ``test_torch_mesh_serve.py``'s,
rtol 1e-4 / atol 1e-5, on outputs, k, v and caches (the partial sums over
model round otherwise than one product). Beside them: each rank's param
bytes against ``spec_for``'s shard shapes, the residual's layout between
layers (the act_seq chunk in a prefill, whole in a decode step), and a
split the code cannot compute on raising.
"""
import numpy as np
import pytest

from conftest import run_with_devices
from repro_torch.launch import mesh as M

import torch_dist_ranks as R

B, S, T_MAX = 4, 16, 24
RTOL, ATOL = 1e-4, 1e-5
ATTN = {"llama": ("llama3.2-3b", "causal", 0),
        "smollm": ("smollm-360m", "causal", 0),
        "paligemma": ("paligemma-3b", "prefix", 8)}

REFERENCE = r"""
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding
from repro.config import get_smoke
from repro.launch.mesh import make_test_mesh, test_mesh_config
from repro.models import attention as A
from repro.models import layers as L
from repro.models import ssm as SSM
from repro.sharding import rules_for, use_rules

mesh, mesh_cfg = make_test_mesh((2, 2)), test_mesh_config((2, 2))
rules = rules_for(mesh_cfg, mesh)
B, S, T_MAX = __B__, __S__, __T_MAX__
rng = np.random.default_rng(0)
out = {}


def normal(*shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def draw(defs):
    # each leaf around its init, off it by a little noise, so a slice taken
    # from the wrong rank shows
    def leaf(p):
        if p.init == "ones":
            return 1.0 + normal(*p.shape, scale=0.1)
        if p.init == "zeros":
            return normal(*p.shape, scale=0.1)
        if p.init == "ssm_a":
            return np.log(np.linspace(1.0, 16.0, p.shape[-1])).astype(
                np.float32) + normal(*p.shape, scale=0.1)
        fan_in = p.shape[0] if len(p.shape) == 1 else int(np.prod(
            p.shape[:-1]))
        return normal(*p.shape, scale=fan_in ** -0.5)
    return jax.tree.map(leaf, defs, is_leaf=lambda x: isinstance(x, L.Param))


def place(params, defs):
    return jax.tree.map(
        lambda d, p: jax.device_put(p, NamedSharding(
            mesh, rules.spec_for(d.logical, d.shape))),
        defs, params, is_leaf=lambda x: isinstance(x, L.Param))


def save(name, params, **arrays):
    for k, v in params.items():
        if isinstance(v, dict):
            for k2, v2 in v.items():
                out[f"{name}/params/{k}/{k2}"] = np.asarray(v2)
        else:
            out[f"{name}/params/{k}"] = np.asarray(v)
    for k, v in arrays.items():
        out[f"{name}/{k}"] = np.asarray(v)


def f32(arch):
    return dataclasses.replace(get_smoke(arch), dtype="float32")


positions = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
index = S
with jax.set_mesh(mesh), use_rules(rules):
    for name, (arch, mode, prefix) in __ATTN__.items():
        cfg = f32(arch)
        defs = A.attn_defs(cfg)
        p = draw(defs)
        x, x1 = normal(B, S, cfg.d_model), normal(B, 1, cfg.d_model)
        y, k, v = jax.jit(lambda p, x: A.full_attention(
            p, x, positions, cfg, mask_mode=mode, prefix_len=prefix,
            return_kv=True))(place(p, defs), x)
        # a decode step at position S on a cache of T_MAX holding k, v
        ck = np.zeros((B, T_MAX) + k.shape[2:], np.float32)
        cv = np.zeros_like(ck)
        ck[:, :S], cv[:, :S] = k, v
        y1, nk, nv = jax.jit(lambda p, x1, ck, cv: A.decode_step_attention(
            p, x1, ck, cv, jnp.int32(index), cfg))(place(p, defs), x1, ck, cv)
        save(name, p, x=x, x1=x1, y=y, k=k, v=v, cache_k=ck, cache_v=cv,
             y1=y1, new_k=nk, new_v=nv)

    cfg = f32("whisper-base")
    defs = A.attn_defs(cfg)
    p = draw(defs)
    t = cfg.n_audio_frames
    x, x1, enc = (normal(B, S, cfg.d_model), normal(B, 1, cfg.d_model),
                  normal(B, t, cfg.d_model))
    y, k, v = jax.jit(lambda p, x, enc: A.full_attention(
        p, x, positions, cfg, mask_mode="full", kv_x=enc,
        return_kv=True))(place(p, defs), x, enc)
    y1, _, _ = jax.jit(lambda p, x1, k, v: A.decode_step_attention(
        p, x1, k, v, jnp.int32(index), cfg, cross=True))(
            place(p, defs), x1, k, v)
    save("cross", p, x=x, x1=x1, enc=enc, y=y, k=k, v=v, y1=y1)

    cfg = f32("llama3.2-3b")
    defs = L.mlp_defs(cfg.d_model, cfg.d_ff)
    p = draw(defs)
    x, x1 = normal(B, S, cfg.d_model), normal(B, 1, cfg.d_model)
    y = jax.jit(L.mlp)(place(p, defs), x)
    y1 = jax.jit(L.mlp)(place(p, defs), x1)
    save("mlp", p, x=x, x1=x1, y=y, y1=y1)

    for name, arch in (("rms", "llama3.2-3b"), ("layer", "whisper-base")):
        cfg = f32(arch)
        defs = L.norm_defs(cfg.d_model, cfg.norm_type)
        p = draw(defs)
        x = normal(B, S, cfg.d_model)
        y = jax.jit(lambda p, x: L.apply_norm(p, x, cfg.norm_type,
                                              cfg.norm_eps))(place(p, defs), x)
        save(name, p, x=x, y=y)

    cfg = f32("mamba2-2.7b")
    defs = SSM.mamba_defs(cfg)
    p = draw(defs)
    x, x1 = normal(B, S, cfg.d_model), normal(B, 1, cfg.d_model)
    y, tails = jax.jit(lambda p, x: SSM.mamba_fwd(p, x, cfg,
                                                  return_state=True))(
        place(p, defs), x)
    y1, cache = jax.jit(lambda p, x1, c: SSM.mamba_decode_step(
        p, x1, c, cfg))(place(p, defs), x1, tails)
    save("mamba", p, x=x, x1=x1, y=y, y1=y1,
         **{f"state/{k}": v for k, v in tails.items()},
         **{f"stepped/{k}": v for k, v in cache.items()})
np.savez("__OUT__", **out)
print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_tp") / "reference.npz"
    code = REFERENCE
    for key, value in dict(B=B, S=S, T_MAX=T_MAX, ATTN=ATTN,
                           OUT=path).items():
        code = code.replace(f"__{key}__", str(value))
    assert "OK" in run_with_devices(code, n_devices=4, timeout=600)
    with np.load(path) as data:
        return {key: data[key] for key in data.files}


def _case(ref, name):
    """A case's params (nested) and arrays from the reference's npz."""
    case = {"params": {}}
    for key, value in ref.items():
        if not key.startswith(name + "/"):
            continue
        path = key[len(name) + 1:].split("/")
        if path[0] == "params":
            node = case["params"]
            for p in path[1:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = value
        else:
            case["/".join(path)] = value
    return case


CASES = tuple(ATTN) + ("cross", "mlp", "rms", "layer", "mamba")


@pytest.fixture(scope="module")
def ranks(reference):
    cases = {name: _case(reference, name) for name in CASES}
    return M.spawn(R.mesh_tp_cases, 4, backend="gloo", device="cpu",
                   args=(cases, ATTN, T_MAX), timeout_s=600)


def _whole(ranks, name, key, seq_dim=None):
    """The whole batch from the ranks' pieces: the data ranks' rows (dim
    0); along ``seq_dim`` the model ranks' chunks put together, else the
    model ranks of a data row holding theirs bitwise alike."""
    parts = [ranks[r][name][key] for r in range(4)]
    rows = []
    for d in (0, 2):
        if seq_dim is None:
            assert np.array_equal(parts[d], parts[d + 1]), key
            rows.append(parts[d])
        else:
            rows.append(np.concatenate([parts[d], parts[d + 1]], seq_dim))
    return np.concatenate(rows, 0)


@pytest.mark.parametrize("name", tuple(ATTN) + ("cross",))
def test_attention_prefill_matches_reference(reference, ranks, name):
    """The prefill attention on the rank's heads, its act_seq chunk of the
    queries in and out, within rtol 1e-4 / atol 1e-5: llama's 4 / 2 heads
    split, smollm's 3 / 1 held whole, paligemma's 4 query heads split
    over its one KV head, whisper's cross attention over whole frames."""
    np.testing.assert_allclose(_whole(ranks, name, "y", 1),
                               reference[name + "/y"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", tuple(ATTN) + ("cross",))
def test_attention_kv_are_the_ranks_heads(reference, ranks, name):
    """The prefill's k, v on a rank: its KV heads where they split (rank m
    the m-th half), else all of them, within rtol 1e-4 / atol 1e-5."""
    for key in ("k", "v"):
        want = reference[f"{name}/{key}"]
        kv = want.shape[2]
        for r, out in enumerate(ranks):
            d, m = divmod(r, 2)
            rows = want[d * B // 2:(d + 1) * B // 2]
            if out[name]["kv_split"]:
                rows = rows[:, :, m * kv // 2:(m + 1) * kv // 2]
            np.testing.assert_allclose(out[name][key], rows, rtol=RTOL,
                                       atol=ATOL, err_msg=key)
    assert [o[name]["kv_split"] for o in ranks] == [
        name in ("llama", "cross")] * 4


@pytest.mark.parametrize("name", tuple(ATTN) + ("cross",))
def test_attention_decode_step_matches_reference(reference, ranks, name):
    """One decode step (the token's q, k, v gathered over model, the
    sequence-sharded decode attention, wo row-parallel and summed over
    model; the cross step over whisper's frames split by model) within
    rtol 1e-4 / atol 1e-5; the self caches' chunks as the reference
    wrote them."""
    np.testing.assert_allclose(_whole(ranks, name, "y1"),
                               reference[name + "/y1"], rtol=RTOL,
                               atol=ATOL)
    if name == "cross":
        return
    for key in ("k", "v"):
        np.testing.assert_allclose(_whole(ranks, name, f"new_{key}", 1),
                                   reference[f"{name}/new_{key}"],
                                   rtol=RTOL, atol=ATOL)


def test_mlp_matches_reference(reference, ranks):
    """The MLP on the rank's columns of w_gate / w_up and rows of w_down:
    a prefill's chunk (sum-scattered along the sequence) and a decode
    step's whole token (summed over model), rtol 1e-4 / atol 1e-5."""
    np.testing.assert_allclose(_whole(ranks, "mlp", "y", 1),
                               reference["mlp/y"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_whole(ranks, "mlp", "y1"),
                               reference["mlp/y1"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["rms", "layer"])
def test_norm_on_the_chunk_matches_reference(reference, ranks, name):
    """RMSNorm and whisper's LayerNorm (with its bias) on the rank's
    act_seq chunk, the scale and bias gathered over data, rtol 1e-4 /
    atol 1e-5."""
    np.testing.assert_allclose(_whole(ranks, name, "y", 1),
                               reference[name + "/y"], rtol=RTOL, atol=ATOL)


def test_mamba_mixer_matches_reference(reference, ranks):
    """The Mamba2 mixer on the rank's 4 of 8 heads (the SSD scan on them,
    the gated norm's sum of squares over model, ``out`` row-parallel): the
    prefill's chunk and a decode step's token, rtol 1e-4 / atol 1e-5."""
    np.testing.assert_allclose(_whole(ranks, "mamba", "y", 1),
                               reference["mamba/y"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_whole(ranks, "mamba", "y1"),
                               reference["mamba/y1"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("when", ["state", "stepped"])
def test_mamba_cache_by_heads(reference, ranks, when):
    """The mixer's cache after the prefill and after the step: the SSM
    state by the rank's heads (dim 1 of (B, H, N, P)) and the x conv tail
    by its columns (dim 2 of (B, W−1, d_inner)), the B and C tails whole,
    rtol 1e-4 / atol 1e-5."""
    for key, dim in (("ssm", 1), ("conv_x", 2), ("conv_b", None),
                     ("conv_c", None)):
        got = _whole(ranks, "mamba", f"{when}/{key}", dim)
        np.testing.assert_allclose(got, reference[f"mamba/{when}/{key}"],
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    h = reference["mamba/state/ssm"].shape[1]
    assert all(o["mamba"][f"{when}/ssm"].shape[1] == h // 2 for o in ranks)


@pytest.mark.parametrize("arch", R.FAMILY_ARCHS)
def test_rank_param_bytes_are_spec_for_shards(ranks, arch):
    """An engine's params on each rank take the bytes of ``spec_for``'s
    shard shapes of every leaf, about a quarter of the whole model's on
    this (2, 2) mesh where every dim divides."""
    for out in ranks:
        held, shards, whole = out["bytes"][arch]
        assert held == shards, arch
        assert held < whole / 2, arch


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-2.7b"])
def test_residual_between_layers_is_the_act_seq_chunk(ranks, arch):
    """A prefill of S = 16: every layer takes and returns the rank's
    (B/2, S/2, D) chunk; the model ranks' chunks differ."""
    for out in ranks:
        shapes = out["layout"][arch]["prefill"]
        assert shapes and all(s == (B // 2, S // 2) for s in shapes), shapes
    assert not np.array_equal(ranks[0]["layout"][arch]["first"],
                              ranks[1]["layout"][arch]["first"])


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mamba2-2.7b"])
def test_decode_step_holds_the_residual_whole(ranks, arch):
    """A decode step (S = 1 does not divide the model axis): every layer
    takes the rank's (B/2, 1, D) rows whole, bitwise alike on the two
    model ranks."""
    for out in ranks:
        shapes = out["layout"][arch]["decode"]
        assert shapes and all(s == (B // 2, 1) for s in shapes), shapes
    for r in (0, 2):
        assert np.array_equal(ranks[r]["layout"][arch]["step"],
                              ranks[r + 1]["layout"][arch]["step"])


def test_a_split_the_code_cannot_compute_on_raises(ranks):
    """No fallback: rules that split a Mamba2 mixer's d_inner and not its
    heads make it raise, as do query heads that straddle the groups of KV
    heads held whole."""
    for out in ranks:
        assert "heads (ssm_heads) and its d_inner (mlp)" in out["raises"][
            "mamba"]
        assert "do not fit the groups" in out["raises"]["q_group"]
