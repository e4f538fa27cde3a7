"""The port's MoE layer (``repro_torch.models.moe``) against the reference's
single-device path (``repro.models.moe.moe_ffn`` with no mesh rules) on the
CPU, on the same numpy-seeded router, expert weights and tokens.

Tolerances. Routing (the experts picked, their order, each slot's rank in
its expert's queue, the kept mask) is exact in f32: both packages take the
same f32 softmax, and ties go to the lower expert index in both. The aux
term is a mean over the tokens, summed in another order: 1–2 f32 ulps apart
(2.2e-7 relative at most here), held to 1e-6 relative. The outputs differ
only in the order of f32 sums: the F32 bound of ``test_torch_lm.py``. In
bf16 the outputs are held to that file's bf16 bounds (atol 5e-2, relative
L2 3e-2).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import phi35_moe as jphi
from repro.configs import qwen3_moe as jqwen
from repro.models import moe as JM
from repro_torch.config.base import MoEConfig
from repro_torch.configs import phi35_moe as tphi
from repro_torch.configs import qwen3_moe as tqwen
from repro_torch.models import moe as TM

torch.set_num_threads(1)

F32 = dict(rtol=1e-4, atol=1e-5)
BF16_ATOL, BF16_REL_L2 = 5e-2, 3e-2
AUX = dict(rtol=1e-6, atol=0)
# (E, k): the two smoke configs' routings, phi3.5-moe's 16/2 and
# qwen3-moe's 128/8 (at smoke width)
ROUTINGS = [(4, 2), (8, 2), (16, 2), (128, 8)]


def _cfgs(e, k, dtype="float32"):
    """The reference's and the port's qwen3-moe smoke config with E experts,
    top-k, in ``dtype``."""
    jcfg = dataclasses.replace(jqwen.smoke(), dtype=dtype,
                               moe=dataclasses.replace(jqwen.smoke().moe,
                                                       num_experts=e,
                                                       top_k=k))
    tcfg = dataclasses.replace(tqwen.smoke(), dtype=dtype,
                               moe=MoEConfig(num_experts=e, top_k=k))
    return jcfg, tcfg


def _inputs(cfg, seed, tokens=(2, 12)):
    """Router, expert weights (fan-in scaled) and x (B, S, D) as numpy."""
    rng = np.random.default_rng(seed)
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    params = {"router": rng.normal(size=(d, e)) / d ** 0.5,
              "w_gate": rng.normal(size=(e, d, f)) / d ** 0.5,
              "w_up": rng.normal(size=(e, d, f)) / d ** 0.5,
              "w_down": rng.normal(size=(e, f, d)) / f ** 0.5}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.normal(size=tokens + (d,)).astype(np.float32)
    return params, x


def _run(jcfg, tcfg, params, x, dtype):
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want, jaux = JM.moe_ffn({k: jnp.asarray(v) for k, v in params.items()},
                            jnp.asarray(x, jdt), jcfg)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    tx = torch.from_numpy(x).to(tdt)
    got = TM.moe_ffn(tparams, tx, tcfg)
    logits = TM.router_logits(tparams, tx)
    _, indices = TM.top_k_routing(logits, tcfg.moe.top_k)
    taux = TM.load_balance(logits, indices, tcfg)
    assert got.dtype == tdt and taux.dtype == torch.float32
    return (got.float().numpy(), np.asarray(want, np.float32),
            float(taux), float(jaux))


def _reference_routing(logits, cfg):
    """The reference's routing of f32 logits: its ``_top_k_routing``, and
    each slot's rank and kept mask by ``moe_ffn``'s own expressions."""
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    t = logits.shape[0]
    weights, indices = JM._top_k_routing(jnp.asarray(logits), k)
    cap = int(max(8, 1.25 * k * t / e))
    cap = -(-cap // 8) * 8
    flat_e = indices.reshape(t * k)
    pos = jnp.cumsum(jax.nn.one_hot(flat_e, e, dtype=jnp.int32), axis=0) - 1
    pos = jnp.take_along_axis(pos, flat_e[:, None], axis=1)[:, 0]
    pos = pos.reshape(t, k)
    return (np.asarray(weights), np.asarray(indices), np.asarray(pos),
            np.asarray(pos < cap), cap)


@pytest.mark.parametrize("e,k", ROUTINGS)
def test_routing_exact_in_f32(e, k):
    jcfg, tcfg = _cfgs(e, k)
    params, x = _inputs(tcfg, seed=e)
    logits = x.reshape(-1, tcfg.d_model) @ params["router"]
    weights, indices, pos, kept, cap = _reference_routing(logits, jcfg)
    tw, ti, tpos, tcap = TM.routing(torch.from_numpy(logits), tcfg)
    assert tcap == cap == TM.capacity(logits.shape[0], tcfg)
    np.testing.assert_array_equal(ti.numpy(), indices)
    np.testing.assert_array_equal(tpos.numpy(), pos)
    np.testing.assert_array_equal(tpos.numpy() < tcap, kept)
    np.testing.assert_allclose(tw.numpy(), weights, **F32)


@pytest.mark.parametrize("e,k", ROUTINGS)
def test_moe_ffn_f32(e, k):
    jcfg, tcfg = _cfgs(e, k)
    params, x = _inputs(tcfg, seed=10 + e)
    got, want, taux, jaux = _run(jcfg, tcfg, params, x, "float32")
    np.testing.assert_allclose(got, want, **F32)
    np.testing.assert_allclose(taux, jaux, **AUX)


@pytest.mark.parametrize("cfgs", [(jphi.smoke(), tphi.smoke()),
                                  (jqwen.smoke(), tqwen.smoke()),
                                  _cfgs(128, 8, "bfloat16")],
                         ids=["phi35-smoke", "qwen3-smoke", "e128-k8"])
def test_moe_ffn_bf16(cfgs):
    jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16") for c in cfgs)
    params, x = _inputs(tcfg, seed=20)
    got, want, taux, jaux = _run(jcfg, tcfg, params, x, "bfloat16")
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= BF16_REL_L2, rel
    np.testing.assert_allclose(taux, jaux, **AUX)


@pytest.mark.parametrize("e,k", ROUTINGS)
def test_zero_router_ties_pick_the_lowest_experts(e, k):
    """Every gate equal: experts 0..k−1 for every token, as jax.lax.top_k
    picks them (torch.topk would not), and the outputs agree."""
    jcfg, tcfg = _cfgs(e, k)
    params, x = _inputs(tcfg, seed=30 + e)
    params["router"][:] = 0.0
    logits = torch.from_numpy(x.reshape(-1, tcfg.d_model) @ params["router"])
    _, idx = TM.top_k_routing(logits, k)
    np.testing.assert_array_equal(
        idx.numpy(), np.broadcast_to(np.arange(k), idx.shape))
    _, jidx = JM._top_k_routing(jnp.asarray(logits.numpy()), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    got, want, taux, jaux = _run(jcfg, tcfg, params, x, "float32")
    np.testing.assert_allclose(got, want, **F32)
    np.testing.assert_allclose(taux, jaux, **AUX)


@pytest.mark.parametrize("e,k", [(4, 2), (16, 2)])
def test_over_capacity_slots_drop_as_in_the_reference(e, k):
    """A router biased onto expert 0 sends every token there first: its
    queue overflows the capacity, the slots ranked beyond it drop (the same
    slots as the reference's), and the outputs agree."""
    jcfg, tcfg = _cfgs(e, k)
    params, x = _inputs(tcfg, seed=40 + e, tokens=(2, 24))
    # logit 0 about 10 above the others: a gate of e^-10 for the rest, not
    # one that underflows (XLA's CPU flushes subnormal gates to zero, and
    # ties among the zeros would then pick otherwise than PyTorch's gates)
    x = np.abs(x)
    params["router"] = (params["router"] / 10).astype(np.float32)
    params["router"][:, 0] = 0.1
    logits = x.reshape(-1, tcfg.d_model) @ params["router"]
    _, indices, _, kept, cap = _reference_routing(logits, jcfg)
    _, ti, tpos, tcap = TM.routing(torch.from_numpy(logits), tcfg)
    assert (indices[:, 0] == 0).all() and cap < logits.shape[0]
    dropped = ~(tpos.numpy() < tcap)
    assert dropped[:, 0].sum() == logits.shape[0] - cap
    np.testing.assert_array_equal(~dropped, kept)
    got, want, taux, jaux = _run(jcfg, tcfg, params, x, "float32")
    np.testing.assert_allclose(got, want, **F32)
    np.testing.assert_allclose(taux, jaux, **AUX)
    # a token whose every slot dropped gets a zero row from the layer
    gone = dropped.all(axis=1)
    assert not got.reshape(-1, tcfg.d_model)[gone].any()
