"""The port's compiled loops on the CPU, against the reference: the decode
step with its index as a device tensor (``repro_torch.models``), the serving
engine's static per-batch cache and decode loop (``launch.serve``), and the
SVM ``dms`` epoch body with α as a device scalar (``core.svm.DmsEpochs``).
On the CPU these bodies run eagerly, as :class:`repro_torch.runtime.graphs
.Compiled` runs them there; the card's graphs are held to the same bodies
in ``tests/test_torch_graphs_cuda.py``.

Tolerances: the existing files' own. Against the reference, f32 at rtol
1e-4 / atol 1e-5 and bf16 at atol 5e-2 with a relative L2 of 3e-2
(``tests/test_torch_lm.py``, ``tests/test_torch_ssm.py``); greedy tokens
exactly. Within the port, bitwise: a device-tensor index and an int run the
same operations, and the epoch body runs today's blocks in today's order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_smoke as jget_smoke
from repro.launch import mesh as jmesh
from repro.launch.serve import ServeEngine as JServeEngine
from repro.models.registry import build_model as jbuild
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.config import get_smoke
from repro_torch.core import collectives, svm, sync
from repro_torch.data import make_svm_dataset
from repro_torch.launch.serve import ServeEngine
from repro_torch.models import attention as TA
from repro_torch.models.registry import build_model as tbuild
from repro_torch.runtime import graphs as G

torch.set_num_threads(1)

ARCHS = ["smollm-360m", "mamba2-2.7b", "zamba2-1.2b"]
F32 = dict(rtol=1e-4, atol=1e-5)
BF16_ATOL, BF16_REL_L2 = 5e-2, 3e-2
MODES = [("none", "all"), ("delayed", "all"), ("chunked", "all"),
         ("none", "ring"), ("none", "pairwise")]


def _cfgs(arch, dtype):
    return (dataclasses.replace(jget_smoke(arch), dtype=dtype),
            dataclasses.replace(get_smoke(arch), dtype=dtype))


def _close(got, want, dtype):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_ATOL)
        den = np.linalg.norm(want)
        if den > 0:
            assert np.linalg.norm(got - want) / den <= BF16_REL_L2


# ------------------------------------------------------------------ decode

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_device_index_decode(arch, dtype):
    """Four decode steps with the index as a device tensor (as the engine's
    loop passes it, advanced in place) bitwise the steps with an int index,
    logits and every cache leaf; both against the reference's
    ``decode_step`` with its traced ``jnp.int32`` index."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.key(5))
    sd = interop.lm_params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    tm = tbuild(tcfg, attn_impl="torch", ssd_impl="torch")
    tp = tm.load(sd, "cpu")
    b, s, steps = 2, 13, 4
    tokens = np.random.default_rng(6).integers(
        1, jcfg.vocab_size, size=(b, s)).astype(np.int32)
    cdt = getattr(torch, dtype)
    caches = [tm.init_cache(b, s + steps, dtype=cdt) for _ in range(2)]
    for cache in caches:
        tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(tokens).long()},
                           cache)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens)})

    def grow(dst, src):   # the reference engine's _grow_cache
        return jnp.pad(src.astype(dst.dtype),
                       [(0, d - w) for d, w in zip(dst.shape, src.shape)])
    jcache = jax.tree.map(grow, jm.init_cache(b, s + steps,
                                              dtype=jnp.dtype(dtype)), jc)
    index = torch.tensor([s])
    token = np.argmax(np.asarray(jl, np.float32), axis=-1)[:, None]
    for i in range(s, s + steps):
        tok = torch.from_numpy(token).long()
        by_int, _ = tm.decode_step(tp, {"token": tok, "cache": caches[0],
                                        "index": i})
        by_tensor, _ = tm.decode_step(tp, {"token": tok, "cache": caches[1],
                                           "index": index})
        index.add_(1)
        assert torch.equal(by_tensor, by_int)
        for a, c in zip(T.leaves(caches[1]), T.leaves(caches[0])):
            assert torch.equal(a, c)
        jl, jcache = jm.decode_step(jp, {"token": jnp.asarray(token),
                                         "cache": jcache,
                                         "index": jnp.int32(i)})
        _close(by_tensor, jl, dtype)
        token = np.argmax(np.asarray(jl, np.float32), axis=-1)[:, None]
    assert int(index) == s + steps


@pytest.mark.parametrize("index", [7, torch.tensor(7), torch.tensor([7])])
def test_decode_index_forms(index):
    """An int, a 0-dim and a (1,) tensor all become the same (1,) int64."""
    got = TA.decode_index(index, torch.device("cpu"))
    assert got.dtype == torch.long and tuple(got.shape) == (1,)
    assert int(got) == 7


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_reuses_its_cache(arch):
    """Two ``generate`` calls of one batch size on the engine's one cache,
    the second prompt shorter than the first, each give the reference
    engine's tokens (f32); a third batch size gets a cache of its own, and
    the first call's cache and loop are the second's."""
    jcfg, tcfg = _cfgs(arch, "float32")
    jeng = JServeEngine(jcfg, jmesh.make_test_mesh((1, 1)),
                        jmesh.test_mesh_config((1, 1)), max_len=32,
                        dtype=jnp.float32)
    sd = interop.lm_params_from_jax(jax.tree.map(np.asarray, jeng.params),
                                    tcfg)
    teng = ServeEngine(tcfg, "cpu", max_len=32, dtype=torch.float32,
                       params=sd)
    assert teng.graphs is False
    rng = np.random.default_rng(1)
    long_p = rng.integers(1, jcfg.vocab_size, size=(3, 18), dtype=np.int32)
    short_p = long_p[:, :5].copy()
    for prompts, gen in ((long_p, 10), (short_p, 12)):
        got = teng.generate(prompts, gen)
        assert got.dtype == np.int32 and got.shape == (3, gen)
        np.testing.assert_array_equal(got, np.asarray(
            jeng.generate(prompts, gen)))
    cache, loop = teng.cache(3), teng.decode_loop(3)
    np.testing.assert_array_equal(teng.generate(short_p[:2], 4),
                                  np.asarray(jeng.generate(short_p[:2], 4)))
    assert teng.cache(3) is cache and teng.decode_loop(3) is loop
    assert teng.cache(2) is not cache


def test_prefill_zeroes_a_reused_cache():
    """A shorter prompt's prefill leaves the cache a fresh engine's: the
    longer request's k, v past it are zeros again."""
    eng = ServeEngine(get_smoke("smollm-360m"), "cpu", max_len=24)
    fresh = ServeEngine(get_smoke("smollm-360m"), "cpu", max_len=24)
    prompts = torch.arange(1, 21).reshape(2, 10)
    eng.generate(prompts, 6)
    _, cache = eng.prefill(prompts[:, :4])
    _, want = fresh.prefill(prompts[:, :4])
    for a, b in zip(T.leaves(cache), T.leaves(want)):
        assert torch.equal(a, b)


def test_graphs_true_on_the_cpu_raises():
    with pytest.raises(ValueError, match="graphs=True"):
        ServeEngine(get_smoke("smollm-360m"), "cpu", graphs=True)
    x = np.ones((64, 4), np.float32)
    with pytest.raises(ValueError, match="graphs=True"):
        svm.dms(np.zeros(4, np.float32), x, np.ones(64, np.float32),
                workers=4, epochs=1, block_size=4, device="cpu", graphs=True)
    with pytest.raises(ValueError, match="graphs=True"):
        G.use_graphs(True, torch.device("cpu"))
    with pytest.raises(ValueError, match="eagerly"):
        svm.dms(np.zeros(4, np.float32), x, np.ones(64, np.float32),
                workers=4, epochs=1, block_size=4, topology="ring",
                gossip_async=True, device="cpu", graphs=True)


@pytest.mark.parametrize("graphs,device,want", [
    (None, "cpu", False), (False, "cpu", False), (None, "cuda", True),
    (False, "cuda", False), (True, "cuda", True)])
def test_use_graphs(graphs, device, want):
    assert G.use_graphs(graphs, torch.device(device)) is want


def test_compiled_runs_eagerly_without_a_graph():
    """graph=False: every call runs the body on the given buffers."""
    buf = torch.zeros(3)
    run = G.Compiled(lambda b: b.add_(1) * 2, buf, graph=False)
    assert run.capture_s is None and run.graph is None
    assert torch.equal(run(), torch.full((3,), 2.0))
    run()
    assert torch.equal(buf, torch.full((3,), 2.0))


def test_compiled_graph_on_the_cpu_raises():
    """A capture takes buffers on one card: CPU buffers raise, and nothing
    is counted as captured."""
    captures = G.CAPTURES
    with pytest.raises(ValueError, match="one card"):
        G.Compiled(lambda b: b.add_(1), torch.zeros(3), graph=True)
    assert G.CAPTURES == captures


def test_engine_release():
    """``release`` drops a batch size's cache and decode loop; the next
    request makes them anew and gets the same tokens."""
    eng = ServeEngine(get_smoke("smollm-360m"), "cpu", max_len=24)
    prompts = torch.arange(1, 21).reshape(2, 10)
    want = eng.generate(prompts, 6)
    cache, loop = eng.cache(2), eng.decode_loop(2)
    eng.release(2)
    eng.release(5)                      # a batch size never used: no-op
    np.testing.assert_array_equal(eng.generate(prompts, 6), want)
    assert eng.cache(2) is not cache and eng.decode_loop(2) is not loop


# --------------------------------------------------------------------- dms

@pytest.fixture(scope="module")
def webspam():
    ds = make_svm_dataset("webspam", seed=0, n_override=2048)
    return ds.x_train, ds.y_train


def _dms_today(w0, x, y, *, workers, epochs, block_size, c=1.0, **modes):
    """``dms(backend="vmap")`` as it ran before the epoch body: every block
    through the stepper from its init carry, α a CPU scalar."""
    xs, ys = svm._shard_data(torch.from_numpy(x), torch.from_numpy(y),
                             workers)
    w0 = torch.from_numpy(w0)
    k, n_local, d = xs.shape
    nb = n_local // block_size
    xb = xs[:, :nb * block_size].reshape(k, nb, block_size, d)
    yb = ys[:, :nb * block_size].reshape(k, nb, block_size)
    step = svm.dms_block_stepper(d=d, c=c, grad_impl="kernel", **modes)
    carry = svm.dms_stepper_init(w0, k, **modes)
    for t in range(epochs):
        for i in range(nb):
            carry = step(carry, xb[:, i], yb[:, i], svm._alpha(t, w0.dtype))
    if modes["overlap"] == "none" and modes["topology"] == "all":
        return carry["w"][0]
    return carry["w"].mean(dim=0)[:d]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("overlap,topology", MODES)
def test_dms_epoch_body_is_today_bitwise(webspam, overlap, topology, dtype):
    """The epoch body (static carry, α a device scalar filled before each
    epoch, the epoch-end carry copied back), run eagerly on the CPU as on
    the card under ``graphs=False``, bitwise the block loop it replaces."""
    x, y = (a.astype(dtype) for a in webspam)
    w0 = np.zeros(x.shape[1], dtype)
    kw = dict(workers=8, epochs=3, block_size=16, overlap=overlap,
              topology=topology)
    got = svm.dms(w0, x, y, device="cpu", **kw)
    assert got.dtype == torch.from_numpy(w0).dtype
    assert torch.equal(got, _dms_today(w0, x, y, **kw))


def test_dms_epochs_alpha_and_carry():
    """The α an epoch reads is today's rounded 1/(1+t), and a run of epochs
    leaves its result in the static carry."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(4, 6, 8, 12)).astype(np.float32))
    y = torch.from_numpy(np.where(rng.random((4, 6, 8)) > 0.5, 1.0,
                                  -1.0).astype(np.float32))
    run = svm.DmsEpochs(torch.zeros(12), x, y, c=1.0, grad_impl="kernel",
                        overlap="delayed")
    assert run.compiled.capture_s is None and run.compiled.graph is None
    carry = run.carry
    for t in range(3):
        run.epoch(t)
        assert torch.equal(run.alpha, svm._alpha(t, torch.float32))
    assert run.carry is carry and carry["w"].is_contiguous()
    assert carry["w"].any() and carry["pending"].any()


@pytest.mark.parametrize("overlap,topology", MODES)
def test_dms_epochs_reset(webspam, overlap, topology):
    """A run reset to another w0 (as a kept capture is at a later ``dms``
    call) is bitwise a fresh run from that w0, and the first run's model,
    a tensor of its own, is left as it was."""
    x, y = (torch.from_numpy(a) for a in webspam)
    k, bs = 8, 16
    xs, ys = svm._shard_data(x, y, k)
    nb = xs.shape[1] // bs
    xb = xs[:, :nb * bs].reshape(k, nb, bs, -1)
    yb = ys[:, :nb * bs].reshape(k, nb, bs)
    kw = dict(c=1.0, grad_impl="kernel", overlap=overlap, topology=topology)
    w0s = [torch.zeros(x.shape[1]), torch.from_numpy(
        np.random.default_rng(5).normal(size=x.shape[1]).astype(np.float32))]
    run = svm.DmsEpochs(w0s[0], xb, yb, **kw)
    models = []
    for w0 in w0s:
        if models:
            run.reset(w0)
        for t in range(2):
            run.epoch(t)
        models.append(run.model())
    first = models[0].clone()
    fresh = svm.DmsEpochs(w0s[1], xb, yb, **kw)
    for t in range(2):
        fresh.epoch(t)
    assert torch.equal(models[1], fresh.model())
    run.reset(w0s[1])
    run.epoch(0)
    assert torch.equal(models[0], first)


@pytest.mark.parametrize("topology", ["ring", "pairwise"])
def test_permute_by_slices_is_the_gather(topology):
    """The gossip exchange's rows gathered by slices (the one-card replica
    axis's ``permute``) are the index gather of the same permutation,
    bitwise, for each of the topology's wires."""
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(8, 5, 3)).astype(np.float32))
    for perm in sync._gossip_perms(8, topology):
        src = [0] * 8
        for s, d in perm:
            src[d] = s
        assert torch.equal(collectives.STACKED.permute(x, perm), x[src])
