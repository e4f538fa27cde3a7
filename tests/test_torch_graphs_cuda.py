"""The port's compiled loops on a card: the SVM ``dms`` epoch and the
serving engine's decode step as CUDA graphs (:mod:`repro_torch.runtime.graphs`),
each against the same body run eagerly (``graphs=False``). No JAX here, so
the file runs where JAX is absent:

    PYTHONPATH=src python -m pytest -q tests/test_torch_graphs_cuda.py

Without a card every test skips. Bound: bitwise. A replay launches the
kernels the eager body launches, in the same order, on the same inputs, so
no rounding can differ. The host's launch counters count a capture's
launches once and a replay's not at all; the profiler counts what runs.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.config import get_smoke
from repro_torch.core import svm
from repro_torch.kernels.hinge import ops as hinge_ops
from repro_torch.launch.serve import ServeEngine
from repro_torch.runtime import graphs as G

torch.set_num_threads(1)

# every mode dms_block_stepper takes but async gossip, which stays eager
MODES = [("none", "all"), ("delayed", "all"), ("chunked", "all"),
         ("none", "ring"), ("none", "pairwise")]
ARCHS = ["smollm-360m", "mamba2-2.7b", "zamba2-1.2b"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: a CUDA graph has no CPU mode")
    return torch.device("cuda")


def _svm_data(dev, k=8, blocks=10, bs=16, d=64, seed=0):
    rng = np.random.default_rng(seed)
    n = k * blocks * bs
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = np.where(x @ rng.normal(size=d) > 0, 1.0, -1.0).astype(np.float32)
    return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)


def _count_launches(fn):
    """(result, hinge launches, of them on the cluster kernel) of ``fn()``."""
    hinge_ops.LAUNCHES = hinge_ops.CLUSTER_LAUNCHES = 0
    out = fn()
    torch.cuda.synchronize()
    return out, hinge_ops.LAUNCHES, hinge_ops.CLUSTER_LAUNCHES


# the first test of the file: in a fresh process it captures kernels that
# were never launched before (their libraries loaded, nothing warmed)
@pytest.mark.parametrize("grad_impl", ["kernel", "torch"])
@pytest.mark.parametrize("overlap,topology", MODES)
def test_dms_graph_is_eager_bitwise(cuda, overlap, topology, grad_impl):
    """Every stepper mode: the graphed epochs bitwise the eager ones; the
    first call captures (each block's launch recorded and counted once),
    the second replays that capture (no launch made on the host)."""
    svm.DMS_GRAPHS.clear()
    x, y = _svm_data(cuda)
    w0 = torch.zeros(x.shape[1], device=cuda)
    kw = dict(workers=8, epochs=3, block_size=16, overlap=overlap,
              topology=topology, grad_impl=grad_impl, device=cuda)
    captures = G.CAPTURES
    graphed, n_graph, c_graph = _count_launches(lambda: svm.dms(w0, x, y,
                                                                **kw))
    assert G.CAPTURES == captures + 1
    again, n_again, _ = _count_launches(lambda: svm.dms(w0, x, y, **kw))
    eager, n_eager, c_eager = _count_launches(
        lambda: svm.dms(w0, x, y, graphs=False, **kw))
    assert G.CAPTURES == captures + 1
    assert torch.equal(graphed, eager) and torch.equal(again, eager)
    on = grad_impl == "kernel"
    assert (n_graph, c_graph) == (10 * on, 10 * on)
    assert (n_eager, c_eager) == (30 * on, 30 * on)
    assert n_again == 0


def _profiled(fn):
    """(hinge launches by the host count, cluster-kernel runs by the
    profiler) of ``fn()``, counted from 0."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    hinge_ops.LAUNCHES = hinge_ops.CLUSTER_LAUNCHES = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    seen = sum(e.device_type == DeviceType.CUDA and "hinge_cluster" in e.name
               for e in prof.events())
    assert hinge_ops.CLUSTER_LAUNCHES == hinge_ops.LAUNCHES
    return hinge_ops.LAUNCHES, seen


def test_dms_launches_counted_by_the_profiler(cuda):
    """A call that captures counts an epoch's launches on the host, once,
    and the profiler sees every epoch's; a call on the kept capture counts
    none on the host and the profiler sees them all."""
    svm.DMS_GRAPHS.clear()
    x, y = _svm_data(cuda, seed=1)
    w0 = torch.zeros(x.shape[1], device=cuda)
    kw = dict(workers=8, block_size=16, device=cuda)
    assert _profiled(lambda: svm.dms(w0, x, y, epochs=4, **kw)) == (10, 40)
    assert _profiled(lambda: svm.dms(w0, x, y, epochs=3, **kw)) == (0, 30)
    assert _profiled(lambda: svm.dms(w0, x, y, epochs=2, graphs=False,
                                     **kw)) == (20, 20)


def test_dms_keeps_its_capture(cuda):
    """A later call on the same data replays the kept capture: from
    another w0, on data changed in place (read by address), each bitwise
    the eager call, the earlier result left as it was; data at another
    address captures anew, and at most ``DMS_GRAPHS_MAX`` are kept."""
    svm.DMS_GRAPHS.clear()
    x, y = _svm_data(cuda, seed=3)
    w0 = torch.zeros(x.shape[1], device=cuda)
    kw = dict(workers=8, epochs=2, block_size=16, device=cuda)
    captures = G.CAPTURES
    first = svm.dms(w0, x, y, **kw)
    kept = first.clone()
    w1 = torch.linspace(-1, 1, x.shape[1], device=cuda)
    assert torch.equal(svm.dms(w1, x, y, **kw),
                       svm.dms(w1, x, y, graphs=False, **kw))
    x.mul_(-0.5)
    assert torch.equal(svm.dms(w0, x, y, **kw),
                       svm.dms(w0, x, y, graphs=False, **kw))
    assert G.CAPTURES == captures + 1 and torch.equal(first, kept)
    x2 = x.clone()
    assert torch.equal(svm.dms(w0, x2, y, **kw), svm.dms(w0, x, y, **kw))
    assert G.CAPTURES == captures + 2 and len(svm.DMS_GRAPHS) == 2
    for bs in (2, 4, 5, 8, 10, 20, 40, 80):
        svm.dms(w0, x, y, workers=8, epochs=1, block_size=bs, device=cuda)
    assert len(svm.DMS_GRAPHS) == svm.DMS_GRAPHS_MAX


def test_compiled_counts_launches_at_capture(cuda):
    """A body of three kernel launches: the capture counts three and runs
    none (no warm-up: the buffer is untouched), four replays count none
    and run all twelve."""
    x, y = _svm_data(cuda, k=2, blocks=1, bs=8)
    xb, yb = x.reshape(2, 8, -1), y.reshape(2, 8)
    w = torch.zeros((2, x.shape[1]), device=cuda)

    def body(w):
        for _ in range(3):
            w.copy_(w - 0.5 * hinge_ops.hinge_block_grad(w, xb, yb, 1.0))
    want = w.clone()
    for _ in range(4):
        body(want)
    hinge_ops.LAUNCHES = 0
    run = G.Compiled(body, w, graph=True)
    torch.cuda.synchronize()
    assert hinge_ops.LAUNCHES == 3
    assert not w.any()
    for _ in range(4):
        run()
    torch.cuda.synchronize()
    assert hinge_ops.LAUNCHES == 3
    assert torch.equal(w, want)


def test_failed_capture_raises(cuda):
    """A host read inside the body ends the capture: it raises, and no
    capture is counted."""
    v = torch.ones(4, device=cuda)
    captures = G.CAPTURES

    def body(v):
        if float(v.sum()) > 0:
            v.add_(1)
    with pytest.raises(RuntimeError):
        G.Compiled(body, v, graph=True)
    assert G.CAPTURES == captures
    torch.cuda.synchronize()


def _engines(arch, dev, max_len):
    cfg = get_smoke(arch)
    return {graphs: ServeEngine(cfg, dev, max_len=max_len, graphs=graphs)
            for graphs in (True, False)}


def _forced(engine, prompts, forced):
    """Logits of each teacher-forced step of the engine's decode loop."""
    logits, _ = engine.prefill(prompts)
    loop = engine.decode_loop(prompts.shape[0])
    loop.start(logits, prompts.shape[1])
    out = []
    for i in range(forced.shape[1]):
        loop.token.copy_(forced[:, i:i + 1])
        out.append(loop.step().clone())
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_graph_is_eager_bitwise(cuda, arch):
    """Greedy tokens and teacher-forced logits of the graphed step bitwise
    the eager step's; one capture per batch size however many calls, the
    second call's prompt shorter than the first's; after ``release`` the
    next call captures anew."""
    engines = _engines(arch, cuda, max_len=40)
    rng = np.random.default_rng(0)
    vocab = engines[True].cfg.vocab_size
    long_p = torch.from_numpy(rng.integers(1, vocab, size=(3, 20))).to(cuda)
    short_p = long_p[:, :9]
    captures = G.CAPTURES
    got = [engines[True].generate(p, 12) for p in (long_p, short_p)]
    assert G.CAPTURES == captures + 1
    engines[True].generate(long_p[:2], 4)
    assert G.CAPTURES == captures + 2
    want = [engines[False].generate(p, 12) for p in (long_p, short_p)]
    assert G.CAPTURES == captures + 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    forced = torch.from_numpy(rng.integers(1, vocab, size=(3, 10))).to(cuda)
    for a, b in zip(_forced(engines[True], long_p, forced),
                    _forced(engines[False], long_p, forced)):
        assert torch.equal(a, b)
    engines[True].release(3)
    np.testing.assert_array_equal(engines[True].generate(long_p, 12), got[0])
    assert G.CAPTURES == captures + 3


def test_replays_never_wait_for_the_host(cuda):
    """The replayed decode loop and the replayed dms epochs under the sync
    debug mode "error"."""
    engine = ServeEngine(dataclasses.replace(get_smoke("zamba2-1.2b")), cuda,
                         max_len=32)
    prompts = torch.arange(1, 17, device=cuda).reshape(2, 8)
    want = engine.generate(prompts, 6)
    logits, _ = engine.prefill(prompts)
    loop = engine.decode_loop(2)
    x, y = _svm_data(cuda, seed=2)
    k, d = 8, x.shape[1]
    xs, ys = svm._shard_data(x, y, k)
    run = svm.DmsEpochs(torch.zeros(d, device=cuda),
                        xs.reshape(k, 10, 16, d), ys.reshape(k, 10, 16),
                        c=1.0, grad_impl="kernel", graphs=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loop.start(logits, 8)
        for _ in range(6):
            loop.step()
        for t in range(3):
            run.epoch(t)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    np.testing.assert_array_equal(loop.tokens(8, 6), want)
    assert bool(torch.isfinite(run.model()).all())
