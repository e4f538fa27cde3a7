"""Why the port's int8 local SGD flips a few values against the reference
on one process: the quantizer's rounding of last-bit differences.

One subprocess (``conftest.run_with_devices``, 2 devices) runs the
reference's ``make_local_sgd_block`` on (pod 2, data 1, model 1), K = 2,
int8 ``periodic``, mamba2-2.7b at its smoke widths in f32 (the case whose
flips stood past 1e-4 against the reference), for two seeds: momentum over
a block of two steps and AdamW (eps 1e-6, as the trainer on the card runs
it) over a block of one. It records the value each replica hands the
quantizer at the sync (its delta plus its error-feedback residual, carried
out of the block in place of the new residual), and each replica's
gradient at the block's start on its rows of the first microbatch. The
port's one-process K = 2 block runs from the same states and batches and
records its own, with its gradient there and that gradient's terms: the
gradient of each position's loss.

The two differ where the gradients' sums run in other orders. The bound
on that difference comes from the reduction, not from the runs: a sum of
N terms in f32, in any order, is within N·2^-24·Σ|terms| of the exact one
(the gradient is the mean over the replica's N positions of their losses'
gradients), and the backward's rounding moves across a leaf through the
positions' shared activations, so each leaf takes its largest Σ|terms|:
δ = N·2^-24·max over the leaf of Σ_t |∇ℓ_t| / N. The claims, value by
value: the port's gradient is within δ of the reference's; each value
handed to the quantizer is within what a gradient difference of δ makes of
the optimizer's update (plus the f32 rounding of the update and the
params). An int8 value then differs from the reference's only where a .5
boundary of the step lies between the two values, so within that bound of
one. Momentum's update moves with the gradient's difference times lr;
AdamW's first update, lr·g/(|g| + eps), normalizes a gradient element that
is itself within δ of zero (a sum that cancels) to a sizable step, so
there a last-bit difference moves a value by up to 2·lr: that is where
AdamW's flips come from. A difference past these would be a fault of the
port.
"""
import json

import numpy as np
import pytest

from conftest import run_with_devices

ARCH = "mamba2-2.7b"
SEEDS = (31, 32)
# momentum over a block of two steps (the trainer tests' optimizer), and
# AdamW over a block of one step (its first update, lr·g/(|g| + eps),
# normalizes every gradient element) at the card's eps
RUNS = {"momentum": dict(h=2, opt=dict(name="momentum", learning_rate=0.05)),
        "adamw": dict(h=1, opt=dict(name="adamw", learning_rate=1e-3,
                                    eps=1e-6))}
ROWS, SEQ = 4, 32

REFERENCE = r"""
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.config import (DataConfig, MeshConfig, OptimizerConfig,
                          SyncConfig, TrainConfig, get_smoke)
from repro.core import compression as C
from repro.core import local_sgd as LS
from repro.models.registry import build_model

RUNS = json.loads('''__RUNS__''')
out = {}

def dump(tag, tree):
    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], prefix + "/" + k)
        else:
            out[prefix] = np.asarray(node)
    walk(tree, tag)

inner = C.compress_tree

def compress_tree(delta, ef):
    # the residual carries the value handed to the quantizer out of the
    # block (one block: nothing reads it after the sync)
    q, s, _ = inner(delta, ef)
    return q, s, jax.tree.map(lambda d, e: d.astype(jnp.float32) + e,
                              delta, ef)
C.compress_tree = compress_tree

mesh = jax.make_mesh((2, 1, 1), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
for name, run in RUNS.items():
    cfg = TrainConfig(
        model=dataclasses.replace(get_smoke("__ARCH__"), dtype="float32"),
        mesh=MeshConfig(shape=(2, 1, 1), axis_names=("pod", "data", "model"),
                        replica_axis="pod"),
        sync=SyncConfig(strategy="periodic", period=run["h"],
                        compression="int8"),
        optimizer=OptimizerConfig(**run["opt"]),
        data=DataConfig(seq_len=__SEQ__, global_batch=__ROWS__))
    model = build_model(cfg.model)
    for seed in __SEEDS__:
        rng = np.random.default_rng(seed)
        batch = {k: rng.integers(0, cfg.model.vocab_size,
                                 (run["h"], __ROWS__, __SEQ__)
                                 ).astype(np.int32)
                 for k in ("tokens", "targets")}
        tag = f"{name}/{seed}"
        dump(f"{tag}/batch", batch)
        with jax.set_mesh(mesh):
            state = LS.init_state(model, cfg, jax.random.key(seed),
                                  replicas=2)
            dump(f"{tag}/init", state)
            spec = lambda x: P("pod") if x.ndim else P()
            state = jax.tree.map(
                lambda x: jax.device_put(x, NamedSharding(mesh, spec(x))),
                state)
            state, _ = jax.jit(LS.make_local_sgd_block(model, cfg, mesh))(
                state, jax.tree.map(jnp.asarray, batch))
        dump(f"{tag}/x", state["sync"]["ef"])
        init = LS.init_state(model, cfg, jax.random.key(seed), replicas=2)
        rows = __ROWS__ // 2
        for r in range(2):
            mb = {k: jnp.asarray(v[0, r * rows:(r + 1) * rows])
                  for k, v in batch.items()}
            grad = jax.jit(jax.grad(lambda p: model.loss(p, mb)[0]))
            dump(f"{tag}/grad{r}",
                 grad(jax.tree.map(lambda x: x[r], init["params"])))
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
    path = tmp_path_factory.mktemp("int8_flips") / "reference.npz"
    code = (REFERENCE.replace("__RUNS__", json.dumps(RUNS))
            .replace("__ARCH__", ARCH).replace("__SEEDS__", repr(SEEDS))
            .replace("__ROWS__", str(ROWS)).replace("__SEQ__", str(SEQ))
            .replace("__OUT__", str(path)))
    assert "OK" in run_with_devices(code, n_devices=2, timeout=900)
    with np.load(path) as data:
        return {key: data[key] for key in data.files}


def _terms(model, params, batch):
    """Per leaf (dotted key): Σ_t |∇ℓ_t| / N over the N positions of
    ``batch``, ℓ_t the NLL of position t (the terms whose mean is the
    loss's gradient), from one forward and one batched backward."""
    import torch
    from repro_torch import sharding as S
    from repro_torch import tree as T
    view = T.map(lambda t: t.detach().requires_grad_(), params)
    flat, unflatten = T.flatten(view)
    table = (view["embed"]["embedding"] if model.cfg.tie_embeddings
             else view["out_embedding"])
    with torch.enable_grad():
        x = model.backbone(view, model._embed_inputs(view, batch))
        logits = (x @ table.T).float()
        nll = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]),
            batch["targets"].reshape(-1), reduction="none")
        n = nll.numel()
        per = torch.autograd.grad(nll, flat, grad_outputs=torch.eye(n),
                                  is_grads_batched=True)
    return {k: t.numpy() for k, t in S.flat_keys(
        unflatten([g.abs().sum(0) / n for g in per])).items()}, n


def _port(reference, name, seed):
    """The port's one-process K = 2 block of run ``name`` from the
    reference's state and batch: each leaf's (K, …) value handed to the
    quantizer at the sync; and per replica, on its rows of the first
    microbatch, its gradient at the start of the block, its terms'
    Σ|∇ℓ_t| / N (:func:`_terms`) and N, by dotted key."""
    import dataclasses

    import torch
    from repro_torch import interop
    from repro_torch import sharding as S
    from repro_torch import tree as T
    from repro_torch.config import (DataConfig, MeshConfig, OptimizerConfig,
                                    SyncConfig, TrainConfig, get_smoke)
    from repro_torch.core import compression as C
    from repro_torch.core import local_sgd as LS
    from repro_torch.models.registry import build_model
    run = RUNS[name]
    cfg = TrainConfig(
        model=dataclasses.replace(get_smoke(ARCH), dtype="float32"),
        mesh=MeshConfig(shape=(2,), axis_names=("pod",), replica_axis="pod"),
        sync=SyncConfig(strategy="periodic", period=run["h"],
                        compression="int8"),
        optimizer=OptimizerConfig(**run["opt"]),
        data=DataConfig(seq_len=SEQ, global_batch=ROWS))
    model = build_model(cfg.model, attn_impl="torch", ssd_impl="torch")
    state = interop.lm_train_state_from_jax(
        _subtree(reference, f"{name}/{seed}/init"), cfg)
    batch = {k: torch.as_tensor(v).long() for k, v in
             _subtree(reference, f"{name}/{seed}/batch").items()}
    per = ROWS // 2
    grads = []
    for r in (0, 1):
        params = T.map(lambda t: t[r], state["params"])
        rows = {k: v[0, r * per:(r + 1) * per] for k, v in batch.items()}
        g = S.flat_keys(LS.value_and_grad(model, params, rows)[2])
        grads.append(({k: t.numpy() for k, t in g.items()},
                      *_terms(model, params, rows)))
    seen, inner = [], C.compress_tree

    def capture(delta, ef, **kw):
        d, e = S.flat_keys(delta), S.flat_keys(ef)
        seen.append({k: (d[k].float() + e[k]).numpy().copy() for k in d})
        return inner(delta, ef, **kw)
    C.compress_tree = capture
    try:
        LS.make_local_sgd_block(model, cfg)(state, batch)
    finally:
        C.compress_tree = inner
    assert len(seen) == 1
    return seen[0], grads


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _compare(reference, name, seed):
    """Per replica and leaf: (key, r, the port's value, the reference's,
    the param at the block's start, the port's first gradient, the
    reference's, δ: N·2^-24 times the leaf's largest Σ|∇ℓ_t| / N)."""
    port, grads = _port(reference, name, seed)
    ref = _flatten(_subtree(reference, f"{name}/{seed}/x"))
    start = _flatten(_subtree(reference, f"{name}/{seed}/init/params"))
    assert sorted(ref) == sorted(port)
    for r in (0, 1):
        theirs = _flatten(_subtree(reference, f"{name}/{seed}/grad{r}"))
        mine, terms, n = grads[r]
        for key, w in ref.items():
            yield (key, r, port[key][r].astype(np.float64),
                   w[r].astype(np.float64),
                   start[key][r].astype(np.float64),
                   mine[key].astype(np.float64),
                   theirs[key].astype(np.float64),
                   n * 2.0 ** -24 * float(terms[key].max()))


def _ulp(x):
    """The f32 spacing at |x|."""
    return np.spacing(np.abs(x).astype(np.float32)).astype(np.float64)


def _check(reference, name, seed, bound):
    """Each leaf's gradient within δ of the reference's; every value's
    difference within ``bound(g, δ)`` (the update's change under a
    gradient difference δ, in units of lr) times lr, plus the f32 rounding
    of the update, of the param and of the delta. Returns (int8 values
    that flip, values)."""
    lr = RUNS[name]["opt"]["learning_rate"]
    flips = values = 0
    for key, r, x_g, x_w, p, g, g_ref, delta in _compare(reference, name,
                                                         seed):
        assert np.all(np.abs(g - g_ref) <= delta), (
            key, r, float(np.abs(g - g_ref).max() / delta))
        # the rounding: eight f32 ulps of a unit update, two of the sums
        slack = lr * (bound(g, delta) + 2.0 ** -20) \
            + 2 * _ulp(np.abs(p) + np.abs(x_g))
        over = np.abs(x_g - x_w) - slack
        assert np.all(over <= 0), (key, r, float(over.max() / lr))
        flips += int((_q(x_g) != _q(x_w)).sum())
        values += x_g.size
    return flips, values


def _q(x):
    """The quantizer's int8 values (the reference's per-tensor step)."""
    step = np.float32(max(np.abs(x).max(), np.float32(1e-12))) \
        / np.float32(127.0)
    return np.clip(np.round(x / step), -127, 127)


@pytest.mark.parametrize("seed", SEEDS)
def test_momentum_flips_are_rounding_at_half_a_step(reference, seed):
    """Momentum over two steps moves a param by lr·(1.9·g1 + g2): a
    gradient difference δ moves it by 2.9·lr·δ at most (the second step's
    gradient, at params that moved by lr·g1, taken within the first's δ).
    Every value is within that of the reference's, so an int8 value that
    differs sits within it of a .5 boundary: rounding carried it across."""
    flips, values = _check(reference, "momentum", seed,
                           lambda g, delta: 2.9 * delta)
    print(f"momentum seed {seed}: {flips} of {values} int8 values flip")


def _adamw_first(g, delta):
    """The largest change of AdamW's first update, g/(|g| + eps) an
    element, over gradients within δ of g: 2 where the sign can flip,
    else the slope eps/(|g| − δ + eps)² times δ."""
    eps = RUNS["adamw"]["opt"]["eps"]
    mag = np.abs(g)
    slope = eps / (np.maximum(mag - delta, 0.0) + eps) ** 2
    return np.where(mag <= delta, 2.0, np.minimum(2.0, slope * delta))


@pytest.mark.parametrize("seed", SEEDS)
def test_adamw_flips_are_its_normalization_of_last_bit_gradients(
        reference, seed):
    """AdamW's first update is lr·g/(|g| + eps) an element: a gradient
    element within δ of zero (a sum that cancels) is normalized to a
    sizable step, so a last-bit difference there moves a value by up to
    2·lr, where momentum's moves it by lr times that difference. Every
    value is within what a gradient difference of δ makes of that update,
    so an int8 value that differs sits within it of a .5 boundary: the
    flips are the optimizer's normalization of last-bit gradient
    differences, not the port's."""
    flips, values = _check(reference, "adamw", seed, _adamw_first)
    print(f"adamw seed {seed}: {flips} of {values} int8 values flip")
