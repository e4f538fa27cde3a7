"""repro_torch.sharding against repro.sharding: the reference's spec cases,
the spec property, and tree_specs over the full-width params of every arch
on the reference's 16×16 and 2×16×16 meshes."""
import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

try:
    from hypothesis import given, settings, strategies as st
except ImportError:   # optional dev dep: property tests skip
    from conftest import given, settings, st

from repro.config import MeshConfig as JMeshConfig
from repro.config import get_arch as jget_arch
from repro.config import list_archs
from repro.models import layers as JL
from repro.models.registry import build_model as jbuild
from repro import sharding as JS

from repro_torch import sharding as S
from repro_torch.config import MeshConfig, get_arch
from repro_torch.models import layers as TL
from repro_torch.models.registry import build_model as tbuild


class FakeMesh:
    """axis_names/devices.shape stand-in (no real devices needed), as
    ``tests/test_sharding.py`` builds one."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.zeros(shape)


MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _rules(shape=(16, 16), names=("data", "model"), pkg=S, cfg_cls=MeshConfig):
    cfg = cfg_cls(shape=shape, axis_names=names,
                  replica_axis="pod" if "pod" in names else "")
    return pkg.rules_for(cfg, FakeMesh(shape, names))


def _pad(spec, n):
    t = tuple(spec)
    return t + (None,) * (n - len(t))


class TestSpecFor:
    """tests/test_sharding.py::TestSpecFor's cases, on the port."""

    def test_basic_mapping(self):
        spec = _pad(_rules().spec_for(("batch", "seq", "embed"),
                                      (256, 4096, 1024)), 3)
        assert spec == ("data", None, None)

    def test_divisibility_fallback(self):
        r = _rules()
        spec = _pad(r.spec_for(("layers", "embed", "heads", "head_dim"),
                               (32, 960, 15, 64)), 4)
        assert spec[2] is None
        spec = _pad(r.spec_for(("layers", "embed", "heads", "head_dim"),
                               (32, 960, 32, 64)), 4)
        assert spec[2] == "model"

    def test_axis_used_once(self):
        spec = _rules().spec_for(("batch", "kv_heads", "q_group"),
                                 (16, 32, 16))
        flat = []
        for e in spec:
            if e is not None:
                flat.extend(e if isinstance(e, tuple) else (e,))
        assert len(flat) == len(set(flat))

    def test_gqa_preference_order(self):
        spec = _rules().spec_for(("batch", "kv_heads", "q_group", "seq"),
                                 (16, 4, 16, 512))
        assert spec[1] is None and spec[2] == "model"

    def test_tokens_two_axis_sharding(self):
        spec = _rules().spec_for(("tokens", None), (1048576, 4096))
        assert spec[0] == ("data", "model")

    def test_missing_axis_dropped_on_single_pod(self):
        assert _rules().spec_for(("replica", "embed"), (2, 1024)) == (
            None, "data")

    def test_multi_pod_replica(self):
        r = _rules((2, 16, 16), ("pod", "data", "model"))
        assert r.spec_for(("replica", "embed"), (2, 1024)) == ("pod", "data")

    def test_rules_and_strip_match_reference(self):
        for shape, names in MESHES.values():
            t = _rules(shape, names)
            j = _rules(shape, names, JS, JMeshConfig)
            assert t.rules == j.rules
            assert S.strip_axes(t, ("model",)).rules == JS.strip_axes(
                j, ("model",)).rules
        assert S.DEFAULT_RULES == JS.DEFAULT_RULES

    def test_shard_shape(self):
        r = _rules((2, 16, 16), ("pod", "data", "model"))
        spec = r.spec_for(("tokens", "embed", "heads"), (4096, 960, 32))
        assert r.shard_shape(spec, (4096, 960, 32)) == (16, 960, 32)
        spec = r.spec_for(("replica", "batch", "heads"), (2, 64, 32))
        assert r.shard_shape(spec, (2, 64, 32)) == (1, 4, 2)
        assert r.shard_shape((), (3, 5)) == (3, 5)
        with pytest.raises(ValueError):
            r.shard_shape(("data",), (15,))


@settings(deadline=None, max_examples=100)
@given(
    logical=st.lists(st.sampled_from(list(S.DEFAULT_RULES) + [None]),
                     min_size=1, max_size=5),
    dims=st.lists(st.sampled_from([1, 2, 3, 15, 16, 30, 32, 256]),
                  min_size=5, max_size=5),
)
def test_spec_equals_reference(logical, dims):
    """Any (logical axes × shape): the port's spec is the reference's, on
    both meshes."""
    shape = tuple(dims[:len(logical)])
    for mshape, names in MESHES.values():
        got = _rules(mshape, names).spec_for(tuple(logical), shape)
        want = _rules(mshape, names, JS, JMeshConfig).spec_for(
            tuple(logical), shape)
        assert isinstance(got, tuple) and got == tuple(want)


def _flat_ref(specs, n_layers, stacks):
    """Dotted key → spec of the reference's tree, each stacked leaf split
    into per-layer keys with its leading ``layers`` entry dropped."""
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, P))[0]:
        keys = [e.key for e in path]
        if keys[0] in stacks:
            for i in range(n_layers[keys[0]]):
                out[".".join([keys[0], str(i)] + keys[1:])] = tuple(spec)[1:]
        else:
            out[".".join(keys)] = tuple(spec)
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, tuple):
        return {prefix[:-1]: tree}
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}."))
    return out


@pytest.mark.parametrize("arch", list_archs())
def test_tree_specs_match_reference(arch):
    jcfg, tcfg = jget_arch(arch), get_arch(arch)
    jdefs, tdefs = jbuild(jcfg).param_defs(), tbuild(tcfg).param_defs()
    n_layers = {k: len(v) for k, v in tdefs.items() if k in TL.STACKS}
    for mshape, names in MESHES.values():
        jr = _rules(mshape, names, JS, JMeshConfig)
        tr = _rules(mshape, names)
        want = _flat_ref(JS.tree_specs(JL.axes_of(jdefs), JL.shapes_of(jdefs),
                                       jr), n_layers, TL.STACKS)
        specs = S.tree_specs(TL.axes_of(tdefs), TL.shapes_of(tdefs), tr)
        got = _flat(specs)
        assert got.keys() == want.keys()
        shapes = _flat(TL.shapes_of(tdefs))
        for key, spec in got.items():
            n = len(shapes[key])
            assert _pad(spec, n) == _pad(want[key], n), (arch, key)
            tr.shard_shape(spec, shapes[key])     # every spec divides
