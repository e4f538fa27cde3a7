"""The port's examples (``examples/torch_*.py``) at their small sizes with
``--device cpu``: each runs to its end and prints its result; each imports
``repro_torch`` and nothing of ``repro``."""
import ast
import importlib.util
import pathlib

import pytest

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
RUNS = {
    "torch_quickstart": (["--device", "cpu", "--n", "1200", "--epochs", "2"],
                         "paper's conclusion"),
    "torch_svm_paper_repro": (["--device", "cpu", "--quick", "--n", "600",
                               "--epochs", "1"], "block=512"),
    "torch_lm_local_sgd": (["--device", "cpu", "--blocks", "1"],
                           "sync bytes/step"),
    "torch_serve_batched": (["--device", "cpu", "--requests", "2",
                             "--gen-tokens", "3"], "req1:"),
}


def _load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_runs_on_the_cpu(name, capsys):
    argv, expect = RUNS[name]
    _load(name).main(argv)
    out = capsys.readouterr().out
    assert expect in out, out


@pytest.mark.parametrize("name", sorted(RUNS))
def test_example_imports_only_the_port(name):
    tree = ast.parse((EXAMPLES / f"{name}.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module.split(".")[0])
    assert "repro_torch" in mods
    assert not mods & {"repro", "jax", "jaxlib"}, mods


def test_example_default_device_is_the_card(monkeypatch):
    """Without ``--device`` an example asks for the card, and raises where
    there is none (as on this machine when CUDA is absent)."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _load("torch_quickstart").main(["--n", "600"])
