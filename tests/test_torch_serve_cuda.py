"""The serving engine on a card: engines made with the default
``device="cuda"`` share one copy of the weights.

    PYTHONPATH=src python -m pytest -q tests/test_torch_serve_cuda.py

Without a card the test skips. It imports no JAX: on the card the engine
is held against itself (graphed against eager, bitwise tokens).
"""
import numpy as np
import pytest
import torch

from repro_torch.config import get_smoke
from repro_torch.launch.serve import ServeEngine


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the engine's default device is "
                    "the card")


def test_engines_on_the_default_card_share_one_copy_of_the_weights(card):
    """Engines made with the default ``device="cuda"`` take each other's
    params (held on ``cuda:0``) without a copy, as ``"cuda:0"`` does; the
    eager engine on the shared weights generates the graphed one's tokens;
    params of another dtype are refused."""
    cfg = get_smoke("phi3.5-moe-42b-a6.6b")
    first = ServeEngine(cfg, max_len=24)
    eager = ServeEngine(cfg, "cuda", max_len=24, graphs=False,
                        params=first.params)
    indexed = ServeEngine(cfg, "cuda:0", max_len=24, params=first.params)
    assert eager.params is first.params and indexed.params is first.params
    prompts = np.arange(1, 17, dtype=np.int32).reshape(2, 8)
    np.testing.assert_array_equal(eager.generate(prompts, 4),
                                  first.generate(prompts, 4))
    with pytest.raises(ValueError, match="float32"):
        ServeEngine(cfg, dtype=torch.float32, params=first.params)
