"""Where the port's entry points run: on the card unless asked otherwise."""
from __future__ import annotations

from typing import Union

import torch

from repro_torch import tree as T


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a :class:`torch.device`; raises for CUDA without a card
    rather than running on the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev


def wait(tree) -> None:
    """Wait for every card that holds a tensor of ``tree`` (a tensor, or a
    tree of them); nothing to wait for on the CPU. The port's
    ``jax.block_until_ready``, for host timers."""
    for dev in {x.device for x in T.leaves(tree)
                if isinstance(x, torch.Tensor) and x.is_cuda}:
        torch.cuda.synchronize(dev)
