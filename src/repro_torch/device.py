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


def same_device(a: Union[str, torch.device],
                b: Union[str, torch.device]) -> bool:
    """Whether ``a`` and ``b`` name one device: a CUDA device given without
    an index (``"cuda"``) is the current card, as a tensor placed there
    reports it (``cuda:0``)."""
    def where(d):
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            return d.type, torch.cuda.current_device()
        return d.type, d.index
    return where(a) == where(b)


def wait(tree) -> None:
    """Wait for every card that holds a tensor of ``tree`` (a tensor, or a
    tree of them); nothing to wait for on the CPU. The port's
    ``jax.block_until_ready``, for host timers."""
    for dev in {x.device for x in T.leaves(tree)
                if isinstance(x, torch.Tensor) and x.is_cuda}:
        torch.cuda.synchronize(dev)
