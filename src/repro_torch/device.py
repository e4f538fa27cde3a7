"""Where the port's entry points run: on the card unless asked otherwise."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a :class:`torch.device`; raises for CUDA without a card
    rather than running on the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return dev
