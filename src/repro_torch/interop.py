"""Carry the reference's SVM state into the port.

``repro`` hands its state out as JAX arrays, which ``np.asarray`` turns into
numpy; :func:`svm_state_to_torch` turns that into the port's tensors on a
given device, keeping each dtype. The state is a model ``w`` or a DMS carry
dict (``repro.core.svm.dms_stepper_init``'s keys). This module imports no
JAX: the caller converts to numpy.
"""
from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

CARRY_KEYS = ("w", "pending", "sent", "mixbuf", "cnt")

State = Union[np.ndarray, Dict[str, np.ndarray]]


def svm_state_to_torch(state: State, device: Union[str, torch.device]
                       ) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
    """A model ``w`` (an array) or a DMS carry (a dict with keys among
    ``w``, ``pending``, ``sent``, ``mixbuf``, ``cnt``) as tensors on
    ``device``, dtypes kept. The tensors own their memory (no view of the
    caller's arrays). Raises ``KeyError`` on another key."""
    if isinstance(state, dict):
        unknown = sorted(set(state) - set(CARRY_KEYS))
        if unknown:
            raise KeyError(f"not a DMS carry key: {unknown}; "
                           f"known: {list(CARRY_KEYS)}")
        return {k: svm_state_to_torch(v, device) for k, v in state.items()}
    arr = np.asarray(state)
    return torch.tensor(arr, dtype=getattr(torch, arr.dtype.name),
                        device=device)
