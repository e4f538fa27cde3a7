"""The work of a hand-written kernel's call, and the hook through which a
counter records it.

A ctypes launch is invisible to a ``TorchDispatchMode``, so each wrapper
(``kernels/*/ops.py``) states its call's work from the shapes: the
operations it must do, by the type they run in, and the bytes it must move
(each input read once, each output written once). The operations are kept
by the unit that runs them, which sets the rate they are priced at
(:func:`repro_torch.launch.roofline.compute_s`): a dtype's name, or
``"tf32"`` for float32 products on the TF32 tensor cores. The same formulas
give ``chip_smoke.py``'s bounds. While a counter is active
(:class:`repro_torch.launch.roofline.WorkCounter`), a wrapper's body runs
inside :func:`call`: the counter records the work once and counts none of
the tensor ops run within (the plain version on the CPU, the output's
allocation on the card), so a kernel's work reads the same whatever
implements it. On the meta device, and only under a counter, the wrapper
returns empty outputs of the right shapes; outside one a meta input raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List

import torch

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class Work:
    name: str                  # the wrapper: hinge_block_grad, flash_attention, …
    flops: Dict[str, float]    # operations by the unit that runs them
    bytes: float               # inputs read once, outputs written once


# the counters recording now, innermost last (each pushes itself on entry)
COUNTERS: List = []


# what call() returns with no counter active: enters as False, does nothing
_UNCOUNTED = contextlib.nullcontext(False)


def call(work: Callable[..., Work], *args):
    """A context around a wrapper's body. With a counter active it records
    ``work(*args)`` once and counts no op run inside, and enters as True;
    with none it is a shared context that does nothing and enters as False
    (``work`` is not called)."""
    if not COUNTERS:
        return _UNCOUNTED
    return COUNTERS[-1].kernel(work(*args))


def on_meta(counted: bool, what: str) -> None:
    """Refuse meta inputs outside a counter: no path runs a kernel there."""
    if not counted:
        raise ValueError(f"{what}: meta tensors run only under a work "
                         f"counter (repro_torch.launch.roofline.WorkCounter)")


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")
