"""H-ladder runtime: mid-run adaptive MSF with no kernel builds after warmup.
The port of ``repro.runtime.ladder``.

The reference AOT-compiles one jitted train block per rung of the period
ladder ``SyncConfig.ladder_rungs()``, so that a mid-run move of H never
recompiles. The port has no XLA: its train block is eager, and both the
block (the loop over microbatches runs over the batch's leading dim) and
the state layout are H-independent, so every rung is the same step. What is
left of a compile is a kernel library being built by nvcc or loaded at its
first use (:mod:`repro_torch.kernels.nvcc`). So:

* :func:`compile_rungs` warms the ladder: every kernel the step reaches is
  built and loaded once, and each rung is the step behind a guard that
  raises on a batch of any other shape (as a compiled executable refuses a
  foreign shape rather than recompiling).
* :class:`LadderRuntime` holds the rungs, the switch transform
  (:func:`repro_torch.core.local_sgd.ladder_switch_state`: flush the sync
  state to the fully synchronized model and restart the schedule counters)
  and the :class:`repro_torch.core.autotune.AdaptiveController` in ladder
  mode. A controller move is one switch call at the sync boundary and
  another rung; the driver re-blocks the data pipeline at the new H. The
  switch is exact: bit-identical to launching fresh at the new H from the
  flushed model.
* :class:`CompileCounter` counts nvcc's build and load calls; after the
  ladder's warmup the whole adaptive run (blocks, switches, checkpoints)
  must add none.

The rungs stay eager: a rung as one CUDA graph per H is ROADMAP §1 item 19.
The runtime is host-driven and knows nothing about the model, only about
(state, batch) callables; the SVM path gets the same treatment from
:func:`repro_torch.core.svm.dms_block_ladder`.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import torch

from repro_torch import tree as T
from repro_torch.kernels import nvcc


class CompileCounter:
    """Counts the port's compile events: the calls of
    :func:`repro_torch.kernels.nvcc.build` and :func:`~repro_torch.kernels
    .nvcc.load` (a kernel library built or loaded at its first use) since
    the counter was made, read from the process's tally
    :data:`repro_torch.kernels.nvcc.EVENTS`.

    ``mark()`` snapshots the tally after ladder warmup; ``since_mark`` is
    the number the adaptive run asserts to be zero.
    """

    def __init__(self):
        self.start = self.marked = nvcc.EVENTS

    @property
    def count(self) -> int:
        return nvcc.EVENTS - self.start

    def mark(self) -> None:
        self.marked = nvcc.EVENTS

    @property
    def since_mark(self) -> int:
        return nvcc.EVENTS - self.marked


def warm_kernels(kernels: Iterable[Callable[[], object]]) -> None:
    """Build and load each kernel library (``kernels`` are the wrappers'
    ``load_library`` functions, which cache what they load)."""
    for load in kernels:
        load()


def _shape(x) -> Tuple[int, ...]:
    return tuple(int(n) for n in x.shape)


def compile_rungs(step_fn: Callable, sample_batch, rungs, *,
                  kernels: Iterable[Callable[[], object]] = ()
                  ) -> Dict[int, Callable]:
    """Warm the ladder and return ``{H: rung}``.

    ``kernels`` are the loaders of the kernel libraries ``step_fn`` reaches
    (none on the CPU, where the wrappers take the plain versions); each is
    built and loaded here. ``sample_batch`` is ONE microbatch (numpy or
    tensor leaves); rung H takes batch leaves ``(H,) + leaf.shape`` and
    raises ``ValueError`` on any other shape.
    """
    warm_kernels(kernels)
    shapes = {k: _shape(v) for k, v in sample_batch.items()}
    out: Dict[int, Callable] = {}
    for h in sorted(set(int(r) for r in rungs)):
        out[h] = _guarded(step_fn, h, shapes)
    return out


def _guarded(step_fn: Callable, h: int, shapes) -> Callable:
    want = {k: (h,) + s for k, s in shapes.items()}

    def rung(state, batch):
        got = {k: _shape(v) for k, v in batch.items()}
        if got != want:
            raise ValueError(f"rung H={h} takes a batch of {want}; got {got}")
        return step_fn(state, batch)
    return rung


class LadderRuntime:
    """The H ladder + adaptive controller, driven per block.

    The step runner calls :attr:`step_fn` for each block and
    :meth:`on_block` after it; a controller rung move applies the switch
    and the runner re-blocks the data pipeline (:attr:`h` is the current
    rung). ``trajectory`` records every ``(block, H)`` transition,
    including the start. ``device`` is where the rungs' state lives
    (:meth:`place`).
    """

    def __init__(self, rungs: Dict[int, Callable], switch_fn: Callable,
                 controller, telemetry=None,
                 device: Union[str, torch.device, None] = None,
                 compile_counter: Optional[CompileCounter] = None):
        if controller.h not in rungs:
            raise ValueError(
                f"controller start rung {controller.h} not in compiled "
                f"ladder {sorted(rungs)}")
        self.rungs = dict(rungs)
        self.switch_fn = switch_fn
        self.controller = controller
        self.telemetry = telemetry
        self.device = None if device is None else torch.device(device)
        self.compile_counter = compile_counter
        self.blocks = 0
        self.switches = 0
        self.trajectory: List[Tuple[int, int]] = [(0, controller.h)]

    @property
    def h(self) -> int:
        return self.controller.h

    @property
    def step_fn(self) -> Callable:
        return self.rungs[self.h]

    def on_block(self, state):
        """One executed block: feed the controller, maybe switch rungs.

        Returns ``(state, switched)``; on a switch the state has been
        flushed and re-seeded by the switch transform and the caller must
        re-block its data pipeline at the new :attr:`h`.
        """
        self.blocks += 1
        h_prev = self.controller.h
        # the timing already landed in the shared telemetry through the
        # timed rungs; this only advances the re-solve cadence
        self.controller.observe_block()
        if self.controller.h != h_prev:
            state = self.switch_fn(state)
            self.switches += 1
            self.trajectory.append((self.blocks, self.controller.h))
            return state, True
        return state, False

    # ------------------------------------------------------- checkpointing
    def checkpoint_state(self) -> dict:
        """The rung a checkpoint must restore (the controller's telemetry is
        not persisted: it re-warms within adapt_every blocks)."""
        return {"h": self.h, "blocks": self.blocks}

    def restore(self, ck: dict) -> None:
        """Go back to a checkpointed rung. The block count rewinds to the
        checkpoint's, the controller's with it, so that the replayed blocks
        meet the controller's cadence as the run being resumed did."""
        h = int(ck["h"])
        if h not in self.rungs:
            raise ValueError(
                f"checkpointed rung {h} not in compiled ladder "
                f"{sorted(self.rungs)}")
        self.blocks = int(ck.get("blocks", self.blocks))
        if hasattr(self.controller, "_blocks"):
            self.controller._blocks = self.blocks
        if h != self.controller.h:
            self.controller.h = h
            self.controller.history.append((self.blocks, h))
            self.trajectory.append((self.blocks, h))

    def place(self, state):
        """Move restored (host) state onto the rungs' device."""
        if self.device is None:
            return state
        return T.map(lambda x: x.to(self.device)
                     if isinstance(x, torch.Tensor) else x, state)

    def to_dict(self) -> dict:
        out = {
            "ladder": sorted(self.rungs),
            "h": self.h,
            "blocks": self.blocks,
            "switches": self.switches,
            "h_trajectory": [list(t) for t in self.trajectory],
        }
        if self.compile_counter is not None:
            out["compiles_total"] = self.compile_counter.count
            out["compiles_after_warmup"] = self.compile_counter.since_mark
        if self.telemetry is not None:
            out["telemetry"] = self.telemetry.to_dict()
        return out
