"""Fault-tolerant step runner, the port of ``repro.runtime.ft``.

* :class:`StragglerWatchdog` — per-step deadline timer: records a step that
  took longer than the deadline.
* :class:`FaultInjector` — deterministic failure/straggle injection for
  tests (``inject_failure_at`` step raises :class:`SimulatedFault` once).
* :class:`StepRunner` — drives ``step_fn`` with checkpoint/restart: on a
  fault it restores the latest checkpoint (params/opt/sync, the data
  cursor, the ladder's rung) and replays. ``max_restarts`` bounds the
  retry loop. Batches are deterministic in (seed, step), so the replay is
  bitwise the run that never failed.

A checkpoint is taken after the ladder has seen the block, so it holds the
state, the rung and the block count that the next block starts from (a
controller move that falls on a checkpoint step is in it).

Before the run's first checkpoint a restart goes back to the state the run
started from, never to a checkpoint another run left in the directory. The
port's trainer step updates its input's optimizer moments in place (as the
reference's jitted trainer donates its state), so that state has moved on by
then: the runner keeps its own copy of it on the host, and of the ladder's
rung, until its first checkpoint (only when ``max_restarts > 0``). With no
checkpoint manager (``ckpt_manager=None``) nothing is written, and every
restart goes back to that copy.

Across ranks (``mesh=``, each rank one replica of the state, its collectives
over the mesh) a fault on one rank restarts every rank. Before each step
every rank runs its injector, catches its :class:`SimulatedFault` into a
flag, and the flags go through one all-reduce
(:func:`repro_torch.core.collectives.agree`, which also checks that the
ranks are at the same step): if any rank faulted, every rank restores, and
none enters the step's collectives alone. So ``restarts`` is the same on
every rank, and passing ``max_restarts`` raises on every rank. After the
run's first checkpoint every rank restores rank 0's file (the manager's
gather and scatter, ``CheckpointManager(mesh=)``); before it, each rank goes
back to its own host copy of its replica. The watchdog judges each step by
its elapsed time's max over the ranks (a step waits for its slowest rank),
so every rank records the same stragglers. A rank's clock starts before the
flag's all-reduce: a rank held up before the step is the others' wait there.

An exception raised inside ``step_fn`` is not agreed, a
:class:`SimulatedFault` included (the other ranks are in the step's
collectives and cannot hear of it): with a mesh it propagates, and the
launcher stops the other ranks (:func:`repro_torch.launch.mesh.spawn`), as
the reference re-raises anything that is not a ``SimulatedFault``. On one
process a ``SimulatedFault`` from ``step_fn`` restores as an injected one
does.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List

import torch

from repro_torch import tree as T
from repro_torch.config.base import FaultToleranceConfig
from repro_torch.core import collectives as CL
from repro_torch.device import wait


class SimulatedFault(RuntimeError):
    pass


class StragglerWatchdog:
    def __init__(self, deadline_sec: float):
        self.deadline = deadline_sec
        self.events: List[Dict[str, Any]] = []

    def check(self, step: int, elapsed: float) -> bool:
        """Record and report whether the step straggled."""
        if self.deadline and elapsed > self.deadline:
            self.events.append({"step": step, "elapsed": elapsed})
            return True
        return False


class FaultInjector:
    def __init__(self, cfg: FaultToleranceConfig):
        self.cfg = cfg
        self._fired = False

    def before_step(self, step: int) -> None:
        if self.cfg.inject_straggle_sec and \
                step == max(0, self.cfg.inject_failure_at - 1):
            time.sleep(self.cfg.inject_straggle_sec)
        if step == self.cfg.inject_failure_at and not self._fired:
            self._fired = True          # fail exactly once, then recover
            raise SimulatedFault(f"injected fault at step {step}")


def _to_host(tree):
    return T.map(lambda x: x.detach().to("cpu", copy=True)
                 if isinstance(x, torch.Tensor) else x, tree)


def _take(state: dict) -> dict:
    """A new dict of ``state``'s items, ``state`` emptied."""
    taken = dict(state)
    state.clear()
    return taken


def _place_like(host, like):
    """A copy of ``host``'s tensors on the devices of ``like``'s (the kept
    copy stays as it is)."""
    return T.map(lambda h, x: h.to(x.device, copy=True)
                 if isinstance(h, torch.Tensor) else h, host, like)


class StepRunner:
    """Checkpoint/restart training driver.

    ``step_fn(state, batch) -> (state, metrics)``; it may update the state
    it is given in place. ``make_pipeline(start_step) -> iterator`` rebuilds
    the data pipeline at a cursor — the restore path uses it to resume data
    exactly where the checkpoint was taken. ``ckpt_manager`` may be None:
    no checkpoints. With a ``mesh`` (see the module docstring) every rank
    runs a runner over its replica, its ``ckpt_manager`` made with the same
    mesh; ``fault_cfg`` may differ between ranks in what it injects only.
    """

    def __init__(self, step_fn: Callable, ckpt_manager,
                 fault_cfg: FaultToleranceConfig, ckpt_interval: int,
                 make_pipeline: Callable[[int], Any], fingerprint: str = "",
                 ladder=None, mesh=None):
        self.step_fn = step_fn
        self.ckpt = ckpt_manager
        self.cfg = fault_cfg
        self.interval = max(1, ckpt_interval)
        self.make_pipeline = make_pipeline
        self.fingerprint = fingerprint
        # optional H-ladder runtime (repro_torch.runtime.ladder
        # .LadderRuntime): each step is then one sync block run by the
        # ladder's current rung; after the block the controller may switch
        # rungs, and the (flushed) state continues under the new rung with
        # the data pipeline re-blocked at the new H from its cursor
        self.ladder = ladder
        self.mesh = mesh
        self.watchdog = StragglerWatchdog(fault_cfg.step_deadline_sec)
        self.injector = FaultInjector(fault_cfg)
        self.restarts = 0
        self.metrics_log: List[Dict[str, Any]] = []
        self._start = None

    def run(self, state, start_step: int, num_steps: int):
        """Run ``num_steps`` steps from ``state`` (a dict) at data step
        ``start_step``; returns (final state, step reached).

        The runner takes the state over, as the reference's jitted step
        takes a donated state: the dict given is emptied, so that no
        reference the caller still holds keeps the start state's tensors
        alive after the first block has replaced them. Only the current
        state is held between steps."""
        state = _take(state)
        step = start_step
        pipeline = self.make_pipeline(step)
        end = start_step + num_steps
        self._start = None
        if self.cfg.max_restarts > 0:
            self._start = (_to_host(state), start_step,
                           self.ladder.checkpoint_state()
                           if self.ladder is not None else None)
        try:
            while step < end:
                try:
                    batch = next(pipeline)
                except StopIteration:
                    break
                step_fn = (self.ladder.step_fn if self.ladder is not None
                           else self.step_fn)
                t0 = None
                try:
                    t0 = self._before_step(step)
                    state, metrics = step_fn(state, batch)
                except SimulatedFault:
                    if self.mesh is not None and t0 is not None:
                        raise       # raised inside the step: not agreed
                    self.restarts += 1
                    if self.restarts > self.cfg.max_restarts:
                        raise
                    state, step, pipeline = self._restore(state)
                    continue
                wait(metrics)
                elapsed = time.perf_counter() - t0
                if self.mesh is not None:
                    (elapsed,) = CL.max_over([elapsed])
                straggled = self.watchdog.check(step, elapsed)
                self.metrics_log.append(
                    {"step": step, "elapsed": elapsed, "straggled": straggled,
                     **{k: float(v) for k, v in metrics.items()}})
                step += 1
                state, pipeline = self._after_block(state, step, pipeline)
        finally:
            self._start = None
        return state, step

    def _before_step(self, step: int) -> float:
        """The injector before ``step``, then the step's start on this
        rank's clock; with a mesh the ranks agree on the step and on
        whether any of them faulted. Raises the fault (with a mesh, on every
        rank if any faulted)."""
        fault = None
        try:
            self.injector.before_step(step)
        except SimulatedFault as exc:
            fault = exc
        t0 = time.perf_counter()
        if self.mesh is not None:
            (faulted,) = CL.agree({"step": step},
                                  maxes=[float(fault is not None)])
            if faulted and fault is None:
                fault = SimulatedFault(f"a fault on another rank before "
                                       f"step {step}")
        if fault is not None:
            raise fault
        return t0

    def _after_block(self, state, step: int, pipeline):
        """The ladder's move, then the checkpoint: a move that falls on a
        checkpoint step is in it."""
        if self.ladder is not None:
            state, switched = self.ladder.on_block(state)
            if switched:
                # same microbatch stream, re-blocked at the new H
                pipeline = self.make_pipeline(pipeline.state()["step"])
        if self.ckpt is not None and step % self.interval == 0:
            extra = {"data": pipeline.state()}
            if self.ladder is not None:
                extra["ladder"] = self.ladder.checkpoint_state()
            self.ckpt.save(step, state, extra=extra,
                           fingerprint=self.fingerprint)
            self._start = None      # a restart now restores this
        return state, pipeline

    def _restore(self, like_state):
        if self._start is not None:
            # no checkpoint of this run yet: back to the state, step and
            # rung the run started from
            host, start, ladder_ck = self._start
            if ladder_ck is not None:
                self.ladder.restore(ladder_ck)
            return (_place_like(host, like_state), start,
                    self.make_pipeline(start))
        self.ckpt.wait()
        if self.mesh is not None:
            self.ckpt.barrier()    # rank 0's file is whole for every rank
        latest = self.ckpt.latest_step()
        state, extra = self.ckpt.restore(
            like_state, expected_fingerprint=self.fingerprint)
        cursor = int(extra.get("data", {}).get("step", latest))
        if self.ladder is not None:
            if "ladder" in extra:
                self.ladder.restore(extra["ladder"])
            state = self.ladder.place(state)
        return state, latest, self.make_pipeline(cursor)
