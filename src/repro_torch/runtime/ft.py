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
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List

import torch

from repro_torch import tree as T
from repro_torch.config.base import FaultToleranceConfig
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
    no checkpoints.
    """

    def __init__(self, step_fn: Callable, ckpt_manager,
                 fault_cfg: FaultToleranceConfig, ckpt_interval: int,
                 make_pipeline: Callable[[int], Any], fingerprint: str = "",
                 ladder=None):
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
                try:
                    self.injector.before_step(step)
                    t0 = time.perf_counter()
                    state, metrics = step_fn(state, batch)
                except SimulatedFault:
                    self.restarts += 1
                    if self.restarts > self.cfg.max_restarts:
                        raise
                    state, step, pipeline = self._restore(state)
                    continue
                wait(metrics)
                elapsed = time.perf_counter() - t0
                straggled = self.watchdog.check(step, elapsed)
                self.metrics_log.append(
                    {"step": step, "elapsed": elapsed, "straggled": straggled,
                     **{k: float(v) for k, v in metrics.items()}})
                step += 1
                state, pipeline = self._after_block(state, step, pipeline)
        finally:
            self._start = None
        return state, step

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
        latest = self.ckpt.latest_step()
        state, extra = self.ckpt.restore(
            like_state, expected_fingerprint=self.fingerprint)
        cursor = int(extra.get("data", {}).get("step", latest))
        if self.ladder is not None:
            if "ladder" in extra:
                self.ladder.restore(extra["ladder"])
            state = self.ladder.place(state)
        return state, latest, self.make_pipeline(cursor)
