"""Lightweight host-side timing telemetry for the sync schedule, the port of
``repro.core.telemetry`` (a copy: the port imports nothing of ``repro``).

The MSF auto-tuner (:mod:`repro_torch.core.autotune`) needs two numbers per
(model × replicas × fabric): ``T_step`` (compute time per optimizer step)
and ``T_sync`` (one executed sync). This module collects both from the
*running* trainer; the timers wrap the host-side step invocations and end
in ``torch.cuda.synchronize`` on the card, where the reference ends in
``jax.block_until_ready``:

* the SVM timed-step path (``svm.dms_timed_steps``) measures compute and
  sync separately → :meth:`BlockTelemetry.record_step_time` /
  :meth:`record_sync_time` feed the EMAs directly;
* the LM block path (``local_sgd.make_train_step``) sees whole-block wall
  times ``T(H) = H·T_step + T_sync`` → :meth:`record_block` keeps a per-H
  EMA and, once two distinct H's have been observed (the adaptive
  controller's H moves provide them), solves the two-parameter model by
  least squares on ``y = T_step + T_sync·(1/H)``. Where the block also
  times its sync (the port's local-SGD block does, with CUDA events around
  ``sync_point``), the split is exact from the first block.

The first sample of each kind is dropped (``warmup``) so a first call that
builds or loads a kernel never poisons the EMAs. All state is plain Python
floats — safe to read from the training loop at any block boundary.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple


class EMA:
    """Exponential moving average; ``None`` until the first update."""

    def __init__(self, decay: float = 0.8):
        self.decay = decay
        self.value: Optional[float] = None

    def update(self, x: float) -> float:
        self.value = (x if self.value is None
                      else self.decay * self.value + (1 - self.decay) * x)
        return self.value


class BlockTelemetry:
    """Measured ``T_step`` / ``T_sync`` estimates from the timed paths."""

    def __init__(self, decay: float = 0.8, warmup: int = 1):
        self._decay = decay
        self._step = EMA(decay)
        self._sync = EMA(decay)
        self._skip_step = warmup
        self._skip_sync = warmup
        self._skip_block = warmup
        self._block_by_h: Dict[int, EMA] = {}   # H → per-STEP wall-time EMA
        self._block_n_by_h: Dict[int, int] = {}  # H → recorded block count
        self.n_steps = 0
        self.n_syncs = 0
        self.n_blocks = 0

    # ------------------------------------------------------------ direct
    def record_step_time(self, seconds: float, steps: int = 1) -> None:
        """Measured compute-only time of ``steps`` optimizer steps."""
        if self._skip_step > 0:
            self._skip_step -= 1
            return
        self._step.update(seconds / max(1, steps))
        self.n_steps += steps

    def record_sync_time(self, seconds: float) -> None:
        """Measured time of one executed sync collective."""
        if self._skip_sync > 0:
            self._skip_sync -= 1
            return
        self._sync.update(seconds)
        self.n_syncs += 1

    # ----------------------------------------------------------- blocks
    def record_block(self, h: int, block_s: float,
                     sync_s: Optional[float] = None) -> None:
        """One whole sync block (H steps + boundary sync) of wall time.

        With a separately measured ``sync_s`` the split is exact; without
        it the (H, per-step time) pair feeds the least-squares separation.
        """
        if self._skip_block > 0:
            self._skip_block -= 1
            return
        self.n_blocks += 1
        h = max(1, int(h))
        self._block_n_by_h[h] = self._block_n_by_h.get(h, 0) + 1
        if sync_s is not None:
            self._sync.update(sync_s)
            self.n_syncs += 1
            self._step.update(max(block_s - sync_s, 0.0) / h)
            self.n_steps += h
            return
        self._block_by_h.setdefault(h, EMA(self._decay)).update(block_s / h)

    def _solve_blocks(self) -> Optional[Tuple[float, float]]:
        """Least squares of ``y = T_step + T_sync·x`` over x = 1/H."""
        pts = [(1.0 / h, e.value) for h, e in self._block_by_h.items()
               if e.value is not None]
        if len(pts) < 2:
            return None
        n = len(pts)
        sx = sum(x for x, _ in pts)
        sy = sum(y for _, y in pts)
        sxx = sum(x * x for x, _ in pts)
        sxy = sum(x * y for x, y in pts)
        den = n * sxx - sx * sx
        if abs(den) < 1e-18:
            return None
        t_sync = (n * sxy - sx * sy) / den
        t_step = (sy - t_sync * sx) / n
        return max(t_step, 0.0), max(t_sync, 0.0)

    # ---------------------------------------------------------- reading
    def estimates(self) -> Optional[Tuple[float, float]]:
        """(T_step, T_sync) in seconds, or None until enough data."""
        if self._step.value is not None and self._sync.value is not None:
            return self._step.value, self._sync.value
        return self._solve_blocks()

    def per_step_s(self) -> Optional[float]:
        """Crude per-step wall time when the split is underdetermined:
        the direct T_step EMA if one exists, else the mean of the per-H
        block EMAs (sync amortized in — an upper bound on T_step)."""
        if self._step.value is not None:
            return self._step.value
        vals = [e.value for e in self._block_by_h.values()
                if e.value is not None]
        return sum(vals) / len(vals) if vals else None

    def per_rung(self) -> Dict[int, dict]:
        """Per-H block stats — the H-ladder runtime's rung telemetry.

        ``per_step_s`` is the rung's whole-block wall time divided by H
        (sync amortized in); ``blocks`` how many blocks ran at that rung.
        Rungs observed only through the direct (separately timed) path
        report counts without a per-step EMA.
        """
        out: Dict[int, dict] = {}
        for h in sorted(self._block_n_by_h):
            ema = self._block_by_h.get(h)
            out[h] = {
                "per_step_s": ema.value if ema is not None else None,
                "blocks": self._block_n_by_h[h],
            }
        return out

    def to_dict(self) -> dict:
        est = self.estimates()
        return {
            "t_step_s": est[0] if est else None,
            "t_sync_s": est[1] if est else None,
            "n_steps": self.n_steps,
            "n_syncs": self.n_syncs,
            "n_blocks": self.n_blocks,
            "per_rung": {str(h): r for h, r in self.per_rung().items()},
        }
