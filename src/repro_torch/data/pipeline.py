"""Resumable data pipeline, the port of ``repro.data.pipeline``.

The pipeline owns an integer cursor (``state()`` / ``restore()``) and
produces batches deterministically from (seed, step) on the host with numpy,
byte-identical to the reference's. One process holds the whole batch (the
reference's multi-host index slicing waits for ``torch.distributed``,
ROADMAP §1 item 9); ``__next__`` places it on the pipeline's device.
"""
from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from repro_torch.config.base import DataConfig, ModelConfig
from repro_torch.data.synthetic import synthetic_lm_batch


class DataPipeline:
    def __init__(self, data_cfg: DataConfig, model_cfg: ModelConfig,
                 device: Union[str, torch.device] = "cpu",
                 start_step: int = 0):
        self.cfg = data_cfg
        self.model_cfg = model_cfg
        self.device = torch.device(device)
        self._step = int(start_step)

    # -- checkpointable cursor ------------------------------------------------
    def state(self) -> Dict[str, int]:
        return {"step": self._step}

    def restore(self, state: Dict[str, int]) -> None:
        self._step = int(state["step"])

    # -- batch production -----------------------------------------------------
    def _host_batch(self, step: int) -> Dict[str, np.ndarray]:
        return synthetic_lm_batch(
            step,
            global_batch=self.cfg.global_batch,
            seq_len=self.cfg.seq_len,
            vocab_size=self.model_cfg.vocab_size,
            seed=self.cfg.seed,
        )

    def next_host(self) -> Dict[str, np.ndarray]:
        """Advance the cursor and return the host (numpy) batch."""
        batch = self._host_batch(self._step)
        self._step += 1
        return batch

    def __next__(self) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in self.next_host().items()}

    def __iter__(self):
        return self

    def peek_shapes(self) -> Dict[str, tuple]:
        b = self._host_batch(0)
        return {k: v.shape for k, v in b.items()}
