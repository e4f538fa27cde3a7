"""Resumable data pipeline, the port of ``repro.data.pipeline``.

The pipeline owns an integer cursor (``state()`` / ``restore()``) and
produces batches deterministically from (seed, step) on the host with numpy,
byte-identical to the reference's, and places them on the pipeline's device
(``__next__``). Host sharding is index-based, as the reference's: given a
``mesh`` (:class:`repro_torch.launch.mesh.Mesh`) each process takes only
its slice of the global batch (:meth:`DataPipeline.process_slice`, the
mesh's rank and size in place of ``jax.process_index()`` /
``process_count()``); without one the slice is the whole batch.
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
                 start_step: int = 0, mesh=None):
        self.cfg = data_cfg
        self.model_cfg = model_cfg
        self.device = torch.device(device)
        self._step = int(start_step)
        self.mesh = mesh

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

    def process_slice(self, batch: Dict[str, np.ndarray]
                      ) -> Dict[str, np.ndarray]:
        """The rows this process contributes: row block ``rank`` of
        ``size`` equal blocks of the global batch (the mesh's rank and
        size; the whole batch without a mesh)."""
        if self.mesh is None or self.mesh.size() == 1:
            return batch
        n_proc = self.mesh.size()
        b = self.cfg.global_batch
        if b % n_proc:
            raise ValueError(f"global batch {b} does not split over "
                             f"{n_proc} processes")
        per = b // n_proc
        lo = self.mesh.rank() * per
        return {k: v[lo:lo + per] for k, v in batch.items()}

    def next_host(self) -> Dict[str, np.ndarray]:
        """Advance the cursor and return the host (numpy) batch, this
        process's slice of it."""
        batch = self.process_slice(self._host_batch(self._step))
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
