"""Resumable data pipeline, the port of ``repro.data.pipeline``.

The pipeline owns an integer cursor (``state()`` / ``restore()``) and
produces batches deterministically from (seed, step) on the host with numpy,
byte-identical to the reference's, and places them on the pipeline's device
(``__next__``). Host sharding is index-based, as the reference's: given a
``mesh`` (:class:`repro_torch.launch.mesh.Mesh`) each process takes only
its slice of the global batch (:meth:`DataPipeline.process_slice`, the
mesh's rank and size in place of ``jax.process_index()`` /
``process_count()``); without one the slice is the whole batch.

The VLM and audio families take their stub frontends' inputs beside the
tokens, the reference's ``input_layout("train")``: ``patches`` (B, P, D)
and ``frames`` (B, n_audio_frames, D), zeros (as the reference's serving
CLI makes its stubs), sliced by rows with the tokens and placed in the
model's dtype. The reference's own pipeline yields tokens and targets
alone, so its trainer's CLI cannot train these families (ROADMAP §3).
"""
from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from repro_torch.config.base import DataConfig, ModelConfig
from repro_torch.data.synthetic import synthetic_lm_batch


def stub_inputs(model_cfg: ModelConfig, rows: int
                ) -> Dict[str, np.ndarray]:
    """The stub frontends' inputs of ``rows`` sequences, zeros: the VLM's
    ``patches`` (rows, P, D), the audio family's ``frames`` (rows, T, D);
    none for the other families. Float32 on the host (zeros in any float
    dtype); :meth:`DataPipeline.place` casts them to the model's."""
    d = model_cfg.d_model
    if model_cfg.family == "vlm":
        return {"patches": np.zeros((rows, model_cfg.num_image_tokens, d),
                                    np.float32)}
    if model_cfg.family == "audio":
        return {"frames": np.zeros((rows, model_cfg.n_audio_frames, d),
                                   np.float32)}
    return {}


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
        batch = synthetic_lm_batch(
            step,
            global_batch=self.cfg.global_batch,
            seq_len=self.cfg.seq_len,
            vocab_size=self.model_cfg.vocab_size,
            seed=self.cfg.seed,
        )
        batch.update(stub_inputs(self.model_cfg, self.cfg.global_batch))
        return batch

    def process_slice(self, batch: Dict[str, np.ndarray]
                      ) -> Dict[str, np.ndarray]:
        """The rows this process contributes: row block ``rank`` of
        ``size`` equal blocks of the global batch (the mesh's rank and
        size; the whole batch without a mesh). On a mesh with a ``model``
        axis the model ranks of a data row take the same rows: the block
        and the count are over the other axes (row-major)."""
        if self.mesh is None or self.mesh.size() == 1:
            return batch
        n_proc, index = 1, 0
        for axis in self.mesh.axes:
            if axis == "model":
                continue
            n_proc *= self.mesh.size(axis)
            index = index * self.mesh.size(axis) + self.mesh.rank(axis)
        b = self.cfg.global_batch
        if b % n_proc:
            raise ValueError(f"global batch {b} does not split over "
                             f"{n_proc} processes")
        per = b // n_proc
        lo = index * per
        return {k: v[lo:lo + per] for k, v in batch.items()}

    def next_host(self) -> Dict[str, np.ndarray]:
        """Advance the cursor and return the host (numpy) batch, this
        process's slice of it."""
        batch = self.process_slice(self._host_batch(self._step))
        self._step += 1
        return batch

    def place(self, batch: Dict[str, np.ndarray]
              ) -> Dict[str, torch.Tensor]:
        """A host batch on the pipeline's device: integer leaves as they
        are, float leaves (the stub inputs) in the model's dtype."""
        dtype = getattr(torch, self.model_cfg.dtype)
        return {k: torch.from_numpy(v).to(
                    self.device, dtype=dtype if v.dtype.kind == "f" else None)
                for k, v in batch.items()}

    def __next__(self) -> Dict[str, torch.Tensor]:
        return self.place(self.next_host())

    def __iter__(self):
        return self

    def peek_shapes(self) -> Dict[str, tuple]:
        b = self._host_batch(0)
        return {k: v.shape for k, v in b.items()}
