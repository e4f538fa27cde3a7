"""Atomic, keep-k checkpointing of the port's state trees (nested dicts and
lists of tensors, :mod:`repro_torch.tree`), the port of
``repro.checkpoint.manager`` with the same on-disk layout::

    <dir>/step_000000123/       # one directory per step
        manifest.json           # leaf paths, shapes, dtypes, fingerprint
        arrays.npz              # all leaves, keyed by their path
    <dir>/LATEST                # text file: "step_000000123"

Atomicity: write into ``<dir>/.tmp_step_x``, fsync, then ``os.rename`` —
rename is atomic on POSIX, so a crash mid-write never corrupts LATEST. Every
leaf is copied to the host before the write (on the card, a device-to-host
copy). numpy has no bfloat16, so a bf16 leaf is stored as its uint16 bits
with its dtype in the manifest and restored bitwise; a Python number leaf
(the trainer's ``step``) comes back as a Python number. The directory is
made at the first save.

``async_write=True`` moves serialization and IO to a daemon thread;
``wait()`` joins outstanding writes (called before restore and at exit).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.config.base import CheckpointConfig


def _paths(tree, prefix: str = "") -> List[str]:
    """The leaves' paths in leaf order: dict keys and list indices joined
    by "/" (the reference's keys for the same tree)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{prefix}/{k}" if prefix else k)]
    if isinstance(tree, (list, tuple)):
        return [p for i, t in enumerate(tree)
                for p in _paths(t, f"{prefix}/{i}" if prefix else str(i))]
    return [prefix]


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return type(x).__name__ if isinstance(x, (bool, int, float)) \
        else str(np.asarray(x).dtype)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    return np.asarray(x)


def _from_numpy(arr: np.ndarray, dtype: str, like, device):
    if not isinstance(like, torch.Tensor):
        return type(like)(arr.item()) if isinstance(
            like, (bool, int, float)) else arr
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    return t.to(like.device if device is None else device)


class CheckpointManager:
    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg
        self.directory = cfg.directory
        self._lock = threading.Lock()
        self._pending: List[threading.Thread] = []

    # ------------------------------------------------------------------ save
    def save(self, step: int, state, extra: Optional[Dict[str, Any]] = None,
             fingerprint: str = "") -> None:
        # copy to the host *before* any thread handoff so the caller can
        # keep changing device state
        leaves = [(k, _to_numpy(v), _dtype_name(v))
                  for k, v in zip(_paths(state), T.leaves(state))]
        if self.cfg.async_write:
            t = threading.Thread(
                target=self._write, args=(step, leaves, extra, fingerprint),
                daemon=True)
            t.start()
            with self._lock:
                self._pending.append(t)
        else:
            self._write(step, leaves, extra, fingerprint)

    def _write(self, step: int, leaves, extra, fingerprint: str) -> None:
        name = f"step_{step:09d}"
        os.makedirs(self.directory, exist_ok=True)
        tmp = os.path.join(self.directory, f".tmp_{name}")
        final = os.path.join(self.directory, name)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k: v for k, v, _ in leaves})
        manifest = {
            "step": step,
            "keys": [k for k, _, _ in leaves],
            "shapes": {k: list(v.shape) for k, v, _ in leaves},
            "dtypes": {k: dt for k, _, dt in leaves},
            "fingerprint": fingerprint,
            "extra": extra or {},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        # LATEST pointer, also via atomic rename
        latest_tmp = os.path.join(self.directory, ".LATEST_tmp")
        with open(latest_tmp, "w") as f:
            f.write(name)
            f.flush()
            os.fsync(f.fileno())
        os.rename(latest_tmp, os.path.join(self.directory, "LATEST"))
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.cfg.keep_last] if self.cfg.keep_last else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)

    def wait(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        for t in pending:
            t.join()

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(d[len("step_"):]) for d in os.listdir(
            self.directory) if d.startswith("step_"))

    def latest_step(self) -> Optional[int]:
        path = os.path.join(self.directory, "LATEST")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return int(f.read().strip()[len("step_"):])

    def restore(self, like_state, step: Optional[int] = None,
                device: Union[str, torch.device, None] = None,
                expected_fingerprint: str = "") -> Tuple[Any, Dict[str, Any]]:
        """Restore into the structure of ``like_state``: each tensor leaf on
        ``device``, or where ``like_state``'s leaf lies. Returns
        (state, extra)."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        base = os.path.join(self.directory, f"step_{step:09d}")
        with open(os.path.join(base, "manifest.json")) as f:
            manifest = json.load(f)
        if expected_fingerprint and manifest["fingerprint"] and \
                manifest["fingerprint"] != expected_fingerprint:
            raise ValueError(
                f"checkpoint fingerprint {manifest['fingerprint']} does not "
                f"match config fingerprint {expected_fingerprint}")
        with np.load(os.path.join(base, "arrays.npz")) as npz:
            arrays = {k: npz[k] for k in npz.files}
        keys = _paths(like_state)
        missing = [k for k in keys if k not in arrays]
        if missing:
            raise KeyError(f"checkpoint missing keys: {missing[:5]}...")
        flat, unflatten = T.flatten(like_state)
        state = unflatten([_from_numpy(arrays[k], manifest["dtypes"][k], like,
                                       device)
                           for k, like in zip(keys, flat)])
        return state, manifest.get("extra", {})
