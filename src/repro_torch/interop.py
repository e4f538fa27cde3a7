"""Carry the reference's state into the port.

``repro`` hands its state out as JAX arrays, which ``np.asarray`` turns into
numpy. :func:`svm_state_to_torch` turns an SVM model ``w`` or a DMS carry
dict (``repro.core.svm.dms_stepper_init``'s keys) into the port's tensors on
a given device; :func:`lm_params_from_jax` turns an LM param pytree into the
port's state dict, and :func:`rank_params_from_jax` into a serving rank's
shards of it; :func:`lm_train_state_from_jax` turns a local-SGD train
state into the port's trainer state, and :func:`rank_train_state_from_jax`
into a training rank's share of it. All keep each dtype. This module imports no JAX: the
caller converts to numpy (``jax.tree.map(np.asarray, params)``).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from repro_torch.config.base import ModelConfig, TrainConfig

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
    return _tensor(state, device)


def _tensor(value, device=None) -> torch.Tensor:
    """A numpy array (bfloat16 from ``ml_dtypes`` too) as a tensor that owns
    its memory, dtype kept."""
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":  # numpy has no bf16: carry the bits
        bits = torch.tensor(arr.view(np.uint16), device=device)
        return bits.view(torch.bfloat16)
    return torch.tensor(arr, dtype=getattr(torch, arr.dtype.name),
                        device=device)


def _stack_depths(cfg: ModelConfig) -> Dict[str, int]:
    """The depth of each layer stack a model's params may hold."""
    return {"layers": cfg.n_layers, "dec_layers": cfg.n_layers,
            "enc_layers": cfg.n_encoder_layers}


def lm_params_from_jax(params: Mapping[str, Any], cfg: ModelConfig
                       ) -> Dict[str, torch.Tensor]:
    """The reference's LM param pytree (a model's ``init``, a nested dict,
    as numpy) as the port's state dict: nested keys joined by dots, and
    each scanned layer stack (every leaf with a leading depth dim: ``layers``
    and the enc-dec's ``dec_layers`` of ``n_layers``, its ``enc_layers`` of
    ``n_encoder_layers``; an MoE's ``(n_layers, E, …)`` expert leaves too)
    split into one entry per layer, ``<stack>.<i>.<key>``. Load it with the
    port's model's ``load``."""
    out: Dict[str, torch.Tensor] = {}
    stacks = _stack_depths(cfg)

    def walk(prefix: str, node, layer=None, depth=None):
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(f"{prefix}{key}.", value, layer, depth)
                continue
            arr = np.asarray(value)
            if layer is not None:
                if arr.shape[:1] != (depth,):
                    raise ValueError(f"{prefix}{key}: leading dim "
                                     f"{arr.shape[:1]} is not the stack's "
                                     f"depth {depth}")
                arr = arr[layer]
            out[prefix + key] = _tensor(arr)

    for key, value in params.items():
        if key in stacks:
            for i in range(stacks[key]):
                walk(f"{key}.{i}.", value, i, stacks[key])
        elif isinstance(value, Mapping):
            walk(f"{key}.", value)
        else:
            out[key] = _tensor(value)
    return out


def rank_params_from_jax(params: Mapping[str, Any], cfg: ModelConfig,
                         rules, mesh) -> Dict[str, torch.Tensor]:
    """:func:`lm_params_from_jax` followed by this rank's shard of every
    entry: the state dict a serving rank on ``mesh`` loads
    (``ServeEngine(…, params=…, mesh=mesh)``), under ``rules`` (the
    engine's, :func:`repro_torch.launch.serve.serving_rules`) and
    :func:`repro_torch.sharding.serve_specs` (``spec_for`` of each
    leaf)."""
    from repro_torch import sharding as S
    from repro_torch.models.registry import build_model
    specs = S.flat_keys(S.serve_specs(build_model(cfg).param_defs(), rules))
    return {key: S.shard_of(t, specs[key], mesh).clone()
            for key, t in lm_params_from_jax(params, cfg).items()}


def lm_train_state_from_jax(state: Mapping[str, Any], cfg: TrainConfig,
                            device: Union[str, torch.device] = "cpu"
                            ) -> Dict[str, Any]:
    """The reference's LM train state (``repro.core.local_sgd.init_state``'s
    dict ``{"params", "opt", "sync", "step"}``, as numpy) as the port's
    trainer state on ``device``: the same nested dicts (the layer stack kept
    as ``(n_layers, …)`` leaves, the layout the port's trainer holds), every
    leaf a tensor of its dtype, ``step`` an int.

    Under a replica strategy (``periodic``/``hierarchical``) every params,
    opt and sync leaf must carry the leading replica dim of
    ``cfg.mesh``'s replica axis; a params leaf of a layer stack then
    carries the stack's depth next (``n_layers`` for ``layers`` and
    ``dec_layers``, ``n_encoder_layers`` for ``enc_layers``). Raises
    ``ValueError`` where a leaf does not, and ``KeyError`` on a missing or
    unknown top-level key."""
    keys = {"params", "opt", "sync", "step"}
    if set(state) != keys:
        raise KeyError(f"train state keys {sorted(state)}, expected "
                       f"{sorted(keys)}")
    replicated = cfg.sync.strategy in ("periodic", "hierarchical")
    k = cfg.mesh.axis_size(cfg.mesh.replica_axis or "pod")
    lead = (k,) if replicated else ()
    depths = _stack_depths(cfg.model)

    def convert(node, path):
        if isinstance(node, Mapping):
            return {key: convert(v, f"{path}.{key}") for key, v in node.items()}
        arr = np.asarray(node)
        if arr.shape[:len(lead)] != lead:
            raise ValueError(f"{path}: shape {arr.shape} lacks the replica "
                             f"dim {k}")
        parts = path.split(".")
        if (parts[0] == "params" and len(parts) > 2 and parts[1] in depths
                and arr.shape[len(lead):len(lead) + 1] != (depths[parts[1]],)):
            raise ValueError(f"{path}: shape {arr.shape} lacks the layer "
                             f"dim {depths[parts[1]]} of {parts[1]!r}")
        return _tensor(arr, device)

    out = {key: convert(state[key], key) for key in ("params", "opt", "sync")}
    out["step"] = int(np.asarray(state["step"]))
    return out


def rank_train_state_from_jax(state: Mapping[str, Any], cfg: TrainConfig,
                              rules, mesh) -> Dict[str, Any]:
    """This rank's share of the reference's train state on ``mesh``:
    :func:`lm_train_state_from_jax`, then (under a replica strategy) the
    rank's replica (``local_sgd.scatter_replicas``), then its shard of each
    leaf (``sharding.shard_of``) under ``rules``
    (:func:`repro_torch.sharding.training_rules`) and
    ``local_sgd.state_specs``; each leaf its own memory on the mesh's
    device."""
    from repro_torch import sharding as S
    from repro_torch import tree as T
    from repro_torch.core import local_sgd as LS
    from repro_torch.models.registry import build_model
    full = lm_train_state_from_jax(state, cfg)
    replicated = cfg.sync.strategy in ("periodic", "hierarchical")
    if replicated:
        full = LS.scatter_replicas(full, mesh, cfg.mesh.replica_axis or "pod")
    specs = LS.state_specs(full, S.train_specs(
        build_model(cfg.model).param_defs(), rules), replicated)
    out = dict(full)
    for key in ("params", "opt", "sync"):
        out[key] = T.map(lambda t: t.to(mesh.device, copy=True),
                         S.shard_tree(full[key], specs[key], mesh))
    return out
