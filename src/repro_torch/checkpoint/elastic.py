"""Elastic reshaping of local-SGD (MSF) replica state, the port of
``repro.checkpoint.elastic``.

Local-SGD replicas are designed to diverge between syncs, which makes an
elastic resize natural under the paper's averaging semantics:

* **shrink** (K → K' < K replicas): average the K replicas (exactly the
  paper's model synchronization), then keep K' copies;
* **grow** (K → K' > K): average, then broadcast to all K' replicas —
  a sync point followed by fan-out.

The replica dimension is the leading dim of every tensor leaf (the
trainer's layout). Leaves without it (scalar counters, the trainer's Python
``step``) pass through unchanged.
"""
from __future__ import annotations

import torch

from repro_torch import tree as T


def rescale_replicated_state(state, old_replicas: int, new_replicas: int):
    """Reshape a replica-leading state tree from K to K' replicas."""
    if old_replicas == new_replicas:
        return state

    def leaf(x):
        if not isinstance(x, torch.Tensor) or x.dim() == 0 \
                or x.shape[0] != old_replicas:
            return x
        avg = x.float().mean(dim=0)
        return avg.expand((new_replicas,) + tuple(avg.shape)).to(
            x.dtype).contiguous()

    return T.map(leaf, state)


def add_replica_dim(state, replicas: int):
    """Fan a replica-free state out to K identical replicas (join a sync)."""
    return T.map(lambda x: x.unsqueeze(0).expand(
        (replicas,) + tuple(x.shape)).contiguous()
        if isinstance(x, torch.Tensor) else x, state)


def drop_replica_dim(state):
    """Average away the replica dim (final sync before export/eval)."""
    return T.map(lambda x: x.float().mean(dim=0).to(x.dtype)
                 if isinstance(x, torch.Tensor) and x.dim() > 0 else x, state)
