from repro_torch.checkpoint.elastic import rescale_replicated_state
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager", "rescale_replicated_state"]
