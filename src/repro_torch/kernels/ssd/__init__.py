"""Mamba2 SSD chunk scan: ``ref`` is the plain version (the exact per-step
recurrence), ``ops`` the wrapper of the CUDA kernel in ``csrc/``. Neither
import builds anything."""
