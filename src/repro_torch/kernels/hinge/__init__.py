"""Fused hinge block-subgradient: plain version (``ref``) and CUDA kernel
(``ops``). Neither import builds anything."""
