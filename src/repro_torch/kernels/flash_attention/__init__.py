"""Flash attention (forward, GQA, causal/prefix masks): ``ref`` is the plain
version, ``ops`` the wrapper of the CUDA kernel in ``csrc/``."""
