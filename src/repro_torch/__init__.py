"""repro_torch — the PyTorch/CUDA port of :mod:`repro` (parallel-SGD SVM).

The package mirrors ``repro``'s module paths so each module's counterpart is
easy to find. It imports ``torch``, numpy and the standard library only, never
``jax`` and nothing of ``repro``. Importing it imports no submodule: the CUDA
kernels are built at their first launch, not here.
"""
