"""Hand-written CUDA kernels for Hopper (sm_90a), one subpackage each.

Each subpackage is ``ref.py`` (the plain PyTorch version: the CPU path and the
comparison on the card), ``ops.py`` (the wrapper: checks, dispatch, launch
count) and ``csrc/`` (the CUDA source, built by :mod:`repro_torch.kernels.nvcc`
at first launch).

* ``hinge`` — fused SVM block-subgradient (the paper's inner loop)
* ``flash_attention`` — forward online-softmax GQA attention (the prefill)
* ``quant`` — symmetric int8 quantize/dequantize (the compressed sync)
* ``ssd`` — the Mamba2 SSD chunk scan (the SSM and hybrid prefill)
"""
