"""Symmetric int8 quantize/dequantize of the compressed sync: plain version
(``ref``) and CUDA kernel (``ops``). Neither import builds anything."""
