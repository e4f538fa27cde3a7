"""llama3.2-3b — small llama3, GQA kv=8.

[hf:meta-llama/Llama-3.2-1B (family); unverified]
28L · d_model 3072 · 24H (kv 8, head_dim 128) · d_ff 8192 · vocab 128256.
The same configs as ``repro.configs.llama32_3b``.
"""
from repro_torch.config.base import ModelConfig
from repro_torch.config.registry import register_arch


def full() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-3b",
        family="dense",
        n_layers=28,
        d_model=3072,
        n_heads=24,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=128256,
        rope_theta=500000.0,
        ce_chunk=512,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        rope_theta=500000.0,
    )


register_arch("llama3.2-3b", full, smoke)
