"""qwen2.5-3b — GQA kv=2, QKV bias.

[hf:Qwen/Qwen2.5-0.5B (family); hf]
36L · d_model 2048 · 16H (kv 2, head_dim 128) · d_ff 11008 · vocab 151936.
The same configs as ``repro.configs.qwen25_3b``.
"""
from repro_torch.config.base import ModelConfig
from repro_torch.config.registry import register_arch


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b",
        family="dense",
        n_layers=36,
        d_model=2048,
        n_heads=16,
        n_kv_heads=2,
        d_ff=11008,
        vocab_size=151936,
        qkv_bias=True,
        ce_chunk=512,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=320,
        vocab_size=512,
        qkv_bias=True,
    )


register_arch("qwen2.5-3b", full, smoke)
