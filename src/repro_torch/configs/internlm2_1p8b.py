"""internlm2-1.8b — GQA dense LM.

[arXiv:2403.17297; hf]
24L · d_model 2048 · 16H (kv 8, head_dim 128) · d_ff 8192 · vocab 92544.
The same configs as ``repro.configs.internlm2_1p8b``.
"""
from repro_torch.config.base import ModelConfig
from repro_torch.config.registry import register_arch


def full() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b",
        family="dense",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=92544,
        ce_chunk=512,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internlm2-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=512,
    )


register_arch("internlm2-1.8b", full, smoke)
