"""zamba2-1.2b — Mamba2 backbone + shared attention block (hybrid).

[arXiv:2411.15242; hf]
38L Mamba2 (d_inner 4096, 64 SSD heads × 64) · shared attn+MLP block with
32H (kv 32, head_dim 64) + d_ff 8192, applied every 6 backbone layers ·
ssm_state 64 · vocab 32000. The same configs as
``repro.configs.zamba2_1p2b``, with its deviations from the published
model (no shared-block input concatenation, no LoRA adapters).
"""
from repro_torch.config.base import ModelConfig, SSMConfig
from repro_torch.config.registry import register_arch


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=32000,
        ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk_size=256),
        shared_block_every=6,
        subquadratic=True,
        ce_chunk=512,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke",
        family="hybrid",
        n_layers=5,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, chunk_size=8),
        shared_block_every=2,
        subquadratic=True,
    )


register_arch("zamba2-1.2b", full, smoke)
