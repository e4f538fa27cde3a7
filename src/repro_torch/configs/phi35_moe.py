"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE, GQA kv=8.

[hf:microsoft/Phi-3.5-MoE-instruct; hf]
32L · d_model 4096 · 32H (kv 8, head_dim 128) · d_ff 6400/expert ·
vocab 32064 · 16e top-2 ⇒ 41.9B total / 6.6B active. The same configs as
``repro.configs.phi35_moe``.
"""
from repro_torch.config.base import ModelConfig, MoEConfig
from repro_torch.config.registry import register_arch


def full() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=6400,
        vocab_size=32064,
        moe=MoEConfig(num_experts=16, top_k=2),
        ce_chunk=512,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-smoke",
        family="moe",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=192,
        vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2),
    )


register_arch("phi3.5-moe-42b-a6.6b", full, smoke)
