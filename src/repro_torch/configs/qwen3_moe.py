"""qwen3-moe-235b-a22b — 128-expert top-8 MoE, the largest arch.

[hf:Qwen/Qwen3-30B-A3B (family); hf]
94L · d_model 4096 · 64H (kv 4, head_dim 128 explicit) · d_ff 1536/expert ·
vocab 151936 · 128e top-8 ⇒ ~235B total / ~22B active: at full depth its
bf16 weights (470 GB) need expert parallelism across cards. The same
configs as ``repro.configs.qwen3_moe``.
"""
from repro_torch.config.base import ModelConfig, MoEConfig
from repro_torch.config.registry import register_arch


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        d_ff=1536,
        vocab_size=151936,
        head_dim=128,
        moe=MoEConfig(num_experts=128, top_k=8),
        ce_chunk=512,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke",
        family="moe",
        n_layers=3,
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        d_ff=64,
        vocab_size=512,
        head_dim=32,
        moe=MoEConfig(num_experts=8, top_k=2),
    )


register_arch("qwen3-moe-235b-a22b", full, smoke)
