"""smollm-360m — llama-arch small model with non-power-of-two heads.

[hf:HuggingFaceTB/SmolLM-135M (family); hf]
32L · d_model 960 · 15H (kv 5, head_dim 64) · d_ff 2560 · vocab 49152.
The same configs as ``repro.configs.smollm_360m``.
"""
from repro_torch.config.base import ModelConfig
from repro_torch.config.registry import register_arch


def full() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m",
        family="dense",
        n_layers=32,
        d_model=960,
        n_heads=15,
        n_kv_heads=5,
        d_ff=2560,
        vocab_size=49152,
        tie_embeddings=True,
        ce_chunk=512,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="smollm-smoke",
        family="dense",
        n_layers=2,
        d_model=96,
        n_heads=3,          # keeps the non-divisible head count property
        n_kv_heads=1,
        d_ff=256,
        vocab_size=512,
        tie_embeddings=True,
    )


register_arch("smollm-360m", full, smoke)
