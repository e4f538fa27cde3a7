"""paligemma-3b — SigLIP (stub) + gemma-2b prefix-LM decoder.

[arXiv:2407.07726; hf]
18L · d_model 2048 · 8H (kv 1 = MQA, head_dim 256) · d_ff 16384 ·
vocab 257216 · 256 image-prefix tokens (224px / 14px patches).

The SigLIP tower is a stub, as in the reference: the model takes
precomputed patch embeddings (B, 256, 2048) before the text, and prefix
attention is bidirectional over the image tokens. The same configs as
``repro.configs.paligemma_3b``.
"""
from repro_torch.config.base import ModelConfig
from repro_torch.config.registry import register_arch


def full() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b",
        family="vlm",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        d_ff=16384,
        vocab_size=257216,
        head_dim=256,
        tie_embeddings=True,
        num_image_tokens=256,
        ce_chunk=480,      # divides the 3840/32512-token text spans
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="paligemma-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=128,
        vocab_size=512,
        head_dim=32,
        tie_embeddings=True,
        num_image_tokens=8,
    )


register_arch("paligemma-3b", full, smoke)
