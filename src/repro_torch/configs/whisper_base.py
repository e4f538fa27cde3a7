"""whisper-base — encoder-decoder audio backbone, conv frontend stubbed.

[arXiv:2212.04356; unverified]
6L enc + 6L dec · d_model 512 · 8H (kv 8, head_dim 64) · d_ff 2048 ·
vocab 51865 · LayerNorm · tied embeddings · 1500 audio frames (30 s).

The conv1d/mel frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, 1500, 512). Real whisper has a 448-token
decoder context. The same configs as ``repro.configs.whisper_base``.
"""
from repro_torch.config.base import ModelConfig
from repro_torch.config.registry import register_arch


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        family="audio",
        n_layers=6,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        d_ff=2048,
        vocab_size=51865,
        norm_type="layer",
        tie_embeddings=True,
        n_encoder_layers=6,
        n_audio_frames=1500,
        ce_chunk=512,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        family="audio",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=512,
        norm_type="layer",
        tie_embeddings=True,
        n_encoder_layers=2,
        n_audio_frames=16,
    )


register_arch("whisper-base", full, smoke)
