"""mamba2-2.7b — attention-free SSM (state-space duality).

[arXiv:2405.21060; unverified]
64L · d_model 2560 (d_inner 5120, 80 SSD heads × head_dim 64) ·
ssm_state 128 · vocab 50280, untied. The same configs as
``repro.configs.mamba2_2p7b``.
"""
from repro_torch.config.base import ModelConfig, SSMConfig
from repro_torch.config.registry import register_arch


def full() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b",
        family="ssm",
        n_layers=64,
        d_model=2560,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk_size=256),
        subquadratic=True,
        ce_chunk=512,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=512,
        ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, chunk_size=8),
        subquadratic=True,
    )


register_arch("mamba2-2.7b", full, smoke)
