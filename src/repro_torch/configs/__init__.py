"""Architecture configs, the same ten as ``repro.configs``, and the paper's
SVM dataset configs (``svm_datasets``). Importing this package registers
every ``--arch`` id."""

from repro_torch.configs import (  # noqa: F401
    internlm2_1p8b,
    llama32_3b,
    mamba2_2p7b,
    paligemma_3b,
    phi35_moe,
    qwen25_3b,
    qwen3_moe,
    smollm_360m,
    whisper_base,
    zamba2_1p2b,
)
