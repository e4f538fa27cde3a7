"""Architecture configs the port can build, and the paper's SVM dataset
configs (``svm_datasets``). Importing this package registers the ``--arch``
ids; the other seven of ``repro.configs`` wait for their model families."""

from repro_torch.configs import mamba2_2p7b, smollm_360m, zamba2_1p2b  # noqa: F401
