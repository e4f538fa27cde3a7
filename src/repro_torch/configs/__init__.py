"""Architecture configs the port can build, and the paper's SVM dataset
configs (``svm_datasets``). Importing this package registers the ``--arch``
ids; the other nine of ``repro.configs`` wait for their model families."""

from repro_torch.configs import smollm_360m  # noqa: F401
