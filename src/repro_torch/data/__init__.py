from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synthetic import (
    PAPER_DATASETS,
    SVMDataset,
    make_svm_dataset,
    synthetic_lm_batch,
)

__all__ = ["DataPipeline", "PAPER_DATASETS", "SVMDataset",
           "make_svm_dataset", "synthetic_lm_batch"]
