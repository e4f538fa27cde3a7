from repro_torch.data.synthetic import (
    PAPER_DATASETS,
    SVMDataset,
    make_svm_dataset,
)

__all__ = ["PAPER_DATASETS", "SVMDataset", "make_svm_dataset"]
