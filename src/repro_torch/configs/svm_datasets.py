"""The paper's three SVM workloads as configs (synthetic stand-ins).

Geometry (n, d, sparsity) follows Table I; see
:mod:`repro_torch.data.synthetic` for the stand-in generation rationale.
"""
from repro_torch.config.base import DataConfig

IJCNN1 = DataConfig(dataset="ijcnn1", features=22, num_samples=35_000,
                    sparsity=40.91)
WEBSPAM = DataConfig(dataset="webspam", features=254, num_samples=350_000,
                     sparsity=99.9)
EPSILON = DataConfig(dataset="epsilon", features=2_000, num_samples=400_000,
                     sparsity=44.9)

SVM_DATASETS = {"ijcnn1": IJCNN1, "webspam": WEBSPAM, "epsilon": EPSILON}
