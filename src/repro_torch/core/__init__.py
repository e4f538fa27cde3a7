"""The paper's system in PyTorch: SGD-SVM (``svm``) and its cost model."""
