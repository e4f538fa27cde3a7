"""The paper's SVM dataset configs (``svm_datasets``)."""
