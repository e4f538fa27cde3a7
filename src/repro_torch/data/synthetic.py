"""Synthetic SVM datasets, copied from ``repro.data.synthetic``.

The paper's datasets (Ijcnn1, Webspam, Epsilon) are not redistributable
offline, so :func:`make_svm_dataset` generates stand-ins matched on the
published statistics — sample count, feature dimension, sparsity percentage,
and an (approximately) linearly separable structure with label noise. The
generator stays numpy: for the same ``seed``/``n_override`` its arrays are
byte-identical to the reference's (a test holds them so).

``synthetic_lm_batch`` provides deterministic token streams for the LM
training path (zipf-ish marginal over the vocab, shifted-label targets), also
byte-identical to the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SVMDataset:
    """Train / cross-validation / test split, paper Table I layout."""

    name: str
    x_train: np.ndarray        # (n_train, d) float32
    y_train: np.ndarray        # (n_train,)  float32 in {-1, +1}
    x_cv: np.ndarray
    y_cv: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray

    @property
    def n_train(self) -> int:
        return self.x_train.shape[0]

    @property
    def features(self) -> int:
        return self.x_train.shape[1]


# name → (n_samples, features, sparsity %) from the paper (Table I / §III)
PAPER_DATASETS: Dict[str, Tuple[int, int, float]] = {
    "ijcnn1": (35_000, 22, 40.91),
    "webspam": (350_000, 254, 99.9),
    "epsilon": (400_000, 2_000, 44.9),
}


def make_svm_dataset(name: str, seed: int = 0, train_fraction: float = 0.8,
                     scale: float = 1.0, label_noise: float = 0.05,
                     n_override: Optional[int] = None) -> SVMDataset:
    """Generate a sparsity/shape-matched stand-in for a paper dataset.

    ``n_override`` shrinks the sample count for fast tests/benchmarks while
    keeping the feature dimension (the quantity that drives communication
    volume) faithful.
    """
    if name not in PAPER_DATASETS:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(PAPER_DATASETS)}")
    n, d, sparsity_pct = PAPER_DATASETS[name]
    if n_override:
        n = int(n_override)
    rng = np.random.default_rng(seed)

    # ground-truth separating hyperplane
    w_true = rng.normal(size=d).astype(np.float32)
    w_true /= np.linalg.norm(w_true)

    density = max(1e-4, 1.0 - sparsity_pct / 100.0)
    x = rng.normal(scale=scale, size=(n, d)).astype(np.float32)
    if density < 1.0:
        mask = rng.random(size=(n, d)) < density
        # keep at least one nonzero per row so no sample is empty
        empty = ~mask.any(axis=1)
        mask[empty, rng.integers(0, d, size=int(empty.sum()))] = True
        x = x * mask

    margin = x @ w_true
    y = np.where(margin >= 0, 1.0, -1.0).astype(np.float32)
    flip = rng.random(n) < label_noise
    y[flip] = -y[flip]

    n_train = int(train_fraction * n)
    n_rest = n - n_train
    n_cv = n_rest // 2
    idx = rng.permutation(n)
    tr, cv, te = np.split(idx, [n_train, n_train + n_cv])
    return SVMDataset(
        name=name,
        x_train=x[tr], y_train=y[tr],
        x_cv=x[cv], y_cv=y[cv],
        x_test=x[te], y_test=y[te],
    )


# ---------------------------------------------------------------------------
# LM token stream
# ---------------------------------------------------------------------------

def synthetic_lm_batch(step: int, *, global_batch: int, seq_len: int,
                       vocab_size: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """Deterministic (seed, step) → batch. Zipf-distributed tokens.

    Returns ``{"tokens": (B, S) int32, "targets": (B, S) int32}`` where
    targets are tokens shifted left (next-token prediction), final position
    wrapping to token 0 (ignored-index convention is up to the loss).
    """
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    # zipf over a capped support, remapped into the vocab
    raw = rng.zipf(1.2, size=(global_batch, seq_len + 1)).astype(np.int64)
    tokens = (raw % vocab_size).astype(np.int32)
    return {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
