"""Synthetic dataset generators, the port's copy of
``distkeras_tpu/data/datasets.py`` (numpy only, so the same code: the
same seed gives the same rows in both packages).

The reference's examples download MNIST / ATLAS Higgs / Criteo; with
zero egress these generate *learnable* synthetic stand-ins (labels are
a deterministic function of features, so convergence tests have
signal), with the same column names the real loaders would produce:
``features`` / ``label``.
"""

from __future__ import annotations

import numpy as np

from distkeras_tpu_torch.data.dataset import Dataset


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(seed)


def synthetic_classification(num_rows: int, feature_shape: tuple[int, ...],
                             num_classes: int, seed: int = 0,
                             margin: float = 1.0) -> Dataset:
    """Gaussian mixture with one center per class: ``x = center[label] +
    noise``, center coordinates ~ N(0, margin²), unit noise.

    The per-coordinate class signal is ~``margin * sqrt(2)`` noise stds —
    deliberately NOT normalized by dimension, so gradient descent sees
    strong signal in every coordinate and smoke-test budgets converge at
    any feature size.  (Both earlier generators — argmax-of-linear-map and
    dim-normalized centers — had large aggregate but vanishing
    per-coordinate signal at 784 dims: feature learning stalled on the
    uniform-loss plateau for hundreds of epochs.)"""
    rng = _rng(seed)
    dim = int(np.prod(feature_shape))
    label = rng.integers(0, num_classes, size=num_rows).astype(np.int32)
    centers = _rng(seed + 1).normal(size=(num_classes, dim)) * margin
    x = rng.normal(size=(num_rows, dim)) + centers[label]
    x = x.astype(np.float32).reshape(num_rows, *feature_shape)
    return Dataset({"features": x, "label": label})


def mnist_synth(num_rows: int = 4096, seed: int = 0) -> Dataset:
    """MNIST-shaped: 28x28x1 in [0,1], 10 classes."""
    ds = synthetic_classification(num_rows, (28, 28, 1), 10, seed)
    return ds.map_column("features", lambda x: (x - x.min()) /
                         (x.max() - x.min()))


def cifar10_synth(num_rows: int = 4096, seed: int = 1) -> Dataset:
    return synthetic_classification(num_rows, (32, 32, 3), 10, seed)


def imagenet_synth(num_rows: int = 512, image_size: int = 224,
                   num_classes: int = 1000, seed: int = 2) -> Dataset:
    return synthetic_classification(num_rows,
                                    (image_size, image_size, 3),
                                    num_classes, seed)


def imdb_synth(num_rows: int = 2048, seq_len: int = 64,
               vocab_size: int = 1000, seed: int = 3) -> Dataset:
    """Token sequences (0 = pad); label = whether "positive" tokens (ids
    below vocab/2) outnumber "negative" ones — order-free but recurrent-
    friendly signal."""
    rng = _rng(seed)
    lengths = rng.integers(seq_len // 2, seq_len + 1, size=num_rows)
    tokens = rng.integers(1, vocab_size, size=(num_rows, seq_len))
    mask = np.arange(seq_len)[None, :] < lengths[:, None]
    tokens = (tokens * mask).astype(np.int32)
    positive = ((tokens > 0) & (tokens < vocab_size // 2)).sum(axis=1)
    label = (positive * 2 > lengths).astype(np.int32)
    return Dataset({"features": tokens, "label": label})


def criteo_synth(num_rows: int = 4096, num_dense: int = 13,
                 num_categorical: int = 26, vocab_size: int = 1000,
                 seed: int = 4) -> Dataset:
    """Criteo-shaped CTR rows: dense float features (log-normal, like
    Criteo counts), string categoricals, binary label correlated with a
    random subset of both."""
    rng = _rng(seed)
    dense = rng.lognormal(0.0, 1.0,
                          size=(num_rows, num_dense)).astype(np.float32)
    cats = rng.integers(0, vocab_size, size=(num_rows, num_categorical))
    cat_strings = np.char.add("cat_", cats.astype(str))
    w_dense = _rng(seed + 1).normal(size=num_dense)
    score = np.log1p(dense) @ w_dense + (cats[:, 0] % 2) - 0.5
    label = (score > np.median(score)).astype(np.int32)
    cols = {"label": label}
    cols["dense"] = dense
    for j in range(num_categorical):
        cols[f"c{j}"] = cat_strings[:, j]
    return Dataset(cols)


def lm_synth(num_rows: int = 1024, seq_len: int = 128,
             vocab_size: int = 256, seed: int = 5) -> Dataset:
    """Language-model rows for the Transformer: next-token targets over a
    deterministic mod-arithmetic sequence (perfectly learnable)."""
    rng = _rng(seed)
    start = rng.integers(1, vocab_size, size=(num_rows, 2))
    seq = np.zeros((num_rows, seq_len + 1), dtype=np.int64)
    seq[:, :2] = start
    for t in range(2, seq_len + 1):
        seq[:, t] = (seq[:, t - 1] + seq[:, t - 2]) % vocab_size
    return Dataset({"features": seq[:, :-1].astype(np.int32),
                    "label": seq[:, 1:].astype(np.int32)})
