"""ETL transformers, the port's copy of ``distkeras_tpu/data/
transformers.py``: the reference's ``distkeras/transformers.py`` surface
(LabelIndex / OneHot / MinMax / Reshape / Dense) over columnar numpy,
plus the hash-bucketing the Criteo Wide&Deep configuration needs, and
``Assemble``/``StandardScale``/``Pipeline``.

Objects with ``transform(dataset) -> dataset``, vectorized over whole
columns, with an explicit ``fit`` for the stateful ones.  MinMax,
StandardScale, Dense and HashBucket take the C lane of
``distkeras_tpu_torch.native`` where it is available and their numpy
lane (the plain version) otherwise; both give the JAX package's values.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from distkeras_tpu_torch import native
from distkeras_tpu_torch.data.dataset import Dataset


class Transformer:
    """Spark-ML-style transformer: ``transform(Dataset) -> Dataset``.

    Stateful transformers implement ``fit`` and raise if used unfitted.
    """

    def fit(self, dataset: Dataset) -> "Transformer":
        return self

    def transform(self, dataset: Dataset) -> Dataset:
        raise NotImplementedError

    def fit_transform(self, dataset: Dataset) -> Dataset:
        return self.fit(dataset).transform(dataset)

    def __call__(self, dataset: Dataset) -> Dataset:
        return self.transform(dataset)


class LabelIndexTransformer(Transformer):
    """String/arbitrary labels -> contiguous integer indices.

    Reference: LabelIndexTransformer (SURVEY.md §2.1, name MED).
    """

    def __init__(self, input_col: str, output_col: str | None = None):
        self.input_col = input_col
        self.output_col = output_col or input_col + "_index"
        self.classes_: np.ndarray | None = None

    def fit(self, dataset: Dataset) -> "LabelIndexTransformer":
        self.classes_ = np.unique(dataset[self.input_col])
        return self

    def transform(self, dataset: Dataset) -> Dataset:
        if self.classes_ is None:
            raise RuntimeError("fit() before transform()")
        idx = np.searchsorted(self.classes_, dataset[self.input_col])
        idx = idx.astype(np.int32)
        # reject labels unseen at fit time instead of aliasing them
        if not np.array_equal(
                np.asarray(self.classes_)[np.clip(idx, 0,
                                                  len(self.classes_) - 1)],
                dataset[self.input_col]):
            raise ValueError(f"unseen labels in {self.input_col!r}")
        return dataset.with_column(self.output_col, idx)


class OneHotTransformer(Transformer):
    """Integer index column -> one-hot float32 matrix column.

    Reference: OneHotTransformer; ``utils.to_dense_vector`` per row.
    """

    def __init__(self, input_col: str, num_classes: int,
                 output_col: str | None = None):
        self.input_col = input_col
        self.num_classes = num_classes
        self.output_col = output_col or input_col + "_onehot"

    def transform(self, dataset: Dataset) -> Dataset:
        idx = np.asarray(dataset[self.input_col], dtype=np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= self.num_classes):
            raise ValueError(
                f"indices outside [0, {self.num_classes})")
        eye = np.eye(self.num_classes, dtype=np.float32)
        return dataset.with_column(self.output_col, eye[idx])


class MinMaxTransformer(Transformer):
    """Scale a numeric column into [new_min, new_max].

    Reference: MinMaxTransformer (per-feature min/max over the DataFrame).
    """

    def __init__(self, input_col: str, output_col: str | None = None,
                 new_min: float = 0.0, new_max: float = 1.0):
        self.input_col = input_col
        self.output_col = output_col or input_col
        self.new_min, self.new_max = new_min, new_max
        self.min_: np.ndarray | None = None
        self.max_: np.ndarray | None = None

    def fit(self, dataset: Dataset) -> "MinMaxTransformer":
        col = np.asarray(dataset[self.input_col], dtype=np.float64)
        self.min_ = col.min(axis=0)
        self.max_ = col.max(axis=0)
        return self

    def transform(self, dataset: Dataset) -> Dataset:
        if self.min_ is None:
            raise RuntimeError("fit() before transform()")
        col = np.asarray(dataset[self.input_col], dtype=np.float32)
        span = np.where(self.max_ > self.min_, self.max_ - self.min_, 1.0)
        if native.available():
            scale = (self.new_max - self.new_min) / span
            out = native.affine_scale(col, scale,
                                      self.new_min - self.min_ * scale)
        else:
            unit = (col - self.min_) / span
            out = (unit * (self.new_max - self.new_min)
                   + self.new_min).astype(np.float32)
        return dataset.with_column(self.output_col, out)


class StandardScaleTransformer(Transformer):
    """Zero-mean unit-variance scaling (common companion to MinMax)."""

    def __init__(self, input_col: str, output_col: str | None = None,
                 epsilon: float = 1e-8):
        self.input_col = input_col
        self.output_col = output_col or input_col
        self.epsilon = epsilon
        self.mean_: np.ndarray | None = None
        self.std_: np.ndarray | None = None

    def fit(self, dataset: Dataset) -> "StandardScaleTransformer":
        col = np.asarray(dataset[self.input_col], dtype=np.float64)
        self.mean_ = col.mean(axis=0)
        self.std_ = col.std(axis=0)
        return self

    def transform(self, dataset: Dataset) -> Dataset:
        if self.mean_ is None:
            raise RuntimeError("fit() before transform()")
        col = np.asarray(dataset[self.input_col], dtype=np.float32)
        if native.available():
            scale = 1.0 / (self.std_ + self.epsilon)
            out = native.affine_scale(col, scale, -self.mean_ * scale)
        else:
            out = ((col - self.mean_)
                   / (self.std_ + self.epsilon)).astype(np.float32)
        return dataset.with_column(self.output_col, out)


class ReshapeTransformer(Transformer):
    """Reshape each row's feature vector (e.g. flat 784 -> 28x28x1).

    Reference: ReshapeTransformer (flat -> image tensor for convnets).
    """

    def __init__(self, input_col: str, shape: Sequence[int],
                 output_col: str | None = None):
        self.input_col = input_col
        self.shape = tuple(shape)
        self.output_col = output_col or input_col

    def transform(self, dataset: Dataset) -> Dataset:
        col = np.asarray(dataset[self.input_col])
        return dataset.with_column(
            self.output_col, col.reshape((len(dataset), *self.shape)))


class DenseTransformer(Transformer):
    """(indices, values) sparse row pairs -> dense float32 vectors.

    Reference: DenseTransformer (Spark sparse Vector -> dense).  Columnar
    encoding: ``indices_col``/``values_col`` are ``[N, nnz]`` padded arrays
    (pad index < 0 ignored).
    """

    def __init__(self, indices_col: str, values_col: str, dim: int,
                 output_col: str = "features"):
        self.indices_col = indices_col
        self.values_col = values_col
        self.dim = dim
        self.output_col = output_col

    def transform(self, dataset: Dataset) -> Dataset:
        idx = np.asarray(dataset[self.indices_col], dtype=np.int64)
        val = np.asarray(dataset[self.values_col], dtype=np.float32)
        if native.available():
            out = native.dense_scatter(idx, val, self.dim)
        else:
            n = len(dataset)
            out = np.zeros((n, self.dim), dtype=np.float32)
            valid = idx >= 0
            rows = np.broadcast_to(np.arange(n)[:, None], idx.shape)
            out[rows[valid], idx[valid]] = val[valid]
        return dataset.with_column(self.output_col, out)


class HashBucketTransformer(Transformer):
    """Hash arbitrary categorical values into ``num_buckets`` int ids —
    the Criteo categorical path (reference handled this in notebook ETL).

    Deterministic FNV-1a over the value's string bytes; no vocabulary
    state, so it needs no ``fit`` and is stable across shards/hosts.
    """

    def __init__(self, input_col: str, num_buckets: int,
                 output_col: str | None = None):
        self.input_col = input_col
        self.num_buckets = num_buckets
        self.output_col = output_col or input_col + "_bucket"

    @staticmethod
    def _fnv1a(data: bytes) -> int:
        """Scalar reference implementation (tests check the vectorized
        path against this)."""
        h = 0xcbf29ce484222325
        for b in data:
            h = ((h ^ b) * 0x100000001b3) & 0xFFFFFFFFFFFFFFFF
        return h

    @staticmethod
    def _fnv1a_vectorized(col: np.ndarray) -> np.ndarray:
        """FNV-1a over each value's UTF-8 bytes, vectorized across rows:
        view the fixed-width byte array as a [N, W] uint8 matrix and fold
        column-by-column (W = max string width, typically tiny), masking
        rows already past their length.  uint64 arithmetic wraps, which is
        exactly FNV's mod-2^64."""
        s = np.char.encode(col.astype(str), "utf-8")
        width = s.dtype.itemsize
        mat = np.frombuffer(s.tobytes(), dtype=np.uint8).reshape(-1, width)
        lengths = np.char.str_len(s)
        h = np.full(len(s), 0xcbf29ce484222325, dtype=np.uint64)
        prime = np.uint64(0x100000001b3)
        with np.errstate(over="ignore"):
            for j in range(width):
                active = j < lengths
                h[active] = (h[active] ^ mat[active, j]) * prime
        return h

    def transform(self, dataset: Dataset) -> Dataset:
        col = np.asarray(dataset[self.input_col])
        if native.available():
            s = np.char.encode(col.astype(str), "utf-8")
            out = native.fnv1a_bucket(s, np.char.str_len(s),
                                      self.num_buckets)
        else:
            h = self._fnv1a_vectorized(col)
            out = (h % np.uint64(self.num_buckets)).astype(np.int32)
        return dataset.with_column(self.output_col, out)


class AssembleTransformer(Transformer):
    """Concatenate numeric columns into one float32 feature matrix — the
    Spark ``VectorAssembler`` idiom the reference notebooks use to build
    ``features_col`` before training.  Scalar columns contribute one
    column each; matrix columns are flattened per row."""

    def __init__(self, input_cols: Sequence[str],
                 output_col: str = "features"):
        self.input_cols = list(input_cols)
        self.output_col = output_col

    def transform(self, dataset: Dataset) -> Dataset:
        parts = []
        n = len(dataset)
        for name in self.input_cols:
            col = np.asarray(dataset[name], dtype=np.float32)
            parts.append(col.reshape(n, -1))
        return dataset.with_column(self.output_col,
                                   np.concatenate(parts, axis=1))


class Pipeline(Transformer):
    """Sequential transformer composition (fit stages in order, each on
    the output of the previous)."""

    def __init__(self, stages: Sequence[Transformer]):
        self.stages = list(stages)

    def fit(self, dataset: Dataset) -> "Pipeline":
        for stage in self.stages:
            dataset = stage.fit(dataset).transform(dataset)
        return self

    def transform(self, dataset: Dataset) -> Dataset:
        for stage in self.stages:
            dataset = stage.transform(dataset)
        return dataset
