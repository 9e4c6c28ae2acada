"""``Dataset``: a named-column table with DataFrame-shaped verbs.

The port's copy of the in-memory part of ``distkeras_tpu/data/
dataset.py`` (numpy only, so the same code): columns are numpy arrays
aligned on the row axis, and ``shuffle`` draws the same permutation from
the same seed, so a trainer of either package sees its batches in the
same order.  ``shard``/``repartition`` split the rows as the JAX
package does, so a PS trainer of either package gives each worker the
same rows.  The in-memory verbs (``drop``, ``rename``, ``filter``,
``train_test_split``, ``concat``) are the reference's.  The CSV and npz
readers and the sharded (out-of-core) sets are not ported yet
(ROADMAP.md §1 item 5).
"""

from __future__ import annotations

from typing import Callable, Iterator, Mapping, Sequence

import numpy as np


class Dataset:
    """Immutable dict of aligned columns."""

    def __init__(self, columns: Mapping[str, np.ndarray]):
        if not columns:
            raise ValueError("Dataset needs at least one column")
        cols = {k: np.asarray(v) for k, v in columns.items()}
        n = {len(v) for v in cols.values()}
        if len(n) != 1:
            raise ValueError(
                f"column lengths differ: "
                f"{ {k: len(v) for k, v in cols.items()} }")
        self._columns = cols
        self._num_rows = n.pop()

    # -- basic accessors ---------------------------------------------------

    @property
    def columns(self) -> dict[str, np.ndarray]:
        return dict(self._columns)

    @property
    def column_names(self) -> list[str]:
        return list(self._columns)

    def __len__(self) -> int:
        return self._num_rows

    def __getitem__(self, name: str) -> np.ndarray:
        return self._columns[name]

    def __contains__(self, name: str) -> bool:
        return name in self._columns

    def __repr__(self) -> str:
        shapes = {k: v.shape for k, v in self._columns.items()}
        return f"Dataset(rows={self._num_rows}, columns={shapes})"

    # -- DataFrame-shaped verbs -------------------------------------------

    def select(self, names: Sequence[str]) -> "Dataset":
        return Dataset({k: self._columns[k] for k in names})

    def with_column(self, name: str, values: np.ndarray) -> "Dataset":
        cols = self.columns
        cols[name] = np.asarray(values)
        return Dataset(cols)

    def drop(self, *names: str) -> "Dataset":
        return Dataset(
            {k: v for k, v in self._columns.items() if k not in names})

    def rename(self, mapping: Mapping[str, str]) -> "Dataset":
        return Dataset(
            {mapping.get(k, k): v for k, v in self._columns.items()})

    def filter(self, mask: np.ndarray) -> "Dataset":
        mask = np.asarray(mask, dtype=bool)
        return Dataset({k: v[mask] for k, v in self._columns.items()})

    def map_column(self, name: str,
                   fn: Callable[[np.ndarray], np.ndarray],
                   out: str | None = None) -> "Dataset":
        return self.with_column(out or name, fn(self._columns[name]))

    def take(self, n: int) -> "Dataset":
        return Dataset({k: v[:n] for k, v in self._columns.items()})

    def shuffle(self, seed: int = 0) -> "Dataset":
        perm = np.random.default_rng(seed).permutation(self._num_rows)
        return Dataset({k: v[perm] for k, v in self._columns.items()})

    def train_test_split(self, test_fraction: float = 0.2,
                         seed: int = 0) -> tuple["Dataset", "Dataset"]:
        """Shuffled ``(train, test)`` split, the JAX package's rows for
        the same seed.  Both parts are non-empty or this raises."""
        if not 0.0 < test_fraction < 1.0:
            raise ValueError(
                f"test_fraction must be in (0, 1), got {test_fraction}")
        n_test = int(round(self._num_rows * test_fraction))
        if n_test == 0 or n_test == self._num_rows:
            raise ValueError(
                f"split of {self._num_rows} rows at {test_fraction} "
                f"leaves an empty part")
        perm = np.random.default_rng(seed).permutation(self._num_rows)
        cols = self._columns
        return (Dataset({k: v[perm[n_test:]] for k, v in cols.items()}),
                Dataset({k: v[perm[:n_test]] for k, v in cols.items()}))

    def concat(self, other: "Dataset") -> "Dataset":
        if set(self.column_names) != set(other.column_names):
            raise ValueError("column sets differ")
        return Dataset({k: np.concatenate([v, other[k]])
                        for k, v in self._columns.items()})

    # -- partitioning (the Spark repartition analogue) --------------------

    def shard(self, num_shards: int, index: int,
              drop_remainder: bool = True) -> "Dataset":
        """Rows of shard ``index`` out of ``num_shards`` (contiguous split,
        equal sizes when ``drop_remainder``)."""
        if not 0 <= index < num_shards:
            raise ValueError(f"index {index} not in [0, {num_shards})")
        per = self._num_rows // num_shards
        if per == 0:
            raise ValueError(
                f"{self._num_rows} rows cannot fill {num_shards} shards")
        start = index * per
        stop = start + per if drop_remainder else (
            self._num_rows if index == num_shards - 1 else start + per)
        return Dataset({k: v[start:stop]
                        for k, v in self._columns.items()})

    def repartition(self, num_shards: int) -> list["Dataset"]:
        return [self.shard(num_shards, i) for i in range(num_shards)]

    # -- batching ----------------------------------------------------------

    def batches(self, batch_size: int, *, columns: Sequence[str]
                | None = None, drop_remainder: bool = True,
                ) -> Iterator[dict[str, np.ndarray]]:
        cols = ({k: self._columns[k] for k in columns}
                if columns else self._columns)
        stop = ((self._num_rows // batch_size) * batch_size
                if drop_remainder else self._num_rows)
        for start in range(0, stop, batch_size):
            yield {k: v[start:start + batch_size]
                   for k, v in cols.items()}

    def num_batches(self, batch_size: int,
                    drop_remainder: bool = True) -> int:
        if drop_remainder:
            return self._num_rows // batch_size
        return -(-self._num_rows // batch_size)
