"""``Dataset``: a named-column table with DataFrame-shaped verbs.

The port's copy of ``distkeras_tpu/data/dataset.py`` (numpy only, so
the same code): columns are numpy arrays
aligned on the row axis, and ``shuffle`` draws the same permutation from
the same seed, so a trainer of either package sees its batches in the
same order.  ``shard``/``repartition`` split the rows as the JAX
package does, so a PS trainer of either package gives each worker the
same rows.  The in-memory verbs (``drop``, ``rename``, ``filter``,
``train_test_split``, ``concat``) are the reference's, as are the
readers and writers: ``from_csv`` (the C lane of ``native.parse_csv``,
or the ``csv.reader`` lane, typed alike), ``from_npz``/``to_npz``, and
the out-of-core sets of ``data/sharded.py`` (``from_npz_shards``,
``from_csv_shards``, ``to_npz_shards``).
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

    # -- IO ---------------------------------------------------------------

    @classmethod
    def from_csv(cls, path, *, delimiter: str = ",",
                 header: bool = True,
                 names: Sequence[str] | None = None) -> "Dataset":
        """Read a delimited text file into typed columns.

        The reference ingested CSVs through Spark's reader (its Criteo/
        ATLAS notebooks); here each column is auto-typed: all-numeric
        columns become f32 (ints stay int64), anything else a numpy
        string column — ready for ``LabelIndexTransformer`` /
        ``HashBucketTransformer``.  ``names`` overrides or supplies the
        column names (required when ``header=False``); plain unquoted
        CSV/TSV only.  Numeric means plain decimal spellings: hex
        (``0x1a``) and digit-underscore (``1_000``) tokens type as
        strings on both parse paths.

        When the native kernels are available
        (``distkeras_tpu_torch.native``), tokenizing and type conversion
        run in C with the GIL released — both faster and overlappable by
        the out-of-core segment-prefetch thread; the Python path below
        is the semantic reference and the fallback.
        """
        from distkeras_tpu_torch import native as _native

        with open(path, "rb") as fh:
            raw = fh.read()

        if (_native.available() and len(delimiter) == 1
                and delimiter.isascii() and b'"' not in raw):
            # a quote character anywhere sends the whole file down the
            # csv.reader lane: the C tokenizer is plain-split and would
            # otherwise silently disagree on quoted fields
            ds = cls._from_csv_native(raw, path, delimiter, header,
                                      names)
            if ds is not None:
                return ds

        import csv as _csv
        import io as _io

        reader = _csv.reader(_io.StringIO(raw.decode(), newline=""),
                             delimiter=delimiter)
        rows = [row for row in reader if row]
        if not rows:
            raise ValueError(f"{path}: empty file")
        if header:
            file_names, rows = rows[0], rows[1:]
            names = list(names) if names is not None else file_names
        elif names is None:
            raise ValueError("header=False needs explicit names=")
        else:
            names = list(names)
        if not rows:
            raise ValueError(f"{path}: no data rows")
        widths = {len(r) for r in rows}
        if widths != {len(names)}:
            raise ValueError(
                f"{path}: rows have {sorted(widths)} fields, "
                f"expected {len(names)}")
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(
                f"{path}: duplicate column name(s) {sorted(dupes)}")

        def typed(values: list[str]) -> np.ndarray:
            # underscore/hex spellings type as strings (int("1_0")
            # would accept them; the native lane cannot — both lanes
            # are strict so they agree)
            plain = not any("_" in v or "x" in v or "X" in v
                            for v in values)
            if plain:
                try:
                    return np.asarray([int(v) for v in values],
                                      dtype=np.int64)
                except (ValueError, OverflowError):
                    # OverflowError: ids past int64 fall through to the
                    # float/string paths instead of crashing
                    pass
                try:
                    return np.asarray([float(v) for v in values],
                                      dtype=np.float32)
                except ValueError:
                    pass
            return np.asarray(values)

        return cls({name: typed([r[c] for r in rows])
                    for c, name in enumerate(names)})

    @classmethod
    def _from_csv_native(cls, raw: bytes, path, delimiter: str,
                         header: bool, names):
        """C parse lane (see ``native.parse_csv``); returns ``None`` to
        fall back to the csv.reader lane when the buffer needs it
        (undecodable header bytes; the caller already routes quoted
        files away)."""
        from distkeras_tpu_torch import native as _native

        # header = first non-blank line, parsed in Python (names need
        # decoding anyway); data region starts after it
        skip = 0
        if header:
            while skip < len(raw):
                eol = raw.find(b"\n", skip)
                if eol < 0:
                    eol = len(raw)
                line = raw[skip:eol].rstrip(b"\r")
                if line:
                    try:
                        file_names = line.decode().split(delimiter)
                    except UnicodeDecodeError:
                        return None  # csv.reader lane handles encoding
                    skip = eol + 1
                    break
                skip = eol + 1
            else:
                raise ValueError(f"{path}: empty file")
            names = (list(names) if names is not None
                     else [n for n in file_names])
        elif names is None:
            raise ValueError("header=False needs explicit names=")
        else:
            names = list(names)
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(
                f"{path}: duplicate column name(s) {sorted(dupes)}")
        try:
            cols = _native.parse_csv(raw, skip, delimiter, names)
        except ValueError as e:
            if "fields" in str(e):
                raise ValueError(f"{path}: {e}") from None
            raise ValueError(f"{path}: no data rows") from None
        return cls(cols)

    @classmethod
    def from_npz(cls, path) -> "Dataset":
        """Read an ``.npz`` archive: each array becomes a column."""
        with np.load(path) as archive:
            return cls({k: np.asarray(archive[k])
                        for k in archive.files})

    @classmethod
    def from_npz_shards(cls, pattern_or_paths):
        """Out-of-core dataset over many ``.npz`` shard files (glob
        pattern or path list) — returns a ``ShardedDataset`` that
        trainers stream one shard at a time (``data/sharded.py``)."""
        from distkeras_tpu_torch.data.sharded import from_npz_shards

        return from_npz_shards(pattern_or_paths)

    @classmethod
    def from_csv_shards(cls, pattern_or_paths, *, delimiter: str = ",",
                        header: bool = True, names=None):
        """Out-of-core dataset over many delimited text files — the
        reference's Criteo/ATLAS ingestion shape, streamed one file at
        a time (``data/sharded.py``)."""
        from distkeras_tpu_torch.data.sharded import from_csv_shards

        return from_csv_shards(pattern_or_paths, delimiter=delimiter,
                               header=header, names=names)

    def to_npz_shards(self, prefix, rows_per_shard: int) -> list[str]:
        """Write this dataset as ``.npz`` shard files readable by
        ``from_npz_shards``; returns the paths."""
        from distkeras_tpu_torch.data.sharded import to_npz_shards

        return to_npz_shards(self, prefix, rows_per_shard)

    def to_npz(self, path) -> str:
        """Write all columns to an ``.npz`` archive (the format the
        examples' ``--data-npz`` flag reads).  Returns the actual file
        path (numpy appends ``.npz`` when missing).  A column named
        ``file`` is rejected — it collides with ``np.savez``'s
        parameter and cannot be stored by keyword."""
        if "file" in self._columns:
            raise ValueError(
                "cannot write a column named 'file' to npz (collides "
                "with np.savez's parameter); rename() it first")
        path = str(path)
        if not path.endswith(".npz"):
            path += ".npz"
        np.savez(path, **self._columns)
        return path

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
