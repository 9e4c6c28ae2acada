"""Out-of-core training data: a dataset backed by shard files, the
port's copy of ``distkeras_tpu/data/sharded.py`` (numpy only, so the
same code and, for the same seed, the same epoch plan shard for shard
and row for row).

``ShardedDataset`` holds a *list of shard files* plus their row counts
(read from the npy headers, not the data) and materializes one shard at
a time.  Trainers iterate ``epoch_segments`` — shard files in a
seed-permuted order, rows shuffled within each shard ("shuffle what
fits", the standard out-of-core approximation of a global shuffle) — so
peak host memory is one shard, not the dataset.

With a single shard file the epoch is bit-identical to the in-memory
path (same ``Dataset.shuffle(seed)`` permutation), the equivalence
contract ``tests/test_torch_sharded_data.py`` pins.
"""

from __future__ import annotations

import glob as _glob
import zipfile
from typing import Iterator, Sequence

import numpy as np

from distkeras_tpu_torch.data.dataset import Dataset


def _npz_column_meta(path: str) -> dict[str, tuple[tuple, np.dtype]]:
    """Column name -> (shape, dtype) from an npz's member headers —
    reads a few hundred bytes per member, never the array data."""
    from numpy.lib import format as npf

    meta = {}
    with zipfile.ZipFile(path) as z:
        for name in z.namelist():
            if not name.endswith(".npy"):
                continue
            with z.open(name) as fh:
                version = npf.read_magic(fh)
                if version == (1, 0):
                    shape, _, dtype = npf.read_array_header_1_0(fh)
                else:
                    shape, _, dtype = npf.read_array_header_2_0(fh)
            meta[name[:-4]] = (shape, dtype)
    return meta


class ShardedDataset:
    """A list of ``.npz`` shard files acting as one logical dataset.

    Construct via ``Dataset.from_npz_shards(pattern)`` or directly from
    paths.  Header metadata (row counts, columns, dtypes) is read
    eagerly and validated for consistency; array data is loaded one
    shard at a time by ``load_shard`` / ``epoch_segments``.
    """

    def __init__(self, paths: Sequence[str]):
        paths = [str(p) for p in paths]
        if not paths:
            raise ValueError("ShardedDataset needs at least one shard")
        self.paths = paths
        metas = [_npz_column_meta(p) for p in paths]
        names = set(metas[0])
        for p, m in zip(paths[1:], metas[1:]):
            if set(m) != names:
                raise ValueError(
                    f"shard {p} has columns {sorted(m)}, expected "
                    f"{sorted(names)} (from {paths[0]})")
            for k in names:
                if m[k][0][1:] != metas[0][k][0][1:]:
                    raise ValueError(
                        f"shard {p} column {k!r} has row shape "
                        f"{m[k][0][1:]}, expected {metas[0][k][0][1:]}")
        self._column_names = sorted(names)
        self.shard_rows = []
        for p, m in zip(paths, metas):
            counts = {v[0][0] for v in m.values()}
            if len(counts) != 1:
                raise ValueError(
                    f"shard {p}: column lengths differ: "
                    f"{ {k: v[0][0] for k, v in m.items()} }")
            self.shard_rows.append(counts.pop())

    # -- metadata ----------------------------------------------------------

    @property
    def column_names(self) -> list[str]:
        return list(self._column_names)

    @property
    def num_shards(self) -> int:
        return len(self.paths)

    def __len__(self) -> int:
        return int(sum(self.shard_rows))

    def __repr__(self) -> str:
        return (f"ShardedDataset(shards={self.num_shards}, "
                f"rows={len(self)}, columns={self._column_names})")

    # -- materialization ---------------------------------------------------

    def load_shard(self, index: int) -> Dataset:
        return Dataset.from_npz(self.paths[index])

    def to_dataset(self) -> Dataset:
        """Materialize everything (small sets / tests only)."""
        out = self.load_shard(0)
        for i in range(1, self.num_shards):
            out = out.concat(self.load_shard(i))
        return out

    def map(self, fn) -> "ShardedDataset":
        """A view whose shards pass through ``fn(Dataset) -> Dataset``
        at load time — the out-of-core seam for per-shard ETL (e.g. a
        fitted ``Pipeline.transform`` or an ``AssembleTransformer``,
        fit on a sample shard).  ``fn`` must preserve the row count:
        the epoch plan (resume fast-skip, round prediction) is computed
        from the raw shard metadata."""
        return _MappedShards(self, fn)

    def epoch_segment_loaders(self, seed: int = 0):
        """The epoch plan without the data: yields ``(rows, load)``
        pairs in the seed-permuted shard order, where ``rows`` comes
        from the header metadata and ``load()`` materializes that
        segment (shuffled).  Lets a resuming trainer skip whole shard
        files it has already consumed without reading them."""
        rng = np.random.default_rng(seed)
        order = (rng.permutation(self.num_shards)
                 if self.num_shards > 1 else [0])
        for slot, i in enumerate(order):
            # per-shard seed keeps distinct shards from sharing a
            # permutation; hashing (seed, slot, shard) through
            # SeedSequence avoids the additive-salt collisions where
            # nearby epoch seeds alias across (slot, shard) pairs.
            # Shard count 1 must keep the plain seed for the
            # bit-identity contract with the in-memory path.
            if self.num_shards == 1:
                s = seed
            else:
                s = int(np.random.SeedSequence(
                    [seed % (1 << 63), slot, int(i)]
                ).generate_state(1, dtype=np.uint64)[0])
            yield (int(self.shard_rows[int(i)]),
                   lambda idx=int(i), s=s:
                   self.load_shard(idx).shuffle(seed=s))

    def epoch_segments(self, seed: int = 0) -> Iterator[Dataset]:
        """One training epoch as a stream of in-memory ``Dataset``
        segments: shard files in a seed-permuted order, rows shuffled
        within each shard.  Deterministic in ``seed``; with one shard
        this is exactly ``[full.shuffle(seed)]`` (the in-memory
        trainers' epoch), so single-shard training is bit-identical to
        in-memory training."""
        for _, load in self.epoch_segment_loaders(seed):
            yield load()


class _MappedShards(ShardedDataset):
    """``ShardedDataset.map``'s view: same shard plan, transformed
    loads."""

    def __init__(self, base: ShardedDataset, fn):
        self._base = base
        self._fn = fn
        self.paths = list(base.paths)
        self.shard_rows = list(base.shard_rows)
        # pre-transform names; the transformed columns exist per loaded
        # segment (fn may add/drop columns)
        self._column_names = base.column_names

    def load_shard(self, index: int) -> Dataset:
        out = self._fn(self._base.load_shard(index))
        if len(out) != self.shard_rows[index]:
            raise ValueError(
                f"map fn changed shard {index}'s row count "
                f"({self.shard_rows[index]} -> {len(out)}); the epoch "
                f"plan requires row-preserving transforms")
        return out


class CsvShardedDataset(ShardedDataset):
    """Out-of-core CSV: a list of delimited text files acting as one
    logical dataset — the reference's Criteo/ATLAS ingestion shape
    (Spark read CSVs per partition).  Row counts come from a line scan
    (no parsing); shard 0 is additionally parsed up front as the
    schema anchor, so header mismatches, duplicate columns, and
    non-numeric surprises fail at construction.  Later shards are
    validated against the anchor at load time: row counts must match
    the line scan, dtypes must match shard 0 (integer columns are
    widened to a float anchor automatically; anything else — e.g. a
    stray non-numeric token turning a column into strings — raises
    naming the shard and column).
    """

    def __init__(self, paths: Sequence[str], *, delimiter: str = ",",
                 header: bool = True,
                 names: Sequence[str] | None = None):
        paths = [str(p) for p in paths]
        if not paths:
            raise ValueError("CsvShardedDataset needs at least one "
                             "shard")
        self.paths = paths
        self._delimiter = delimiter
        self._header = header
        if not header and names is None:
            raise ValueError("header=False needs explicit names=")
        self._names = list(names) if names is not None else None
        self.shard_rows = []
        first_header: str | None = None
        for p in paths:
            rows = 0
            seen_header = False
            with open(p) as fh:
                for line in fh:
                    if not line.strip():
                        continue
                    if header and not seen_header:
                        # header = first NON-BLANK line, matching
                        # Dataset.from_csv's reader
                        seen_header = True
                        if first_header is None:
                            first_header = line.strip()
                        elif line.strip() != first_header:
                            raise ValueError(
                                f"shard {p} header {line.strip()!r} "
                                f"differs from {paths[0]}'s "
                                f"{first_header!r}")
                        continue
                    rows += 1
            if rows == 0:
                raise ValueError(f"shard {p} has no data rows")
            self.shard_rows.append(rows)
        # shard 0 is the schema anchor: parsing it here surfaces
        # duplicate columns, ragged rows, and the per-column dtypes
        anchor = self._parse(0)
        if len(anchor) != self.shard_rows[0]:
            raise ValueError(
                f"shard {paths[0]}: line scan found "
                f"{self.shard_rows[0]} data rows but the parser "
                f"yielded {len(anchor)}")
        self._dtypes = {k: v.dtype for k, v in anchor.columns.items()}
        self._column_names = sorted(anchor.column_names)

    def _parse(self, index: int) -> Dataset:
        return Dataset.from_csv(self.paths[index],
                                delimiter=self._delimiter,
                                header=self._header,
                                names=self._names)

    def load_shard(self, index: int) -> Dataset:
        out = self._parse(index)
        if len(out) != self.shard_rows[index]:
            raise ValueError(
                f"shard {self.paths[index]}: line scan found "
                f"{self.shard_rows[index]} data rows but the parser "
                f"yielded {len(out)}")
        cols = out.columns
        for k, want in self._dtypes.items():
            got = cols[k].dtype
            if got == want:
                continue
            if np.issubdtype(want, np.floating) \
                    and np.issubdtype(got, np.integer):
                # a shard whose values happen to all be
                # integer-formatted: widen to the float anchor so every
                # segment feeds the step the same dtype
                cols[k] = cols[k].astype(want)
                continue
            if got.kind == want.kind:
                if want.kind in "USO":
                    # string columns whose longest token differs per
                    # shard (<U2 vs <U5), the normal categorical
                    # shape; transformers hash or index per value,
                    # width is irrelevant
                    continue
                # same-kind numeric width drift (int32 vs an int64
                # anchor, say) would change the step's input dtype per
                # shard — cast to the anchor, but never silently: a
                # narrowing cast that changes any value is data
                # corruption, not schema alignment
                cast = cols[k].astype(want)
                if not np.array_equal(cast.astype(got), cols[k]):
                    raise ValueError(
                        f"shard {self.paths[index]} column {k!r} "
                        f"parsed as {got} with values that do not fit "
                        f"shard 0's anchor dtype {want}")
                cols[k] = cast
                continue
            raise ValueError(
                f"shard {self.paths[index]} column {k!r} parsed as "
                f"{got}, but shard 0 anchors it as {want} (a "
                f"non-numeric token turns a numeric column into "
                f"strings; clean the file or pre-bucket it)")
        return Dataset(cols)


def _resolve_paths(pattern_or_paths) -> list[str]:
    if isinstance(pattern_or_paths, (list, tuple)):
        return [str(p) for p in pattern_or_paths]
    paths = sorted(_glob.glob(str(pattern_or_paths)))
    if not paths:
        raise ValueError(f"no files match {pattern_or_paths!r}")
    return paths


def from_csv_shards(pattern_or_paths, *, delimiter: str = ",",
                    header: bool = True,
                    names: Sequence[str] | None = None
                    ) -> CsvShardedDataset:
    """``Dataset.from_csv_shards``: out-of-core dataset over delimited
    text files (glob pattern, sorted, or explicit path list)."""
    return CsvShardedDataset(_resolve_paths(pattern_or_paths),
                             delimiter=delimiter, header=header,
                             names=names)


def from_npz_shards(pattern_or_paths) -> ShardedDataset:
    """``Dataset.from_npz_shards``: build a ShardedDataset from a glob
    pattern (sorted) or an explicit path list."""
    return ShardedDataset(_resolve_paths(pattern_or_paths))


def to_npz_shards(dataset: Dataset, prefix: str,
                  rows_per_shard: int) -> list[str]:
    """Split ``dataset`` into ``.npz`` shard files
    ``{prefix}-00000.npz, ...``; returns the paths (the writer side of
    ``from_npz_shards``, used by tests/examples)."""
    if rows_per_shard < 1:
        raise ValueError(f"rows_per_shard must be >= 1, got "
                         f"{rows_per_shard}")
    n = len(dataset)
    paths = []
    for idx, start in enumerate(range(0, n, rows_per_shard)):
        part = Dataset({k: v[start:start + rows_per_shard]
                        for k, v in dataset.columns.items()})
        paths.append(part.to_npz(f"{prefix}-{idx:05d}.npz"))
    return paths
