"""Loader for the port's native columnar kernels (``csrc/columnar.cpp``),
the port's copy of ``distkeras_tpu/native.py``.

Builds the shared library with the system C++ compiler (``g++ -O3
-shared -fPIC -std=c++17``) on first use, into ``_native_build/`` beside
this file, the file name keyed by a hash of the source, and binds four
entry points through ``ctypes``: ``fnv1a_bucket``, ``affine_scale``,
``parse_csv`` and ``dense_scatter``.  Each has a numpy lane (the plain
version) in ``data/transformers.py`` or ``Dataset.from_csv``;
``available()`` gates the C lane, and ``DISTKERAS_TPU_DISABLE_NATIVE=1``
(the JAX package's switch, so one variable governs both packages)
forces the numpy lanes.  The library is host code: it runs on the CPU
beside the trainer, on the card's machine as here.

``calls`` counts the C-lane calls per entry point (one per call that
entered the library), as the kernels' wrappers count their launches;
``reset_counts()`` zeroes them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "columnar.cpp"
_BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_native_build"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_failed: str | None = None

ENTRY_POINTS = ("fnv1a_bucket", "affine_scale", "parse_csv",
                "dense_scatter")
#: C-lane calls per entry point since the last ``reset_counts()``
calls = dict.fromkeys(ENTRY_POINTS, 0)
_count_lock = threading.Lock()


def _note(name: str) -> None:
    # the segment-prefetch thread parses while the trainer buckets
    with _count_lock:
        calls[name] += 1


def reset_counts() -> None:
    with _count_lock:
        for k in calls:
            calls[k] = 0


def _compiler() -> str | None:
    for cc in ("g++", "clang++", "c++"):
        if shutil.which(cc):
            return cc
    return None


def library_path() -> pathlib.Path:
    """Where the library for the current source lives (built or not)."""
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    return _BUILD_DIR / f"columnar-{tag}.so"


def _build() -> ctypes.CDLL:
    out = library_path()
    if not out.exists():
        cc = _compiler()
        if cc is None:
            raise RuntimeError("no C++ compiler on PATH")
        _BUILD_DIR.mkdir(exist_ok=True)
        # per-process temporary name: concurrent builders (test workers)
        # never write the same inode; the rename makes the last one win
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        subprocess.run(
            [cc, "-O3", "-shared", "-fPIC", "-std=c++17",
             str(_SRC), "-o", str(tmp)],
            check=True, capture_output=True, text=True)
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


def _load() -> ctypes.CDLL | None:
    global _lib, _failed
    if _lib is not None or _failed is not None:
        return _lib
    with _lock:
        if _lib is not None or _failed is not None:
            return _lib
        if os.environ.get("DISTKERAS_TPU_DISABLE_NATIVE") == "1":
            _failed = "disabled by DISTKERAS_TPU_DISABLE_NATIVE"
            return None
        try:
            lib = _build()
        except subprocess.CalledProcessError as e:
            _failed = (f"native build unavailable: {e}\n"
                       f"{e.stderr}")  # the compiler's diagnostic
            return None
        except (RuntimeError, OSError) as e:
            _failed = f"native build unavailable: {e}"
            return None
        lib.fnv1a_bucket.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p]
        lib.affine_scale.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.dense_scatter.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        lib.csv_index.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_char, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.csv_index.restype = ctypes.c_int64
        lib.csv_parse_numeric.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.csv_parse_numeric.restype = ctypes.c_int64
        lib.csv_fill_bytes.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def why_unavailable() -> str | None:
    _load()
    return _failed


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def fnv1a_bucket(fixed_width_bytes: np.ndarray, lengths: np.ndarray,
                 num_buckets: int) -> np.ndarray:
    """FNV-1a bucket ids for a numpy ``S``-dtype array (one hash per
    row over its real bytes)."""
    lib = _load()
    assert lib is not None, "check available() first"
    s = np.ascontiguousarray(fixed_width_bytes)
    width = s.dtype.itemsize
    n = len(s)
    mat = s.view(np.uint8).reshape(n, width)  # zero-copy
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    out = np.empty(n, dtype=np.int32)
    _note("fnv1a_bucket")
    lib.fnv1a_bucket(_ptr(mat), n, width, _ptr(lengths),
                     ctypes.c_uint64(num_buckets), _ptr(out))
    return out


def affine_scale(col: np.ndarray, scale: np.ndarray,
                 shift: np.ndarray) -> np.ndarray:
    """``col * scale + shift`` column-wise; ``col`` is float32
    ``[N, ...]`` (trailing dims flattened), scale/shift float64 per
    column."""
    lib = _load()
    assert lib is not None, "check available() first"
    col = np.ascontiguousarray(col, dtype=np.float32)
    rows = col.shape[0]
    cols = int(np.prod(col.shape[1:])) if col.ndim > 1 else 1
    # per-column statistics of an [N, 28, 28] column arrive shaped
    # (28, 28); the kernel is flat per trailing element
    scale = np.ascontiguousarray(np.broadcast_to(
        np.asarray(scale, np.float64).ravel(), (cols,)))
    shift = np.ascontiguousarray(np.broadcast_to(
        np.asarray(shift, np.float64).ravel(), (cols,)))
    out = np.empty_like(col)
    _note("affine_scale")
    lib.affine_scale(_ptr(col), rows, cols, _ptr(scale), _ptr(shift),
                     _ptr(out))
    return out


def parse_csv(data: bytes, skip: int, delimiter: str,
              names: list[str]) -> dict[str, np.ndarray]:
    """Tokenize and type a delimited text buffer (the GIL released inside
    the C calls).  ``data[skip:]`` holds the data rows; each column comes
    back int64 / float32 / unicode exactly as ``Dataset.from_csv``'s
    Python lane types it.  Raises ``ValueError`` on ragged rows."""
    lib = _load()
    assert lib is not None, "check available() first"
    _note("parse_csv")
    cols = len(names)
    buf = np.frombuffer(data, dtype=np.uint8)  # zero-copy view
    max_rows = max(data.count(b"\n", skip) + 1, 1)
    off = np.empty(max_rows * cols, dtype=np.int64)
    lens = np.empty(max_rows * cols, dtype=np.int32)
    rows = lib.csv_index(_ptr(buf), len(data), skip,
                         delimiter.encode(), cols, _ptr(off),
                         _ptr(lens))
    if rows < 0:
        raise ValueError(
            f"row at data line {-rows} does not have {cols} fields")
    if rows == 0:
        raise ValueError("no data rows")
    out: dict[str, np.ndarray] = {}
    iout = np.empty(rows, dtype=np.int64)
    fout = np.empty(rows, dtype=np.float64)
    for c, name in enumerate(names):
        verdict = lib.csv_parse_numeric(_ptr(buf), _ptr(off),
                                        _ptr(lens), rows, cols, c,
                                        _ptr(iout), _ptr(fout))
        if verdict == 0:
            out[name] = iout.copy()
        elif verdict == 1:
            out[name] = fout.astype(np.float32)
        else:
            width = max(
                int(lens[:rows * cols].reshape(rows, cols)[:, c].max()),
                1)
            raw = np.empty(rows, dtype=f"S{width}")
            lib.csv_fill_bytes(_ptr(buf), _ptr(off), _ptr(lens),
                               rows, cols, c, width,
                               _ptr(raw.view(np.uint8)))
            try:
                out[name] = raw.astype(f"U{width}")
            except UnicodeDecodeError:
                # non-ASCII bytes: decode per cell (numpy's bytes->str
                # cast is ASCII-only)
                out[name] = np.asarray(
                    [v.decode() for v in raw.tolist()])
    return out


def dense_scatter(indices: np.ndarray, values: np.ndarray,
                  dim: int) -> np.ndarray:
    """Padded ``(indices, values)`` rows -> dense ``[N, dim]`` float32
    (a pad index < 0 is ignored)."""
    lib = _load()
    assert lib is not None, "check available() first"
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    val = np.ascontiguousarray(values, dtype=np.float32)
    if idx.size and idx.max() >= dim:
        # the numpy lane raises IndexError here: malformed sparse data
        # fails loudly on both lanes
        raise IndexError(
            f"sparse index {int(idx.max())} out of bounds for dim {dim}")
    rows, nnz = idx.shape
    out = np.zeros((rows, dim), dtype=np.float32)
    _note("dense_scatter")
    lib.dense_scatter(_ptr(idx), _ptr(val), rows, nnz, dim, _ptr(out))
    return out
