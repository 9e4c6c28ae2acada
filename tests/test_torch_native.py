"""The port's native columnar library (``distkeras_tpu_torch/native.py``,
``csrc/columnar.cpp``): its four entry points against the numpy lanes
and against the JAX package's own library on the same inputs, the same
errors on both lanes, the C-lane counters, the shared disable switch,
and the whole ETL surface working with the library disabled.

Both libraries build with ``g++`` here (the CPU the ETL runs on is the
host's, on the card's machine as here).  The JAX package's library is
only read by these tests."""

import numpy as np
import pytest

from distkeras_tpu import native as jax_native
from distkeras_tpu.data import Dataset as JaxDataset
from distkeras_tpu_torch import native
from distkeras_tpu_torch.data import datasets
from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.data.transformers import (
    DenseTransformer,
    HashBucketTransformer,
    MinMaxTransformer,
    StandardScaleTransformer,
)


@pytest.fixture
def libs():
    """Both packages' libraries, built on first use (decided here, not
    at import, so every test worker collects the same tests)."""
    if not (native.available() and jax_native.available()):
        pytest.skip(f"native kernels unavailable: "
                    f"{native.why_unavailable()} / "
                    f"{jax_native.why_unavailable()}")


needs_native = pytest.mark.usefixtures("libs")


def _numpy_lane(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)


VALUES = np.array(["cat_1", "", "a", "longer_categorical_value_42",
                   "cat_1", "ünïcode"], dtype=object)


@needs_native
@pytest.mark.parametrize("buckets", [1, 1000, 2 ** 31 - 1])
def test_fnv1a_bucket_matches_scalar_numpy_and_jax(buckets):
    s = np.char.encode(VALUES.astype(str), "utf-8")
    lengths = np.char.str_len(s)
    got = native.fnv1a_bucket(s, lengths, buckets)
    scalar = [HashBucketTransformer._fnv1a(str(v).encode("utf-8"))
              % buckets for v in VALUES]
    vectorized = (HashBucketTransformer._fnv1a_vectorized(VALUES)
                  % np.uint64(buckets)).astype(np.int32)
    np.testing.assert_array_equal(got, scalar)
    np.testing.assert_array_equal(got, vectorized)
    np.testing.assert_array_equal(
        got, jax_native.fnv1a_bucket(s, lengths, buckets))
    assert got.dtype == np.int32 and got[0] == got[4]


@needs_native
def test_affine_scale_matches_numpy_and_jax():
    rng = np.random.default_rng(0)
    col = rng.normal(size=(257, 5)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, size=5)
    shift = rng.normal(size=5)
    got = native.affine_scale(col, scale, shift)
    want = (col.astype(np.float64) * scale + shift).astype(np.float32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, jax_native.affine_scale(col, scale, shift))
    # a 1-D column with scalar statistics, a 3-D one with per-element
    col1 = rng.normal(size=64).astype(np.float32)
    np.testing.assert_array_equal(native.affine_scale(col1, 2.0, -1.0),
                                  jax_native.affine_scale(col1, 2.0, -1.0))
    col3 = rng.normal(size=(8, 3, 2)).astype(np.float32)
    s3 = rng.uniform(size=(3, 2))
    np.testing.assert_array_equal(native.affine_scale(col3, s3, -s3),
                                  jax_native.affine_scale(col3, s3, -s3))


@needs_native
def test_dense_scatter_matches_numpy_and_jax(monkeypatch):
    rng = np.random.default_rng(1)
    idx = rng.integers(-1, 16, size=(128, 6))
    val = rng.normal(size=(128, 6)).astype(np.float32)
    got = native.dense_scatter(idx, val, 16)
    np.testing.assert_array_equal(got,
                                  jax_native.dense_scatter(idx, val, 16))
    ds = Dataset({"indices": idx, "values": val})
    t = DenseTransformer("indices", "values", dim=16)
    fast = t.transform(ds)["features"]
    _numpy_lane(monkeypatch)
    np.testing.assert_array_equal(fast, t.transform(ds)["features"])
    np.testing.assert_array_equal(fast, got)


@needs_native
def test_dense_scatter_raises_on_both_lanes(monkeypatch):
    idx = np.array([[0, 7]], np.int64)
    val = np.ones((1, 2), np.float32)
    ds = Dataset({"i": idx, "v": val})
    with pytest.raises(IndexError):
        native.dense_scatter(idx, val, 4)
    _numpy_lane(monkeypatch)
    with pytest.raises(IndexError):
        DenseTransformer("i", "v", dim=4).transform(ds)


CSV_BODY = ("a,b,c,d,e\n"
            "1,1.5,tok_1,3,99999999999999999999\n"
            "2,2.5,tok_22,,12\n"
            "\n"
            "-3, -7 ,x9,0x1A,-4\n"
            "4,8e2,t,nan,1")


@needs_native
@pytest.mark.parametrize("ending", ["lf", "crlf"])
def test_parse_csv_matches_python_lane_and_jax(monkeypatch, tmp_path,
                                               ending):
    """Typing and values of every column: int64/float32/strings, blank
    lines, CRLF, whitespace, empty cells, hex strictness, int64
    overflow falling to float, no trailing newline."""
    p = tmp_path / "t.csv"
    if ending == "lf":
        p.write_text(CSV_BODY)
    else:
        p.write_bytes(CSV_BODY.replace("\n", "\r\n").encode() + b"\r\n")
    raw = p.read_bytes()
    names = ["a", "b", "c", "d", "e"]
    skip = raw.index(b"\n") + 1
    c_cols = native.parse_csv(raw, skip, ",", names)
    jax_cols = jax_native.parse_csv(raw, skip, ",", names)
    native.reset_counts()
    fast = Dataset.from_csv(str(p))
    assert native.calls["parse_csv"] == 1
    _numpy_lane(monkeypatch)
    slow = Dataset.from_csv(str(p))
    assert native.calls["parse_csv"] == 1
    for k in names:
        for other in (jax_cols[k], fast[k], slow[k]):
            assert c_cols[k].dtype == other.dtype, k
            np.testing.assert_array_equal(c_cols[k], other)
    assert c_cols["a"].dtype == np.int64
    assert c_cols["b"].dtype == np.float32
    assert c_cols["c"].dtype.kind == c_cols["d"].dtype.kind == "U"
    assert c_cols["e"].dtype == np.float32


@needs_native
@pytest.mark.parametrize("lane", ["c", "python"])
def test_csv_errors_match_the_jax_package(monkeypatch, tmp_path, lane):
    cases = {"r.csv": ("a,b\n1,2\n3\n", "fields"),
             "h.csv": ("a,b\n", "no data rows"),
             "dup.csv": ("a,a\n1,2\n", "duplicate")}
    if lane == "python":
        _numpy_lane(monkeypatch)
        monkeypatch.setattr(jax_native, "available", lambda: False)
    for name, (body, match) in cases.items():
        p = tmp_path / name
        p.write_text(body)
        with pytest.raises(ValueError, match=match) as ours:
            Dataset.from_csv(str(p))
        with pytest.raises(ValueError, match=match) as theirs:
            JaxDataset.from_csv(str(p))
        assert str(ours.value) == str(theirs.value)


@needs_native
def test_transformers_c_lane_equals_numpy_lane(monkeypatch):
    """The Criteo ETL surface gives the same table through both lanes,
    and the C lane's counters see each call."""
    data = datasets.criteo_synth(512, num_dense=4, num_categorical=3,
                                 vocab_size=50, seed=0)
    hb = HashBucketTransformer("c0", 37)
    mm = MinMaxTransformer("dense")
    ss = StandardScaleTransformer("dense", output_col="dense_std")
    native.reset_counts()
    fast = ss.fit_transform(mm.fit_transform(hb.transform(data)))
    assert native.calls == {"fnv1a_bucket": 1, "affine_scale": 2,
                            "parse_csv": 0, "dense_scatter": 0}
    _numpy_lane(monkeypatch)
    slow = ss.fit_transform(mm.fit_transform(hb.transform(data)))
    assert native.calls["affine_scale"] == 2
    np.testing.assert_array_equal(fast["c0_bucket"], slow["c0_bucket"])
    np.testing.assert_allclose(fast["dense"], slow["dense"],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(fast["dense_std"], slow["dense_std"],
                               rtol=1e-6, atol=1e-6)


def test_disable_switch_is_the_jax_packages(monkeypatch):
    """``DISTKERAS_TPU_DISABLE_NATIVE=1`` turns the port's C lane off,
    as it does the JAX package's."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", None)
    monkeypatch.setenv("DISTKERAS_TPU_DISABLE_NATIVE", "1")
    assert not native.available()
    assert "DISTKERAS_TPU_DISABLE_NATIVE" in native.why_unavailable()


def test_library_is_keyed_by_the_source():
    path = native.library_path()
    assert path.parent.name == "_native_build"
    assert path.name.startswith("columnar-") and path.suffix == ".so"
    if native.available():
        assert path.exists()


def test_everything_works_without_native(monkeypatch, tmp_path):
    """The whole ETL surface with the library disabled."""
    _numpy_lane(monkeypatch)
    native.reset_counts()
    data = datasets.criteo_synth(256, num_dense=3, num_categorical=2,
                                 vocab_size=20, seed=1)
    out = MinMaxTransformer("dense").fit_transform(
        HashBucketTransformer("c0", 10).transform(data))
    assert out["c0_bucket"].dtype == np.int32
    assert out["dense"].min() >= 0.0 and out["dense"].max() <= 1.0
    p = tmp_path / "x.csv"
    p.write_text("x,y\n1,a\n2,b\n")
    assert Dataset.from_csv(str(p))["x"].tolist() == [1, 2]
    assert sum(native.calls.values()) == 0
