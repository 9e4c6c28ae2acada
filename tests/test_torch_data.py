"""The port's data readers, writers and ETL transformers against the JAX
package's on the same files and the same numpy inputs: ``from_csv`` on
both lanes (names, dtypes and values exactly), npz files and shards
written by either package read by the other, and every transformer's
fit and transform equal, the hash buckets bit for bit."""

import numpy as np
import pytest

from distkeras_tpu import native as jax_native
from distkeras_tpu.data import Dataset as JaxDataset
from distkeras_tpu.data import ShardedDataset as JaxShardedDataset
from distkeras_tpu.data import datasets as jax_datasets
from distkeras_tpu.data import transformers as jax_tf
from distkeras_tpu_torch import native
from distkeras_tpu_torch.data import Dataset, ShardedDataset, datasets
from distkeras_tpu_torch.data import transformers as tf

LANES = ["c", "python"]


def _lane(monkeypatch, lane):
    if lane == "python":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jax_native, "available", lambda: False)


def _same(ours, theirs):
    assert ours.column_names == theirs.column_names
    for k in theirs.column_names:
        assert ours[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


FILES = {
    "typed.csv": "id,score,cat\n1,0.5,a\n2,1.5,b\n3,-2.0,a\n",
    "quoted.csv": 'a,b\n1,"x,y"\n2,"plain"\n',
    "hex.csv": "a,b,c\n0x1a,1_000,7\n0X2,2,8\n",
    "blank_first.csv": "\n\nx,label\n1.5,0\n\n2.5,1\n",
    "overflow.csv": "id\n12345678901234567890123\n1\n",
    "crlf.csv": "a,b\r\n1,2\r\n3,4.5\r\n",
    "unicode.csv": "k,v\nünï,1\nab,2\n",
}


@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("name", sorted(FILES))
def test_from_csv_matches_jax(monkeypatch, tmp_path, name, lane):
    p = tmp_path / name
    p.write_text(FILES[name])
    _lane(monkeypatch, lane)
    _same(Dataset.from_csv(str(p)), JaxDataset.from_csv(str(p)))


@pytest.mark.parametrize("lane", LANES)
def test_from_csv_options_match_jax(monkeypatch, tmp_path, lane):
    _lane(monkeypatch, lane)
    q = tmp_path / "t.tsv"
    q.write_text("1\tx\n2\ty\n")
    kw = dict(delimiter="\t", header=False, names=["n", "s"])
    _same(Dataset.from_csv(str(q), **kw), JaxDataset.from_csv(str(q), **kw))
    p = tmp_path / "h.csv"
    p.write_text("a,b\n1,2\n")
    _same(Dataset.from_csv(str(p), names=["x", "y"]),
          JaxDataset.from_csv(str(p), names=["x", "y"]))
    # a multi-byte delimiter goes down the csv.reader lane, which
    # refuses it in both packages alike
    m = tmp_path / "multi.csv"
    m.write_text("a||b\n1||2\n")
    with pytest.raises(TypeError) as theirs:
        JaxDataset.from_csv(str(m), delimiter="||")
    with pytest.raises(TypeError) as ours:
        Dataset.from_csv(str(m), delimiter="||")
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("body,kw", [
    ("a,b\n1,2\n3\n", {}),                 # ragged
    ("a,b\n", {}),                         # header only
    ("", {}),                              # empty
    ("a,a\n1,2\n", {}),                    # duplicate names
    ("1,2\n", {"header": False}),          # no names
])
def test_from_csv_errors_match_jax(monkeypatch, tmp_path, lane, body, kw):
    p = tmp_path / "bad.csv"
    p.write_text(body)
    _lane(monkeypatch, lane)
    with pytest.raises(ValueError) as theirs:
        JaxDataset.from_csv(str(p), **kw)
    with pytest.raises(ValueError) as ours:
        Dataset.from_csv(str(p), **kw)
    assert str(ours.value) == str(theirs.value)


def test_undecodable_header_takes_the_python_lane(tmp_path):
    """The C lane hands a header it cannot decode to the csv.reader
    lane, which raises the same error in both packages."""
    p = tmp_path / "bytes.csv"
    p.write_bytes(b"\xff\xfe,b\n1,2\n")
    native.reset_counts()
    with pytest.raises(UnicodeDecodeError) as theirs:
        JaxDataset.from_csv(str(p))
    with pytest.raises(UnicodeDecodeError) as ours:
        Dataset.from_csv(str(p))
    assert str(ours.value) == str(theirs.value)
    assert native.calls["parse_csv"] == 0


def test_quoted_file_takes_the_python_lane(tmp_path):
    p = tmp_path / "q.csv"
    p.write_text('a,b\n1,"x,y"\n')
    native.reset_counts()
    assert Dataset.from_csv(str(p))["b"].tolist() == ["x,y"]
    assert native.calls["parse_csv"] == 0


def test_npz_written_by_either_package_reads_in_the_other(tmp_path):
    ours = datasets.criteo_synth(64, num_dense=3, num_categorical=2,
                                 vocab_size=10, seed=0)
    theirs = jax_datasets.criteo_synth(64, num_dense=3, num_categorical=2,
                                       vocab_size=10, seed=0)
    _same(ours, theirs)
    a = ours.to_npz(str(tmp_path / "ours"))
    b = theirs.to_npz(str(tmp_path / "theirs"))
    assert a.endswith(".npz") and b.endswith(".npz")
    _same(JaxDataset.from_npz(a), ours)
    _same(Dataset.from_npz(b), ours)
    with pytest.raises(ValueError, match="file"):
        Dataset({"file": np.zeros(2)}).to_npz(str(tmp_path / "f"))


def test_npz_shards_cross_read(tmp_path):
    full = datasets.synthetic_classification(100, (3,), 4, seed=1)
    ours = full.to_npz_shards(str(tmp_path / "o"), rows_per_shard=32)
    theirs = jax_datasets.synthetic_classification(
        100, (3,), 4, seed=1).to_npz_shards(str(tmp_path / "t"),
                                            rows_per_shard=32)
    assert [p.rsplit("/", 1)[1] for p in ours] == [
        f"o-{i:05d}.npz" for i in range(4)]
    for mine, other in ((ShardedDataset(theirs), JaxShardedDataset(ours)),
                        (Dataset.from_npz_shards(str(tmp_path / "t-*.npz")),
                         JaxDataset.from_npz_shards(str(tmp_path
                                                        / "o-*.npz")))):
        assert mine.shard_rows == other.shard_rows == [32, 32, 32, 4]
        assert mine.column_names == other.column_names
        _same(mine.to_dataset(), other.to_dataset())
        _same(mine.to_dataset(), full)


def _criteo(pkg, rows=300):
    return pkg.criteo_synth(rows, num_dense=4, num_categorical=3,
                            vocab_size=40, seed=2)


def _stages(mod):
    """Every transformer class, built the same way in either package."""
    return [
        ("hash", mod.HashBucketTransformer("c1", 17)),
        ("minmax", mod.MinMaxTransformer("dense", new_min=-1.0,
                                         new_max=2.0)),
        ("standard", mod.StandardScaleTransformer("dense", "dense_std")),
        ("label", mod.LabelIndexTransformer("c0")),
        ("assemble", mod.AssembleTransformer(["dense", "label"])),
        ("reshape", mod.ReshapeTransformer("dense", (2, 2), "dense_img")),
    ]


@pytest.mark.parametrize("lane", LANES)
@pytest.mark.parametrize("stage", [s for s, _ in _stages(tf)])
def test_each_transformer_matches_jax(monkeypatch, lane, stage):
    _lane(monkeypatch, lane)
    ours = dict(_stages(tf))[stage]
    theirs = dict(_stages(jax_tf))[stage]
    a = ours.fit_transform(_criteo(datasets))
    b = theirs.fit_transform(_criteo(jax_datasets))
    _same(a, b)
    for attr in ("classes_", "min_", "max_", "mean_", "std_"):
        if getattr(theirs, attr, None) is not None:
            np.testing.assert_array_equal(getattr(ours, attr),
                                          getattr(theirs, attr))


@pytest.mark.parametrize("lane", LANES)
def test_one_hot_dense_and_pipeline_match_jax(monkeypatch, lane):
    _lane(monkeypatch, lane)
    rng = np.random.default_rng(3)
    cols = {"idx": rng.integers(0, 5, 40),
            "si": rng.integers(-1, 9, (40, 3)),
            "sv": rng.normal(size=(40, 3)).astype(np.float32)}
    for mod, pkg in ((tf, Dataset), (jax_tf, JaxDataset)):
        ds = pkg(cols)
        cols_out = mod.Pipeline([
            mod.OneHotTransformer("idx", 5),
            mod.DenseTransformer("si", "sv", dim=9, output_col="dv"),
        ]).fit_transform(ds)
        if mod is tf:
            ours = cols_out
        else:
            _same(ours, cols_out)
    with pytest.raises(ValueError, match="outside"):
        tf.OneHotTransformer("idx", 3).transform(Dataset(cols))


def test_criteo_pipeline_matches_jax_bit_for_bit():
    """The baseline's ETL: min-max, hash buckets, assemble; fitted on one
    part, applied to another."""
    def run(mod, pkg):
        data = pkg.criteo_synth(400, num_dense=4, num_categorical=5,
                                vocab_size=300, seed=4)
        etl = mod.Pipeline(
            [mod.MinMaxTransformer("dense")]
            + [mod.HashBucketTransformer(f"c{j}", 97) for j in range(5)]
            + [mod.AssembleTransformer(
                ["dense"] + [f"c{j}_bucket" for j in range(5)])])
        etl.fit(data.take(100))
        return etl.transform(data)

    _same(run(tf, datasets), run(jax_tf, jax_datasets))


def test_hash_bucket_vectorized_matches_scalar():
    col = np.array(["a", "bb", "", "ünï", "cat_7"] * 3)
    h = tf.HashBucketTransformer._fnv1a_vectorized(col)
    want = [tf.HashBucketTransformer._fnv1a(v.encode("utf-8")) for v in col]
    np.testing.assert_array_equal(h, np.asarray(want, np.uint64))
    np.testing.assert_array_equal(
        h, jax_tf.HashBucketTransformer._fnv1a_vectorized(col))


def test_unfitted_transformers_raise():
    ds = Dataset({"x": np.arange(4.0)})
    for t in (tf.MinMaxTransformer("x"), tf.StandardScaleTransformer("x"),
              tf.LabelIndexTransformer("x")):
        with pytest.raises(RuntimeError, match="fit"):
            t.transform(ds)
    fitted = tf.LabelIndexTransformer("x").fit(ds)
    with pytest.raises(ValueError, match="unseen"):
        fitted.transform(Dataset({"x": np.array([9.0])}))
