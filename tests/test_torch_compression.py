"""The port's commit codecs (``parallel/compression.py``) against the JAX
package's: for f32 and f64 deltas, each codec's encoded bytes are equal
(top-k ties included: the same ``np.argpartition`` selection), each
side decodes the other's bytes to bit-equal leaves, and the per-shard
round trip splits and reassembles alike.  The port's bfloat16 rounding
is held against ``ml_dtypes`` (the JAX side's cast), NaN and infinities
included."""

import jax
import ml_dtypes
import numpy as np
import pytest

from distkeras_tpu.parallel import compression as jax_codecs
from distkeras_tpu.parallel.sharded_ps import plan_shards as jax_plan
from distkeras_tpu_torch.parallel import compression
from distkeras_tpu_torch.parallel.trees import tree_leaves

jax.config.update("jax_platforms", "cpu")

SPECS = ["int8", "bfloat16", "topk", "topk:0.25", "topk:1.0"]


def _delta(dtype, seed=0):
    rng = np.random.default_rng(seed)
    ties = np.array([0.5, -0.5, 0.5, 0.25, -0.5, 0.5, 0.0, 0.5], dtype)
    return {"Dense_1": {"kernel": (0.01 * rng.standard_normal((12, 5)))
                        .astype(dtype),
                        "bias": ties},
            "Dense_0": {"kernel": (0.01 * rng.standard_normal((7, 12)))
                        .astype(dtype),
                        "bias": np.zeros(12, dtype)}}


def _assert_leaves_equal(got, want):
    got, want = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("spec", SPECS)
def test_encoded_bytes_equal_the_jax_packages(spec, dtype):
    tree = _delta(dtype)
    port, ref = compression.resolve_codec(spec), jax_codecs.resolve_codec(
        spec)
    assert port.name == ref.name
    data = port.encode(tree)
    assert data == ref.encode(tree)
    # each side reads the other's bytes into the same leaves
    _assert_leaves_equal(port.decode(data, tree), ref.decode(data, tree))
    _, applied = port.round_trip(tree)
    _assert_leaves_equal(applied, ref.round_trip(tree)[1])


@pytest.mark.parametrize("spec", ["int8", "bfloat16", "topk:0.5"])
def test_round_trip_shards_match_the_jax_packages(spec):
    tree = _delta(np.float32, seed=1)
    plan = jax_plan(jax.tree_util.tree_map(np.asarray, tree), 2)
    port, ref = compression.resolve_codec(spec), jax_codecs.resolve_codec(
        spec)
    datas, applied = port.round_trip_shards(tree, plan)
    want_datas, want_applied = ref.round_trip_shards(tree, plan)
    assert datas == want_datas
    _assert_leaves_equal(applied, want_applied)


def test_bf16_rounding_is_ml_dtypes():
    rng = np.random.default_rng(2)
    x = np.concatenate([
        rng.standard_normal(4096).astype(np.float32) * 1e3,
        # halfway cases both ways, the top of the range, the specials
        np.array([1.00390625, 1.01171875, -1.00390625, 3.3895314e38,
                  3.4e38, np.inf, -np.inf, np.nan, -np.nan, 0.0, -0.0,
                  1e-40, -1e-45], np.float32)])
    want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(compression.bf16_words(x), want)


def test_raw_nbytes_and_resolution():
    tree = _delta(np.float64)
    assert compression.raw_nbytes(tree) == jax_codecs.raw_nbytes(tree)
    assert compression.resolve_codec(None) is None
    codec = compression.Int8Codec()
    assert compression.resolve_codec(codec) is codec
    assert isinstance(compression.resolve_codec("bf16"),
                      compression.Bf16Codec)
    assert compression.resolve_codec("topk:0.1").fraction == 0.1
    with pytest.raises(KeyError, match="unknown compression"):
        compression.resolve_codec("zip")
    with pytest.raises(TypeError):
        compression.resolve_codec(3)
    with pytest.raises(ValueError, match="fraction"):
        compression.TopKCodec(0.0)
    with pytest.raises(ValueError, match="leaves"):
        codec.decode_leaves(codec.encode_leaves([np.ones(2)]),
                            [np.ones(2), np.ones(3)])
