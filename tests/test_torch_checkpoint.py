"""The port's msgpack codec, checkpoint files, PS snapshots and
parameter serialization against the JAX package's (flax's encoding).

The codec's bytes equal ``flax.serialization``'s byte for byte on the
same trees, and it decodes flax's bytes to the same values.  Checkpoint
files, PS snapshots and serialized parameters cross in both directions;
the trainers' files are held in ``test_torch_checkpoint_cross.py``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as flax_ser

from distkeras_tpu import checkpoint as jax_ckpt
from distkeras_tpu import utils as jax_utils
from distkeras_tpu.models import ModelSpec
from distkeras_tpu.models import model_config as jax_config
from distkeras_tpu_torch import checkpoint, convert, serialization, utils

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a).view(np.int16).copy()) \
        .view(torch.bfloat16)


def _trees():
    rng = np.random.default_rng(0)
    bf = np.asarray(rng.standard_normal((3, 5)), jnp.bfloat16)
    arrays = {
        "f32": rng.standard_normal((4, 3)).astype(np.float32),
        "f16": rng.standard_normal((7,)).astype(np.float16),
        "i32": np.arange(-300, 300, 7, dtype=np.int32),
        "u32": np.array([0, 1, 2 ** 32 - 1], np.uint32),
        "bool": np.array([True, False, True]),
        "zero_d": np.array(2.5, np.float32),
        "empty": np.zeros((0, 3), np.float32)}
    scalars = {"small": 1, "neg": -33, "u8": 200, "u16": 60000,
               "u32": 2 ** 31, "u64": 2 ** 40, "i16": -200, "i32": -70000,
               "i64": -2 ** 40, "float": 0.1, "true": True, "false": False,
               "none": None, "np_f32": np.float32(3.5),
               "np_u64": np.uint64(2 ** 63), "np_i8": np.int8(-4),
               "complex": 1 - 2j, "short": "x", "long": "y" * 300,
               "bytes": b"\x00\x01" * 200}
    nested = {"b": {"d": {"x": np.ones((2, 2), np.float32)}, "a": [1, 2]},
              "list": [np.float32(1), [2, "three"], {"k": np.int32(4)}],
              "tuple": (np.zeros(3, np.float32), 5)}
    wide = {f"k{i}": i for i in range(40)}
    return {"arrays": (arrays, arrays),
            "bf16": ({"w": bf, "s": np.asarray(1.5, jnp.bfloat16)},
                     {"w": _bf16(bf), "s": _bf16(np.asarray(1.5,
                                                            jnp.bfloat16))}),
            "scalars": (scalars, scalars), "nested": (nested, nested),
            "wide": (wide, wide)}


TREES = _trees()


def _same(got, want, path="."):
    """Equal trees: dict keys in order, leaves of equal type/dtype and
    bits; a torch bf16 leaf against flax's bf16 numpy array."""
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}/{i}")
    elif isinstance(got, torch.Tensor):
        assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
        assert np.array_equal(got.view(torch.int16).numpy(),
                              np.asarray(want).view(np.int16)), path
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, path
        assert got.shape == want.shape, path
        assert np.array_equal(got, want, equal_nan=True), path
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("name", sorted(TREES))
def test_codec_bytes_equal_flax(name):
    """``to_bytes`` and ``msgpack_serialize`` (lists kept; tuples
    refused, as under strict types) equal flax's byte for byte, and the
    port decodes flax's bytes to flax's own values."""
    ref, port = TREES[name]
    want = flax_ser.to_bytes(ref)
    assert serialization.to_bytes(port) == want
    _same(serialization.msgpack_restore(want), flax_ser.msgpack_restore(want))
    plain = {k: v for k, v in ref.items() if k != "tuple"}
    plain_port = {k: v for k, v in port.items() if k != "tuple"}
    want = flax_ser.msgpack_serialize(plain)
    assert serialization.msgpack_serialize(plain_port) == want
    _same(serialization.msgpack_restore(want), flax_ser.msgpack_restore(want))
    if name == "nested":
        with pytest.raises(TypeError, match="tuple"):
            serialization.msgpack_serialize(port)


def test_codec_chunks_large_leaves_as_flax(monkeypatch):
    """Leaves above ``MAX_CHUNK_SIZE`` (set small on both sides) are
    written and read in flax's chunked form."""
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(1)
    bf = np.asarray(rng.standard_normal((9, 11)), jnp.bfloat16)
    ref = {"big": rng.standard_normal((10, 7)).astype(np.float32),
           "small": np.arange(4, dtype=np.int32),
           "inner": {"bf": bf, "odd": np.arange(33, dtype=np.int64)}}
    port = {**ref, "inner": {"bf": _bf16(bf), "odd": ref["inner"]["odd"]}}
    want = flax_ser.to_bytes(ref)
    assert serialization.to_bytes(port) == want
    assert b"__msgpack_chunked_array__" in want
    _same(serialization.msgpack_restore(want), flax_ser.msgpack_restore(want))


def test_codec_takes_tensors_in_one_host_copy():
    """Tensor leaves (grad-carrying, non-contiguous, bool) give the
    bytes of their numpy values."""
    w = torch.randn(3, 4, requires_grad=True)
    tree = {"w": w, "t": w.detach().T, "b": torch.tensor([True, False]),
            "i": torch.arange(5, dtype=torch.int32)}
    ref = {k: v.detach().numpy().copy() for k, v in tree.items()}
    assert serialization.to_bytes(tree) == flax_ser.to_bytes(ref)
    host = serialization.to_host(tree)
    assert all(isinstance(v, np.ndarray) for v in host.values())


def test_from_state_dict_follows_flax():
    state = {"a": np.ones(2), "b": {"0": 1, "1": 2}, "extra": 3}
    got = serialization.from_state_dict({"a": 0, "b": [0, 0]}, state)
    assert got["b"] == [1, 2] and set(got) == {"a", "b"}
    with pytest.raises(ValueError, match="do not match"):
        serialization.from_state_dict({"missing": 0}, state)


def test_checkpoint_paths_and_cursor(tmp_path):
    """A dotted directory is a directory; an explicit ``.msgpack`` file
    gets its parents; writes leave no ``.tmp``; each package reads the
    other's file, and the JAX loader ignores the port's stream entry."""
    state = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
             "key": np.array([0, 7], np.uint32)}
    dotted = tmp_path / "runs" / "v1.5"
    dotted.mkdir(parents=True)
    written = checkpoint.save_checkpoint(dotted, state, {"epoch": 1},
                                         streams={"rng": None,
                                                  "commit_orders": 3})
    assert written.endswith("ckpt_latest.msgpack")
    assert not list(dotted.glob("*.tmp"))
    loaded, cursor = jax_ckpt.load_checkpoint(
        dotted, {"w": np.zeros((2, 3), np.float32),
                 "key": jax.random.key(0)})
    assert cursor == {"epoch": 1}
    np.testing.assert_array_equal(loaded["w"], state["w"])
    assert np.array_equal(jax.random.key_data(loaded["key"]), state["key"])
    got, cursor, streams = checkpoint.load_checkpoint(dotted, streams=True)
    assert streams == {"rng": None, "commit_orders": 3}
    _same(got, state)

    explicit = tmp_path / "out" / "model.msgpack"
    jax_ckpt.save_checkpoint(explicit, {"w": np.ones(3, np.float32),
                                        "key": jax.random.key(5)},
                             {"epoch": 2})
    got, cursor, streams = checkpoint.load_checkpoint(explicit, streams=True)
    assert cursor == {"epoch": 2} and streams is None
    np.testing.assert_array_equal(got["key"], np.array([0, 5], np.uint32))
    assert checkpoint.save_checkpoint(explicit, got, cursor) == str(explicit)
    with pytest.raises(ValueError, match="do not match"):
        checkpoint.load_checkpoint(explicit, {"absent": 0})
    # a key leaf holds a seed as jax.random.key holds it
    assert np.array_equal(jax.random.key_data(jax.random.key(9)),
                          convert.seed_key(9))
    key = convert.seed_key(2 ** 40 + 9)
    gen = convert.stream_from_key(key)
    assert gen.initial_seed() == 2 ** 40 + 9
    assert np.array_equal(convert.stream_key(gen), key)


def _snapshot(sharded: bool):
    center = {"Dense_0": {"kernel": np.arange(6, dtype=np.float32)
                          .reshape(2, 3), "bias": np.zeros(3, np.float32)}}
    reply = {"0": {"seq": 4, "center": np.ones(2, np.float32)},
             "1": {"seq": np.uint64(2 ** 63)}}
    if not sharded:
        return {"center": center, "num_commits": 7, "epoch": 2,
                "last_reply": reply, "clock": np.int32(7)}
    shard = {"num_commits": 7, "last_reply": reply}
    other = {"num_commits": 7, "last_reply": {"0": {"seq": 3}}}
    return {"center": center, "sharded": 2, "shards": [shard, other]}


@pytest.mark.parametrize("sharded", [False, True])
def test_ps_snapshots_cross_byte_for_byte(tmp_path, sharded):
    snap = _snapshot(sharded)
    ours = checkpoint.save_ps_snapshot(tmp_path / "a" / "ps.snap", snap)
    theirs = jax_ckpt.save_ps_snapshot(tmp_path / "b" / "ps.snap", snap)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    assert not list((tmp_path / "a").glob("*.tmp"))
    _same(checkpoint.load_ps_snapshot(theirs), jax_ckpt.load_ps_snapshot(
        ours))
    assert checkpoint.ps_snapshot_info(theirs) == \
        jax_ckpt.ps_snapshot_info(ours)
    _same(checkpoint.ps_snapshot_center(theirs),
          jax_ckpt.ps_snapshot_center(str(ours)))
    with pytest.raises(ValueError, match="not a PS snapshot"):
        checkpoint.ps_snapshot_center({"clock": 1})


LM = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=4,
          num_kv_heads=2, max_len=16, dtype="float32")


@pytest.mark.parametrize("family", ["mlp", "resnet", "transformer_lm"])
def test_serialize_params_crosses(family):
    """``serialize_params`` of the port's parameters is the JAX
    package's bytes of the same parameters (a JAX tree, keys in order);
    ``deserialize_params`` reads either package's bytes."""
    if family == "mlp":
        spec, sample = jax_config("mlp", (8,), num_classes=4,
                                  hidden=(16, 16)), jnp.zeros((2, 8))
    elif family == "resnet":
        spec = jax_config("resnet", (16, 16, 3), num_classes=4,
                          stage_sizes=(1, 1), width=8, norm="group_pallas")
        sample = jnp.zeros((2, 16, 16, 3))
    else:
        spec = jax_config("transformer_lm", (16,), input_dtype="int32",
                          **LM)
        sample = jnp.zeros((2, 16), jnp.int32)
    model = ModelSpec.from_config(spec).build()
    if family == "transformer_lm":
        model = model.clone(attn="dense")
    params = jax.tree_util.tree_map(
        np.asarray, model.init(jax.random.key(1), sample)["params"])
    heads = LM["num_heads"] if family == "transformer_lm" else None
    sd = convert.params_from_flax(params)
    want = jax_utils.serialize_params(params)
    assert utils.serialize_params(sd, num_heads=heads) == want
    back = utils.deserialize_params(sd, want)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    got = jax_utils.deserialize_params(params, utils.serialize_params(
        sd, num_heads=heads))
    _same(jax.tree_util.tree_map(np.asarray, got), params)
    with pytest.raises(ValueError, match="template"):
        utils.deserialize_params({"other": torch.zeros(1)}, want)


def test_model_config_and_helpers_match_jax():
    cfg = jax_config("mlp", (8,), num_classes=4, hidden=(16,))
    text = utils.serialize_model_config(cfg)
    assert text == jax_utils.serialize_model_config(cfg)
    assert utils.deserialize_model_config(text) == json.loads(text)
    labels = np.array([0, 3, 1])
    np.testing.assert_array_equal(utils.to_dense_vector(labels, 4),
                                  jax_utils.to_dense_vector(labels, 4))
    with pytest.raises(ValueError, match="labels must be in"):
        utils.to_dense_vector([4], 4)
    cols = {"a": np.arange(10), "b": np.arange(10) * 2}
    for k, v in utils.shuffle(cols, seed=3).items():
        np.testing.assert_array_equal(v, jax_utils.shuffle(cols, seed=3)[k])
    for drop in (True, False):
        got = list(utils.batch_iterator(cols, 4, drop_remainder=drop))
        want = list(jax_utils.batch_iterator(cols, 4, drop_remainder=drop))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["a"], w["a"])
    x = np.ones((5, 2))
    np.testing.assert_array_equal(utils.pad_to_multiple(x, 4),
                                  jax_utils.pad_to_multiple(x, 4))
    a = {"w": torch.tensor([3.0, 4.0]), "b": torch.tensor([[1.0]])}
    assert utils.tree_dot(a, a).item() == 26.0
    assert utils.tree_l2_norm(a).item() == pytest.approx(26.0 ** 0.5)
    assert utils.tree_size(a) == 3
    assert utils.tree_cast(a, torch.bfloat16)["w"].dtype == torch.bfloat16
