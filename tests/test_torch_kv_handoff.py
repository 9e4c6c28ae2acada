"""The KV-block handoff between the packages (f32, same weights): both
packers give the same bytes for the same host arrays; a JAX engine's
export, packed, unpacked by the port and imported, makes the port's
tokens equal the JAX monolithic engine's, and the same holds from the
port to the JAX engine; a stale ``weights_ver`` is rejected; a malformed
frame raises.  Segments go in the flax cache tree's flatten order, which
is lexicographic in the block names (``Block_10`` before ``Block_2``)."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from distkeras_tpu.models import ModelSpec
from distkeras_tpu.models import model_config as jax_config
from distkeras_tpu.serving import DecodeEngine as JaxEngine
from distkeras_tpu.serving import pack_kv_blocks as jax_pack
from distkeras_tpu.serving import unpack_kv_blocks as jax_unpack
from distkeras_tpu_torch import DecodeEngine, build_model, convert
from distkeras_tpu_torch.models import model_config
from distkeras_tpu_torch.serving import pack_kv_blocks, unpack_kv_blocks

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)

MAXLEN, VOCAB, ALIGN = 32, 37, 4


def _pair(**kw):
    base = {"vocab_size": VOCAB, "num_layers": 2, "d_model": 32,
            "num_heads": 2, "max_len": MAXLEN, "dtype": "float32", **kw}
    jmodel = ModelSpec.from_config(jax_config(
        "transformer_lm", (MAXLEN,), input_dtype="int32", **base)).build()
    variables = jmodel.init(jax.random.key(0),
                            jnp.zeros((2, MAXLEN), jnp.int32))
    port = build_model(model_config("transformer_lm", (MAXLEN,),
                                    input_dtype="int32", **base),
                       device="cpu").eval()
    port.load_state_dict(convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"])))
    return jmodel, variables, port


@pytest.fixture(scope="module")
def lm():
    return _pair()


def _kw():
    return dict(slots=2, prefill_align=ALIGN, prefix_cache_bytes=1 << 24)


def _prompts(seed=4):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, VOCAB, (12,)).astype(np.int32)
    return (np.concatenate([head, [1, 2, 3]]).astype(np.int32),
            np.concatenate([head, rng.integers(0, VOCAB, (6,))]
                           ).astype(np.int32))


def _wire(parts) -> bytes:
    return b"".join(bytes(p) for p in parts)


def test_packers_give_equal_bytes():
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, VOCAB, (9,)).astype(np.int32)
    for dtype in (np.float32, ml_dtypes.bfloat16, np.int8):
        blocks = [[rng.standard_normal((1, 2, 4, 16)).astype(dtype),
                   rng.standard_normal((1, 2, 4, 1)).astype(np.float32)]
                  for _ in range(2)]
        export = {"prompt": prompt, "n_blocks": 2, "weights_ver": 3,
                  "blocks": blocks}
        wire = _wire(jax_pack(export))
        assert _wire(pack_kv_blocks(export)) == wire
        got = unpack_kv_blocks(wire)
        assert got["weights_ver"] == 3 and got["n_blocks"] == 2
        np.testing.assert_array_equal(got["prompt"], prompt)
        # host tensors pack to the same bytes (bf16 through its uint16 view)
        assert _wire(pack_kv_blocks(got)) == wire
        assert got["blocks"][0][0].dtype == {
            np.float32: torch.float32, ml_dtypes.bfloat16: torch.bfloat16,
            np.int8: torch.int8}[dtype]
    assert _wire(pack_kv_blocks({"prompt": prompt, "blocks": []})) \
        == _wire(jax_pack({"prompt": prompt, "blocks": []}))


def test_jax_export_imports_into_the_port(lm):
    jmodel, variables, port = lm
    head, tail = _prompts()
    src = JaxEngine(jmodel, variables, **_kw())
    list(src.run([{"prompt": head, "max_new_tokens": 2}]))
    export = unpack_kv_blocks(_wire(jax_pack(src.export_prefix(tail))))
    assert export["n_blocks"] == 3
    dst = DecodeEngine(port, **_kw())
    assert dst.import_prefix(export["prompt"], export["blocks"],
                             weights_ver=export["weights_ver"]) == 3
    assert dst.match_blocks(tail) == 3
    (got,) = dst.run([{"prompt": tail, "max_new_tokens": 6}])
    (want,) = JaxEngine(jmodel, variables, slots=2, prefill_align=ALIGN
                        ).run([{"prompt": tail, "max_new_tokens": 6}])
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert dst.prefix_stats()["hits"] == 1
    assert dst.prefix_stats()["tokens_saved"] == 12


def test_port_export_imports_into_jax(lm):
    jmodel, variables, port = lm
    head, tail = _prompts(seed=5)
    src = DecodeEngine(port, **_kw())
    list(src.run([{"prompt": head, "max_new_tokens": 2}]))
    export = src.export_prefix(tail)
    assert export["n_blocks"] == 3 and len(export["blocks"][0]) == 4
    got = jax_unpack(_wire(pack_kv_blocks(export)))
    dst = JaxEngine(jmodel, variables, **_kw())
    assert dst.import_prefix(got["prompt"], got["blocks"],
                             weights_ver=got["weights_ver"]) == 3
    (res,) = dst.run([{"prompt": tail, "max_new_tokens": 6}])
    (want,) = JaxEngine(jmodel, variables, slots=2, prefill_align=ALIGN
                        ).run([{"prompt": tail, "max_new_tokens": 6}])
    np.testing.assert_array_equal(res["tokens"], want["tokens"])
    assert dst.prefix_stats()["hits"] == 1
    # the port's own round trip, and into a paged engine (page == block)
    again = DecodeEngine(port, kv_pages=16, **_kw())
    back = unpack_kv_blocks(_wire(pack_kv_blocks(export)))
    assert again.import_prefix(back["prompt"], back["blocks"]) == 3
    (res,) = again.run([{"prompt": tail, "max_new_tokens": 6}])
    np.testing.assert_array_equal(res["tokens"], want["tokens"])
    assert again.free_pages() == 16


def test_segments_follow_the_flax_flatten_order():
    """Twelve layers: the export's leaves go Block_0, Block_1, Block_10,
    Block_11, Block_2, ..., each block's key then value, as the JAX
    engine's."""
    jmodel, variables, port = _pair(num_layers=12, d_model=16)
    head, tail = _prompts()
    src = JaxEngine(jmodel, variables, **_kw())
    list(src.run([{"prompt": head, "max_new_tokens": 1}]))
    jexp = src.export_prefix(tail)
    eng = DecodeEngine(port, **_kw())
    list(eng.run([{"prompt": head, "max_new_tokens": 1}]))
    pexp = eng.export_prefix(tail)
    assert len(pexp["blocks"][0]) == len(jexp["blocks"][0]) == 24
    for js, ps in zip(jexp["blocks"][1], pexp["blocks"][1]):
        np.testing.assert_allclose(ps.numpy(), np.asarray(js), atol=1e-5)
    # the fifth leaf (after Block_0's and Block_1's key and value) is
    # layer 10's key rows of block 1 (slot 0 still holds the finished
    # request's rows)
    torch.testing.assert_close(
        pexp["blocks"][1][4],
        eng._pools[0].cache.keys[10][:1, :, ALIGN:2 * ALIGN], rtol=0,
        atol=0)


def test_stale_weights_ver_is_rejected(lm):
    jmodel, variables, port = lm
    head, tail = _prompts()
    src = DecodeEngine(port, **_kw())
    list(src.run([{"prompt": head, "max_new_tokens": 2}]))
    export = src.export_prefix(tail)
    dst = DecodeEngine(port, **_kw())
    dst.swap_variables(dict(dst.variables))  # weights_ver 1
    assert dst.import_prefix(tail, export["blocks"],
                             weights_ver=export["weights_ver"]) == 0
    assert dst.match_blocks(tail) == 0
    assert dst.import_prefix(tail, export["blocks"], weights_ver=1) == 3
    with pytest.raises(ValueError, match="do not match"):
        DecodeEngine(port, **_kw()).import_prefix(
            tail, [[s[:, :1] for s in export["blocks"][0]]])


def test_malformed_frame_raises(lm):
    _, _, port = lm
    head, tail = _prompts()
    src = DecodeEngine(port, **_kw())
    list(src.run([{"prompt": head, "max_new_tokens": 2}]))
    wire = _wire(pack_kv_blocks(src.export_prefix(tail)))
    for bad, match in ((b"X" + wire[1:], "not a kv"),
                       (wire[:5], "not a kv"),
                       (wire[:1] + (10 ** 9).to_bytes(8, "big") + wire[9:],
                        "meta overruns"),
                       (wire[:-7], "overruns"),
                       (wire + b"\0", "length mismatch")):
        with pytest.raises(ValueError, match=match):
            unpack_kv_blocks(bad)
