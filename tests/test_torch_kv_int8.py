"""The int8 KV cache of the port against the JAX package's: the
quantizer bit for bit (round half to even on both sides), a GQA model's
decode logits against flax's within 1e-5 of their rms (f32, same
weights), and the int8 engine's tokens per request equal to the JAX int8
engine's and to the port's int8 ``generate()``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import ModelSpec
from distkeras_tpu.models import model_config as jax_config
from distkeras_tpu.models.transformer import _quantize_kv as jax_quantize
from distkeras_tpu.serving import DecodeEngine as JaxEngine
from distkeras_tpu_torch import DecodeEngine, build_model, convert, generate
from distkeras_tpu_torch.models import model_config
from distkeras_tpu_torch.models.transformer import KVCache, _quantize_kv

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)

MAXLEN, VOCAB = 32, 37
BASE = dict(vocab_size=VOCAB, num_layers=2, d_model=32, num_heads=4,
            num_kv_heads=2, max_len=MAXLEN, dtype="float32",
            kv_cache_dtype="int8")


@pytest.fixture(scope="module")
def lm():
    jmodel = ModelSpec.from_config(jax_config(
        "transformer_lm", (MAXLEN,), input_dtype="int32", **BASE)).build()
    variables = jmodel.init(jax.random.key(0),
                            jnp.zeros((2, MAXLEN), jnp.int32))
    port = build_model(model_config("transformer_lm", (MAXLEN,),
                                    input_dtype="int32", **BASE),
                       device="cpu").eval()
    port.load_state_dict(convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"])))
    return jmodel, variables, port


def _prompts(lengths, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, (t,)).astype(np.int32) for t in lengths]


def test_quantize_kv_matches_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    # exact halves: a row of amax 127 has scale 1, so x/scale = k + 0.5
    # and both sides must round half to even
    x[0, 0, 0] = np.arange(-8, 8, dtype=np.float32) + 0.5
    x[0, 0, 0, 0] = 127.0
    x[1, 2, 1] = 0.0  # an all-zero row: scale 0, values 0
    for arr in (x, x.astype(np.float32) * 1e-3):
        jq, js = jax_quantize(jnp.asarray(arr))
        tq, ts = _quantize_kv(torch.from_numpy(arr))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_int8_cache_layout(lm):
    _, _, port = lm
    cache = port.new_cache(3, 16)
    assert cache.quantized and cache.keys[0].dtype == torch.int8
    assert cache.key_scales[0].shape == (3, 2, 16, 1)
    assert cache.value_scales[1].dtype == torch.float32
    # the flax cache tree's order: per layer key, value, their scales
    leaves = cache.leaves()
    assert [t.dtype for t in leaves[:4]] == [torch.int8, torch.int8,
                                            torch.float32, torch.float32]
    back = KVCache.from_leaves(leaves, True)
    assert all(a is b for a, b in zip(back.leaves(), leaves))


def test_int8_gqa_logits_match_flax(lm):
    """Prefill of an 8-token prompt (dense path) then three T=1 steps:
    every logit row within 1e-5 of its rms of flax's."""
    jmodel, variables, port = lm
    dec = jmodel.clone(decode=True)
    prompt = _prompts([8], seed=1)[0][None]
    logits, st = dec.apply(variables, jnp.asarray(prompt),
                           mutable=["cache"])
    cache = port.new_cache(1)
    with torch.no_grad():
        got, _ = port(torch.from_numpy(prompt), cache=cache)
    rows = [(np.asarray(logits[:, -1]), got[:, -1].numpy())]
    tok = np.asarray(jnp.argmax(logits[:, -1], -1))
    for _ in range(3):
        logits, st = dec.apply({**variables, "cache": st["cache"]},
                               jnp.asarray(tok)[:, None], mutable=["cache"])
        with torch.no_grad():
            got, _ = port(torch.tensor(np.array(tok)).long()[:, None],
                          cache=cache)
        rows.append((np.asarray(logits[:, -1]), got[:, -1].numpy()))
        tok = np.asarray(jnp.argmax(logits[:, -1], -1))
    for want, have in rows:
        rms = np.sqrt(np.mean(want ** 2))
        assert np.max(np.abs(want - have)) <= 1e-5 * rms
    # the cache itself: the same int8 values and scales
    jc = st["cache"]["Block_0"]["SelfAttention_0"]
    np.testing.assert_array_equal(cache.keys[0].numpy(),
                                  np.asarray(jc["cached_key"]))
    np.testing.assert_allclose(cache.value_scales[0].numpy(),
                               np.asarray(jc["value_scale"]), rtol=1e-6)


def test_int8_engine_tokens_equal_jax_engine(lm):
    jmodel, variables, port = lm
    prompts = _prompts([5, 9, 3, 17, 6, 11])
    reqs = [{"prompt": p, "max_new_tokens": n, "i": i}
            for i, (p, n) in enumerate(zip(prompts, [6, 9, 4, 8, 12, 5]))]
    kw = dict(slots=3, buckets=[16, 32], prefill_align=4)
    got = {r["i"]: r["tokens"] for r in DecodeEngine(port, **kw).run(reqs)}
    want = {r["i"]: r["tokens"]
            for r in JaxEngine(jmodel, variables, **kw).run(reqs)}
    for req in reqs:
        i, p = req["i"], req["prompt"]
        np.testing.assert_array_equal(got[i], want[i])
        gen = generate(port, p[None], max_new_tokens=req["max_new_tokens"])
        np.testing.assert_array_equal(got[i], gen[0, len(p):].numpy())
