"""The port's shared-prefix KV store and chunked prefill against the JAX
engine's (f32, same weights): tokens equal across admission orders, on
partial-block matches and after evict-then-readmit under a tiny budget;
decode steps interleave with a long chunked prefill; deadlines fire
between chunks; a weight swap invalidates the store and a request
admitted before it never donates its KV; ``prefix_stats`` equal to the
JAX engine's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import ModelSpec
from distkeras_tpu.models import model_config as jax_config
from distkeras_tpu.serving import DecodeEngine as JaxEngine
from distkeras_tpu_torch import (DecodeEngine, build_model, convert,
                                 flight_recorder, generate, telemetry)
from distkeras_tpu_torch.models import model_config

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)

MAXLEN, VOCAB = 32, 37
BASE = dict(vocab_size=VOCAB, num_layers=2, d_model=32, num_heads=2,
            max_len=MAXLEN, dtype="float32")


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


def _shared(n=4, shared=12, tail=6, seed=7):
    rng = np.random.default_rng(seed)
    head = rng.integers(0, VOCAB, (shared,)).astype(np.int32)
    return [np.concatenate([head, rng.integers(0, VOCAB, (tail,))
                            .astype(np.int32)]) for _ in range(n)]


def _want(port, prompt, n_new):
    return generate(port, prompt[None], max_new_tokens=n_new
                    )[0, len(prompt):].numpy()


def _kw(**kw):
    return {"slots": 4, "prefill_align": 4, "buckets": (MAXLEN,), **kw}


def _drain(eng, prompts, n_new=5, tag="r"):
    for i, p in enumerate(prompts):
        eng.submit(p, max_new_tokens=n_new, request_id=f"{tag}{i}")
    out = {}
    for r in eng.drain():
        assert "error" not in r, r
        out[int(r["request_id"][len(tag):])] = np.asarray(r["tokens"])
    return out


def _waves(eng, prompts, orders, n_new=5):
    return [_drain(eng, [prompts[i] for i in order], n_new, tag)
            for tag, order in zip("abcd", orders)]


@pytest.mark.parametrize("kw", [
    {"prefix_cache_bytes": 1 << 24},
    {"prefix_cache_bytes": 1 << 24, "prefill_chunk": 8},
    {"prefill_chunk": 4}], ids=["prefix", "prefix_chunk", "chunk"])
def test_parity_across_admission_orders(lm, kw):
    """Three waves (warm-up, reversed, again) through the port and the
    JAX engine: equal tokens, equal ``prefix_stats``, the port's equal
    to ``generate()``; the store hits once warm."""
    jmodel, variables, port = lm
    prompts = _shared()
    orders = [range(4), reversed(range(4)), range(4)]
    orders = [list(o) for o in orders]
    eng = DecodeEngine(port, **_kw(**kw))
    jeng = JaxEngine(jmodel, variables, **_kw(**kw))
    got, want = _waves(eng, prompts, orders), _waves(jeng, prompts, orders)
    refs = [_want(port, p, 5) for p in prompts]
    for g, w, order in zip(got, want, orders):
        for k, i in enumerate(order):
            np.testing.assert_array_equal(g[k], w[k])
            np.testing.assert_array_equal(g[k], refs[i])
    assert eng.prefix_stats() == jeng.prefix_stats()
    if "prefix_cache_bytes" in kw:
        st = eng.prefix_stats()
        assert st["hits"] >= len(prompts) and st["tokens_saved"] >= 8


def test_partial_block_match_reuses_only_whole_blocks(lm):
    jmodel, variables, port = lm
    rng = np.random.default_rng(11)
    a = rng.integers(0, VOCAB, (13,)).astype(np.int32)
    b = np.concatenate([a[:9], rng.integers(0, VOCAB, (5,)).astype(np.int32)])
    eng = DecodeEngine(port, **_kw(slots=1, prefix_cache_bytes=1 << 24))
    _drain(eng, [a], tag="a")
    saved0 = eng.prefix_stats()["tokens_saved"]
    (got_b,) = _drain(eng, [b], tag="b").values()
    st = eng.prefix_stats()
    np.testing.assert_array_equal(got_b, _want(port, b, 5))
    assert st["hits"] == 1 and st["tokens_saved"] - saved0 == 8
    probe = np.concatenate([a[:9], np.zeros(3, np.int32)])
    assert eng.match_blocks(probe) == 2 and eng.match_blocks(a) == 3


def test_evict_then_readmit_under_tiny_budget(lm):
    """2048 bytes a block (two layers of K and V, [1, 2, 4, 16] f32):
    a 4200-byte budget forces LRU eviction; the stats equal the JAX
    engine's and the tokens ``generate()``'s."""
    jmodel, variables, port = lm
    prompts = _shared()
    eng = DecodeEngine(port, **_kw(prefix_cache_bytes=4200))
    jeng = JaxEngine(jmodel, variables, **_kw(prefix_cache_bytes=4200))
    refs = [_want(port, p, 5) for p in prompts]
    for tag in ("a", "b"):
        got = _drain(eng, prompts, tag=tag)
        _drain(jeng, prompts, tag=tag)
        for i, r in enumerate(refs):
            np.testing.assert_array_equal(got[i], r)
    st = eng.prefix_stats()
    assert st == jeng.prefix_stats()
    assert st["evictions"] > 0 and st["bytes"] <= 4200


def test_decode_steps_interleave_with_a_long_chunked_prefill(lm):
    """While a 30-token prompt prefills in four chunks of 8, the other
    slot keeps decoding: ``decode_step`` spans sit between the long
    request's ``prefill_chunk`` spans, and its tokens stay exact."""
    _, _, port = lm
    rng = np.random.default_rng(3)
    short = rng.integers(0, VOCAB, (5,)).astype(np.int32)
    long = rng.integers(0, VOCAB, (30,)).astype(np.int32)
    tel = telemetry.enable()
    try:
        eng = DecodeEngine(port, **_kw(slots=2, prefill_chunk=8))
        eng.submit(short, max_new_tokens=12, request_id="short")
        out = eng.step()
        eng.submit(long, max_new_tokens=2, request_id="long")
        out = {r["request_id"]: r["tokens"] for r in out + eng.drain()}
        ev = [e for e in tel.tracer.events()
              if e["name"] in ("prefill_chunk", "decode_step")]
    finally:
        telemetry.disable()
    chunk_idx = [i for i, e in enumerate(ev)
                 if e["name"] == "prefill_chunk"
                 and e["args"].get("request_id") == "long"]
    assert len(chunk_idx) == 4
    between = [e["name"] for e in ev[chunk_idx[0]:chunk_idx[-1]]]
    assert between.count("decode_step") >= 3
    np.testing.assert_array_equal(out["short"], _want(port, short, 12))
    np.testing.assert_array_equal(out["long"], _want(port, long, 2))


def test_deadline_expiry_fires_between_prefill_chunks(lm):
    _, _, port = lm
    rng = np.random.default_rng(9)
    long = rng.integers(0, VOCAB, (28,)).astype(np.int32)
    eng = DecodeEngine(port, **_kw(slots=1, prefill_chunk=4))
    eng.submit(long, max_new_tokens=4, request_id="doomed", deadline=60.0)
    assert eng.step() == []  # admitted, first chunk run
    pool = eng._pools[0]
    (slot,) = pool.prefilling
    pool.reqs[slot].deadline = telemetry.now() - 1.0  # backdate
    assert [r.get("error") for r in eng.step()] == ["deadline_exceeded"]
    assert not pool.prefilling and pool.reqs[slot] is None
    (p,) = _shared(n=1)
    got = _drain(eng, [p], n_new=3, tag="x")
    np.testing.assert_array_equal(got[0], _want(port, p, 3))


def test_swap_invalidates_the_store(lm, tmp_path):
    """A swap clears the store (counter, flight-recorder event) and the
    tokens after it equal a cold JAX engine's on the new weights."""
    jmodel, variables, port = lm
    prompts = _shared()
    v2 = jax.tree_util.tree_map(lambda x: x * 1.01, variables)
    tel = telemetry.enable()
    fr = flight_recorder.start(tmp_path / "fdr")
    try:
        eng = DecodeEngine(port, **_kw(prefill_chunk=8,
                                       prefix_cache_bytes=1 << 24))
        _drain(eng, prompts, tag="warm")
        assert eng.prefix_stats()["nodes"] > 0
        eng.swap_variables(convert.params_from_flax(
            jax.tree_util.tree_map(np.asarray, v2["params"])))
        st = eng.prefix_stats()
        assert st["nodes"] == 0 and st["bytes"] == 0
        assert st["invalidations"] == 1
        got = _drain(eng, prompts, tag="post")
        assert tel.metrics.sum_counter(
            "serving_prefix_invalidations_total") == 1
        ev = [e for e in fr.read_events() if e["kind"] == "prefix_invalidate"]
        assert len(ev) == 1 and ev[0]["reason"] == "weight_swap"
    finally:
        flight_recorder.stop()
        telemetry.disable()
    cold = _drain(JaxEngine(jmodel, v2, **_kw(prefill_chunk=8,
                                              prefix_cache_bytes=1 << 24)),
                  prompts, tag="cold")
    for i in range(len(prompts)):
        np.testing.assert_array_equal(got[i], cold[i])
    with pytest.raises(ValueError, match="mismatch"):
        eng.swap_variables({k: v[:1] for k, v in eng.variables.items()})


def test_mid_flight_swap_never_donates_stale_kv(lm):
    jmodel, variables, port = lm
    (p,) = _shared(n=1)
    v2 = {k: v * 1.01 for k, v in port.state_dict().items()}
    eng = DecodeEngine(port, **_kw(slots=1, prefix_cache_bytes=1 << 24))
    eng.submit(p, max_new_tokens=6, request_id="inflight")
    eng.step()          # admitted and prefilled under the old weights
    eng.swap_variables(v2)
    eng.drain()         # finishes under the new ones: hybrid KV
    assert eng.prefix_stats()["nodes"] == 0
    got = _drain(eng, [p], n_new=5, tag="x")
    jv2 = jax.tree_util.tree_map(lambda x: x * 1.01, variables)
    (want,) = JaxEngine(jmodel, jv2, slots=1, prefill_align=4).run(
        [{"prompt": p, "max_new_tokens": 5}])
    np.testing.assert_array_equal(got[0], want["tokens"])


def test_knob_validation(lm):
    _, _, port = lm
    for kw, match in (({"prefill_chunk": 3}, "prefill_align"),
                      ({"prefill_chunk": 0}, "prefill_align"),
                      ({"prefix_cache_bytes": 0}, "prefix_cache_bytes"),
                      ({"kv_pages": 8, "page_size": 8,
                        "prefix_cache_bytes": 1 << 20}, "page_size")):
        with pytest.raises(ValueError, match=match):
            DecodeEngine(port, **_kw(**kw))
