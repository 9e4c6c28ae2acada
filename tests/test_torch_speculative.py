"""The port's speculative decoding against the JAX package's (f32, same
weights): ``normalize``, ``ngram_propose`` and ``accept_length`` equal
the JAX functions; n-gram and draft speculation give the plain greedy
tokens (full acceptance with the target as its own draft, rollbacks with
a smaller one) on the envelope and paged pools; eos and ``max_new`` stop
mid-window; a request opts out; paged preemption under speculation;
``spec_stats`` equal to the JAX engine's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu import speculative as jax_spec
from distkeras_tpu.models import ModelSpec
from distkeras_tpu.models import model_config as jax_config
from distkeras_tpu.serving import DecodeEngine as JaxEngine
from distkeras_tpu_torch import (DecodeEngine, build_model, convert,
                                 generate, speculative, telemetry)
from distkeras_tpu_torch.models import model_config

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)

MAXLEN, VOCAB = 32, 37


def _pair(seed, num_layers=1, d_model=32):
    base = dict(vocab_size=VOCAB, num_layers=num_layers, d_model=d_model,
                num_heads=2, max_len=MAXLEN, dtype="float32")
    jmodel = ModelSpec.from_config(jax_config(
        "transformer_lm", (MAXLEN,), input_dtype="int32", **base)).build()
    variables = jmodel.init(jax.random.key(seed),
                            jnp.zeros((2, MAXLEN), jnp.int32))
    port = build_model(model_config("transformer_lm", (MAXLEN,),
                                    input_dtype="int32", **base),
                       device="cpu").eval()
    port.load_state_dict(convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"])))
    return jmodel, variables, port


@pytest.fixture(scope="module")
def lm():
    return _pair(0)


@pytest.fixture(scope="module")
def small():
    return _pair(1, d_model=16)


def _prompts(lengths, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, (t,)).astype(np.int32) for t in lengths]


def _want(port, prompt, n_new):
    return generate(port, prompt[None], max_new_tokens=n_new
                    )[0, len(prompt):].numpy()


def _specs(lm, small, name, k=3):
    """The port's and the JAX engine's ``speculative=`` for one case."""
    jmodel, variables, port = lm
    if name == "ngram":
        # single-token matches: the tiny model's ledgers seldom repeat
        # a pair
        cfg = {"proposer": "ngram", "k": k, "ngram": 1}
        return cfg, cfg
    if name == "self":
        return ({"proposer": "draft", "k": k, "draft_model": port},
                {"proposer": "draft", "k": k, "draft_model": jmodel,
                 "draft_variables": variables})
    sj, sv, sp = small
    return ({"proposer": "draft", "k": k, "draft_model": sp},
            {"proposer": "draft", "k": k, "draft_model": sj,
             "draft_variables": sv})


def test_ngram_propose_and_accept_length_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(200):
        ledger = rng.integers(0, 4, (int(rng.integers(1, 20)),))
        k, n = int(rng.integers(1, 5)), int(rng.integers(1, 4))
        np.testing.assert_array_equal(speculative.ngram_propose(ledger, k, n),
                                      jax_spec.ngram_propose(ledger, k, n))
        p, g = rng.integers(0, 3, (k,)), rng.integers(0, 3, (k + 1,))
        assert (speculative.accept_length(p, g)
                == jax_spec.accept_length(p, g))
    np.testing.assert_array_equal(
        speculative.ngram_propose(np.array([1, 2, 3, 9, 1, 2, 3, 7, 1, 2]),
                                  3, 2), [3, 7, 1])


def test_normalize_equals_jax(lm, small):
    jmodel, variables, port = lm
    for cfg in (None, {}, {"k": 2, "ngram": 3}):
        want = jax_spec.normalize(cfg, vocab_size=VOCAB, max_len=MAXLEN)
        assert speculative.normalize(cfg, vocab_size=VOCAB,
                                     max_len=MAXLEN) == want
    got = speculative.normalize({"proposer": "draft", "draft_model": port},
                                vocab_size=VOCAB, max_len=MAXLEN)
    assert (got["proposer"], got["k"], got["ngram"]) == ("draft", 4, 2)
    assert got["draft_variables"] is None
    for bad, match in (("x", "mapping"), ({"bogus": 1}, "unknown"),
                       ({"proposer": "beam"}, "proposer"),
                       ({"k": 0}, "k must"), ({"ngram": 0}, "ngram"),
                       ({"proposer": "draft"}, "draft_model")):
        for normalize in (speculative.normalize, jax_spec.normalize):
            with pytest.raises(ValueError, match=match):
                normalize(bad, vocab_size=VOCAB, max_len=MAXLEN)
    with pytest.raises(ValueError, match="state_dict"):
        speculative.normalize({"proposer": "draft", "draft_model": port,
                               "draft_variables": {"x": 1}},
                              vocab_size=VOCAB, max_len=MAXLEN)
    with pytest.raises(ValueError, match="vocab_size"):
        speculative.normalize({"proposer": "draft", "draft_model": port},
                              vocab_size=VOCAB + 1, max_len=MAXLEN)


@pytest.mark.parametrize("paged", [False, True], ids=["envelope", "paged"])
@pytest.mark.parametrize("name", ["ngram", "self", "small"])
def test_parity_and_spec_stats_equal_jax(lm, small, name, paged):
    """Tokens equal the JAX engine's and ``generate()``'s per request;
    ``spec_stats`` and the program keys equal the JAX engine's; the
    target as its own draft accepts every proposal; every page earned by
    a wide verify comes back."""
    jmodel, variables, port = lm
    rng = np.random.default_rng(7)
    prompts = [np.tile(rng.integers(0, VOCAB, (4,)), 3)[:10].astype(np.int32)
               for _ in range(3)] + _prompts([5, 9, 11])
    reqs = [{"prompt": p, "max_new_tokens": 8, "i": i}
            for i, p in enumerate(prompts)]
    kw = dict(slots=3, buckets=[MAXLEN], prefill_align=4,
              kv_pages=24 if paged else None)
    pspec, jspec = _specs(lm, small, name)
    eng = DecodeEngine(port, speculative=pspec, **kw)
    jeng = JaxEngine(jmodel, variables, speculative=jspec, **kw)
    got = {r["i"]: r["tokens"] for r in eng.run(reqs)}
    want = {r["i"]: r["tokens"] for r in jeng.run(reqs)}
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(got[i], want[i])
        np.testing.assert_array_equal(got[i], _want(port, p, 8))
    st = eng.spec_stats()
    assert st == jeng.spec_stats() and st["proposed"] > 0
    if name == "self":
        assert st["accept_rate"] == 1.0
    assert sorted(eng.compile_counts) == sorted(jeng.compile_counts)
    if paged:
        assert eng.free_pages() == 24


@pytest.mark.parametrize("stop", ["eos", "max_new"])
def test_stops_mid_window(lm, small, stop):
    _, _, port = lm
    p = _prompts([9], seed=7)[0]
    free = _want(port, p, 8)
    eos = int(free[3])
    first = int(np.argwhere(free == eos)[0][0])
    item = ({"prompt": p, "max_new_tokens": 8, "eos_id": eos}
            if stop == "eos" else {"prompt": p, "max_new_tokens": 3})
    want = free[:first + 1] if stop == "eos" else free[:3]
    for kv_pages in (None, 24):
        eng = DecodeEngine(port, slots=2, buckets=[MAXLEN], prefill_align=4,
                           kv_pages=kv_pages,
                           speculative=_specs(lm, small, "self")[0])
        (r,) = eng.run([item])
        np.testing.assert_array_equal(r["tokens"], want)
        assert kv_pages is None or eng.free_pages() == kv_pages


def test_per_request_opt_out_is_baseline(lm, small):
    _, _, port = lm
    prompts = _prompts([5, 9, 3])
    eng = DecodeEngine(port, slots=3, buckets=[MAXLEN], prefill_align=4,
                       speculative=_specs(lm, small, "self")[0])
    got = {r["i"]: r["tokens"]
           for r in eng.run([{"prompt": p, "max_new_tokens": 6,
                              "speculative": False, "i": i}
                             for i, p in enumerate(prompts)])}
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(got[i], _want(port, p, 6))
    assert eng.spec_stats()["proposed"] == 0


def test_paged_preemption_with_speculation_equals_jax(lm, small):
    jmodel, variables, port = lm
    pl = _prompts([9, 9, 5])
    kw = dict(slots=3, buckets=[32], prefill_align=4, kv_pages=8)
    pspec, jspec = _specs(lm, small, "self")

    def drill(eng):
        eng.submit(pl[0], max_new_tokens=12, priority=0, meta={"i": 0})
        eng.submit(pl[1], max_new_tokens=12, priority=0, meta={"i": 1})
        out = list(eng.step())
        eng.submit(pl[2], max_new_tokens=10, priority=2, meta={"i": 2})
        out += eng.drain()
        return {r["i"]: r for r in out}

    tel = telemetry.enable()
    try:
        eng = DecodeEngine(port, speculative=pspec, **kw)
        got = drill(eng)
        snap = tel.metrics.snapshot()["counters"]
    finally:
        telemetry.disable()
    want = drill(JaxEngine(jmodel, variables, speculative=jspec, **kw))
    for i, n in [(0, 12), (1, 12), (2, 10)]:
        assert "error" not in got[i]
        np.testing.assert_array_equal(got[i]["tokens"], want[i]["tokens"])
        np.testing.assert_array_equal(got[i]["tokens"], _want(port, pl[i], n))
    assert sum(v for k, v in snap.items()
               if k.startswith("serving_preemptions_total")) >= 1
    assert (snap["serving_pages_allocated_total"]
            == snap["serving_pages_freed_total"])
    assert eng.free_pages() == 8


def test_weight_swap_invalidates_in_flight_drafts(lm, small):
    """A swap mid-stream: the speculative engine's tokens equal a plain
    engine's that swaps at the same committed-token boundary."""
    jmodel, variables, port = lm
    v2 = {k: v * 1.01 for k, v in port.state_dict().items()}
    p = _prompts([7], seed=5)[0]
    eng = DecodeEngine(port, slots=1, buckets=[MAXLEN], prefill_align=4,
                       speculative=_specs(lm, small, "self")[0])
    eng.submit(p, max_new_tokens=12)
    out = eng.step() + eng.step()
    c = len(eng._pools[0].reqs[0].tokens)
    assert c > 2  # a k+1-wide commit landed
    assert (eng._pools[0].spec["dpos"] >= 0).all()
    eng.swap_variables(v2)
    assert (eng._pools[0].spec["dpos"] == -1).all()
    got = (out + eng.drain())[0]["tokens"]
    base = DecodeEngine(port, slots=1, buckets=[MAXLEN], prefill_align=4)
    base.submit(p, max_new_tokens=12)
    base.step()
    while len(base._pools[0].reqs[0].tokens) < c:
        base.step()
    base.swap_variables(v2)
    np.testing.assert_array_equal(got, base.drain()[0]["tokens"])


def test_engine_validation(lm, small):
    _, _, port = lm
    spec = {"proposer": "ngram"}
    with pytest.raises(ValueError, match="temperature"):
        DecodeEngine(port, speculative=spec, temperature=0.7)
    with pytest.raises(ValueError, match="steps_per_sync"):
        DecodeEngine(port, speculative=spec, steps_per_sync=2)
