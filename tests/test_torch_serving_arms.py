"""The port's ``DecodeEngine`` with every arm at once, against the JAX
engine (f32, same weights): mixed traffic with paging, the prefix store,
chunked prefill and n-gram speculation on together gives equal tokens
per request, equal ``compile_counts`` keys and equal prefix, paging and
speculation stats.  Also: a prefill that raises ends only its own
request; no program key is added in steady state or by a swap; the
telemetry counts what the results hold; ``reset_rng`` replays sampling;
``close()`` cancels parked requests and returns every page."""

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

MAXLEN, VOCAB = 64, 37
BASE = dict(vocab_size=VOCAB, num_layers=2, d_model=32, num_heads=2,
            max_len=MAXLEN, dtype="float32")
ALL_ON = dict(slots=3, buckets=[32, 64], prefill_align=4, kv_pages=20,
              prefix_cache_bytes=1 << 20, prefill_chunk=8,
              speculative={"proposer": "ngram", "k": 3, "ngram": 1})


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


def _traffic(seed=0):
    """Shared system prompts with ragged tails, repetitive prompts the
    n-gram proposer hits, long prompts that chunk, mixed priorities."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, VOCAB, (16,)).astype(np.int32)
    motif = rng.integers(0, VOCAB, (5,)).astype(np.int32)
    out = []
    for i in range(14):
        kind = i % 3
        if kind == 0:
            p = np.concatenate([head, rng.integers(0, VOCAB, (1 + i % 7,))])
        elif kind == 1:
            p = np.tile(motif, 4)[:8 + i % 9]
        else:
            p = rng.integers(0, VOCAB, (20 + i,))
        out.append({"prompt": p.astype(np.int32), "i": i,
                    "max_new_tokens": 4 + (5 * i) % 11,
                    "priority": i % 3, "tenant": "ab"[i % 2]})
    return out


def _serve(eng, reqs):
    res = {r["i"]: r for r in eng.run(reqs[:7])}
    eng.step()
    res.update({r["i"]: r for r in eng.run(reqs[7:], ordered=False)})
    return res


def test_all_levers_together_equal_jax(lm):
    jmodel, variables, port = lm
    reqs = _traffic()
    eng = DecodeEngine(port, **ALL_ON)
    jeng = JaxEngine(jmodel, variables, **ALL_ON)
    got, want = _serve(eng, reqs), _serve(jeng, reqs)
    assert sorted(got) == sorted(want) == list(range(len(reqs)))
    for i, req in enumerate(reqs):
        assert "error" not in got[i]
        np.testing.assert_array_equal(got[i]["tokens"], want[i]["tokens"])
        p = req["prompt"]
        np.testing.assert_array_equal(
            got[i]["tokens"], generate(port, p[None], max_new_tokens=req[
                "max_new_tokens"])[0, len(p):].numpy())
    assert sorted(eng.compile_counts) == sorted(jeng.compile_counts)
    assert eng.prefix_stats() == jeng.prefix_stats()
    assert eng.paging_stats() == jeng.paging_stats()
    assert eng.spec_stats() == jeng.spec_stats()
    st = eng.prefix_stats()
    assert st["hits"] > 0 and eng.spec_stats()["accepted"] > 0
    assert eng.free_pages() == ALL_ON["kv_pages"]


@pytest.mark.parametrize("arm", ["whole", "chunk", "paged"])
def test_prefill_error_ends_only_its_request(lm, arm):
    _, _, port = lm
    kw = {"whole": {}, "chunk": {"prefill_chunk": 4},
          "paged": {"kv_pages": 12}}[arm]
    eng = DecodeEngine(port, slots=2, buckets=[32], prefill_align=4,
                       max_new_tokens=4, **kw)
    rng = np.random.default_rng(37)
    prompts = [rng.integers(0, VOCAB, (t,)).astype(np.int32)
               for t in (5, 6, 7)]
    name = "_run_chunk" if arm == "chunk" else "_run_prefill"
    real = getattr(eng, name)

    def poisoned(pool, slot, prompt, *a, **kw):
        head = np.asarray(prompt).reshape(-1)[:4]
        if np.array_equal(head, prompts[1][:4]):  # request 1 only
            raise RuntimeError("poisoned prompt")
        return real(pool, slot, prompt, *a, **kw)

    setattr(eng, name, poisoned)
    res = {r["request_id"]: r for r in eng.run(prompts)}
    assert "poisoned prompt" in res[1]["error"]
    assert res[1]["error"].startswith("prefill_failed")
    assert len(res[1]["tokens"]) == 0 and res[1]["ttft"] is None
    for i in (0, 2):
        assert "error" not in res[i]
        np.testing.assert_array_equal(
            res[i]["tokens"],
            generate(port, prompts[i][None], max_new_tokens=4
                     )[0, len(prompts[i]):].numpy())
    setattr(eng, name, real)
    (ok,) = eng.run([prompts[1]])
    assert "error" not in ok
    if arm == "paged":
        assert eng.free_pages() == 12


def test_no_program_key_in_steady_state_or_after_a_swap(lm):
    _, _, port = lm
    reqs = _traffic(seed=1)
    eng = DecodeEngine(port, **ALL_ON)
    _serve(eng, reqs)
    _serve(eng, reqs)
    before = eng.compile_counts
    eng.swap_variables({k: v * 1.01 for k, v in eng.variables.items()})
    _serve(eng, list(reversed(reqs)))
    assert eng.compile_counts == before
    assert all(v == 1 for v in before.values())


def test_telemetry_counts_what_the_results_hold(lm, tmp_path):
    _, _, port = lm
    reqs = _traffic(seed=2)
    tel = telemetry.enable()
    fr = flight_recorder.start(tmp_path / "fdr")
    try:
        eng = DecodeEngine(port, **ALL_ON)
        res = _serve(eng, reqs)
        eng.submit(reqs[0]["prompt"], max_new_tokens=3, deadline=1e-9)
        res[99] = eng.drain()[0]
        m = tel.metrics
        n_tok = sum(len(r["tokens"]) for r in res.values())
        assert m.sum_counter("serving_tokens_total") == n_tok
        st = eng.prefix_stats()
        assert m.sum_counter("serving_prefix_hits_total") == st["hits"]
        assert m.sum_counter("serving_prefix_misses_total") == st["misses"]
        assert (m.sum_counter("serving_prefill_tokens_saved_total")
                == st["tokens_saved"])
        sp = eng.spec_stats()
        assert m.sum_counter("serving_spec_proposed_total") == sp["proposed"]
        assert m.sum_counter("serving_spec_accepted_total") == sp["accepted"]
        assert m.sum_counter("serving_requests_total") == len(res)
        assert m.sum_counter("serving_finished_total") == len(reqs)
        assert m.sum_counter("serving_request_errors_total") == 1
        assert (m.sum_counter("serving_pages_allocated_total")
                == m.sum_counter("serving_pages_freed_total"))
        assert m.sum_counter("compiles_total") == len(eng.compile_counts)
        (h,) = [h for _, h in m.collect("serving_ttft_seconds")]
        assert h.count == len(reqs)
        (h,) = [h for _, h in m.collect("serving_inter_token_seconds")]
        assert 0 < h.count < n_tok
        assert m.collect("serving_slot_occupancy")
        names = {e["name"] for e in tel.tracer.events()}
        assert {"prefill_chunk", "prefix_copy", "verify", "evict"} <= names
        assert isinstance(eng.health(), dict)
        kinds = [e["kind"] for e in fr.read_events()]
        assert "request_error" in kinds
    finally:
        flight_recorder.stop()
        telemetry.disable()


def test_reset_rng_replays_sampling(lm):
    _, _, port = lm
    reqs = _traffic(seed=3)[:4]
    eng = DecodeEngine(port, slots=2, buckets=[64], prefill_align=4,
                       temperature=0.8, top_k=8, seed=5)
    first = [r["tokens"] for r in eng.run(reqs)]
    eng.reset_rng()
    again = [r["tokens"] for r in eng.run(reqs)]
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    eng.submit(reqs[0]["prompt"], max_new_tokens=2)
    with pytest.raises(RuntimeError, match="drain"):
        eng.reset_rng()


def test_close_cancels_parked_requests_and_returns_pages(lm):
    _, _, port = lm
    rng = np.random.default_rng(3)
    pl = [rng.integers(0, VOCAB, (t,)).astype(np.int32) for t in (9, 9, 5)]
    eng = DecodeEngine(port, slots=3, buckets=[32], prefill_align=4,
                       steps_per_sync=2, kv_pages=8)
    ids = [eng.submit(pl[i], max_new_tokens=12, priority=0) for i in (0, 1)]
    eng.step()
    ids.append(eng.submit(pl[2], max_new_tokens=10, priority=2))
    for _ in range(8):
        eng.step()
        if eng.load()["parked"]:
            break
    assert eng.load()["parked"] >= 1
    out = eng.close()
    assert sorted(r["request_id"] for r in out) == sorted(
        set(ids) - {r["request_id"] for r in out if "error" not in r})
    assert all(r["error"] == "engine_closed" for r in out)
    assert eng._alloc.n_free == 8
