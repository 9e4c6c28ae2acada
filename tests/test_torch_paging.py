"""The port's paged KV pool and its QoS scheduler against the JAX
engine's (f32, same weights): the allocator's free list and quotas; the
gather/scatter round trip; paged tokens equal to the envelope engine's in
any admission order; the swap-preemption drill token-equal to the JAX
engine's with the page ledger balanced; recompute and ``"none"``
preemption as the JAX engine runs them; tenant quotas; a parked deadline
expiring into an error result."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu import paging as jax_paging
from distkeras_tpu.models import ModelSpec
from distkeras_tpu.models import model_config as jax_config
from distkeras_tpu.serving import DecodeEngine as JaxEngine
from distkeras_tpu_torch import DecodeEngine, build_model, convert, telemetry
from distkeras_tpu_torch.models import model_config
from distkeras_tpu_torch.paging import (PageAllocator, gather_cache,
                                        pages_for, scatter_cache)

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)

MAXLEN, VOCAB = 32, 37
BASE = dict(vocab_size=VOCAB, num_layers=1, d_model=32, num_heads=2,
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


def _prompts(lengths, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, (t,)).astype(np.int32) for t in lengths]


def _drill(eng, pl, *, first=12, late=10, deadline=None):
    """Two priority-0 requests admitted and decoding, then a priority-2
    arrival that needs their pages; run to empty."""
    eng.submit(pl[0], max_new_tokens=first, priority=0, meta={"i": 0},
               deadline=deadline)
    eng.submit(pl[1], max_new_tokens=first, priority=0, meta={"i": 1},
               deadline=deadline)
    out = list(eng.step())
    eng.submit(pl[2], max_new_tokens=late, priority=2, meta={"i": 2})
    while eng.has_work():
        out.extend(eng.step())
    return {r["i"]: r for r in out}


def _both(lm, make_kw, run):
    """``run(engine)`` on the port's engine and the JAX engine built
    with the same keywords."""
    jmodel, variables, port = lm
    return (run(DecodeEngine(port, **make_kw)),
            run(JaxEngine(jmodel, variables, **make_kw)))


def test_allocator_freelist_and_quota():
    for cls in (PageAllocator, jax_paging.PageAllocator):
        a = cls(6, 4, tenant_quota={"t0": 3})
        assert a.n_free == 6 and pages_for(9, 4) == 3
        assert a.alloc(3, "t0") == [1, 2, 3]   # deterministic pop order
        assert a.alloc(1, "t0") is None         # quota, not capacity
        assert not a.fits_quota(1, "t0") and a.fits_quota(3, "t1")
        assert a.alloc(2, "t1") == [4, 5] and a.n_free == 1
        assert a.alloc(2, "t1") is None         # capacity
        a.free([1, 2, 3], "t0")
        assert a.n_free == 4 and a.fits_quota(3, "t0")
        assert a.alloc(4) == [1, 2, 3, 6]       # freed ids come back first
        assert a.stats() == {"n_pages": 6, "page_size": 4, "free": 0,
                             "allocated_total": 9, "freed_total": 3,
                             "tenants": {"t1": 2, None: 4}}


def test_gather_scatter_round_trip():
    pages = [torch.randn(7, 2, 4, 3), torch.randn(7, 2, 4, 1)]
    table = torch.tensor([[3, 1, 0], [5, 0, 0]])
    env = gather_cache(pages, table)
    assert env[0].shape == (2, 2, 12, 3) and env[1].shape == (2, 2, 12, 1)
    torch.testing.assert_close(env[0][0, :, 4:8], pages[0][1], rtol=0,
                               atol=0)
    want = [p.clone() for p in pages]
    new = [e + 1.0 for e in env]
    scatter_cache(pages, new, table)
    for p, w in zip(pages, want):
        for pid, delta in ((3, 1.0), (1, 1.0), (5, 1.0), (2, 0.0),
                           (4, 0.0), (6, 0.0)):
            torch.testing.assert_close(p[pid], w[pid] + delta, rtol=0,
                                       atol=0)


def test_paged_matches_envelope_any_admission_order(lm):
    _, _, port = lm
    prompts = _prompts([5, 9, 3, 7, 5, 11, 4, 6])
    reqs = [{"prompt": p, "max_new_tokens": n, "i": i}
            for i, (p, n) in enumerate(zip(prompts,
                                           [4, 7, 3, 6, 5, 8, 2, 7]))]
    kw = dict(slots=3, buckets=[16, 32], prefill_align=4, steps_per_sync=2)
    base = {r["i"]: r["tokens"] for r in DecodeEngine(port, **kw).run(reqs)}
    pag = DecodeEngine(port, kv_pages=24, **kw)
    fwd = {r["i"]: r["tokens"] for r in pag.run(reqs)}
    rev = {r["i"]: r["tokens"] for r in pag.run(list(reversed(reqs)),
                                                ordered=False)}
    for i in base:
        np.testing.assert_array_equal(fwd[i], base[i])
        np.testing.assert_array_equal(rev[i], base[i])
    assert pag.free_pages() == 24
    assert DecodeEngine(port, **kw).free_pages() is None


def test_preempt_swap_readmit_equals_jax_engine(lm):
    jmodel, variables, port = lm
    pl = _prompts([9, 9, 5])
    kw = dict(slots=3, buckets=[32], prefill_align=4, steps_per_sync=2,
              kv_pages=8)
    tel = telemetry.enable()
    try:
        eng = DecodeEngine(port, **kw)
        got = _drill(eng, pl)
        snap = tel.metrics.snapshot()["counters"]
        spans = [(e["name"], e["args"].get("direction"))
                 for e in tel.tracer.events()
                 if e["name"] in ("prefill", "page_swap")]
    finally:
        telemetry.disable()
    # the readmission restores the swapped pages: three prefills, no
    # re-prefill (the JAX engine stamps only segmented admissions with
    # their weights version, so its one-shot admissions recompute here)
    assert spans.count(("prefill", None)) == 3
    assert ("page_swap", "in") in spans
    jeng = JaxEngine(jmodel, variables, **kw)
    want = _drill(jeng, pl)
    env = _drill(DecodeEngine(port, **{**kw, "kv_pages": None}), pl)
    for i in range(3):
        assert "error" not in got[i]
        np.testing.assert_array_equal(got[i]["tokens"], want[i]["tokens"])
        np.testing.assert_array_equal(got[i]["tokens"], env[i]["tokens"])
    assert sum(v for k, v in snap.items()
               if k.startswith("serving_preemptions_total")) >= 1
    assert snap["serving_readmissions_total"] >= 1
    assert snap["serving_pages_swapped_total"] >= 1
    assert (snap["serving_pages_allocated_total"]
            == snap["serving_pages_freed_total"])
    assert eng.free_pages() == 8
    assert eng.paging_stats() == jeng.paging_stats()


def test_recompute_preemption_as_jax_engine(lm):
    pl = _prompts([9, 9, 5])
    kw = dict(slots=3, buckets=[32], prefill_align=4, steps_per_sync=2,
              kv_pages=8, preemption="recompute")
    got, want = _both(lm, kw, lambda e: (_drill(e, pl), e.paging_stats()))
    for i, n in [(0, 12), (1, 12), (2, 10)]:
        assert "error" not in got[0][i]
        assert len(got[0][i]["tokens"]) == n
        np.testing.assert_array_equal(got[0][i]["tokens"],
                                      want[0][i]["tokens"])
    assert got[1] == want[1] and got[1]["free"] == 8


def test_preemption_none_sheds_the_grower_as_jax_engine(lm):
    pl = _prompts([9, 9])
    kw = dict(slots=2, buckets=[32], prefill_align=4, steps_per_sync=2,
              kv_pages=6, preemption="none")

    def run(eng):
        eng.submit(pl[0], max_new_tokens=7, meta={"i": 0})
        eng.submit(pl[1], max_new_tokens=7, meta={"i": 1})
        out = eng.drain()
        return ({r["i"]: (r["tokens"].tolist(), r.get("error"))
                 for r in out}, eng.free_pages())

    got, want = _both(lm, kw, run)
    assert got == want
    assert any(err == "kv_pages_exhausted" for _, err in got[0].values())
    assert got[1] == 6


def test_tenant_quota_blocks_only_the_hog(lm):
    pl = _prompts([5, 5, 5])
    kw = dict(slots=3, buckets=[32], prefill_align=4, steps_per_sync=2,
              kv_pages=12, tenant_quota={"hog": 3})

    def run(eng):
        eng.submit(pl[0], max_new_tokens=4, tenant="hog", meta={"i": 0})
        eng.submit(pl[1], max_new_tokens=4, tenant="hog", meta={"i": 1})
        eng.submit(pl[2], max_new_tokens=4, tenant="other", meta={"i": 2})
        order = [r["i"] for r in eng.drain()]
        return order, eng.paging_stats()

    got, want = _both(lm, kw, run)
    assert got == want and got[1]["tenants"] == {}
    _, _, port = lm
    eng = DecodeEngine(port, **kw)
    with pytest.raises(ValueError, match="tenant_quota"):
        eng.submit(np.arange(20, dtype=np.int32), max_new_tokens=8,
                   tenant="hog")


def test_parked_deadline_expires_into_an_error_result(lm):
    _, _, port = lm
    pl = _prompts([9, 9, 5])
    eng = DecodeEngine(port, slots=3, buckets=[32], prefill_align=4,
                       steps_per_sync=2, kv_pages=8)
    for i in (0, 1):
        eng.submit(pl[i], max_new_tokens=12, priority=0, deadline=60.0,
                   meta={"i": i})
    out = list(eng.step())
    eng.submit(pl[2], max_new_tokens=10, priority=2, meta={"i": 2})
    for _ in range(8):
        out.extend(eng.step())
        if eng.paging_stats()["parked"] >= 1:
            break
    assert eng.paging_stats()["parked"] >= 1
    for req in eng._parked:  # expire in place while parked
        req.deadline = telemetry.now() - 1.0
    out.extend(eng.drain())
    res = {r["i"]: r for r in out}
    assert "error" not in res[2]
    expired = [r for r in (res[0], res[1]) if "error" in r]
    assert expired and all(r["error"] == "deadline_exceeded"
                           for r in expired)
    assert eng.free_pages() == 8


def test_paged_program_keys_equal_jax_and_steady(lm):
    """The paged program keys equal the JAX engine's; a second wave adds
    none, and neither does a weight swap."""
    _, _, port = lm
    prompts = _prompts([5, 9, 3, 7])
    reqs = [{"prompt": p, "max_new_tokens": 5} for p in prompts]
    kw = dict(slots=2, buckets=[16, 32], prefill_align=4, kv_pages=16)
    keys = _both(lm, kw, lambda e: (list(e.run(reqs)),
                                    sorted(e.compile_counts))[1])
    assert keys[0] == keys[1]
    eng = DecodeEngine(port, **kw)
    list(eng.run(reqs))
    before = eng.compile_counts
    eng.swap_variables({k: v * 1.01 for k, v in eng.variables.items()})
    list(eng.run(list(reversed(reqs))))
    assert eng.compile_counts == before
