"""Port ``DecodeEngine`` against the port's ``generate`` and the JAX
package's ``DecodeEngine`` on the same weights (f32): greedy tokens
must be EQUAL per request over two buckets and mixed prompt lengths;
``steps_per_sync`` changes nothing; ``queue_bound`` sheds; ``close()``
cancels; deadlines expire; values the JAX engine refuses raise, and
the training path's attention keys serve."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu.models import ModelSpec
from distkeras_tpu.models import model_config as jax_config
from distkeras_tpu.serving import DecodeEngine as JaxEngine
from distkeras_tpu_torch import DecodeEngine, ShedError, build_model
from distkeras_tpu_torch import convert, generate
from distkeras_tpu_torch.models import model_config

jax.config.update("jax_platforms", "cpu")
# tiny shapes: one thread each keeps the parallel test workers off
# each other's cores
torch.set_num_threads(1)

MAXLEN, VOCAB = 256, 64
BASE = dict(vocab_size=VOCAB, num_layers=2, d_model=32, num_heads=4,
            num_kv_heads=2, max_len=MAXLEN, dtype="float32",
            flash_attn=True)


def _cfg(**kw):
    return model_config("transformer_lm", (MAXLEN,), input_dtype="int32",
                        **dict(BASE, **kw))


@pytest.fixture(scope="module")
def models():
    jmodel = ModelSpec.from_config(jax_config(
        "transformer_lm", (MAXLEN,), input_dtype="int32", **BASE)).build()
    variables = jmodel.clone(flash_attn=False).init(
        jax.random.key(2), jnp.zeros((2, 8), jnp.int32))
    port = build_model(_cfg(), device="cpu").eval()
    port.load_state_dict(convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"])))
    return jmodel, variables, port


def _requests(lengths, news, seed=0):
    rng = np.random.default_rng(seed)
    return [{"prompt": rng.integers(0, VOCAB, (t,)).astype(np.int32),
             "max_new_tokens": n, "i": i}
            for i, (t, n) in enumerate(zip(lengths, news))]


def _want(port, req):
    p = req["prompt"]
    return generate(port, p[None], max_new_tokens=req["max_new_tokens"]
                    )[0, len(p):].numpy()


def test_tokens_equal_generate_and_jax_engine(models):
    jmodel, variables, port = models
    reqs = _requests([5, 130, 40, 200, 90, 17, 150],
                     [9, 20, 30, 12, 6, 40, 25])
    kw = dict(slots=3, buckets=[128, 256], prefill_align=128)
    got = {r["i"]: r for r in DecodeEngine(port, **kw).run(reqs)}
    jax_got = {r["i"]: r["tokens"]
               for r in JaxEngine(jmodel, variables, **kw).run(reqs)}
    assert sorted(got) == list(range(len(reqs)))
    for req in reqs:
        r = got[req["i"]]
        assert "error" not in r and r["ttft"] <= r["latency"]
        np.testing.assert_array_equal(r["tokens"], _want(port, req))
        np.testing.assert_array_equal(r["tokens"], jax_got[req["i"]])


def test_steps_per_sync_and_eos_change_nothing(models):
    _, _, port = models
    reqs = _requests([12, 60, 100, 33], [15, 7, 22, 30], seed=1)
    want = {r["i"]: _want(port, r) for r in reqs}
    eos = int(want[3][5])
    res = {r["i"]: r["tokens"] for r in DecodeEngine(
        port, slots=2, buckets=[128, 256], steps_per_sync=4
    ).run(reqs + [{**reqs[3], "i": 9, "eos_id": eos}])}
    for i in range(4):
        np.testing.assert_array_equal(res[i], want[i])
    stop = int(np.argmax(want[3] == eos))
    np.testing.assert_array_equal(res[9], want[3][:stop + 1])


def test_queue_bound_sheds(models):
    _, _, port = models
    eng = DecodeEngine(port, slots=1, max_new_tokens=3, queue_bound=2)
    p = np.arange(5, dtype=np.int32)
    eng.submit(p)
    eng.submit(p)
    with pytest.raises(ShedError) as err:
        eng.submit(p)
    assert err.value.reason == "queue_full"
    assert len(eng.drain()) == 2


def test_close_cancels_inflight(models):
    _, _, port = models
    eng = DecodeEngine(port, slots=1, max_new_tokens=50)
    ids = [eng.submit(np.arange(4 + i, dtype=np.int32)) for i in range(3)]
    eng.step()  # one live, two queued
    out = eng.close()
    assert sorted(r["request_id"] for r in out) == ids
    assert all(r["error"] == "engine_closed" for r in out)
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(np.arange(3, dtype=np.int32))


def test_deadline_expires_queued_requests(models):
    _, _, port = models
    eng = DecodeEngine(port, slots=1, max_new_tokens=4)
    eng.submit(np.arange(4, dtype=np.int32))
    late = eng.submit(np.arange(6, dtype=np.int32), deadline=1e-9)
    res = {r["request_id"]: r for r in eng.drain()}
    assert res[late]["error"] == "deadline_exceeded"
    assert res[late]["ttft"] is None


@pytest.mark.parametrize("key,value", [
    ("prefix_cache_bytes", 0), ("prefill_chunk", 100),
    ("kv_pages", 0), ("speculative", {"proposer": "beam"}),
    ("tenant_quota", 0)])
def test_unsupported_engine_keys_raise(models, key, value):
    """Every serving arm is ported; a value the JAX engine refuses
    raises ``ValueError`` naming its key."""
    _, _, port = models
    with pytest.raises(ValueError, match=key):
        DecodeEngine(port, **{key: value})


@pytest.mark.parametrize("key,value,err", [
    ("num_experts", 4, NotImplementedError),
    ("kv_cache_dtype", "int4", ValueError),
    ("scan_blocks", True, NotImplementedError)])
def test_unsupported_model_keys_raise(key, value, err):
    with pytest.raises(err, match=key.split("_")[0]):
        build_model(_cfg(**{key: value}), device="cpu")


@pytest.mark.parametrize("key,value", [
    ("seq_axis", "sp"), ("blockwise_attn", True), ("attn", "blockwise"),
    ("attn_fn", lambda q, k, v, scale: q)])
def test_training_path_model_keys_serve(models, key, value):
    """Keys of the training path serve as the JAX engine serves them:
    the ring (``seq_axis``) and a custom ``attn_fn`` are cleared for
    decode, the blockwise spelling runs the prefill; tokens equal
    ``generate()``'s on the same model."""
    _, _, port = models
    model = build_model(_cfg(flash_attn=False, **{key: value}),
                        device="cpu").eval()
    model.load_state_dict(port.state_dict())
    reqs = _requests([40, 130], [5, 3], seed=3)
    res = {r["i"]: r for r in DecodeEngine(model, slots=2).run(reqs)}
    for req in reqs:
        np.testing.assert_array_equal(res[req["i"]]["tokens"],
                                      _want(model, req))


def test_unsupported_submit_and_methods_raise(models):
    """``submit``'s QoS and speculation keys and the handoff methods are
    ported: values the JAX engine refuses raise, and an engine without a
    prefix store has nothing to export or import."""
    _, _, port = models
    eng = DecodeEngine(port, slots=1, max_new_tokens=2)
    p = np.arange(3, dtype=np.int32)
    with pytest.raises(ValueError, match="priority"):
        eng.submit(p, priority=3)
    with pytest.raises(ValueError, match="speculative"):
        eng.submit(p, speculative=True)
    with pytest.raises(ValueError, match="structure mismatch"):
        eng.swap_variables({})
    assert eng.export_prefix(p) is None
    assert eng.import_prefix(p, [[]]) == 0 and eng.match_blocks(p) == 0
    eng.submit(p, tenant="a", priority=2)
    (res,) = eng.drain()
    np.testing.assert_array_equal(res["tokens"],
                                  _want(port, {"prompt": p,
                                               "max_new_tokens": 2}))
