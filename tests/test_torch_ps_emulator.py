"""The port's emulated PS rounds (``distkeras_tpu_torch.parallel.
ps_emulator``) against the JAX package's on an MLP: the same start, the
same batches and the same commit orders.

The port runs each worker's window in turn where the JAX round vmaps
them; the workers do not interact before the commits, so the centers,
the workers' parameters and the round metrics agree to f32 rounding:
rtol 2e-5, the limit the JAX package holds its own MLP tiers to (the
mesh-vs-fast check).  An MLP, not a conv net, carries this check: XLA's
CPU convolutions are not batching-stable (a vmapped conv differs from a
solo one by ~7e-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distkeras_tpu.models import ModelSpec
from distkeras_tpu.models import model_config as jax_config
from distkeras_tpu.parallel import ps_emulator as jax_emu
from distkeras_tpu.parallel import update_rules as jax_rules
from distkeras_tpu.workers import TrainState as JaxState
from distkeras_tpu.workers import make_train_step as jax_step
from distkeras_tpu_torch import build_model, convert
from distkeras_tpu_torch.models import model_config
from distkeras_tpu_torch.parallel import ps_emulator, update_rules
from distkeras_tpu_torch.workers import (TrainState, make_train_step,
                                         resolve_optimizer)

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)

W, WINDOW, B, DIM, CLASSES = 4, 2, 8, 8, 4
MLP = dict(num_classes=CLASSES, hidden=(32,))
LOSS = "sparse_categorical_crossentropy"
RTOL = 2e-5
PERMS = [[2, 0, 3, 1], [1, 3, 0, 2], [0, 1, 2, 3]]
RULE_KW = {"aeasgd": {"alpha": 0.25}}


def _setup(seed=0):
    spec = jax_config("mlp", (DIM,), **MLP)
    model = ModelSpec.from_config(spec).build()
    params = model.init(jax.random.key(seed), jnp.zeros((2, DIM)))["params"]
    rng = np.random.default_rng(seed)
    rounds = [{"features": rng.standard_normal(
                   (W, WINDOW, B, DIM)).astype(np.float32),
               "label": rng.integers(0, CLASSES, (W, WINDOW, B)
                                     ).astype(np.int32)}
              for _ in PERMS]
    return model, params, rounds


def _jax_side(model, params, name):
    rule = getattr(jax_rules, jax_rules.RULES[name].__name__)(
        **RULE_KW.get(name, {}))
    tx = optax.sgd(0.05, momentum=0.9)
    states = jax.vmap(lambda k: JaxState.create({"params": params}, tx, k))(
        jax.random.split(jax.random.key(1), W))
    return rule, jax_step(model, LOSS, tx), states


def _port_side(params, name):
    rule = update_rules.RULES[name](**RULE_KW.get(name, {}))
    tx = resolve_optimizer("momentum", 0.05)
    model = build_model(model_config("mlp", (DIM,), **MLP), device="cpu")
    sd = convert.params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                         params))
    states = [TrainState.create(model, sd, tx) for _ in range(W)]
    center = {k: v.clone() for k, v in sd.items()}
    return rule, make_train_step(model, LOSS, tx), states, center


def _assert_trees(got: dict, want, err=""):
    want = convert.params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                           want))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), want[k].numpy(),
                                   rtol=RTOL, atol=1e-6,
                                   err_msg=f"{err} {k}")


def _assert_round(ps, states, metrics, jps, jstates, jmetrics):
    _assert_trees(ps.center, jps.center, "center")
    assert ps.clock == int(jps.clock)
    for w in range(W):
        _assert_trees(states[w].params, jax.tree_util.tree_map(
            lambda x: x[w], jstates.params), f"worker {w}")
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(metrics[key].detach().numpy(),
                                   np.asarray(jmetrics[key]), rtol=RTOL)
    np.testing.assert_array_equal(metrics["staleness"].numpy(),
                                  np.asarray(jmetrics["staleness"]))


@pytest.mark.parametrize("fidelity", ["faithful", "fast"])
@pytest.mark.parametrize("name", ["downpour", "adag", "dynsgd", "aeasgd"])
def test_round_matches_jax(name, fidelity):
    model, params, rounds = _setup()
    jrule, jstep, jstates = _jax_side(model, params, name)
    jround = jax.jit(jax_emu.make_round_fn(jrule, jstep, fidelity))
    jps = jrule.init_state(params)
    rule, step, states, center = _port_side(params, name)
    round_fn = ps_emulator.make_round_fn(rule, step, fidelity)
    ps = rule.init_state(center)
    for perm, batch in zip(PERMS, rounds):
        jps, jstates, jmetrics = jround(
            jps, jstates, {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.asarray(perm))
        ps, states, metrics = round_fn(
            ps, states, {k: torch.from_numpy(v) for k, v in batch.items()},
            perm)
        _assert_round(ps, states, metrics, jps, jstates, jmetrics)


@pytest.mark.parametrize("name", ["downpour", "adag", "dynsgd"])
def test_pipelined_round_and_flush_match_jax(name):
    model, params, rounds = _setup(seed=1)
    jrule, jstep, jstates = _jax_side(model, params, name)
    jround = jax.jit(jax_emu.make_pipelined_round_fn(jrule, jstep))
    jps = jrule.init_state(params)
    jpend = jax.tree_util.tree_map(jnp.zeros_like, jstates.params)
    jpend_perm, jvalid = jnp.arange(W), jnp.asarray(False)
    rule, step, states, center = _port_side(params, name)
    round_fn = ps_emulator.make_pipelined_round_fn(rule, step)
    ps = rule.init_state(center)
    pend, pend_perm, valid = None, list(range(W)), False
    for perm, batch in zip(PERMS, rounds):
        (jps, jstates, jmetrics, jpend, jpend_perm, jvalid) = jround(
            jps, jstates, {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.asarray(perm), jpend, jpend_perm, jvalid)
        (ps, states, metrics, pend, pend_perm, valid) = round_fn(
            ps, states, {k: torch.from_numpy(v) for k, v in batch.items()},
            perm, pend, pend_perm, valid)
        _assert_round(ps, states, metrics, jps, jstates, jmetrics)
    jps = jax_emu.flush_pending(jrule, jps, jpend, jpend_perm, W)
    ps = ps_emulator.flush_pending(rule, ps, pend, pend_perm, W)
    _assert_trees(ps.center, jps.center, "flushed center")
    assert ps.clock == int(jps.clock) == W * len(PERMS)


def test_pipelining_refuses_the_elastic_rule():
    with pytest.raises(ValueError, match="delta-payload"):
        ps_emulator.make_pipelined_round_fn(update_rules.ElasticRule(),
                                            lambda s, b: (s, {}))
    with pytest.raises(ValueError, match="fidelity"):
        ps_emulator.make_round_fn(update_rules.AdagRule(),
                                  lambda s, b: (s, {}), "mesh")


def test_commit_permutations_are_seeded_permutations():
    a = ps_emulator.commit_permutations(2, 5)
    b = ps_emulator.commit_permutations(2, 5)
    drawn = [next(a) for _ in range(6)]
    assert drawn == [next(b) for _ in range(6)]
    assert all(sorted(p) == list(range(5)) for p in drawn)
    assert len({tuple(p) for p in drawn}) > 1
