"""Port worker machinery (``distkeras_tpu_torch.workers``,
``ops/losses.py``) against the JAX package's, which calls optax.

Optimizers and schedules: the same seeded numpy parameters and
gradients go through five steps of each; the parameters must agree to
1e-6 relative (f32 rounding of the same formulas; optax takes the bias
correction's ``decay ** count`` in f32 on XLA, the port in f32 on
numpy, which may differ by an ulp).  Losses: 1e-6 on the values and
their gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distkeras_tpu.ops import losses as jax_losses
from distkeras_tpu.workers import OPTIMIZERS as JAX_OPTIMIZERS
from distkeras_tpu.workers import resolve_schedule as jax_schedule
from distkeras_tpu_torch import workers
from distkeras_tpu_torch.ops import losses

jax.config.update("jax_platforms", "cpu")
# tiny shapes: one thread each keeps the parallel test workers off
# each other's cores
torch.set_num_threads(1)

TOL = 1e-6
SHAPES = {"w": (4, 3), "b": (3,)}


def _draws(seed):
    rng = np.random.default_rng(seed)
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in SHAPES.items()}
    grads = [{n: (rng.standard_normal(s) * 10.0 ** rng.integers(-3, 1)
                  ).astype(np.float32) for n, s in SHAPES.items()}
             for _ in range(5)]
    return params, grads


def _run_both(jax_tx, port_tx, seed):
    params, grads = _draws(seed)
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    js = jax_tx.init(jp)
    tp = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    ts = port_tx.init(tp)
    for g in grads:
        upd, js = jax_tx.update({n: jnp.asarray(v) for n, v in g.items()},
                                js, jp)
        jp = optax.apply_updates(jp, upd)
        port_tx.update({n: torch.from_numpy(v) for n, v in g.items()}, ts,
                       tp)
        for n in SHAPES:
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                       rtol=TOL, atol=TOL, err_msg=n)


@pytest.mark.parametrize("name", sorted(JAX_OPTIMIZERS))
def test_optimizer_matches_optax(name):
    assert set(workers.OPTIMIZERS) == set(JAX_OPTIMIZERS)
    _run_both(JAX_OPTIMIZERS[name](lr=0.05),
              workers.resolve_optimizer(name, 0.05), seed=len(name))


@pytest.mark.parametrize("name,kwargs", [
    ("adam", {"b1": 0.8, "b2": 0.99, "eps": 1e-6}),
    ("adamw", {"weight_decay": 0.1}),
    ("rmsprop", {"decay": 0.5, "eps": 1e-4}),
    ("adagrad", {"initial_accumulator_value": 0.5, "eps": 1e-3}),
])
def test_optimizer_kwargs_match_optax(name, kwargs):
    _run_both(JAX_OPTIMIZERS[name](lr=0.01, **kwargs),
              workers.OPTIMIZERS[name](lr=0.01, **kwargs), seed=7)


SCHEDULE_SPECS = [
    {"schedule": "constant", "value": 0.1},
    {"schedule": "cosine", "init_value": 0.1, "decay_steps": 3,
     "alpha": 0.1},
    {"schedule": "exponential", "init_value": 0.1, "transition_steps": 2,
     "decay_rate": 0.5, "transition_begin": 1, "staircase": True},
    {"schedule": "exponential", "init_value": 0.1, "transition_steps": 1,
     "decay_rate": 0.5, "end_value": 0.02},
    {"schedule": "warmup_cosine", "init_value": 0.0, "peak_value": 0.1,
     "warmup_steps": 2, "decay_steps": 5, "end_value": 0.01},
    {"schedule": "piecewise_constant", "init_value": 0.1,
     "boundaries_and_scales": {"2": 0.5, "4": 0.1}},
]


@pytest.mark.parametrize("spec", SCHEDULE_SPECS,
                         ids=[f"{s['schedule']}{i}"
                              for i, s in enumerate(SCHEDULE_SPECS)])
def test_schedule_matches_optax(spec):
    want, got = jax_schedule(dict(spec)), workers.resolve_schedule(
        dict(spec))
    for count in range(7):
        assert got(count) == pytest.approx(float(want(count)), rel=TOL,
                                           abs=TOL), count


def test_scheduled_sgd_matches_optax():
    spec = SCHEDULE_SPECS[1]
    _run_both(JAX_OPTIMIZERS["momentum"](lr=jax_schedule(dict(spec))),
              workers.resolve_optimizer("momentum", dict(spec)), seed=3)


def test_resolve_rejects_unknown_names():
    with pytest.raises(KeyError, match="unknown optimizer"):
        workers.resolve_optimizer("lamb")
    with pytest.raises(KeyError, match="unknown schedule"):
        workers.resolve_schedule({"schedule": "linear"})
    assert workers.resolve_schedule(np.float32(0.5)) == 0.5


def _loss_cases():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 5, 7)).astype(np.float32)
    soft = rng.random((3, 5, 7)).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    binary = rng.standard_normal((6, 1)).astype(np.float32)
    return {
        "categorical_crossentropy": (logits, soft),
        "sparse_categorical_crossentropy": (
            logits, rng.integers(0, 7, (3, 5)).astype(np.int32)),
        "binary_crossentropy": (binary,
                                rng.integers(0, 2, 6).astype(np.int32)),
        "mse": (logits, soft),
        "mean_squared_error": (binary[:, 0], binary[::-1, 0].copy()),
        "mae": (logits, soft),
        "mean_absolute_error": (binary[:, 0], binary[::-1, 0].copy()),
    }


@pytest.mark.parametrize("name", sorted(jax_losses.LOSSES))
def test_loss_matches_jax(name):
    assert set(losses.LOSSES) == set(jax_losses.LOSSES)
    pred, target = _loss_cases()[name]
    jfn, tfn = jax_losses.LOSSES[name], losses.resolve_loss(name)
    want, want_grad = jax.value_and_grad(
        lambda p: jfn(p, jnp.asarray(target)))(jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_()
    got = tfn(tp, torch.from_numpy(target))
    got.backward()
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(want_grad),
                               rtol=TOL, atol=TOL)


def test_bf16_logits_lose_in_f32():
    logits = torch.randn(2, 4, 9, generator=torch.Generator().manual_seed(0))
    labels = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]])
    lo = losses.categorical_crossentropy(logits.bfloat16(), labels)
    assert lo.dtype == torch.float32
    want = losses.categorical_crossentropy(logits.bfloat16().float(), labels)
    assert lo.item() == want.item()
