"""Dropout in the port's MLP and ConvNet, held to flax's semantics.

The two packages draw from different generators (threefry, Philox), so
no mask of the port can equal one of the JAX package's: dropout is held
by what flax promises instead.  In train mode each element is kept with
probability ``1 - rate`` (the share of zeros within ``Z`` binomial
standard deviations of ``rate``) and a kept one is exactly ``x / (1 -
rate)``; eval mode and ``rate=0`` are the identity, bit for bit; each
training state draws from its own stream (``TrainState.rng``), so two
workers or two members draw different masks, and one seed reruns bit
for bit."""

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import (ADAG, EnsembleTrainer, SingleTrainer,
                                 build_model)
from distkeras_tpu_torch.data import datasets
from distkeras_tpu_torch.models import model_config
from distkeras_tpu_torch.models.layers import dropout
from distkeras_tpu_torch.workers import (TrainState, make_train_step,
                                         resolve_optimizer, rng_stream)

torch.set_num_threads(1)

RATE, Z = 0.3, 6
LOSS = "sparse_categorical_crossentropy"
FAMILIES = {"mlp": ((8,), dict(num_classes=4, hidden=(64, 32))),
            "convnet": ((8, 8, 3), dict(num_classes=4, widths=(8,),
                                        dense=64))}


def test_dropout_keeps_and_scales_as_flax():
    x = torch.randn(200, 500, generator=torch.Generator().manual_seed(0))
    y = dropout(x, RATE, True, torch.Generator().manual_seed(1))
    zeros = (y == 0).float().mean().item()
    assert abs(zeros - RATE) <= Z * np.sqrt(RATE * (1 - RATE) / x.numel())
    kept = y != 0
    assert torch.equal(y[kept], x[kept] / torch.tensor(1 - RATE))
    assert dropout(x, RATE, False, None) is x
    assert dropout(x, 0.0, True, None) is x
    assert torch.equal(dropout(x, 1.0, True, torch.Generator()),
                       torch.zeros_like(x))
    with pytest.raises(ValueError, match="rng"):
        dropout(x, RATE, True, None)
    # bf16 divides by the rate rounded to bf16, as jnp does
    xb = x.bfloat16()
    yb = dropout(xb, RATE, True, torch.Generator().manual_seed(1))
    assert torch.equal(yb[kept], xb[kept] / torch.tensor(
        1 - RATE, dtype=torch.bfloat16))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_model_dropout_modes(family):
    """``dropout_rate=0`` is the current model bit for bit, in either
    mode; with ``dropout_rate=0.3`` eval mode is that model too, train
    mode differs, and the same generator seed gives the same output."""
    shape, kw = FAMILIES[family]
    plain = build_model(model_config(family, shape, **kw), device="cpu")
    drop = build_model(model_config(family, shape, dropout_rate=RATE, **kw),
                       device="cpu")
    drop.load_state_dict(plain.state_dict())
    x = torch.randn(16, *shape, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = plain(x)
        assert torch.equal(plain(x, train=True,
                                 rng=torch.Generator().manual_seed(3)), want)
        assert torch.equal(drop(x), want)
        a = drop(x, train=True, rng=torch.Generator().manual_seed(3))
        b = drop(x, train=True, rng=torch.Generator().manual_seed(3))
        c = drop(x, train=True, rng=torch.Generator().manual_seed(4))
    assert torch.equal(a, b)
    assert not torch.equal(a, want) and not torch.equal(a, c)


def test_each_state_draws_its_own_masks():
    """Two states from one start, one batch: the step's losses differ
    with the workers' streams (``rng_stream(seed + 1, w)``) and with the
    members', and agree where the streams are equal."""
    shape, kw = FAMILIES["mlp"]
    model = build_model(model_config("mlp", shape, dropout_rate=RATE, **kw),
                        device="cpu")
    tx = resolve_optimizer("sgd", 0.1)
    step = make_train_step(model, LOSS, tx)
    rng = np.random.default_rng(5)
    batch = {"features": torch.tensor(rng.standard_normal(
                 (32, *shape)).astype(np.float32)),
             "label": torch.tensor(rng.integers(0, 4, 32))}
    start = model.state_dict()

    def loss(g):
        state = TrainState.create(model, start, tx, rng=g)
        return float(step(state, batch)[1]["loss"])

    assert loss(rng_stream(1, 0)) != loss(rng_stream(1, 1))
    assert loss(rng_stream(1, 0)) == loss(rng_stream(1, 0))
    assert loss(rng_stream(1)) != loss(rng_stream(1, 0))
    ens = EnsembleTrainer(model_config("mlp", shape, dropout_rate=RATE,
                                       **kw), device="cpu")
    members = ens._member_states(start)
    assert len({float(step(s, batch)[1]["loss"]) for s in members}) == 2


@pytest.mark.parametrize("family", list(FAMILIES))
def test_trainers_with_dropout_rerun_bit_equal(family):
    """SingleTrainer and EnsembleTrainer train with ``dropout_rate=0.3``
    (finite losses), and a second run from the same seed is bit-equal."""
    shape, kw = FAMILIES[family]
    cfg = model_config(family, shape, dropout_rate=RATE, **kw)
    data = datasets.synthetic_classification(128, shape, 4, seed=0)
    train = dict(batch_size=16, num_epoch=2, learning_rate=3e-3,
                 worker_optimizer="adam", seed=0, loss=LOSS, device="cpu")
    for cls in (SingleTrainer, EnsembleTrainer):
        runs = []
        for _ in range(2):
            t = cls(cfg, **train)
            out = t.train(data)
            runs.append((t.history["epoch_loss"],
                         out if isinstance(out, list) else [out]))
        assert np.isfinite(runs[0][0]).all()
        assert runs[0][0] == runs[1][0]
        for a, b in zip(runs[0][1], runs[1][1]):
            assert all(torch.equal(a[k], b[k]) for k in a)


def test_adag_trains_a_dropout_mlp():
    """``tests/test_trainers.py::test_async_trainer_with_dropout_model``
    on the port: ADAG with one dropout stream per worker."""
    cfg = model_config("mlp", (8,), num_classes=4, hidden=(32,),
                       dropout_rate=RATE)
    t = ADAG(cfg, num_workers=2, communication_window=2, batch_size=32,
             num_epoch=1, learning_rate=0.05, loss=LOSS, device="cpu")
    t.train(datasets.synthetic_classification(512, (8,), 4, seed=0))
    losses = t.history["round_loss"]
    assert len(losses) >= 1 and np.isfinite(losses).all()
