"""The port's PS trainers (``DOWNPOUR``, ``ADAG``, ``DynSGD``,
``AEASGD``, ``EAMSGD``) against the JAX package's.

Both trainers of a pair start from the same weights (the JAX init,
mapped by ``convert``), see the same epochs (``Dataset.shuffle`` with
``seed + 17 * epoch`` draws the same permutation in both packages, and
``repartition`` splits the rows alike) and apply the same commit orders:
the port's ``commit_orders`` is replaced by the sequence the JAX trainer
draws from ``jax.random.key(seed + 2)``.  On an MLP the history series
agree to 1e-5 and the centers to rtol 2e-5 (f32 summation order,
carried through 16 rounds); staleness exactly."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu import trainers as jax_trainers
from distkeras_tpu.data import datasets as jax_datasets
from distkeras_tpu.models import ModelSpec
from distkeras_tpu.models import model_config as jax_config
from distkeras_tpu_torch import (ADAG, AEASGD, DOWNPOUR, EAMSGD, DynSGD,
                                 convert)
from distkeras_tpu_torch.data import datasets
from distkeras_tpu_torch.models import model_config

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)

MLP = dict(num_classes=4, hidden=(32,))
KW = dict(num_workers=4, communication_window=2, batch_size=8, num_epoch=2,
          learning_rate=0.05, lr_law="off", seed=0,
          loss="sparse_categorical_crossentropy")
HIST_TOL, PARAM_TOL = 1e-5, 2e-5


def _jax_orders(seed, num_workers, rounds):
    """The JAX trainer's commit orders (``trainers.py`` draws one per
    round from ``jax.random.key(seed + 2)``)."""
    key, out = jax.random.key(seed + 2), []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.permutation(sub, num_workers))
                   .tolist())
    return out


def _pair(name, family, shape, model_kw, data_fn, **kw):
    kw = {**KW, **kw}
    spec = jax_config(family, shape, **model_kw)
    params = ModelSpec.from_config(spec).build().init(
        jax.random.key(0), jnp.zeros((2, *shape)))["params"]
    jt = getattr(jax_trainers, name)(spec, **kw)
    jv = jt.train(data_fn(jax_datasets), initial_variables={"params": params})
    pt = globals()[name](model_config(family, shape, **model_kw),
                         device="cpu", **kw)
    orders = _jax_orders(kw["seed"], kw["num_workers"],
                         len(jt.history["round_loss"]))
    pt.commit_orders = lambda: iter(orders)
    pv = pt.train(data_fn(datasets), initial_variables=convert
                  .params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                           params)))
    return jt, jv, pt, pv


@pytest.mark.parametrize("name,fidelity,overlap", [
    ("DOWNPOUR", "faithful", False), ("ADAG", "faithful", False),
    ("DynSGD", "faithful", False), ("AEASGD", "faithful", False),
    ("EAMSGD", "faithful", False), ("ADAG", "fast", False),
    ("DynSGD", "faithful", True)])
def test_trainer_matches_jax(name, fidelity, overlap):
    jt, jv, pt, pv = _pair(
        name, "mlp", (8,), MLP,
        lambda d: d.synthetic_classification(256, (8,), 4, seed=3),
        fidelity=fidelity, commit_overlap=overlap,
        worker_optimizer="nesterov" if name == "EAMSGD" else "momentum")
    assert sorted(pt.history) == sorted(jt.history)
    for key in ("round_loss", "epoch_loss", "dropped_tail_batches"):
        np.testing.assert_allclose(pt.history[key], jt.history[key],
                                   rtol=HIST_TOL, atol=HIST_TOL, err_msg=key)
    assert pt.history["staleness"] == jt.history["staleness"]
    want = convert.params_from_flax(jax.tree_util.tree_map(
        np.asarray, jv["params"]))
    assert pv.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(pv[k].numpy(), want[k].numpy(),
                                   rtol=PARAM_TOL, atol=1e-6, err_msg=k)
    assert pt.parameter_server_state.clock \
        == int(jt.parameter_server_state.clock)
    # the trained center is loaded into the trainer's model too
    assert all(torch.equal(pt.model.state_dict()[k], pv[k]) for k in pv)


def test_group_pallas_resnet_trains_through_adag_like_jax():
    """A tiny ``norm="group_pallas"`` ResNet through ADAG: round losses
    within 1e-3 and centers within 1e-2 of the parameters' rms, per leaf.
    Looser than the MLP's: XLA's CPU convolutions are not
    batching-stable (the vmapped JAX workers' convs differ from solo
    ones by ~7e-3 relative), and momentum carries that through the
    rounds."""
    resnet = dict(num_classes=4, stage_sizes=(1,), bottleneck=False,
                  width=8, norm="group_pallas", stem="space_to_depth",
                  dtype="float32")
    jt, jv, pt, pv = _pair(
        "ADAG", "resnet", (8, 8, 3), resnet,
        lambda d: d.synthetic_classification(64, (8, 8, 3), 4, seed=4),
        num_workers=2, batch_size=4, num_epoch=1, learning_rate=0.02,
        worker_optimizer="momentum")
    np.testing.assert_allclose(pt.history["round_loss"],
                               jt.history["round_loss"], atol=1e-3)
    assert pt.history["staleness"] == jt.history["staleness"]
    want = convert.params_from_flax(jax.tree_util.tree_map(
        np.asarray, jv["params"]))
    for k in want:
        rms = want[k].square().mean().sqrt().item()
        assert (pv[k] - want[k]).abs().max().item() <= 1e-2 * rms + 1e-6, k


def test_adag_trains_a_flash_kernel_lm():
    """``tests/test_flash_attention.py``'s integration case on the port:
    ADAG trains a ``flash_attn=True`` TransformerLM (the flash kernels'
    plain versions on the CPU, under the same autograd Function)."""
    data = datasets.lm_synth(256, seq_len=16, vocab_size=32, seed=0)
    spec = model_config("transformer_lm", (16,), input_dtype="int32",
                        vocab_size=32, num_layers=1, d_model=32,
                        num_heads=4, max_len=16, dtype="float32",
                        flash_attn=True)
    t = ADAG(spec, loss="sparse_categorical_crossentropy", num_workers=4,
             communication_window=2, batch_size=8, num_epoch=2,
             learning_rate=3e-3, worker_optimizer="adam", seed=0,
             device="cpu")
    t.train(data)
    h = t.history["epoch_loss"]
    assert np.isfinite(h).all() and h[-1] < h[0], h
    assert len(t.epoch_time_s) == 2 and min(t.epoch_time_s) > 0


def _caught(make):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        make()
    return [str(x.message) for x in w if issubclass(x.category, UserWarning)]


def test_lr_law_guardrail():
    """The JAX package's per-family lr laws: a config past the measured
    stability scale warns with its law, ``lr_law="scale"`` applies it,
    ``"off"`` silences it."""
    cfg = model_config("mlp", (4,), num_classes=2, hidden=(4,))

    def make(cls, **kw):
        return lambda: cls(cfg, device="cpu", **kw)

    msgs = _caught(make(DOWNPOUR, num_workers=4, communication_window=4,
                        learning_rate=0.05))
    assert len(msgs) == 1 and "num_workers * communication_window" \
        in msgs[0], msgs
    assert "num_workers" in _caught(make(ADAG, num_workers=8,
                                         learning_rate=0.05))[0]
    assert "communication_window" in _caught(make(
        DynSGD, communication_window=8, learning_rate=0.05))[0]
    assert "momentum" in _caught(make(EAMSGD, num_workers=2,
                                      learning_rate=0.05))[0]
    assert _caught(make(AEASGD, num_workers=8, communication_window=8,
                        learning_rate=0.05)) == []
    assert _caught(make(DOWNPOUR, num_workers=4, communication_window=4,
                        learning_rate=0.05 / 16)) == []
    t = DOWNPOUR(cfg, num_workers=4, communication_window=4,
                 learning_rate=0.05, lr_law="scale", device="cpu")
    assert abs(t.learning_rate - 0.05 / 16) < 1e-12
    assert ADAG(cfg, num_workers=4, learning_rate=0.1, lr_law="scale",
                device="cpu").learning_rate == 0.025
    assert EAMSGD(cfg, learning_rate=0.1, lr_law="scale",
                  device="cpu").learning_rate == 0.05
    assert _caught(make(DOWNPOUR, num_workers=4, communication_window=4,
                        learning_rate=0.05, lr_law="off")) == []
    with pytest.raises(ValueError, match="lr_law"):
        DOWNPOUR(cfg, lr_law="sometimes", device="cpu")


def test_elastic_trainers_derive_alpha():
    cfg = model_config("mlp", (4,), num_classes=2, hidden=(4,))
    t = AEASGD(cfg, rho=2.0, learning_rate=0.1, device="cpu")
    assert t.alpha == pytest.approx(0.2)
    assert t.allocate_rule().alpha == pytest.approx(0.2)
    assert AEASGD(cfg, device="cpu").learning_rate == 0.01
    e = EAMSGD(cfg, momentum=0.5, device="cpu")
    assert e.worker_optimizer == "nesterov" and e.momentum == 0.5
    with pytest.raises(ValueError, match="scalar learning_rate"):
        AEASGD(cfg, learning_rate={"schedule": "constant", "value": 0.1},
               device="cpu").alpha


@pytest.mark.parametrize("kw", [
    {"fidelity": "mesh"}, {"model_parallel": 2},
    {"ps_replicas": [("127.0.0.1", 1)]}, {"ps_elastic": True},
    {"ps_groups": [(None, [0, 1])]}, {"comm_codec": "int8"},
    {"comm_dtype": "bfloat16"}, {"attrib_every": 1}])
def test_unported_arms_raise(kw):
    cfg = model_config("mlp", (4,), num_classes=2, hidden=(4,))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ADAG(cfg, device="cpu", **kw)


def test_bad_arguments_raise_as_in_jax():
    cfg = model_config("mlp", (4,), num_classes=2, hidden=(4,))
    with pytest.raises(ValueError, match="valid lowering tiers"):
        ADAG(cfg, fidelity="warp", device="cpu")
    with pytest.raises(ValueError, match="commit_overlap"):
        ADAG(cfg, fidelity="fast", commit_overlap=True, device="cpu")
    t = ADAG(cfg, device="cpu", num_workers=2, communication_window=4,
             batch_size=8)
    data = datasets.synthetic_classification(32, (4,), 2)
    with pytest.raises(ValueError, match="communication window"):
        t.train(data)      # 16 rows a worker: 2 batches, window 4
