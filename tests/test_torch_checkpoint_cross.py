"""Trainer checkpoints cross between the packages, in both directions.

* JAX -> port: a JAX trainer writes a checkpoint; the port restores it
  to the file's values (parameters, optimizer state, BatchNorm
  statistics, the PS center and clock, every worker) and trains on from
  it to the JAX trainer's uninterrupted result.
* port -> JAX: the port writes a checkpoint; the JAX trainer's own
  ``load_checkpoint`` (with its own template) restores the port's
  values, and the JAX trainer trains on from the port's directory.

Runs: ``SingleTrainer`` on an MLP (adam), on a ``norm="batch"`` ResNet
of basic blocks (momentum) and on a tiny ``TransformerLM`` (adam, the
heads' layout); ``ADAG`` on an MLP (momentum, 2 workers).  Random
streams do not cross (threefry against ``torch.Generator``): the models
draw nothing, and the PS runs take the JAX commit orders.  Parity as in
the trainers' own tests: the MLPs to rtol 2e-5, the ResNet within 1e-2
of each parameter's rms, the LM to 2e-5 except its key biases, which
get only rounding noise as gradient (see ``test_torch_trainers.py``),
and a few entries in a thousand whose gradient is as small, which may
differ by up to two Adam steps after a crossing.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as flax_ser

from distkeras_tpu import trainers as jax_trainers
from distkeras_tpu.data import datasets as jax_datasets
from distkeras_tpu.models import ModelSpec
from distkeras_tpu.models import model_config as jax_config
from distkeras_tpu_torch import (ADAG, SingleTrainer, checkpoint, convert,
                                 serialization)
from distkeras_tpu_torch.data import datasets
from distkeras_tpu_torch.models import model_config
from distkeras_tpu_torch.workers import TrainState, rng_stream

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)

LOSS = "sparse_categorical_crossentropy"
LM = dict(vocab_size=64, num_layers=2, d_model=32, num_heads=4,
          num_kv_heads=2, max_len=16, dtype="float32")
CASES = {
    "mlp": dict(family="mlp", shape=(8,), model=dict(num_classes=4,
                                                     hidden=(16,)),
                train=dict(worker_optimizer="adam", learning_rate=3e-3,
                           batch_size=32),
                data=lambda d: d.synthetic_classification(256, (8,), 4,
                                                          seed=2)),
    "resnet_batch": dict(
        family="resnet", shape=(16, 16, 3),
        model=dict(num_classes=4, stage_sizes=(1, 1), bottleneck=False,
                   width=8, norm="batch", dtype="float32"),
        train=dict(worker_optimizer="momentum", learning_rate=0.02,
                   batch_size=8),
        data=lambda d: d.synthetic_classification(32, (16, 16, 3), 4,
                                                  seed=4)),
    "lm": dict(family="transformer_lm", shape=(16,), model=LM,
               dtype="int32",
               train=dict(worker_optimizer="adam", learning_rate=3e-3,
                          batch_size=8),
               data=lambda d: d.lm_synth(32, seq_len=16, vocab_size=64)),
}


def _configs(case):
    c = CASES[case]
    kw = dict(input_dtype=c.get("dtype", "float32"), **c["model"])
    return (jax_config(c["family"], c["shape"], **kw),
            model_config(c["family"], c["shape"], **kw))


def _jax_start(case):
    c = CASES[case]
    spec, _ = _configs(case)
    model = ModelSpec.from_config(spec).build()
    if c["family"] == "transformer_lm":
        model = model.clone(attn="dense")
    sample = jnp.zeros((2, *c["shape"]),
                       jnp.int32 if c.get("dtype") else jnp.float32)
    return jax.tree_util.tree_map(np.asarray,
                                  dict(model.init(jax.random.key(0),
                                                  sample)))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jax_state_dict(state):
    """A restored JAX state (key leaves dropped) as flat numpy."""
    sd = flax_ser.to_state_dict(jax.tree_util.tree_map(
        lambda x: jax.random.key_data(x)
        if jax.dtypes.issubdtype(x.dtype, jax.dtypes.prng_key) else x,
        state))
    return {k: v for k, v in _flat(sd).items()
            if not k.endswith("rng") and "perm_key" not in k}


def _assert_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k


def _keep_epoch_one(trainer, dest):
    """Copy the JAX trainer's epoch-1 save to ``dest`` as it is written
    (its later saves overwrite the file in its own directory)."""
    orig = trainer._maybe_save

    def save(state, cursor):
        orig(state, cursor)
        if cursor.get("epoch") == 1 and not cursor.get("round"):
            dest.mkdir(parents=True)
            shutil.copy(checkpoint.checkpoint_file(trainer.checkpoint_dir),
                        dest / checkpoint.LATEST)

    trainer._maybe_save = save


def _capture_resume(trainer):
    """Wrap the JAX trainer's ``_maybe_resume``: keep what its own
    template restored."""
    got = {}
    orig = trainer._maybe_resume

    def resume(resume_from, template):
        state, cursor = orig(resume_from, template)
        got["state"], got["cursor"] = state, dict(cursor)
        return state, cursor

    trainer._maybe_resume = resume
    return got


def _close(got: dict, want: dict, case):
    for k in want:
        if case == "lm" and "['key']['bias']" in k:
            continue
        if case == "lm":
            # Adam turns a gradient at the rounding level into a step of
            # up to lr: a handful of entries whose gradient is that small
            # may take a step in one package and not in the other
            off = np.abs(got[k] - want[k]) > 2e-5 + 2e-5 * np.abs(want[k])
            assert off.mean() <= 1e-3, k
            assert np.abs(got[k] - want[k])[off].max(initial=0) <= 2 * 3e-3
        elif case == "resnet_batch":
            rms = np.sqrt(np.mean(np.square(want[k])))
            assert np.abs(got[k] - want[k]).max() <= 1e-2 * rms + 1e-6, k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-5,
                                       atol=2e-5, err_msg=k)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_variables(case, pv):
    heads = LM["num_heads"] if case == "lm" else None
    if case == "lm":
        return {"params": convert.params_to_flax(pv, num_heads=heads)}
    return convert.variables_to_flax(pv)


@pytest.mark.parametrize("case", sorted(CASES))
def test_single_trainer_checkpoints_cross(case, tmp_path):
    c = CASES[case]
    spec, cfg = _configs(case)
    start = _jax_start(case)
    train = dict(loss=LOSS, seed=0, **c["train"])
    heads = LM["num_heads"] if case == "lm" else None
    jax_data, data = c["data"](jax_datasets), c["data"](datasets)
    port_start = convert.variables_from_flax(start)

    # the JAX run of two epochs; its epoch-1 file kept
    jax_dir = tmp_path / "jax"
    jt = jax_trainers.SingleTrainer(spec, num_epoch=2, checkpoint_dir=str(
        tmp_path / "jax_all"), **train)
    _keep_epoch_one(jt, jax_dir)
    jv = jt.train(jax_data, initial_variables=start)

    # JAX -> port: the file's values, then epoch 2 from it
    pt = SingleTrainer(cfg, num_epoch=2, device="cpu", **train)
    tx = pt._tx()
    state = TrainState.create(pt.model, port_start, tx, device="cpu",
                              rng=rng_stream(1))
    state, cursor = pt._maybe_resume(str(jax_dir), state)
    assert cursor == {"epoch": 1}
    assert pt.history["epoch_loss"] == jt.history["epoch_loss"][:1]
    want = _flat(serialization.msgpack_restore(
        (jax_dir / checkpoint.LATEST).read_bytes())["state"])
    del want["rng"]
    got = _flat(serialization.to_host(convert.train_state_to_flax(
        state, tx.chain, heads)))
    del got["rng"]
    _assert_equal(got, want)
    pv = pt.train(data, initial_variables=port_start,
                  resume_from=str(jax_dir))
    np.testing.assert_allclose(pt.history["epoch_loss"],
                               jt.history["epoch_loss"], rtol=1e-4)
    _close(_leaves(_port_variables(case, pv)), _leaves(jv), case)

    # port -> JAX: the JAX template restores the port's values, and the
    # JAX trainer trains epoch 2 from the port's directory
    port_dir = tmp_path / "port"
    p1 = SingleTrainer(cfg, num_epoch=1, checkpoint_dir=str(port_dir),
                       device="cpu", **train)
    p1v = p1.train(data, initial_variables=port_start)
    jr = jax_trainers.SingleTrainer(spec, num_epoch=2, **train)
    got = _capture_resume(jr)
    jrv = jr.train(jax_data, initial_variables=start,
                   resume_from=str(port_dir))
    assert got["cursor"] == {"epoch": 1}
    restored = _jax_state_dict(got["state"])
    steps = len(data) // c["train"]["batch_size"]
    assert int(restored["step"]) == steps
    _assert_equal({k[len("params/"):]: v for k, v in restored.items()
                   if k.startswith("params/")},
                  _flat(_port_variables(case, p1v)["params"]))
    if case == "resnet_batch":
        _assert_equal({k[len("model_state/batch_stats/"):]: v
                       for k, v in restored.items()
                       if k.startswith("model_state/batch_stats/")},
                      _flat(convert.variables_to_flax(p1v)["batch_stats"]))
    # the optimizer state is the port's: against the JAX run's own
    # epoch-1 file at the trainers' parity
    jax_file = _flat(serialization.msgpack_restore(
        (jax_dir / checkpoint.LATEST).read_bytes())["state"])
    opt = {k: v for k, v in restored.items() if k.startswith("opt_state")}
    assert opt.keys() == {k for k in jax_file if k.startswith("opt_state")}
    _close(opt, {k: jax_file[k] for k in opt}, case)
    assert jr.history["epoch_loss"][:1] == p1.history["epoch_loss"]
    _close(_leaves(jrv), _leaves(jv), case)


def _jax_orders(seed, num_workers, rounds):
    key, out = jax.random.key(seed + 2), []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.permutation(sub, num_workers))
                   .tolist())
    return out


def test_adag_checkpoints_cross(tmp_path):
    """ADAG (MLP, momentum, 2 workers, 4 rounds an epoch): the stacked
    worker states, the center and the clock cross both ways."""
    c = CASES["mlp"]
    spec, cfg = _configs("mlp")
    start = _jax_start("mlp")
    train = dict(loss=LOSS, seed=1, num_workers=2, communication_window=2,
                 batch_size=16, learning_rate=0.05, lr_law="off",
                 worker_optimizer="momentum")
    jax_data, data = c["data"](jax_datasets), c["data"](datasets)
    port_start = convert.variables_from_flax(start)
    rounds = 256 // 2 // 16 // 2
    orders = _jax_orders(train["seed"], 2, 2 * rounds)

    jax_dir = tmp_path / "jax"
    jt = jax_trainers.ADAG(spec, num_epoch=2, checkpoint_dir=str(
        tmp_path / "jax_all"), **train)
    _keep_epoch_one(jt, jax_dir)
    jv = jt.train(jax_data, initial_variables=start)

    # JAX -> port: the file's values; a resume skips the recorded
    # rounds' orders and meets the JAX trainer's uninterrupted run
    pt = ADAG(cfg, num_epoch=2, device="cpu", **train)
    pt.commit_orders = lambda: iter(orders)
    pv = pt.train(data, initial_variables=port_start,
                  resume_from=str(jax_dir))
    np.testing.assert_allclose(pt.history["round_loss"],
                               jt.history["round_loss"], rtol=1e-5,
                               atol=1e-5)
    assert pt.history["staleness"] == jt.history["staleness"]
    _close(_leaves(convert.params_to_flax(pv)), _leaves(jv["params"]),
           "mlp")
    probe = ADAG(cfg, num_epoch=2, device="cpu", **train)
    tx = probe._tx()
    workers = [TrainState.create(probe.model, port_start, tx, device="cpu",
                                 rng=rng_stream(2, w)) for w in range(2)]
    center = {k: v.clone() for k, v in port_start.items()}
    live, cursor = probe._maybe_resume(str(jax_dir), {
        "ps": probe.allocate_rule().init_state(center), "workers": workers,
        "orders": 0})
    assert cursor == {"epoch": 1, "round": 0} and live["orders"] == rounds
    tree, _ = probe._to_checkpoint(live)
    got = _flat(serialization.to_host(tree))
    want = _flat(serialization.msgpack_restore(
        (jax_dir / checkpoint.LATEST).read_bytes())["state"])
    for k in ("perm_key", "workers/rng"):
        del got[k], want[k]
    _assert_equal(got, want)

    # port -> JAX: the JAX template restores the port's center, clock
    # and workers; the JAX trainer's second epoch (its commit orders
    # start again from the file's perm_key) meets the port's run with
    # those orders
    port_dir = tmp_path / "port"
    p1 = ADAG(cfg, num_epoch=1, checkpoint_dir=str(port_dir), device="cpu",
              **train)
    p1.commit_orders = lambda: iter(orders)
    p1v = p1.train(data, initial_variables=port_start)
    jr = jax_trainers.ADAG(spec, num_epoch=2, **train)
    got = _capture_resume(jr)
    jrv = jr.train(jax_data, initial_variables=start,
                   resume_from=str(port_dir))
    restored = _jax_state_dict(got["state"])
    assert int(restored["ps/clock"]) == 2 * rounds
    assert restored["workers/step"].tolist() == [2 * rounds] * 2
    _assert_equal({k[len("ps/center/"):]: v for k, v in restored.items()
                   if k.startswith("ps/center/")},
                  _flat(convert.params_to_flax(p1v)))
    ref = ADAG(cfg, num_epoch=2, device="cpu", **train)
    ref.commit_orders = lambda: iter(orders[:rounds] * 2)
    rv = ref.train(data, initial_variables=port_start)
    np.testing.assert_allclose(jr.history["round_loss"],
                               ref.history["round_loss"], rtol=1e-5,
                               atol=1e-5)
    _close(_leaves(jrv["params"]), _leaves(convert.params_to_flax(rv)),
           "mlp")
