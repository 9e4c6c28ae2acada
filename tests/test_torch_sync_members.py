"""The port's ``SyncTrainer``, ``EnsembleTrainer`` and ``AveragingTrainer``
against the JAX package's.

Both trainers of a pair start from the same weights (the JAX init,
mapped by ``convert``) and see the same rows: ``Dataset.shuffle`` draws
the same permutation in both packages, and ``repartition`` splits the
rows alike.  The JAX trainers run on the 8-device CPU mesh of
``tests/conftest.py``: ``SyncTrainer(num_workers=4)`` shards its global
batch over 4 devices and all-reduces the gradients, and the members are
sharded over the worker axis.  The port runs the same global batch, and
the members in turn, on one device, so the two differ by f32 summation
order: history series within ``HIST_TOL`` (relative) and parameters
within ``PARAM_TOL`` (relative, plus 1e-7 absolute), carried through 16
adam steps (measured: the losses within 1.3e-7, the parameters within
6e-8 absolute).  Within the port, ``SyncTrainer(W, B)`` is
``SingleTrainer(W * B)`` bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu import trainers as jax_trainers
from distkeras_tpu.data import datasets as jax_datasets
from distkeras_tpu.models import ModelSpec
from distkeras_tpu.models import model_config as jax_config
from distkeras_tpu_torch import (AveragingTrainer, EnsembleTrainer,
                                 SingleTrainer, SyncTrainer, build_model,
                                 convert)
from distkeras_tpu_torch.data import datasets
from distkeras_tpu_torch.models import model_config

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)

MLP = dict(num_classes=4, hidden=(32,))
SHAPE = (8,)
KW = dict(worker_optimizer="adam", learning_rate=3e-3, num_epoch=2,
          seed=0, loss="sparse_categorical_crossentropy")
HIST_TOL, PARAM_TOL = 1e-6, 1e-5


def _data(pkg, rows=256):
    return pkg.synthetic_classification(rows, SHAPE, 4, seed=3)


def _jax_params(seed=0):
    spec = jax_config("mlp", SHAPE, **MLP)
    return ModelSpec.from_config(spec).build().init(
        jax.random.key(seed), jnp.zeros((2, *SHAPE)))["params"]


def _to_port(params):
    return convert.params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                           params))


def _assert_params_close(got, want_flax):
    want = _to_port(want_flax)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=PARAM_TOL, atol=1e-7, err_msg=k)


def test_sync_trainer_matches_jax():
    """``num_workers=4``, adam, 2 epochs of 8 global batches of 32."""
    params = _jax_params()
    jt = jax_trainers.SyncTrainer(jax_config("mlp", SHAPE, **MLP),
                                  num_workers=4, batch_size=8, **KW)
    jv = jt.train(_data(jax_datasets), initial_variables={"params": params})
    pt = SyncTrainer(model_config("mlp", SHAPE, **MLP), num_workers=4,
                     batch_size=8, device="cpu", **KW)
    pv = pt.train(_data(datasets), initial_variables=_to_port(params))
    assert sorted(pt.history) == sorted(jt.history)
    np.testing.assert_allclose(pt.history["epoch_loss"],
                               jt.history["epoch_loss"], rtol=HIST_TOL)
    assert pt.num_workers == jt.num_workers == 4
    _assert_params_close(pv, jv["params"])


def test_sync_trainer_is_single_trainer_at_the_global_batch():
    """The global batch of W x B rows on one device is SingleTrainer's
    batch of W * B: the same steps, bit for bit, from the same start,
    dropout included (both streams seeded ``seed + 1``)."""
    cfg = model_config("mlp", SHAPE, **MLP, dropout_rate=0.2)
    start = build_model(cfg, device="cpu").state_dict()
    sync = SyncTrainer(cfg, num_workers=4, batch_size=8, device="cpu", **KW)
    sv = sync.train(_data(datasets), initial_variables=start)
    single = SingleTrainer(cfg, batch_size=32, device="cpu", **KW)
    tv = single.train(_data(datasets), initial_variables=start)
    assert sync.history["epoch_loss"] == single.history["epoch_loss"]
    np.testing.assert_array_equal(sync.step_metrics["loss"],
                                  single.step_metrics["loss"])
    assert all(torch.equal(sv[k], tv[k]) for k in tv)
    assert SyncTrainer(cfg, device="cpu").num_workers == 1


@pytest.mark.parametrize("kw,exc", [
    (dict(model_parallel=2), NotImplementedError),
    (dict(pipeline_stages=2), NotImplementedError),
    (dict(tp_rules={"Dense_0": None}), NotImplementedError),
    (dict(model_parallel=0), ValueError),
    (dict(pipeline_stages=0), ValueError),
    (dict(model_parallel=2, pipeline_stages=2), ValueError)])
def test_sync_trainer_rejects_what_is_not_ported(kw, exc):
    """Tensor and pipeline parallelism raise, naming ROADMAP.md; values
    the reference refuses raise its ``ValueError``."""
    with pytest.raises(exc, match="ROADMAP.md §1 item 9"
                       if exc is NotImplementedError else None):
        SyncTrainer(model_config("mlp", SHAPE, **MLP), device="cpu", **kw)


def _member_pair(name):
    """The JAX and the port's member trainer, 2 members from one shared
    ``initial_variables``, 2 epochs of 2 batches of 32 per member."""
    params = _jax_params()
    jt = getattr(jax_trainers, name)(jax_config("mlp", SHAPE, **MLP),
                                     batch_size=32, **KW)
    jv = jt.train(_data(jax_datasets, 128),
                  initial_variables={"params": params})
    pt = globals()[name](model_config("mlp", SHAPE, **MLP), batch_size=32,
                         device="cpu", **KW)
    pv = pt.train(_data(datasets, 128), initial_variables=_to_port(params))
    assert sorted(pt.history) == sorted(jt.history)
    np.testing.assert_allclose(pt.history["member_loss"],
                               jt.history["member_loss"], rtol=HIST_TOL)
    np.testing.assert_allclose(pt.history["epoch_loss"],
                               jt.history["epoch_loss"], rtol=HIST_TOL)
    return jt, jv, pt, pv


def test_ensemble_trainer_matches_jax():
    jt, jv, pt, pv = _member_pair("EnsembleTrainer")
    assert isinstance(pv, list) and len(pv) == len(jv) == 2
    for got, want in zip(pv, jv):
        _assert_params_close(got, want["params"])
    assert pt.trained_variables is pv[0] and pt.ensemble_variables is pv
    assert all(torch.equal(pt.model.state_dict()[k], pv[0][k])
               for k in pv[0])


def test_averaging_trainer_matches_jax():
    jt, jv, pt, pv = _member_pair("AveragingTrainer")
    _assert_params_close(pv, jv["params"])
    assert pt.num_workers == 2


def test_member_inits():
    """Ensemble: member i starts from the model's init drawn from ``seed
    + i``, so the members start different; Averaging: every member
    starts from the model's own init (``seed``)."""
    cfg = model_config("mlp", SHAPE, **MLP)
    ens = EnsembleTrainer(cfg, num_models=3, seed=5, device="cpu")
    starts = [s.variables() for s in ens._member_states(None)]
    for i, start in enumerate(starts):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(5 + i)
            want = build_model(cfg, device="cpu").state_dict()
        assert all(torch.equal(start[k], want[k]) for k in want)
    assert not torch.equal(starts[0]["Dense_0.weight"],
                           starts[1]["Dense_0.weight"])
    avg = AveragingTrainer(cfg, num_workers=3, seed=5, device="cpu")
    model = avg.model.state_dict()
    for s in avg._member_states(None):
        assert all(torch.equal(s.params[k].detach(), model[k])
                   for k in model)
    # each member keeps its own stream
    rngs = [s.rng for s in avg._member_states(None)]
    draws = [torch.rand(4, generator=g) for g in rngs]
    assert not torch.equal(draws[0], draws[1])


def test_averaging_is_the_members_mean():
    """The returned parameters are the mean of the members' trained ones
    (kept in ``member_variables``), the model state member 0's; the same
    members as an Ensemble from the same start."""
    cfg = model_config("mlp", SHAPE, **MLP)
    start = build_model(cfg, device="cpu").state_dict()
    avg = AveragingTrainer(cfg, batch_size=32, device="cpu", **KW)
    av = avg.train(_data(datasets, 128), initial_variables=start)
    members = avg.member_variables
    for k in av:
        assert torch.equal(av[k], torch.stack([m[k] for m in members])
                           .mean(0)), k
    ens = EnsembleTrainer(cfg, batch_size=32, device="cpu", **KW)
    ev = ens.train(_data(datasets, 128), initial_variables=start)
    for got, want in zip(ev, members):
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert not torch.equal(members[0]["Dense_0.weight"],
                           members[1]["Dense_0.weight"])


@pytest.mark.parametrize("name", ["EnsembleTrainer", "AveragingTrainer"])
def test_member_trainers_refuse_checkpoints(name):
    """As the reference's ``_guard_no_checkpoint``: ``ValueError`` at
    ``train()``, for a checkpoint directory or a resume."""
    cls = globals()[name]
    cfg = model_config("mlp", SHAPE, **MLP)
    data = _data(datasets, 128)
    with pytest.raises(ValueError, match="does not support checkpointing"):
        cls(cfg, checkpoint_dir="ckpt", device="cpu").train(data)
    with pytest.raises(ValueError, match="does not support checkpointing"):
        cls(cfg, device="cpu").train(data, resume_from="ckpt")
    with pytest.raises(ValueError, match="smaller than one batch"):
        cls(cfg, batch_size=128, device="cpu").train(data)


def test_averaging_keeps_member_0s_model_state():
    """With BatchNorm, the result holds the members' mean parameters and
    member 0's running statistics (not their mean), as the reference's
    ``finalize`` does."""
    cfg = model_config("resnet", (16, 16, 3), num_classes=4,
                       stage_sizes=(1,), bottleneck=False, width=8,
                       norm="batch", dtype="float32")
    avg = AveragingTrainer(cfg, batch_size=8, device="cpu", **KW)
    av = avg.train(datasets.synthetic_classification(32, (16, 16, 3), 4,
                                                      seed=0))
    m0, m1 = avg.member_variables
    stats = [k for k, _ in avg.model.named_buffers()]
    assert stats and all(torch.equal(av[k], m0[k])
                         and not torch.equal(m0[k], m1[k]) for k in stats)
    assert all(torch.equal(av[k], torch.stack([m0[k], m1[k]]).mean(0))
               for k, _ in avg.model.named_parameters())
