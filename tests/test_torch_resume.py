"""Kill-and-resume on the port: a run stopped at a save and resumed from
its checkpoint repeats the uninterrupted run bit for bit (the scenarios
of ``tests/test_checkpoint.py``, on the port), with its history series;
and the guards that refuse checkpointing keep the reference's exception
types and messages."""

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import (ADAG, AveragingTrainer, EnsembleTrainer,
                                 SingleTrainer, SyncTrainer, checkpoint)
from distkeras_tpu_torch.data import datasets
from distkeras_tpu_torch.evaluators import evaluate_model
from distkeras_tpu_torch.models import model_config

torch.set_num_threads(1)

MLP = model_config("mlp", (8,), num_classes=4, hidden=(16,))
DROP_MLP = model_config("mlp", (8,), num_classes=4, hidden=(16,),
                        dropout_rate=0.3)
BN_RESNET = model_config("resnet", (16, 16, 3), num_classes=4,
                         stage_sizes=(1, 1), bottleneck=False, width=8,
                         norm="batch", dtype="float32")
DATA = datasets.synthetic_classification(1024, (8,), 4, seed=0)
IMAGES = datasets.synthetic_classification(64, (16, 16, 3), 4, seed=1)
PS = dict(num_workers=4, communication_window=2, batch_size=16,
          learning_rate=0.05, lr_law="off", device="cpu")


class StopAfter(Exception):
    pass


def _stop_after(trainer, cursor_wanted):
    """Stop the run right after the save at ``cursor_wanted``, as a
    crash would."""
    orig = trainer._maybe_save
    calls = []

    def saving(state, cursor):
        orig(state, cursor)
        calls.append(dict(cursor))
        if all(cursor.get(k) == v for k, v in cursor_wanted.items()):
            raise StopAfter

    trainer._maybe_save = saving
    return calls


def _same_result(a, b):
    assert a.trained_variables.keys() == b.trained_variables.keys()
    for k in a.trained_variables:
        assert torch.equal(a.trained_variables[k], b.trained_variables[k]), k
    # every series but the wall-clock one
    hist = [{k: v for k, v in t.history.items() if k != "segment_stall_s"}
            for t in (a, b)]
    assert hist[0] == hist[1]


def _kill_and_resume(make, data, cursor, tmp_path, **train_kw):
    ref = make()
    ref.train(data, **train_kw)
    part = make(checkpoint_dir=str(tmp_path))
    calls = _stop_after(part, cursor)
    with pytest.raises(StopAfter):
        part.train(data, **train_kw)
    assert calls[-1] == cursor
    resumed = make()
    resumed.train(data, resume_from=str(tmp_path), **train_kw)
    _same_result(resumed, ref)
    return ref, resumed


@pytest.mark.parametrize("cfg,train", [
    (MLP, dict(worker_optimizer="adam", learning_rate=3e-3)),
    (MLP, dict(worker_optimizer="adamw", learning_rate={
        "schedule": "cosine", "init_value": 3e-3, "decay_steps": 40})),
    (DROP_MLP, dict(worker_optimizer="rmsprop", learning_rate=1e-3)),
    (MLP, dict(worker_optimizer="adagrad", learning_rate=0.05))],
    ids=["adam", "adamw_schedule", "dropout_rmsprop", "adagrad"])
def test_single_trainer_kill_and_resume_bitwise(cfg, train, tmp_path):
    """Killed at epoch 2 of 3: the optimizer state (each optimizer's
    optax layout), the step and the dropout stream carry over."""
    _kill_and_resume(
        lambda **kw: SingleTrainer(cfg, batch_size=64, num_epoch=3, seed=1,
                                   device="cpu", **train, **kw),
        DATA, {"epoch": 2}, tmp_path)


def test_sync_trainer_kill_and_resume_bitwise(tmp_path):
    _kill_and_resume(
        lambda **kw: SyncTrainer(MLP, num_workers=2, batch_size=32,
                                 num_epoch=3, seed=2, device="cpu",
                                 worker_optimizer="momentum",
                                 learning_rate=0.05, **kw),
        DATA, {"epoch": 1}, tmp_path)


@pytest.mark.parametrize("cfg,fidelity", [(MLP, "faithful"),
                                          (MLP, "fast"),
                                          (DROP_MLP, "faithful")])
def test_adag_kill_and_resume_at_an_epoch_bitwise(cfg, fidelity, tmp_path):
    """Each worker's optimizer state and stream, the center, the clock
    and the commit orders carry over an epoch boundary."""
    ref, resumed = _kill_and_resume(
        lambda **kw: ADAG(cfg, num_epoch=2, seed=2, fidelity=fidelity,
                          worker_optimizer="momentum", **PS, **kw),
        DATA, {"epoch": 1, "round": 0}, tmp_path)
    assert resumed.parameter_server_state.clock \
        == ref.parameter_server_state.clock


def test_adag_mid_epoch_round_resume(tmp_path):
    """``checkpoint_every_rounds=3``, stopped after round 3's save: the
    resumed run skips the epoch's done rounds; its center, round losses,
    epoch loss (seeded from the restored rounds) and tail-batch counts
    (not recorded twice) equal the uninterrupted run's."""
    ref, resumed = _kill_and_resume(
        lambda **kw: ADAG(MLP, num_epoch=1, seed=3,
                          checkpoint_every_rounds=3, **PS, **kw),
        DATA, {"epoch": 0, "round": 3}, tmp_path)
    assert len(ref.history["round_loss"]) == 8
    assert resumed.history["dropped_tail_batches"] == [0]


def test_mid_epoch_saves_every_r_rounds(tmp_path):
    """Saves after rounds 3 and 6 of 8 and at each epoch's end (a save
    due at an epoch's last round is the epoch-end one)."""
    t = ADAG(MLP, num_epoch=2, seed=3, checkpoint_dir=str(tmp_path),
             checkpoint_every_rounds=3, **PS)
    calls = _stop_after(t, {"epoch": 99})
    t.train(DATA)
    assert calls == [{"epoch": 0, "round": 3}, {"epoch": 0, "round": 6},
                     {"epoch": 1, "round": 0}, {"epoch": 1, "round": 3},
                     {"epoch": 1, "round": 6}, {"epoch": 2, "round": 0}]
    _, cursor = checkpoint.load_checkpoint(tmp_path)
    assert cursor["epoch"] == 2 and len(cursor["history"]["round_loss"]) \
        == 16


def test_batch_norm_workers_resume_bitwise(tmp_path):
    """A BatchNorm ResNet of basic blocks through ADAG, stopped mid-epoch:
    each worker's own running statistics come back, and the returned
    statistics (worker 0's) equal the uninterrupted run's."""
    ref, resumed = _kill_and_resume(
        lambda **kw: ADAG(BN_RESNET, num_epoch=1, seed=0, num_workers=2,
                          communication_window=1, batch_size=8,
                          learning_rate=0.02, lr_law="off",
                          worker_optimizer="momentum", device="cpu",
                          checkpoint_every_rounds=2, **kw),
        IMAGES, {"epoch": 0, "round": 2}, tmp_path)
    for a, b in zip(ref.worker_model_states, resumed.worker_model_states):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_eval_dataset_records_each_epoch_across_a_resume(tmp_path):
    """``eval_dataset`` records one ``eval_accuracy`` per epoch, the
    value ``evaluate_model`` gives on the epoch's variables; a resumed
    run carries the pre-kill epochs' values in its history."""
    train, holdout = DATA.train_test_split(0.25, seed=5)

    def make(**kw):
        return SingleTrainer(MLP, batch_size=64, num_epoch=3, seed=1,
                             device="cpu", worker_optimizer="adam",
                             learning_rate=3e-3, **kw)

    ref, resumed = _kill_and_resume(make, train, {"epoch": 2}, tmp_path,
                                    eval_dataset=holdout)
    acc = ref.history["eval_accuracy"]
    assert len(acc) == 3
    want = evaluate_model(MLP, ref.trained_variables, holdout,
                          batch_size=256, device="cpu")
    assert acc[-1] == want["accuracy"]
    ps = ADAG(MLP, num_epoch=2, seed=3, **PS)
    ps.train(train, eval_dataset=holdout)
    assert len(ps.history["eval_accuracy"]) == 2
    assert ps.history["eval_accuracy"][-1] == evaluate_model(
        MLP, ps.trained_variables, holdout, device="cpu")["accuracy"]


def test_guards_keep_the_reference_exceptions(tmp_path):
    with pytest.raises(ValueError, match="commit_overlap runs one commit "
                                         "round behind"):
        ADAG(MLP, commit_overlap=True, checkpoint_dir=str(tmp_path),
             device="cpu")
    with pytest.raises(ValueError, match="commit_overlap runs one commit"):
        ADAG(MLP, commit_overlap=True, checkpoint_every_rounds=2,
             device="cpu")
    with pytest.raises(NotImplementedError, match="racing threads"):
        ADAG(MLP, fidelity="host", checkpoint_dir=str(tmp_path),
             device="cpu")
    with pytest.raises(NotImplementedError, match="does not checkpoint its "
                                                  "sharded-center layout"):
        ADAG(MLP, fidelity="mesh", checkpoint_dir=str(tmp_path),
             device="cpu")
    for cls, kw in ((EnsembleTrainer, {"num_models": 2}),
                    (AveragingTrainer, {"num_workers": 2})):
        with pytest.raises(ValueError, match="does not support "
                                             "checkpointing"):
            cls(MLP, batch_size=32, device="cpu", **kw).train(
                DATA, resume_from=str(tmp_path))
        with pytest.raises(ValueError, match="does not support "
                                             "checkpointing"):
            cls(MLP, batch_size=32, device="cpu",
                checkpoint_dir=str(tmp_path), **kw).train(DATA)
    # Ensemble/Averaging take eval_dataset and, as the reference's,
    # record nothing from it
    avg = AveragingTrainer(MLP, num_workers=2, batch_size=32, device="cpu")
    avg.train(DATA.take(128), eval_dataset=DATA.take(64))
    assert "eval_accuracy" not in avg.history
    # an orbax (sharded) checkpoint waits for the multi-host work
    sharded = tmp_path / "orbax" / checkpoint.SHARDED
    (sharded / "state_epoch1").mkdir(parents=True)
    (sharded / "LATEST").write_text("state_epoch1")
    assert checkpoint.has_sharded(tmp_path / "orbax")
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md §1 item 8"):
        SingleTrainer(MLP, batch_size=64, device="cpu").train(
            DATA, resume_from=str(tmp_path / "orbax"))
    # a save removes a stale sharded layout from its directory
    SingleTrainer(MLP, batch_size=256, device="cpu",
                  checkpoint_dir=str(tmp_path / "orbax")).train(DATA)
    assert not checkpoint.has_sharded(tmp_path / "orbax")
    # multi-head models (and so their evaluation) wait for item 10
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md §1 item 10"):
        SingleTrainer(MLP, loss=["mse", "mse"], label_col=["a", "b"],
                      device="cpu")
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md §1 item 10"):
        evaluate_model(MLP, {}, DATA, label_col=["a", "b"], device="cpu")


def test_checkpoint_file_holds_the_runs_state(tmp_path):
    """The file's state is the trained state: the returned parameters in
    the flax layout, one step count per worker, the commit clock."""
    t = ADAG(MLP, num_epoch=1, seed=0, checkpoint_dir=str(tmp_path), **PS)
    v = t.train(DATA)
    state, cursor, streams = checkpoint.load_checkpoint(tmp_path,
                                                        streams=True)
    assert list(state) == ["perm_key", "ps", "workers"]
    center = state["ps"]["center"]
    np.testing.assert_array_equal(center["Dense_0"]["kernel"],
                                  v["Dense_0.weight"].numpy().T)
    assert int(state["ps"]["clock"]) == 4 * 8
    assert state["workers"]["step"].tolist() == [16] * 4
    assert list(state["workers"]) == ["step", "params", "opt_state",
                                      "model_state", "rng"]
    assert state["workers"]["rng"].shape == (4, 2)
    assert streams["commit_orders"] == 8 and len(streams["rng"]) == 4
