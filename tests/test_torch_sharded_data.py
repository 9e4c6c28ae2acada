"""Out-of-core data on the port (``data/sharded.py`` and the trainers'
segment machinery), mirroring ``tests/test_sharded_data.py`` and holding
the port against the JAX package on the same shard files.

The epoch plan is numpy in both packages, so for the same seed it is
the same shard for shard and row for row.  Trainer comparisons start
from the same weights (the JAX init mapped by ``convert``) and, for the
PS family, the JAX trainer's commit orders; the JAX trainers run on the
8-device CPU mesh of ``tests/conftest.py``, so they differ from the
port's one device by f32 summation order: history within ``HIST_TOL``
(relative), parameters within ``PARAM_TOL`` (relative) + 1e-7, PERF.md
§2's limits."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu import trainers as jax_trainers
from distkeras_tpu.data import Dataset as JaxDataset
from distkeras_tpu.data import ShardedDataset as JaxShardedDataset
from distkeras_tpu.models import ModelSpec
from distkeras_tpu.models import model_config as jax_config
from distkeras_tpu_torch import convert, trainers
from distkeras_tpu_torch.data import (AssembleTransformer,
                                      CsvShardedDataset, Dataset,
                                      ShardedDataset, datasets)
from distkeras_tpu_torch.models import model_config

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)

HIST_TOL, PARAM_TOL = 1e-6, 1e-5
FEAT = (6,)
MLP = dict(num_classes=4, hidden=(16,))
PS_KW = dict(num_workers=4, communication_window=2, batch_size=8,
             learning_rate=0.05, seed=0, lr_law="off", device="cpu")


def _make(tmp_path, rows=512, shards=4, seed=0, name="part"):
    full = datasets.synthetic_classification(rows, FEAT, 4, seed=seed)
    paths = full.to_npz_shards(str(tmp_path / name),
                               rows_per_shard=rows // shards)
    return full, paths


def _cfg(hidden=(16,)):
    return model_config("mlp", FEAT, num_classes=4, hidden=hidden)


def _same_variables(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _history(t):
    return {k: v for k, v in t.history.items() if k != "segment_stall_s"}


# -- the plan ---------------------------------------------------------------

def test_metadata_without_loading(tmp_path):
    full, _ = _make(tmp_path)
    sd = Dataset.from_npz_shards(str(tmp_path / "part-*.npz"))
    assert isinstance(sd, ShardedDataset)
    assert len(sd) == len(full) and sd.num_shards == 4
    assert sd.column_names == sorted(full.column_names)
    assert sd.shard_rows == [128, 128, 128, 128]
    np.testing.assert_array_equal(sd.to_dataset()["label"], full["label"])
    assert "shards=4" in repr(sd)


@pytest.mark.parametrize("seed", [0, 3, 17, 2 ** 40 + 5])
def test_epoch_plan_equals_jax(tmp_path, seed):
    """Order, per-shard seeds and rows: the same segments in both
    packages, from the same files."""
    _, paths = _make(tmp_path, rows=500, shards=5)
    ours = list(ShardedDataset(paths).epoch_segment_loaders(seed))
    theirs = list(JaxShardedDataset(paths).epoch_segment_loaders(seed))
    assert [r for r, _ in ours] == [r for r, _ in theirs]
    for (_, a), (_, b) in zip(ours, theirs):
        x, y = a(), b()
        for k in y.column_names:
            np.testing.assert_array_equal(x[k], y[k])


def test_one_shard_plan_keeps_the_plain_seed(tmp_path):
    full, _ = _make(tmp_path)
    path = full.to_npz(str(tmp_path / "whole.npz"))
    (seg,) = ShardedDataset([path]).epoch_segments(seed=7)
    shuffled = full.shuffle(seed=7)
    for k in full.column_names:
        np.testing.assert_array_equal(seg[k], shuffled[k])


def test_epoch_segments_cover_every_row_once(tmp_path):
    full, paths = _make(tmp_path)
    sd = ShardedDataset(paths)
    seen = [np.asarray(s["features"]) for s in sd.epoch_segments(seed=3)]
    assert [len(s) for s in seen] == [128] * 4
    np.testing.assert_array_equal(
        np.sort(np.concatenate(seen), axis=0),
        np.sort(np.asarray(full["features"]), axis=0))
    again = np.concatenate([s["label"] for s in sd.epoch_segments(seed=3)])
    other = np.concatenate([s["label"] for s in sd.epoch_segments(seed=4)])
    np.testing.assert_array_equal(
        again, np.concatenate([s["label"] for s in sd.epoch_segments(3)]))
    assert not np.array_equal(again, other)


def test_sharded_guards(tmp_path):
    _, paths = _make(tmp_path)
    with pytest.raises(ValueError, match="no files match"):
        Dataset.from_npz_shards(str(tmp_path / "nope-*.npz"))
    Dataset({"x": np.zeros((4, 2))}).to_npz(str(tmp_path / "bad.npz"))
    with pytest.raises(ValueError, match="columns"):
        ShardedDataset([paths[0], str(tmp_path / "bad.npz")])
    Dataset({"features": np.zeros((4, 9), np.float32),
             "label": np.zeros((4,), np.int64)}).to_npz(
        str(tmp_path / "badshape.npz"))
    with pytest.raises(ValueError, match="row shape"):
        ShardedDataset([paths[0], str(tmp_path / "badshape.npz")])
    with pytest.raises(ValueError, match="rows_per_shard"):
        datasets.synthetic_classification(8, FEAT, 4).to_npz_shards(
            str(tmp_path / "z"), rows_per_shard=0)
    with pytest.raises(ValueError, match="row count"):
        ShardedDataset(paths).map(lambda ds: ds.take(5)).load_shard(0)


# -- trainers over shards against the JAX trainers ----------------------------

def _jax_params(hidden=(16,)):
    spec = jax_config("mlp", FEAT, num_classes=4, hidden=hidden)
    return ModelSpec.from_config(spec).build().init(
        jax.random.key(0), jnp.zeros((2, *FEAT)))["params"]


def _to_port(params):
    return convert.params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                           params))


def _assert_params_close(got, want_flax):
    want = _to_port(want_flax)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=PARAM_TOL, atol=1e-7, err_msg=k)


def _jax_orders(seed, num_workers, rounds):
    key, out = jax.random.key(seed + 2), []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.permutation(sub, num_workers))
                   .tolist())
    return out


@pytest.mark.parametrize("name,kw", [
    ("SingleTrainer", dict(batch_size=16)),
    ("SyncTrainer", dict(num_workers=4, batch_size=4)),
    ("ADAG", dict(num_workers=4, communication_window=2, batch_size=8,
                  fidelity="faithful")),
])
def test_trainers_over_shards_match_jax(tmp_path, name, kw):
    """Four shards and a runt, 2 epochs, adam: history and parameters
    at PERF.md §2's limits, the runt recorded where the JAX trainer
    records it."""
    full = datasets.synthetic_classification(512 + 6, FEAT, 4, seed=0)
    paths = full.to_npz_shards(str(tmp_path / "p"), rows_per_shard=128)
    params = _jax_params()
    common = dict(worker_optimizer="adam", learning_rate=3e-3,
                  num_epoch=2, seed=0,
                  loss="sparse_categorical_crossentropy", **kw)
    jt = getattr(jax_trainers, name)(
        jax_config("mlp", FEAT, num_classes=4, hidden=(16,)), **common)
    jv = jt.train(JaxShardedDataset(paths),
                  initial_variables={"params": params})
    pt = getattr(trainers, name)(_cfg(), device="cpu", **common)
    if name == "ADAG":
        orders = _jax_orders(0, 4, len(jt.history["round_loss"]))
        pt.commit_orders = lambda: iter(orders)
    pv = pt.train(ShardedDataset(paths), initial_variables=_to_port(params))
    assert sorted(pt.history) == sorted(jt.history)
    for key in pt.history:
        if key in ("segment_stall_s", "staleness"):
            continue
        np.testing.assert_allclose(np.asarray(pt.history[key], float),
                                   np.asarray(jt.history[key], float),
                                   rtol=HIST_TOL, err_msg=key)
    if name == "ADAG":
        assert pt.history["staleness"] == jt.history["staleness"]
        assert pt.history["skipped_segment_rows"] == [6, 6]
    _assert_params_close(pv, jv["params"])


def test_single_shard_training_is_bit_identical(tmp_path):
    full, _ = _make(tmp_path, rows=256, shards=1)
    path = full.to_npz(str(tmp_path / "whole.npz"))
    kw = dict(worker_optimizer="sgd", learning_rate=0.05, batch_size=32,
              num_epoch=2, seed=0, device="cpu")
    for cls, extra in ((trainers.SingleTrainer, {}),
                       (trainers.ADAG, dict(num_workers=4,
                                            communication_window=2,
                                            lr_law="off"))):
        kw_all = {**kw, **extra}
        if cls is trainers.ADAG:
            kw_all["batch_size"] = 8
        mem = cls(_cfg(), **kw_all)
        mem.train(full)
        ooc = cls(_cfg(), **kw_all)
        ooc.train(ShardedDataset([path]))
        assert _history(mem) == _history(ooc)
        _same_variables(mem.trained_variables, ooc.trained_variables)


@pytest.mark.parametrize("cls,kw", [
    (trainers.SingleTrainer, {}),
    (trainers.SyncTrainer, dict(num_workers=2)),
    (trainers.ADAG, dict(num_workers=4, communication_window=2,
                         lr_law="off")),
])
def test_segment_prefetch_is_bit_identical(tmp_path, monkeypatch, cls, kw):
    _, paths = _make(tmp_path, rows=512, shards=4)
    sd = ShardedDataset(paths)
    runs = []
    for depth in ("0", "1", "2"):
        monkeypatch.setenv("DKT_SEGMENT_PREFETCH", depth)
        t = cls(_cfg(), batch_size=8, num_epoch=2, learning_rate=0.05,
                seed=0, device="cpu", **kw)
        t.train(sd)
        assert len(t.history["segment_stall_s"]) == 2
        runs.append(t)
    for t in runs[1:]:
        assert _history(t) == _history(runs[0])
        _same_variables(t.trained_variables, runs[0].trained_variables)


FAMILY = ["DOWNPOUR", "ADAG", "DynSGD", "AEASGD", "EAMSGD"]


@pytest.mark.parametrize("fidelity", ["faithful", "fast", "host"])
@pytest.mark.parametrize("name", FAMILY)
def test_every_ps_trainer_streams_shards(tmp_path, name, fidelity):
    """All five PS trainers on every ported tier over npz shards, a
    mapped view of them, and a runt: every round of every segment runs
    (2 shards x 4 rounds), the runt is recorded."""
    full = datasets.synthetic_classification(256 + 3, FEAT, 4, seed=1)
    paths = full.to_npz_shards(str(tmp_path / "s"), rows_per_shard=128)
    sd = ShardedDataset(paths).map(lambda ds: ds.rename({}))
    t = getattr(trainers, name)(_cfg(), num_workers=2,
                                communication_window=2, batch_size=8,
                                num_epoch=1, learning_rate=0.01, seed=0,
                                fidelity=fidelity, lr_law="off",
                                device="cpu")
    t.train(sd)
    assert len(t.history["round_loss"]) == 2 * 2 * 4 // (
        1 if fidelity == "host" else 2)
    assert np.isfinite(t.history["epoch_loss"]).all()
    # the host arm records each worker's slice of the runt (1 row each;
    # the third is the repartition's remainder), as the JAX host arm does
    assert t.history["skipped_segment_rows"] == [
        2 * (3 // 2) if fidelity == "host" else 3]


def test_member_trainers_take_in_memory_data_as_jax_does(tmp_path):
    """The JAX member trainers call ``dataset.shuffle``; a
    ``ShardedDataset`` has none, in either package."""
    _, paths = _make(tmp_path)
    t = trainers.AveragingTrainer(_cfg(), num_workers=2, batch_size=8,
                                  device="cpu")
    with pytest.raises(AttributeError, match="shuffle"):
        t.train(ShardedDataset(paths))
    with pytest.raises(AttributeError, match="shuffle"):
        jax_trainers.AveragingTrainer(
            jax_config("mlp", FEAT, num_classes=4, hidden=(16,)),
            num_workers=2, batch_size=8).train(JaxShardedDataset(paths))


# -- runts, resumes, saves at segment boundaries -----------------------------

def test_runt_shard_is_recorded_not_silent(tmp_path):
    full = datasets.synthetic_classification(512 + 7, FEAT, 4, seed=0)
    paths = full.to_npz_shards(str(tmp_path / "p"), rows_per_shard=256)
    a = trainers.ADAG(_cfg((8,)), num_epoch=1, **PS_KW)
    a.train(ShardedDataset(paths))  # 256, 256, 7
    assert a.history["skipped_segment_rows"] == [7]
    assert len(a.history["round_loss"]) == 2 * 4


class StopAfter(Exception):
    pass


def _stop_after(trainer, cursor_wanted):
    orig = trainer._maybe_save
    calls = []

    def saving(state, cursor):
        orig(state, cursor)
        calls.append(dict(cursor))
        if all(cursor.get(k) == v for k, v in cursor_wanted.items()):
            raise StopAfter
    trainer._maybe_save = saving
    return calls


@pytest.mark.parametrize("every,stop", [(3, {"epoch": 1, "round": 6}),
                                        (4, {"epoch": 0, "round": 8})])
def test_ps_kill_and_resume_out_of_core(tmp_path, every, stop):
    """Kill after a mid-epoch save and resume: bit-equal to the
    uninterrupted run.  4 rounds a segment: ``every=4`` lands each save
    on a segment boundary, deferred to the next segment's first round;
    ``every=3`` saves inside segments, and the resume skips the
    consumed shard files unread."""
    _, paths = _make(tmp_path, rows=1024, shards=4)
    sd = ShardedDataset(paths)
    kw = dict(num_epoch=2, **PS_KW)
    whole = trainers.ADAG(_cfg((8,)), **kw)
    whole.train(sd)

    ck = str(tmp_path / "ck")
    part = trainers.ADAG(_cfg((8,)), checkpoint_dir=ck,
                         checkpoint_every_rounds=every, **kw)
    saves = _stop_after(part, stop)
    with pytest.raises(StopAfter):
        part.train(sd)
    rounds = {c["round"] for c in saves if c["epoch"] == stop["epoch"]}
    assert stop["round"] in rounds
    if every == 4:
        # boundary saves: rounds 4 and 8 of epoch 0, none at 16 (the
        # epoch's end saves as {"epoch": 1, "round": 0})
        assert saves[:2] == [{"epoch": 0, "round": 4},
                             {"epoch": 0, "round": 8}]

    loads = []
    resumed = trainers.ADAG(_cfg((8,)), **kw)
    orig = ShardedDataset.load_shard

    def counting(self, index):
        loads.append(index)
        return orig(self, index)
    ShardedDataset.load_shard = counting
    try:
        resumed.train(sd, resume_from=ck)
    finally:
        ShardedDataset.load_shard = orig
    # the resumed epoch reads only the shards it has rounds left in
    done = stop["round"] // 4
    assert len(loads) == (4 - done) + 4 * (1 - stop["epoch"])
    _same_variables(whole.trained_variables, resumed.trained_variables)
    assert _history(whole) == _history(resumed)


def test_boundary_saves_match_the_jax_trainer(tmp_path, monkeypatch):
    """The cursors a run saves at, ``checkpoint_every_rounds`` landing on
    segment boundaries: the JAX trainer's."""
    from distkeras_tpu import checkpoint as jax_ckpt

    _, paths = _make(tmp_path, rows=1024, shards=4)
    ours = trainers.ADAG(_cfg((8,)), num_epoch=1,
                         checkpoint_dir=str(tmp_path / "a"),
                         checkpoint_every_rounds=4, **PS_KW)
    saves = _stop_after(ours, {"epoch": 99})
    ours.train(ShardedDataset(paths))
    theirs = []
    orig = jax_ckpt.save_checkpoint

    def spy(path, state, cursor):
        theirs.append({k: cursor[k] for k in ("epoch", "round")})
        return orig(path, state, cursor)
    monkeypatch.setattr(jax_ckpt, "save_checkpoint", spy)
    jt = jax_trainers.ADAG(
        jax_config("mlp", FEAT, num_classes=4, hidden=(8,)),
        num_epoch=1, checkpoint_dir=str(tmp_path / "b"),
        checkpoint_every_rounds=4,
        **{k: v for k, v in PS_KW.items() if k != "device"})
    jt.train(JaxShardedDataset(paths))
    assert saves == theirs


# -- the host arm -------------------------------------------------------------

def test_host_arm_streams_sharded_dataset(tmp_path):
    full = datasets.synthetic_classification(1024, FEAT, 4, seed=0)
    paths = full.to_npz_shards(str(tmp_path / "h"), rows_per_shard=256)
    t = trainers.DOWNPOUR(_cfg(), num_epoch=3, fidelity="host",
                          transport="socket",
                          **{**PS_KW, "learning_rate": 0.01})
    t.train(ShardedDataset(paths))
    h = t.history["epoch_loss"]
    assert h[-1] < h[0], h
    # 4 segments x 4 rounds x 3 epochs x 4 workers commits
    assert len(t.history["staleness"][0]) == 4 * 4 * 3 * 4
    assert t.parameter_server_state.num_commits == 4 * 4 * 3 * 4


def test_host_arm_one_worker_equals_faithful_over_shards(tmp_path):
    _, paths = _make(tmp_path, rows=256, shards=2)
    kw = dict(PS_KW, num_workers=1, num_epoch=2)
    runs = {}
    for fid in ("host", "faithful"):
        t = trainers.ADAG(_cfg(), fidelity=fid, **kw)
        t.train(ShardedDataset(paths))
        runs[fid] = t
    _same_variables(runs["host"].trained_variables,
                    runs["faithful"].trained_variables)
    assert runs["host"].history["round_loss"] == \
        runs["faithful"].history["round_loss"]


def test_host_arm_records_skipped_runt_shard(tmp_path):
    full = datasets.synthetic_classification(512 + 6, FEAT, 4, seed=0)
    paths = full.to_npz_shards(str(tmp_path / "r"), rows_per_shard=256)
    t = trainers.DOWNPOUR(_cfg((8,)), num_epoch=1, fidelity="host",
                          **{**PS_KW, "num_workers": 2})
    t.train(ShardedDataset(paths))  # 256, 256, 6
    assert t.history["skipped_segment_rows"] == [6]


def test_host_arm_segment_build_failure_raises_not_hangs(tmp_path):
    _, paths = _make(tmp_path, rows=512, shards=2)

    def bad_fn(ds):
        raise RuntimeError("etl exploded")

    t = trainers.DOWNPOUR(_cfg((8,)), num_epoch=1, fidelity="host",
                          **PS_KW)
    out = []

    def run():
        try:
            t.train(ShardedDataset(paths).map(bad_fn))
        except BaseException as exc:
            out.append(exc)
    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(60)
    assert not th.is_alive(), "a failed segment build hung the workers"
    assert out and isinstance(out[0], RuntimeError)


def test_emulated_arm_segment_failure_raises(tmp_path):
    _, paths = _make(tmp_path, rows=512, shards=2)

    def bad_fn(ds):
        raise RuntimeError("etl exploded")

    for cls, kw in ((trainers.ADAG, PS_KW),
                    (trainers.SingleTrainer, dict(device="cpu"))):
        with pytest.raises(RuntimeError, match="etl exploded"):
            cls(_cfg((8,)), **kw).train(ShardedDataset(paths).map(bad_fn))


def test_too_small_for_any_window_raises(tmp_path):
    tiny = ShardedDataset(
        datasets.synthetic_classification(8, FEAT, 4, seed=0)
        .to_npz_shards(str(tmp_path / "tiny"), rows_per_shard=4))
    for fid in ("host", "faithful"):
        t = trainers.DOWNPOUR(_cfg((8,)), num_workers=2, fidelity=fid,
                              batch_size=8, num_epoch=1,
                              learning_rate=0.01, device="cpu")
        with pytest.raises(ValueError, match="communication window"):
            t.train(tiny)


# -- the prefetch feeder ------------------------------------------------------

def test_prefetch_feeder_exits_when_consumer_abandons():
    started = threading.Event()

    def loads():
        for i in range(100):
            started.set()
            yield np.zeros(4) + i

    before = set(threading.enumerate())
    it = trainers._prefetch_iter(loads(), depth=1)
    next(it)
    assert started.is_set()
    it.close()
    deadline = time.monotonic() + 5.0
    alive: list = []
    while time.monotonic() < deadline:
        alive = [t for t in threading.enumerate()
                 if t.name == "dkt-segment-prefetch" and t.is_alive()
                 and t not in before]
        if not alive:
            break
        time.sleep(0.05)
    assert not alive, "prefetch feeder still alive after close()"


def test_prefetch_iter_keeps_order_and_reraises():
    def items():
        yield from range(5)
        raise KeyError("late")

    got = []
    with pytest.raises(KeyError, match="late"):
        for x in trainers._prefetch_iter(items(), depth=2):
            got.append(x)
    assert got == list(range(5))
    assert list(trainers._prefetch_iter(iter(range(3)), depth=0)) == [0, 1,
                                                                     2]


def test_segment_prefetch_falls_back_on_a_key_mismatch():
    pf = trainers._SegmentPrefetch()
    pf.queue(1, lambda: "one")
    assert pf.get(2, lambda: "two") == "two"
    assert pf.get(1, lambda: "again") == "one"
    pf.queue(3, lambda: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        pf.get(3, lambda: None)


def test_stall_is_measured(tmp_path):
    _, paths = _make(tmp_path, rows=256, shards=2)
    slow = ShardedDataset(paths).map(lambda ds: (time.sleep(0.05), ds)[1])
    t = trainers.SingleTrainer(_cfg(), batch_size=32, num_epoch=1,
                               device="cpu")
    t.train(slow)
    assert t.history["segment_stall_s"][0] >= 0.04


# -- CSV shards ---------------------------------------------------------------

def _write_csv_shards(tmp_path, shards=3, rows_per=128, seed=0):
    rng = np.random.default_rng(seed)
    paths = []
    for s in range(shards):
        p = tmp_path / f"data-{s:03d}.csv"
        with open(p, "w") as fh:
            fh.write("f0,f1,f2,label\n")
            labels = rng.integers(0, 3, size=rows_per)
            feats = rng.normal(size=(rows_per, 3)) + labels[:, None]
            for row, y in zip(feats, labels):
                fh.write(",".join(f"{v:.5f}" for v in row) + f",{y}\n")
        paths.append(str(p))
    return paths


def test_csv_shards_metadata_and_plan_match_jax(tmp_path):
    paths = _write_csv_shards(tmp_path)
    sd = Dataset.from_csv_shards(str(tmp_path / "data-*.csv"))
    jd = JaxDataset.from_csv_shards(str(tmp_path / "data-*.csv"))
    assert isinstance(sd, CsvShardedDataset)
    assert sd.num_shards == 3 and len(sd) == 384
    assert sd.column_names == jd.column_names == ["f0", "f1", "f2", "label"]
    assert sd.shard_rows == jd.shard_rows == [128, 128, 128]
    for a, b in zip(sd.epoch_segments(seed=5), jd.epoch_segments(seed=5)):
        for k in b.column_names:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert paths == sd.paths


def test_csv_shards_train_through_etl_map(tmp_path):
    paths = _write_csv_shards(tmp_path, shards=4, rows_per=256)
    sd = Dataset.from_csv_shards(paths)
    assemble = AssembleTransformer(["f0", "f1", "f2"])
    t = trainers.ADAG(model_config("mlp", (3,), num_classes=3,
                                   hidden=(16,)),
                      num_epoch=3, **PS_KW)
    t.train(sd.map(assemble.transform))
    h = t.history["epoch_loss"]
    assert h[-1] < h[0] * 0.8, h


def test_csv_shard_dtype_anchor(tmp_path):
    (tmp_path / "s-0.csv").write_text("\nx,label\n1.5,0\n2.5,1\n")
    (tmp_path / "s-1.csv").write_text("x,label\n1,0\n2,1\n")
    sd = Dataset.from_csv_shards(str(tmp_path / "s-*.csv"))
    assert sd.shard_rows == [2, 2]
    assert sd.load_shard(1)["x"].dtype == np.float32
    (tmp_path / "s-2.csv").write_text("x,label\nNA,0\n2,1\n")
    sd2 = Dataset.from_csv_shards(str(tmp_path / "s-*.csv"))
    with pytest.raises(ValueError, match="s-2.*'x'|'x'.*s-2"):
        sd2.load_shard(2)
    (tmp_path / "c-0.csv").write_text("cat,label\nab,0\ncd,1\n")
    (tmp_path / "c-1.csv").write_text("cat,label\nabcde,0\nx,1\n")
    sdc = Dataset.from_csv_shards(str(tmp_path / "c-*.csv"))
    assert sdc.load_shard(1)["cat"].dtype.kind == "U"
    (tmp_path / "d-0.csv").write_text("a,a\n1,2\n")
    with pytest.raises(ValueError, match="duplicate"):
        Dataset.from_csv_shards(str(tmp_path / "d-0.csv"))


def test_csv_shard_guards(tmp_path):
    _write_csv_shards(tmp_path)
    bad = tmp_path / "data-999.csv"
    bad.write_text("a,b\n1,2\n")
    with pytest.raises(ValueError, match="header"):
        Dataset.from_csv_shards(str(tmp_path / "data-*.csv"))
    bad.unlink()
    (tmp_path / "e-0.csv").write_text("a,b\n")
    with pytest.raises(ValueError, match="no data rows"):
        Dataset.from_csv_shards(str(tmp_path / "e-0.csv"))
    with pytest.raises(ValueError, match="names"):
        Dataset.from_csv_shards(str(tmp_path / "data-*.csv"), header=False)
