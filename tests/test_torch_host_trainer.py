"""The port's host arm (``DistributedTrainer(fidelity="host")``) against
the JAX package's, on a small MLP in f32 on the CPU.

* One worker is deterministic: from the same weights and batches the
  port's run and the JAX run agree, history and parameters to 1e-6
  relative (f32 summation order in the steps), over ``inprocess`` and
  ``socket`` and with ``compression="int8"``.
* The port's W=1 host arm equals its own ``faithful`` tier at W=1 bit
  for bit, for all five rules: the same steps, and commits whose
  arithmetic is IEEE-exact elementwise f32 on either side (the host
  server applies the rule to numpy leaves, the emulated round to
  tensors).
* The history keys equal the JAX run's for the configurations of
  ``tests/test_history_keys.py``: the chaos run with its injector, the
  sharded socket run with ``commit_overlap``.
* A window retried after its steps ran repeats the clean run.
* ``ps_address`` attaches to an external server of either package.
* Three racing workers under ``racecheck.enable()`` end with no report.
* The kernels' launch counters stay exact when four threads launch.

Every run is joined with a timeout (``bounded``)."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distkeras_tpu import trainers as jax_trainers
from distkeras_tpu.data import datasets as jax_datasets
from distkeras_tpu.models import ModelSpec
from distkeras_tpu.models import model_config as jax_config
from distkeras_tpu.parallel import host_ps as jax_ps
from distkeras_tpu.parallel import update_rules as jax_rules
from distkeras_tpu_torch import (ADAG, AEASGD, DOWNPOUR, EAMSGD, DynSGD,
                                 convert)
from distkeras_tpu_torch.analysis import racecheck
from distkeras_tpu_torch.data import datasets
from distkeras_tpu_torch.models import model_config
from distkeras_tpu_torch.ops import attention, fused_block
from distkeras_tpu_torch.ops import group_norm as gn
from distkeras_tpu_torch.parallel import host_ps
from distkeras_tpu_torch.parallel import update_rules as rules

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)

TIMEOUT = 60.0
TRAINERS = {"DOWNPOUR": DOWNPOUR, "ADAG": ADAG, "DynSGD": DynSGD,
            "AEASGD": AEASGD, "EAMSGD": EAMSGD}
SHAPE, MLP = (8,), dict(num_classes=4, hidden=(16,))
KW = dict(num_workers=1, communication_window=2, batch_size=8, num_epoch=2,
          learning_rate=0.05, lr_law="off", seed=0,
          loss="sparse_categorical_crossentropy",
          worker_optimizer="momentum")
# history: the same losses through f32 steps in another summation
# order; parameters: the same, carried through 32 commits
HIST_TOL = PARAM_TOL = 1e-6


def bounded(fn, *args, timeout=TIMEOUT):
    """``fn(*args)`` on a daemon thread; fails if it is still running
    after ``timeout`` seconds, else returns or raises what it did."""
    out = {}

    def run():
        try:
            out["value"] = fn(*args)
        except BaseException as e:  # handed to the test thread
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"{fn.__name__} still running after {timeout}s"
    if "error" in out:
        raise out["error"]
    return out.get("value")


def _flax_params():
    spec = jax_config("mlp", SHAPE, **MLP)
    return spec, jax.tree_util.tree_map(np.asarray, ModelSpec.from_config(
        spec).build().init(jax.random.key(0), jnp.zeros((2, *SHAPE)))[
            "params"])


def _data(pkg, rows=256):
    return pkg.synthetic_classification(rows, SHAPE, 4, seed=3)


def _port(name="ADAG", **kw):
    return TRAINERS[name](model_config("mlp", SHAPE, **MLP), device="cpu",
                          **{**KW, **kw})


@pytest.mark.parametrize("transport,codec", [("inprocess", None),
                                             ("socket", None),
                                             ("socket", "int8")])
def test_one_worker_matches_jax(transport, codec):
    spec, params = _flax_params()
    kw = {**KW, "fidelity": "host", "transport": transport,
          "compression": codec}
    jt = jax_trainers.ADAG(spec, **kw)
    jv = bounded(jt.train, _data(jax_datasets), {"params": params})
    pt = _port(fidelity="host", transport=transport, compression=codec)
    pv = bounded(pt.train, _data(datasets), convert.params_from_flax(params))
    assert sorted(pt.history) == sorted(jt.history)
    for key in ("round_loss", "epoch_loss"):
        np.testing.assert_allclose(pt.history[key], jt.history[key],
                                   rtol=HIST_TOL, err_msg=key)
    for key in ("staleness", "dropped_tail_batches", "commit_wire_bytes",
                "commit_raw_bytes", "slo_health"):
        assert pt.history.get(key) == jt.history.get(key), key
    want = convert.params_from_flax(jax.tree_util.tree_map(
        np.asarray, jv["params"]))
    for k in want:
        np.testing.assert_allclose(pv[k].numpy(), want[k].numpy(),
                                   rtol=PARAM_TOL, atol=1e-7, err_msg=k)
    assert pt.parameter_server_state.num_commits \
        == jt.parameter_server_state.num_commits == 32


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_one_worker_host_equals_faithful(name):
    extra = {"worker_optimizer": "nesterov"} if name == "EAMSGD" else {}
    start = _port(name, **extra).model.state_dict()
    a = _port(name, fidelity="faithful", **extra)
    b = _port(name, fidelity="host", **extra)
    va = a.train(_data(datasets), start)
    vb = bounded(b.train, _data(datasets), start)
    assert all(torch.equal(va[k], vb[k]) for k in va), name
    assert a.history["round_loss"] == b.history["round_loss"]
    assert a.history["epoch_loss"] == b.history["epoch_loss"]


class _Bomb(Exception):
    pass


def test_a_retried_window_repeats_the_clean_run(monkeypatch):
    """A window that fails after its steps ran (here: the host copy of
    its payload) is run again from the pre-window optimizer state, step
    and stream, so the result equals the run without the fault."""
    from distkeras_tpu_torch import serialization

    start = _port().model.state_dict()
    clean = _port(fidelity="host")
    want = clean.train(_data(datasets), start)
    copies, real = [0], serialization.to_host

    def flaky(tree):
        copies[0] += 1
        if copies[0] == 4:     # the center, then rounds 1 and 2 copied
            raise _Bomb("lost the copy")
        return real(tree)

    monkeypatch.setattr(serialization, "to_host", flaky)
    t = _port(fidelity="host", worker_retries=1)
    got = bounded(t.train, _data(datasets), start)
    assert t.history["worker_round_retries"] == [[(0, 0, 2)]]
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert t.history["round_loss"] == clean.history["round_loss"]


def _chaos_kw(tmp, pkg):
    state = {"transient": True, "stall": True}

    def injector(w, epoch, r):
        if w == 0 and r == 1 and state.pop("transient", False):
            raise _Bomb("transient")
        if w == 1:
            raise _Bomb("hard")
        if w == 2 and r == 1 and state.pop("stall", False):
            time.sleep(0.8)

    return dict(fidelity="host", num_workers=3, communication_window=2,
                batch_size=16, num_epoch=1, learning_rate=0.01,
                worker_optimizer="adam", lr_law="off",
                loss="sparse_categorical_crossentropy", worker_retries=1,
                max_worker_failures=1, worker_timeout=0.2,
                fault_injector=injector, compression="int8",
                ps_snapshot_path=f"{tmp}/{pkg}.snap", ps_snapshot_every=4)


SHARDED_KW = dict(fidelity="host", transport="socket", ps_shards=2,
                  num_workers=2, communication_window=2, batch_size=16,
                  num_epoch=1, learning_rate=0.01, lr_law="off",
                  loss="sparse_categorical_crossentropy",
                  commit_overlap=True)


@pytest.mark.parametrize("case", ["chaos", "sharded_overlap"])
def test_history_keys_match_jax(case, tmp_path):
    spec, params = _flax_params()
    if case == "chaos":
        jkw, pkw = _chaos_kw(tmp_path, "jax"), _chaos_kw(tmp_path, "port")
    else:
        jkw = pkw = SHARDED_KW
    jt = jax_trainers.DOWNPOUR(spec, **jkw)
    bounded(jt.train, _data(jax_datasets, 512), {"params": params})
    pt = DOWNPOUR(model_config("mlp", SHAPE, **MLP), device="cpu", **pkw)
    bounded(pt.train, _data(datasets, 512), convert.params_from_flax(params))
    assert sorted(pt.history) == sorted(jt.history)
    if case == "chaos":
        assert [w for w, _ in pt.history["worker_failures"][0]] == [1]
        assert any(2 in d for d in pt.history["detected_idle_workers"][0])
        assert pt.history["ps_snapshots"][0] >= 1
        ratio = pt.history["commit_wire_bytes"][0] \
            / pt.history["commit_raw_bytes"][0]
        assert 0.25 < ratio < 0.5
    else:
        assert pt.history["pull_bytes_saved"][0] >= 0
        ps = pt.parameter_server_state
        assert ps.num_commits == len(pt.history["round_loss"])


@pytest.mark.parametrize("server_pkg", ["jax", "port"])
def test_ps_address_attaches_to_an_external_server(server_pkg):
    _, params = _flax_params()
    own = _port(fidelity="host")
    want = bounded(own.train, _data(datasets),
                   convert.params_from_flax(params))
    if server_pkg == "jax":
        ps = jax_ps.HostParameterServer(jax_rules.AdagRule(), params)
        server = jax_ps.PSServer(ps, params).start()
    else:
        ps = host_ps.HostParameterServer(rules.AdagRule(), params)
        server = host_ps.PSServer(ps, params).start()
    try:
        t = _port(fidelity="host", transport="socket",
                  ps_address=server.address)
        got = bounded(t.train, _data(datasets),
                      convert.params_from_flax(params))
    finally:
        server.stop()
    assert t.parameter_server_state is None and "staleness" not in t.history
    assert ps.num_commits == 32
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert t.history["round_loss"] == own.history["round_loss"]


def test_three_racing_workers_are_racecheck_clean():
    racecheck.enable()
    try:
        t = _port("DOWNPOUR", fidelity="host", transport="socket",
                  num_workers=3, ps_shards=2, worker_timeout=30.0,
                  learning_rate=0.01)
        bounded(t.train, _data(datasets, 384))
    finally:
        reports = racecheck.disable()
    assert reports == [], [str(r) for r in reports]
    ps = t.parameter_server_state
    assert ps.num_commits == len(t.history["round_loss"]) == 3 * 16
    (staleness,) = t.history["staleness"]
    assert len(staleness) == 48 and min(staleness) >= 0
    assert np.isfinite(t.history["epoch_loss"]).all()


def test_host_arm_guards():
    with pytest.raises(NotImplementedError, match="racing threads"):
        _port(fidelity="host", checkpoint_dir="/nonexistent/ckpt")
    with pytest.raises(ValueError, match="apply only to"):
        _port(fidelity="faithful", worker_retries=1)
    with pytest.raises(ValueError, match="requires transport='socket'"):
        _port(fidelity="host", ps_address=("127.0.0.1", 1))
    with pytest.raises(ValueError, match="ps_snapshot_path"):
        _port(fidelity="host", ps_snapshot_every=2)
    with pytest.raises(ValueError, match="worker_timeout"):
        _port(fidelity="host", worker_timeout=0)
    with pytest.raises(KeyError, match="unknown compression"):
        _port(fidelity="host", compression="zip")
    with pytest.raises(ValueError, match="delta-family"):
        _port("AEASGD", fidelity="host", compression="int8").train(
            _data(datasets))
    with pytest.raises(ValueError, match="delta family"):
        _port("AEASGD", fidelity="host", commit_overlap=True).train(
            _data(datasets))
    with pytest.raises(ValueError, match="unknown transport"):
        _port(fidelity="host", transport="carrier-pigeon").train(
            _data(datasets))


def test_launch_counters_are_exact_across_threads(monkeypatch):
    """Four threads run GroupNorm forward and backward with the kernel
    slot holding a counting plain version (the CPU has no kernel); every
    launch is counted.  The fused-block and attention counters take the
    same lock."""
    def counting(direction, plain):
        def fn(*args, **kw):
            gn._note(f"{direction}_launches", f"{direction}_one_pass")
            return plain(*args, **kw)
        return fn

    kernels = {gn.group_norm_fwd_reference: counting(
        "fwd", gn.group_norm_fwd_reference),
        gn.group_norm_bwd_reference: counting(
        "bwd", gn.group_norm_bwd_reference)}
    monkeypatch.setattr(gn, "_on", lambda device, kernel, reference:
                        kernels[reference])
    for name in ("fwd_launches", "bwd_launches"):
        monkeypatch.setattr(gn, name, 0)
    monkeypatch.setattr(gn, "route_launches",
                        {k: 0 for k in gn.route_launches})
    for name in ("conv_gn_fwd_launches", "tail_bwd_launches"):
        monkeypatch.setattr(fused_block, name, 0)
    monkeypatch.setattr(attention, "hop_dq_launches", 0)
    calls, threads = 25, 4
    x = torch.randn(2, 8, 4, 4).contiguous(memory_format=torch.channels_last)
    gamma, beta = torch.ones(8), torch.zeros(8)

    def work():
        for _ in range(calls):
            xi = x.clone().requires_grad_(True)
            gn.group_norm(xi, gamma, beta, groups=4).sum().backward()
            fused_block._note("conv_gn_fwd_launches", "tail_bwd_launches")
            attention._note("hop_dq_launches")

    pool = [threading.Thread(target=work) for _ in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join(TIMEOUT)
        assert not t.is_alive()
    n = calls * threads
    assert gn.fwd_launches == gn.bwd_launches == n
    assert gn.route_launches["fwd_one_pass"] \
        == gn.route_launches["bwd_one_pass"] == n
    assert fused_block.conv_gn_fwd_launches \
        == fused_block.tail_bwd_launches == attention.hop_dq_launches == n
