"""The port's host parameter server (``parallel/host_ps.py``) against the
JAX package's.

* Server semantics: from one center, one ordered sequence of commits
  (three workers, interleaved pulls so staleness varies, a retried seq,
  an int8 round trip as a payload) goes through each package's
  ``HostParameterServer``, for DOWNPOUR, ADAG, DynSGD, AEASGD and EAMSGD.
  Centers, every reply, the staleness logs and the dedupe tables are
  bit-equal; so are the snapshot files, and a warm restart
  (``from_snapshot``, ``restart_from``) of either package's file by the
  other.
* The wire: over loopback TCP, port clients commit to a JAX ``PSServer``
  and JAX clients to the port's, and each package to its own; the four
  final centers are byte-identical (raw and int8-coded commits, the
  elastic rule's second frame).

Sockets bind port 0; every exchange runs in a thread joined with a
timeout (``bounded``), so a hung server fails one test in seconds."""

import threading
import time

import jax
import numpy as np
import pytest

from distkeras_tpu.parallel import compression as jax_codecs
from distkeras_tpu.parallel import host_ps as jax_ps
from distkeras_tpu.parallel import update_rules as jax_rules
from distkeras_tpu_torch.parallel import compression, host_ps
from distkeras_tpu_torch.parallel import update_rules as rules
from distkeras_tpu_torch.parallel.trees import tree_leaves, tree_map

jax.config.update("jax_platforms", "cpu")

TIMEOUT = 30.0
RULES = {"DOWNPOUR": ("downpour", {}), "ADAG": ("adag", {}),
         "DynSGD": ("dynsgd", {}), "AEASGD": ("aeasgd", {"alpha": 0.25}),
         "EAMSGD": ("eamsgd", {"alpha": 0.05})}


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


def _center(seed=0):
    rng = np.random.default_rng(seed)
    return {"Dense_1": {"kernel": rng.standard_normal((6, 3), np.float32),
                        "bias": rng.standard_normal(3, np.float32)},
            "Dense_0": {"kernel": rng.standard_normal((4, 6), np.float32),
                        "bias": np.zeros(6, np.float32)}}


def _like(tree, rng, scale):
    return tree_map(lambda x: (scale * rng.standard_normal(x.shape))
                    .astype(np.float32), tree)


def _schedule(center, kind, seed=1):
    """``(op, worker, payload, local, seq)`` steps: pulls, commits with
    seqs, a retried seq and (delta family) an int8 round trip."""
    rng = np.random.default_rng(seed)
    steps = []
    for i in range(9):
        w = i % 3
        if i % 4 == 0:
            steps.append(("pull", w, None, None, None))
        if kind == "params":
            local = tree_map(lambda x: x + np.float32(0.1) * rng
                             .standard_normal(x.shape).astype(np.float32),
                             center)
            steps.append(("commit", w, local, local, i))
        else:
            payload = _like(center, rng, 0.05)
            if i == 5:
                payload = jax_codecs.Int8Codec().round_trip(payload)[1]
            steps.append(("commit", w, payload, None, i))
    steps.append(("commit",) + steps[-1][1:])  # a retry of the last seq
    return steps


def _rule(pkg, name):
    key, kw = RULES[name]
    return (jax_rules if pkg == "jax" else rules).RULES[key](**kw)


def _drive(ps, steps):
    replies = []
    for op, w, payload, local, seq in steps:
        if op == "pull":
            replies.append(host_ps.pack_params(ps.pull(w)))
        else:
            replies.append(host_ps.pack_params(
                ps.commit(w, payload, local, seq=seq)))
    return replies


@pytest.mark.parametrize("name", sorted(RULES))
def test_commits_and_snapshots_are_bit_equal(name, tmp_path):
    center = _center()
    kind = _rule("port", name).payload_kind
    steps = _schedule(center, kind)
    ref = jax_ps.HostParameterServer(_rule("jax", name), center)
    port = host_ps.HostParameterServer(_rule("port", name), center)
    assert _drive(port, steps) == _drive(ref, steps)
    assert host_ps.pack_params(port.center) == jax_ps.pack_params(ref.center)
    assert port.staleness_log == ref.staleness_log
    assert max(port.staleness_log) >= 2
    assert port.num_commits == ref.num_commits == len(steps) - 4
    assert port.last_acked_seqs() == ref.last_acked_seqs()
    # snapshot files: the same bytes
    ref.save_snapshot(tmp_path / "jax.snap")
    port.save_snapshot(tmp_path / "port.snap")
    assert (tmp_path / "port.snap").read_bytes() \
        == (tmp_path / "jax.snap").read_bytes()
    # each package warm-restarts the other's file and goes on alike
    more = _schedule(center, kind, seed=2)[3:]
    a = host_ps.HostParameterServer.from_snapshot(
        _rule("port", name), str(tmp_path / "jax.snap"))
    b = jax_ps.HostParameterServer.from_snapshot(
        _rule("jax", name), str(tmp_path / "port.snap"))
    assert _drive(a, more) == _drive(b, more)
    assert host_ps.pack_params(a.center) == jax_ps.pack_params(b.center)
    assert a.staleness_log == b.staleness_log
    # and each package's restart_from serves the other's file
    servers = [host_ps.PSServer.restart_from(
        str(tmp_path / "jax.snap"), _rule("port", name), center),
        jax_ps.PSServer.restart_from(
        str(tmp_path / "port.snap"), _rule("jax", name), center)]
    try:
        got = [bounded(pkg.fetch_center_obj, *srv.address)
               for pkg, srv in zip((jax_ps, host_ps), servers)]
    finally:
        for srv in servers:
            srv.stop()
    assert [g["num_commits"] for g in got] == [port.num_commits] * 2
    for g in got:
        assert host_ps.pack_params(g["center"]) \
            == host_ps.pack_params(port.center)


def test_dedupe_returns_the_cached_reply_and_counts():
    from distkeras_tpu_torch import telemetry

    tel = telemetry.enable()
    try:
        ps = host_ps.HostParameterServer(rules.AdagRule(), _center())
        delta = _like(_center(), np.random.default_rng(3), 0.1)
        first = host_ps.pack_params(ps.commit(0, delta, seq=0))
        again = host_ps.pack_params(ps.commit(0, delta, seq=0))
        assert first == again and ps.num_commits == 1
        assert tel.metrics.sum_counter("ps_commit_dedup_total") == 1
        assert tel.metrics.sum_counter("ps_commits_total") == 1
        assert ps.last_acked_seqs() == {0: 0}
        ps.retire(0)
        assert ps.last_acked_seqs() == {}
    finally:
        telemetry.disable()


def test_liveness_and_snapshot_validation(tmp_path):
    ps = host_ps.HostParameterServer(rules.DownpourRule(), _center())
    ps.register(4)
    assert ps.idle_workers(timeout=0.0) == [4]
    assert ps.idle_workers(timeout=60.0) == []
    with pytest.raises(ValueError, match="snapshot_path"):
        host_ps.HostParameterServer(rules.DownpourRule(), _center(),
                                    snapshot_every=2)
    snap = host_ps.HostParameterServer(
        rules.DownpourRule(), _center(), snapshot_path=tmp_path / "s",
        snapshot_every=2)
    for i in range(4):
        snap.commit(0, _center(i), seq=i)
    assert snap.num_snapshots == 2


@pytest.mark.parametrize("call", ["attach_replicator", "apply_replicated",
                                  "commit_group", "for_replicas",
                                  "for_elastic"])
def test_item_10_entry_points_raise(call):
    ps = host_ps.HostParameterServer(rules.DownpourRule(), _center())
    fn = {"attach_replicator": lambda: ps.attach_replicator(None),
          "apply_replicated": lambda: ps.apply_replicated(0, b"", 0, 0, b""),
          "commit_group": lambda: ps.commit_group(9, _center(), [0], [0]),
          "for_replicas": lambda: host_ps.ResilientPSClient.for_replicas(
              [("127.0.0.1", 1)], worker_id=0, template=_center()),
          "for_elastic": lambda: host_ps.ResilientPSClient.for_elastic(
              [("127.0.0.1", 1)], worker_id=0, template=_center())}[call]
    with pytest.raises(NotImplementedError, match="ROADMAP.md §1 item 10"):
        fn()


def _wire_run(server_pkg, client_pkg, name, codec):
    """A socket run: a ``server_pkg`` server, two ``client_pkg`` clients
    committing the schedule; returns the final center's bytes and the
    replies."""
    spkg = jax_ps if server_pkg == "jax" else host_ps
    cpkg = jax_ps if client_pkg == "jax" else host_ps
    center = _center()
    ps = spkg.HostParameterServer(_rule(server_pkg, name), center)
    server = spkg.PSServer(ps, center).start()
    try:
        clients = [cpkg.PSClient(*server.address, worker_id=w,
                                 template=center, codec=codec)
                   for w in range(2)]
        replies = []
        for op, w, payload, local, seq in _schedule(center, _rule(
                "port", name).payload_kind):
            c = clients[w % 2]
            if op == "pull":
                replies.append(host_ps.pack_params(c.pull()))
            else:
                replies.append(host_ps.pack_params(
                    c.commit(payload, local, seq=seq)))
        for c in clients:
            c.done()
            c.close()
        return host_ps.pack_params(ps.center), replies
    finally:
        server.stop()


@pytest.mark.parametrize("name,codec", [("DynSGD", None), ("ADAG", "int8"),
                                        ("AEASGD", None)])
def test_the_wire_crosses_packages(name, codec):
    runs = {(s, c): bounded(_wire_run, s, c, name, codec)
            for s in ("jax", "port") for c in ("jax", "port")}
    first = runs[("jax", "jax")]
    for key, got in runs.items():
        assert got == first, key


def test_probes_and_stop_cross_packages():
    center = _center()
    for spkg, cpkg in ((jax_ps, host_ps), (host_ps, jax_ps)):
        ps = spkg.HostParameterServer(
            (jax_rules if spkg is jax_ps else rules).DownpourRule(), center)
        server = spkg.PSServer(ps, center).start()
        try:
            assert bounded(cpkg.fetch_epoch, *server.address) == 0
            got = bounded(cpkg.fetch_center_obj, *server.address)
            assert got["num_commits"] == 0 and got["epoch"] == 0
            for g, w in zip(tree_leaves(got["center"]), tree_leaves(center)):
                np.testing.assert_array_equal(np.asarray(g), w)
            bounded(cpkg.stop_server, *server.address)
        finally:
            server.stop()


def test_resilient_client_retries_across_a_kill_and_restart(tmp_path):
    """A killed server restarted from its snapshot on the same port: the
    client's retried commit applies once."""
    center = _center()
    snap = tmp_path / "ps.snap"
    ps = host_ps.HostParameterServer(rules.DownpourRule(), center,
                                      snapshot_path=snap, snapshot_every=1)
    server = host_ps.PSServer(ps, center).start()
    host, port = server.address
    client = host_ps.ResilientPSClient.for_address(
        host, port, worker_id=0, template=center, retries=20,
        backoff_base=0.01, backoff_max=0.05)
    delta = _like(center, np.random.default_rng(5), 0.1)
    restarted = []

    def run():
        client.pull()
        client.commit(delta)
        server.kill()
        # the dead listener may need a moment to release the port
        for _ in range(100):
            try:
                restarted.append(host_ps.PSServer.restart_from(
                    str(snap), rules.DownpourRule(), center, port=port))
                break
            except OSError:
                time.sleep(0.05)
        client.commit(delta)
        client.done()
        client.close()

    try:
        bounded(run)
        new = restarted[0].ps
        assert new.num_commits == 2 and client.retry_count >= 1
        want = tree_map(lambda c, d: c + d + d, center, delta)
        assert host_ps.pack_params(new.center) == host_ps.pack_params(want)
    finally:
        for s in restarted:
            s.stop()
        server.stop()


def test_client_codec_and_payload_checks():
    center = _center()
    ps = host_ps.HostParameterServer(rules.DownpourRule(), center)
    server = host_ps.PSServer(ps, center).start()
    try:
        raw = bounded(host_ps.PSClient, *server.address, 0, center)
        with pytest.raises(ValueError, match="codec declared"):
            raw.commit(b"bytes")
        with pytest.raises(ValueError, match="seq out of range"):
            raw.commit(center, seq=-1)
        raw.close()

        class Custom(compression.Int8Codec):
            pass

        with pytest.raises(ValueError, match="reconstructed"):
            bounded(host_ps.PSClient, *server.address, 1, center, Custom())
    finally:
        server.stop()
