"""The port's sharded parameter server (``parallel/sharded_ps.py``)
against the JAX package's and against the unsharded server: the same
shard plan, bit-equal centers, replies and snapshot files from one
commit sequence, and the shard-addressed wire crossing packages (port
``ShardedPSClient`` to a JAX server and back) with byte-identical final
centers and the same version-delta pull savings.  Every exchange runs
in a thread joined with a timeout."""

import threading

import jax
import numpy as np
import pytest

from distkeras_tpu.parallel import host_ps as jax_ps
from distkeras_tpu.parallel import sharded_ps as jax_sharded
from distkeras_tpu.parallel import update_rules as jax_rules
from distkeras_tpu_torch.parallel import host_ps, sharded_ps
from distkeras_tpu_torch.parallel import update_rules as rules
from distkeras_tpu_torch.parallel.trees import tree_map

jax.config.update("jax_platforms", "cpu")

TIMEOUT = 30.0


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
    return {f"Dense_{i}": {"kernel": rng.standard_normal((3 + i, 5),
                                                         np.float32),
                           "bias": rng.standard_normal(5, np.float32)}
            for i in range(4)}


def _payloads(center, n, seed=1):
    rng = np.random.default_rng(seed)
    return [tree_map(lambda x: (0.05 * rng.standard_normal(x.shape))
                     .astype(np.float32), center) for _ in range(n)]


@pytest.mark.parametrize("k", [1, 2, 3, 5, 20])
def test_plan_is_the_jax_packages(k):
    center = _center()
    assert sharded_ps.plan_shards(center, k) \
        == jax_sharded.plan_shards(center, k)


@pytest.mark.parametrize("rule", ["dynsgd", "aeasgd"])
def test_sharded_equals_unsharded_and_jax(rule, tmp_path):
    center = _center()
    kw = {"alpha": 0.2} if rule == "aeasgd" else {}
    port = sharded_ps.ShardedParameterServer(
        rules.RULES[rule](**kw), center, 3)
    ref = jax_sharded.ShardedParameterServer(
        jax_rules.RULES[rule](**kw), center, 3)
    flat = host_ps.HostParameterServer(rules.RULES[rule](**kw), center)
    for i, p in enumerate(_payloads(center, 7)):
        w = i % 2
        if i % 3 == 0:
            got = [s.pull(w) for s in (port, ref, flat)]
            assert len({host_ps.pack_params(g) for g in got}) == 1
        local = p if rule == "aeasgd" else None
        got = [s.commit(w, p, local, seq=i) for s in (port, ref, flat)]
        assert len({host_ps.pack_params(g) for g in got}) == 1
    # a retried seq dedupes on every shard
    got = port.commit(w, p, local, seq=i)
    assert host_ps.pack_params(got) == host_ps.pack_params(
        ref.commit(w, p, local, seq=i))
    assert port.num_commits == ref.num_commits == flat.num_commits == 7
    assert host_ps.pack_params(port.center) \
        == host_ps.pack_params(flat.center) \
        == jax_ps.pack_params(ref.center)
    assert port.staleness_log == ref.staleness_log == flat.staleness_log
    assert port.last_acked_seqs() == ref.last_acked_seqs()
    port.save_snapshot(tmp_path / "port.snap")
    ref.save_snapshot(tmp_path / "jax.snap")
    assert (tmp_path / "port.snap").read_bytes() \
        == (tmp_path / "jax.snap").read_bytes()
    back = host_ps.PSServer.restart_from(str(tmp_path / "jax.snap"),
                                         rules.RULES[rule](**kw), center)
    try:
        assert isinstance(back.ps, sharded_ps.ShardedParameterServer)
        assert host_ps.pack_params(back.ps.center) \
            == host_ps.pack_params(port.center)
        assert back.ps.shard_clocks() == port.shard_clocks()
    finally:
        back.stop()


def _wire_run(server_pkg, client_pkg, codec):
    """Two clients of ``client_pkg`` over the shard-addressed wire to a
    ``server_pkg`` sharded server: center bytes, replies, pull savings."""
    spkg = jax_sharded if server_pkg == "jax" else sharded_ps
    hpkg = jax_ps if server_pkg == "jax" else host_ps
    cpkg = jax_sharded if client_pkg == "jax" else sharded_ps
    rpkg = jax_rules if server_pkg == "jax" else rules
    center = _center()
    ps = spkg.ShardedParameterServer(rpkg.DynSGDRule(), center, 3)
    server = hpkg.PSServer(ps, center).start()
    stats = [{}, {}]
    try:
        clients = [cpkg.ShardedPSClient(*server.address, worker_id=w,
                                        template=center, num_shards=3,
                                        codec=codec, stats=stats[w])
                   for w in range(2)]
        replies = []
        for i, p in enumerate(_payloads(center, 6)):
            c = clients[i % 2]
            replies.append(host_ps.pack_params(c.pull()))
            replies.append(host_ps.pack_params(c.commit(p, seq=i)))
        # nothing moved since the last pull: every shard is skipped
        replies.append(host_ps.pack_params(clients[1].pull()))
        replies.append(host_ps.pack_params(clients[1].pull()))
        for c in clients:
            c.done()
            c.close()
        return host_ps.pack_params(ps.center), replies, stats
    finally:
        server.stop()


@pytest.mark.parametrize("codec", [None, "int8"])
def test_the_sharded_wire_crosses_packages(codec):
    runs = {(s, c): bounded(_wire_run, s, c, codec)
            for s in ("jax", "port") for c in ("jax", "port")}
    first = runs[("jax", "jax")]
    for key, got in runs.items():
        assert got == first, key
    assert first[2][1]["pull_shards_skipped"] >= 3


def test_sharded_snapshots_every_commit_and_item_10_raises(tmp_path):
    center = _center()
    ps = sharded_ps.ShardedParameterServer(
        rules.AdagRule(), center, 2, snapshot_path=tmp_path / "s",
        snapshot_every=1)
    for i, p in enumerate(_payloads(center, 3)):
        ps.commit(0, p, seq=i)
    assert ps.num_snapshots == 3
    from distkeras_tpu_torch import checkpoint

    info = checkpoint.ps_snapshot_info(tmp_path / "s")
    assert info["sharded"] == 2 and info["num_commits"] == 3
    with pytest.raises(ValueError, match="sharded"):
        host_ps.HostParameterServer.from_snapshot(rules.AdagRule(),
                                                  str(tmp_path / "s"))
    for call in (lambda: ps.attach_replicator(None),
                 lambda: ps.commit_group(9, center, [0], [0]),
                 lambda: ps.apply_replicated_shard(0, 0, b"", 0, 0, b"")):
        with pytest.raises(NotImplementedError, match="item 10"):
            call()
