"""The port's ``ChaosTransport`` (``parallel/faults.py``) against the JAX
package's: one seed gives one decision sequence (base schedule, the
partition window, the wall-clock windows on their own ``[seed, 7]``
stream, the injection cap), it patches the port's transport and only
it, and a socket exchange under resets and truncations completes with
every commit applied once.  Every exchange runs in a thread joined with
a timeout."""

import threading

import jax
import numpy as np
import pytest

from distkeras_tpu.parallel import faults as jax_faults
from distkeras_tpu.parallel import transport as jax_transport
from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.parallel import faults, host_ps, transport
from distkeras_tpu_torch.parallel import update_rules as rules
from distkeras_tpu_torch.parallel.trees import tree_map

jax.config.update("jax_platforms", "cpu")

TIMEOUT = 30.0
OPS = ["connect", "send", "recv", "send", "recv"] * 40


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


@pytest.mark.parametrize("kw", [
    dict(seed=7, reset_rate=0.1, truncate_rate=0.1, delay_rate=0.1,
         delay_s=0.0, max_injections=6),
    dict(seed=3, reset_rate=0.2, partition_at=10, partition_ops=5,
         partition_every=30, skip_ops=4, delay_s=0.0),
    dict(seed=11, reset_rate=0.05, windows=[(0.0, 1e9, ("reset", "delay",
                                                        "truncate"))],
         window_rate=0.5, delay_s=0.0, max_injections=20,
         clock=lambda: 1.0)],
    ids=["base", "partition", "windows"])
def test_decisions_equal_the_jax_packages(kw):
    port, ref = faults.ChaosTransport(**kw), jax_faults.ChaosTransport(**kw)
    got = [port._draw(op, port=5000) for op in OPS]
    want = [ref._draw(op, port=5000) for op in OPS]
    assert got == want
    assert port.counts == ref.counts and sum(port.counts.values()) > 0


def test_target_ports_filter_firing_not_the_schedule():
    kw = dict(seed=5, reset_rate=0.3)
    full = faults.ChaosTransport(**kw)
    aimed = faults.ChaosTransport(target_ports={1234}, **kw)
    base = [full._draw("send", port=99) for _ in range(50)]
    hits = [aimed._draw("send", port=99) for _ in range(50)]
    assert any(base) and not any(hits)
    again = faults.ChaosTransport(target_ports={1234}, **kw)
    assert [again._draw("send", port=1234) for _ in range(50)] == base


def test_install_patches_the_ports_transport_only():
    orig = (transport.connect, transport.send_msg, transport.recv_msg)
    jax_orig = (jax_transport.connect, jax_transport.send_msg)
    with faults.ChaosTransport(seed=1) as chaos:
        assert transport.send_msg == chaos._send_msg
        assert (jax_transport.connect, jax_transport.send_msg) == jax_orig
        with pytest.raises(RuntimeError, match="already installed"):
            chaos.install()
    assert (transport.connect, transport.send_msg,
            transport.recv_msg) == orig
    with pytest.raises(ValueError, match="outside"):
        faults.ChaosTransport(reset_rate=2.0)
    with pytest.raises(ValueError, match="heal"):
        faults.ChaosTransport(partition_at=0, partition_ops=4,
                              partition_every=4)
    with pytest.raises(ValueError, match="subset"):
        faults.ChaosTransport(windows=[(0, 1, ("melt",))])


def test_socket_commits_survive_chaos_exactly_once():
    center = {"w": np.zeros((4, 4), np.float32), "b": np.zeros(4,
                                                              np.float32)}
    deltas = [tree_map(lambda x, i=i: np.full_like(x, 2.0 ** -(i % 5)),
                       center) for i in range(12)]
    tel = telemetry.enable()
    ps = host_ps.HostParameterServer(rules.DownpourRule(), center)
    server = host_ps.PSServer(ps, center).start()
    chaos = faults.ChaosTransport(seed=4, reset_rate=0.08,
                                  truncate_rate=0.08, skip_ops=2,
                                  max_injections=8)

    def run():
        client = host_ps.ResilientPSClient.for_address(
            *server.address, worker_id=0, template=center, retries=30,
            backoff_base=0.001, backoff_max=0.01)
        with chaos:
            client.pull()
            for d in deltas:
                client.commit(d)
        client.done()
        client.close()
        return client

    try:
        client = bounded(run)
    finally:
        server.stop()
        telemetry.disable()
    assert sum(chaos.counts.values()) > 0 and client.retry_count > 0
    # every commit applied once: the center is the exact sum
    assert ps.num_commits == len(deltas)
    want = tree_map(lambda *xs: np.sum(xs, axis=0, dtype=np.float32),
                    *deltas)
    assert host_ps.pack_params(ps.center) == host_ps.pack_params(want)
    assert tel.metrics.sum_counter("chaos_injected_total") \
        == sum(chaos.counts.values())
