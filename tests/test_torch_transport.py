"""The port's PS wire (``parallel/transport.py``, ``parallel/trees.py``,
``host_ps.pack_params``) against the JAX package's: the same op-byte
table, the same frames and the same bytes for the same trees.  Sockets
are ``socketpair``s or loopback listeners on port 0, every wait bounded
by a socket timeout."""

import socket

import jax
import numpy as np
import pytest

from distkeras_tpu.parallel import host_ps as jax_ps
from distkeras_tpu.parallel import transport as jax_transport
from distkeras_tpu_torch.parallel import host_ps, transport
from distkeras_tpu_torch.parallel.trees import (tree_leaves, tree_map,
                                                tree_unflatten)

jax.config.update("jax_platforms", "cpu")

TIMEOUT = 10.0  # seconds: a hung peer fails the test, not the suite


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"Dense_1": {"kernel": rng.standard_normal((6, 3), np.float32),
                        "bias": rng.standard_normal(3, np.float32)},
            "Conv_0": {"kernel": rng.standard_normal((3, 3, 2, 4),
                                                     np.float32),
                       "bias": np.zeros(4, np.float32)},
            "AdaptiveGroupNorm_0": {"scale": np.ones(4, np.float32)}}


@pytest.fixture
def pair():
    a, b = socket.socketpair()
    for s in (a, b):
        s.settimeout(TIMEOUT)
    yield a, b
    a.close()
    b.close()


def test_wire_op_tables_are_the_jax_packages():
    assert transport.WIRE_OPS.scopes() == jax_transport.WIRE_OPS.scopes()
    for scope in jax_transport.WIRE_OPS.scopes():
        assert transport.WIRE_OPS.ops(scope) \
            == jax_transport.WIRE_OPS.ops(scope), scope
    assert transport.MAX_MSG_BYTES == jax_transport.MAX_MSG_BYTES
    assert transport.TRACE_HEADER_LEN == jax_transport.TRACE_HEADER_LEN


def test_wire_op_registry_refuses_collisions():
    ops = transport.WireOps()
    ops.register("ps", b"p", "pull")
    with pytest.raises(transport.WireOpCollision):
        ops.register("ps", b"p", "push")
    with pytest.raises(transport.WireOpCollision):
        ops.register("frame", b"p", "magic")
    with pytest.raises(ValueError, match="one byte"):
        ops.register("ps", b"pp", "x")


@pytest.mark.parametrize("obj", [
    {"center": _tree(), "epoch": 3, "num_commits": 17},
    {"b": [1, -2, 300, 2 ** 40], "a": "text", "c": None, "d": True,
     "e": 0.5, "f": np.float32(2.5), "g": b"raw"},
    [np.arange(5, dtype=np.int64), {"z": np.zeros((2, 0))}]],
    ids=["center", "scalars", "list"])
def test_pack_obj_bytes_equal_the_jax_packages(obj):
    data = transport.pack_obj(obj)
    assert data == jax_transport.pack_obj(obj)
    back = transport.unpack_obj(data)
    want = jax_transport.unpack_obj(data)
    got_leaves, want_leaves = tree_leaves(back), jax.tree_util.tree_leaves(
        want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_tree_order_is_jax_tree_util_order():
    tree = {"b": [np.ones(2), (np.zeros(1), None)], "a": {"y": np.arange(3),
                                                         "x": 1.5}}
    assert [np.asarray(x).tolist() for x in tree_leaves(tree)] == [
        np.asarray(x).tolist() for x in jax.tree_util.tree_leaves(tree)]
    rebuilt = tree_unflatten(tree, tree_leaves(tree))
    assert list(rebuilt) == ["a", "b"] and rebuilt["b"][1][1] is None
    doubled = tree_map(lambda x: 2 * np.asarray(x), tree)
    assert doubled["a"]["x"] == 3.0
    with pytest.raises(ValueError, match="fewer leaves"):
        tree_unflatten(tree, [1])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pack_params_bytes_equal_the_jax_packages(dtype):
    tree = tree_map(lambda x: x.astype(dtype), _tree(1))
    template = _tree(2)
    assert host_ps.pack_params(tree) == jax_ps.pack_params(tree)
    # the template casts each leaf to the wire dtype
    assert host_ps.pack_params(tree, template) \
        == jax_ps.pack_params(tree, template)
    data = jax_ps.pack_params(tree, template)
    got = host_ps.unpack_params(template, data)
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(
            jax_ps.unpack_params(template, data))):
        assert g.dtype == w.dtype and not g.flags.writeable
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="template expects"):
        host_ps.unpack_params(template, data + b"\0")


def test_frames_cross_between_packages(pair):
    a, b = pair
    transport.send_msg(a, b"c", b"\x00" * 8, b"body")
    assert jax_transport.recv_msg(b) == b"c" + b"\x00" * 8 + b"body"
    jax_transport.send_msg(b, b"hello")
    assert transport.recv_msg(a) == b"hello"
    leaves = [np.arange(6, dtype=np.float32), np.ones((2, 2), np.float64)]
    n = transport.send_msg_gather(a, b"P", *[memoryview(x) for x in leaves])
    got = jax_transport.recv_msg_into(b)
    assert n == 1 + 24 + 32 and bytes(got) == b"P" + b"".join(
        x.tobytes() for x in leaves)
    jax_transport.send_msg_gather(b, b"xy")
    assert bytes(transport.recv_msg_into(a)) == b"xy"
    assert transport.frame(b"ab", b"c") == jax_transport.frame(b"ab", b"c")


def test_oversized_header_is_refused_before_allocation(pair):
    a, b = pair
    a.sendall((transport.MAX_MSG_BYTES + 1).to_bytes(8, "big"))
    with pytest.raises(ValueError, match="sanity bound"):
        transport.recv_msg(b)
    a.sendall((transport.MAX_MSG_BYTES + 1).to_bytes(8, "big"))
    with pytest.raises(ValueError, match="sanity bound"):
        transport.recv_msg_into(b)


def test_peer_closing_mid_frame_raises(pair):
    a, b = pair
    a.sendall((10).to_bytes(8, "big") + b"abc")
    a.close()
    with pytest.raises(ConnectionError, match="mid-message"):
        transport.recv_msg(b)


def test_trace_header_is_empty_without_a_span():
    from distkeras_tpu_torch import telemetry

    assert transport.trace_header() == b""
    telemetry.enable()
    try:
        with telemetry.span("client") as sp:
            hdr = transport.trace_header()
        link, rest = transport.split_trace_header(hdr + b"p")
        assert link == (sp.trace_id, sp.span_id) and bytes(rest) == b"p"
        # the JAX package's server reads the same header
        assert jax_transport.split_trace_header(hdr + b"p")[0] == link
    finally:
        telemetry.disable()
    assert transport.split_trace_header(b"p") == (None, b"p")


def test_connect_clears_the_timeout_and_disables_nagle():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen()
    srv.settimeout(TIMEOUT)
    try:
        c = transport.connect(*srv.getsockname(), timeout=5.0)
        conn, _ = srv.accept()
        try:
            assert c.gettimeout() is None
            assert c.getsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY)
        finally:
            c.close()
            conn.close()
    finally:
        srv.close()
