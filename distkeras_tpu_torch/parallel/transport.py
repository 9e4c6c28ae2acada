"""Socket transport: length-prefix framing + msgpack payloads; the port's
copy of ``distkeras_tpu/parallel/transport.py``, the same wire byte for
byte (frames, op bytes, trace header), so either package's clients and
servers talk to the other's.

The analogue of the reference's ``distkeras/networking.py`` (SURVEY.md §1
L1, §2.4): ``connect`` / ``send_msg`` / ``recv_msg`` with a fixed 8-byte
big-endian length header and a ``recvall`` loop
(``determine_host_address``, which only multi-host runs need, comes
with them: ROADMAP.md §1 item 8).  Two deliberate departures from the
reference: payloads are msgpack maps of raw tensor bytes
(``host_ps.pack_params``'s template-implied raw encoding for
parameters, msgpack elsewhere), never pickle (no arbitrary-object
execution on receive), and Nagle is disabled on both ends (the PS
exchange is latency-bound request/response traffic).  ``pack_obj``
writes flax's msgpack encoding through the port's own packer
(``serialization``), since neither flax nor msgpack is installed
beside the port.
"""

from __future__ import annotations

import os
import socket
import struct
from typing import Any

from distkeras_tpu_torch import serialization, telemetry

_HEADER = struct.Struct(">Q")


def _max_msg_bytes() -> int:
    """Sanity bound for the length header: a corrupt/garbage header
    must be rejected BEFORE ``recvall`` tries to allocate it.  Default
    1 GB (a ResNet-scale PS payload is ~45 MB; anything near a
    gigabyte is a desynced stream, not a parameter tree); override
    with ``DKT_MAX_MSG_BYTES`` for genuinely larger models."""
    return int(os.environ.get("DKT_MAX_MSG_BYTES", str(1 << 30)))


MAX_MSG_BYTES = _max_msg_bytes()


def connect(host: str, port: int, timeout: float | None = None
            ) -> socket.socket:
    """``timeout`` bounds connection ESTABLISHMENT only.  It is cleared
    once connected: ``create_connection`` leaves the timeout armed on
    the socket, so a pull slower than the connect timeout (big model,
    busy PS) would raise ``socket.timeout`` MID-frame — desyncing the
    length-prefix stream for every later message on the connection."""
    sock = socket.create_connection((host, port), timeout=timeout)
    sock.settimeout(None)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock


def frame(*parts: bytes) -> bytes:
    """One wire frame: 8-byte big-endian length header + body (exposed
    so ``parallel.faults`` can truncate a real frame mid-wire)."""
    total = sum(len(p) for p in parts)
    return _HEADER.pack(total) + b"".join(parts)


def send_msg(sock: socket.socket, *parts: bytes) -> None:
    """Send one framed message made of ``parts`` (concatenated headers
    let a request carry a command byte + payload without copies)."""
    sock.sendall(frame(*parts))


# sendmsg gathers at most IOV_MAX buffers per call; 64 is far below
# every platform's limit and keeps the partial-send bookkeeping short
_IOV_MAX = 64


def _as_byte_view(part) -> memoryview:
    mv = part if isinstance(part, memoryview) else memoryview(part)
    if mv.format != "B" or not mv.contiguous:
        mv = mv.cast("B")
    return mv


def send_msg_gather(sock: socket.socket, *parts) -> int:
    """Zero-copy scatter-gather variant of ``send_msg``: ``parts`` may
    be ``bytes`` or ``memoryview``s (e.g. views of already-contiguous
    parameter leaves) and are framed as ONE message but written via
    ``socket.sendmsg`` — no ``tobytes()`` materialization and no
    ``b"".join`` concatenation copy (the two host copies ``pack_params``
    pays on the single-mutex PS wire).  Returns the
    body byte count (header excluded) for wire accounting."""
    bufs = [_as_byte_view(p) for p in parts]
    total = sum(b.nbytes for b in bufs)
    bufs.insert(0, memoryview(_HEADER.pack(total)))
    i = 0
    while i < len(bufs):
        sent = sock.sendmsg(bufs[i:i + _IOV_MAX])
        while i < len(bufs) and sent >= bufs[i].nbytes:
            sent -= bufs[i].nbytes
            i += 1
        if sent:  # partial write inside buffer i: resume mid-buffer
            bufs[i] = bufs[i][sent:]
    return total


def recv_msg_into(sock: socket.socket) -> memoryview:
    """Receive one framed message into a single preallocated buffer
    (``recv_into`` — no chunk-list ``b"".join`` copy) and return a
    read-only memoryview over it.  ``numpy.frombuffer`` accepts the
    view directly, so a parameter payload is sliced into leaf arrays
    with zero further copies."""
    head = bytearray(_HEADER.size)
    _recv_into_all(sock, memoryview(head))
    (length,) = _HEADER.unpack(head)
    if length > MAX_MSG_BYTES:
        raise ValueError(
            f"message length {length} exceeds sanity bound "
            f"{MAX_MSG_BYTES} (DKT_MAX_MSG_BYTES)")
    body = bytearray(length)
    _recv_into_all(sock, memoryview(body))
    return memoryview(body).toreadonly()


def _recv_into_all(sock: socket.socket, mv: memoryview) -> None:
    off, n = 0, mv.nbytes
    while off < n:
        got = sock.recv_into(mv[off:], min(n - off, 1 << 20))
        if not got:
            raise ConnectionError("peer closed mid-message")
        off += got


def _recvall(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def pack_obj(obj: Any) -> bytes:
    """Self-describing msgpack encoding of a python object (dicts,
    lists, scalars, numpy arrays — flax's msgpack extension).  The
    serving-gateway wire uses this for request/result/health payloads,
    which have no pre-shared template the raw ``pack_params`` encoding
    could lean on.  Never pickle: nothing executable crosses the
    wire."""
    return serialization.msgpack_serialize(obj)


def unpack_obj(data: bytes | memoryview) -> Any:
    """Inverse of ``pack_obj`` (template-free)."""
    return serialization.msgpack_restore(bytes(data))


def recv_msg(sock: socket.socket) -> bytes:
    (length,) = _HEADER.unpack(_recvall(sock, _HEADER.size))
    if length > MAX_MSG_BYTES:
        # reject BEFORE allocating: a garbage header (desynced stream,
        # hostile peer) must not drive a multi-terabyte recv loop
        raise ValueError(
            f"message length {length} exceeds sanity bound "
            f"{MAX_MSG_BYTES} (DKT_MAX_MSG_BYTES)")
    return _recvall(sock, length)


# -- wire-op registry --------------------------------------------------
#
# Every single-byte command that crosses a framed socket is registered
# here, per protocol scope, instead of living as scattered literals in
# the dispatch/client code; the table is the JAX package's, scope for
# scope, so the two wires agree on every byte — and the registry itself
# rejects the two real collision hazards: two meanings
# for one byte within a scope, and any scope reusing the trace-header
# magic (the PS and replica servers peek one byte to tell a traced
# frame from a bare one, so the magic must be globally unambiguous).


class WireOpCollision(ValueError):
    """A wire-op byte was registered twice with different meanings."""


class WireOps:
    """Per-scope registry of single-byte wire commands.

    Scopes are independent protocols (``"ps"`` and ``"replica"`` both
    use ``b"s"`` for stop — different servers, never ambiguous); the
    ``"frame"`` scope holds bytes that may prefix ANY frame (the trace
    magic) and therefore must not collide with any other scope."""

    def __init__(self) -> None:
        self._ops: dict[str, dict[bytes, str]] = {}

    def register(self, scope: str, op: bytes, name: str) -> bytes:
        if len(op) != 1:
            raise ValueError(f"wire op must be one byte, got {op!r}")
        table = self._ops.setdefault(scope, {})
        if table.get(op, name) != name:
            raise WireOpCollision(
                f"{scope}:{op!r} already registered as "
                f"{table[op]!r}, refusing {name!r}")
        for other, tab in self._ops.items():
            if other == scope:
                continue
            if (scope == "frame" or other == "frame") and op in tab:
                raise WireOpCollision(
                    f"{op!r} ({name!r} in {scope!r}) collides with "
                    f"frame-level byte {tab[op]!r} in {other!r}")
        table[op] = name
        return op

    def ops(self, scope: str) -> dict[bytes, str]:
        """The registered ``op byte -> name`` table for one scope."""
        return dict(self._ops.get(scope, {}))

    def scopes(self) -> tuple[str, ...]:
        return tuple(sorted(self._ops))


WIRE_OPS = WireOps()

# frame-level: may prefix any protocol's frames (see trace header below)
WIRE_OPS.register("frame", b"t", "trace_header")
# classic + sharded PS protocol (host_ps.PSServer._dispatch)
WIRE_OPS.register("ps", b"p", "pull")
WIRE_OPS.register("ps", b"c", "commit")
WIRE_OPS.register("ps", b"P", "pull_since")
WIRE_OPS.register("ps", b"C", "commit_shard")
WIRE_OPS.register("ps", b"d", "done")
WIRE_OPS.register("ps", b"s", "stop")
WIRE_OPS.register("ps", b"E", "epoch")
WIRE_OPS.register("ps", b"V", "center_obj")
# PS replication protocol (replicated_ps: primary -> standby log
# shipping plus the standby's replies; requests a/h/?/b, replies k/f/g)
WIRE_OPS.register("repl", b"a", "append")
WIRE_OPS.register("repl", b"h", "heartbeat")
WIRE_OPS.register("repl", b"?", "status")
WIRE_OPS.register("repl", b"b", "bootstrap")
WIRE_OPS.register("repl", b"k", "ack")
WIRE_OPS.register("repl", b"f", "fenced")
WIRE_OPS.register("repl", b"g", "gap")
# elastic PS protocol (elastic_ps.ElasticPSServer._serve): versioned
# shard-map routing plus the migration snapshot/tail-log stream
WIRE_OPS.register("elastic", b"m", "fetch_map")
WIRE_OPS.register("elastic", b"g", "pull_versioned")
WIRE_OPS.register("elastic", b"c", "commit_shard")
WIRE_OPS.register("elastic", b"B", "migrate_bootstrap")
WIRE_OPS.register("elastic", b"A", "migrate_append")
WIRE_OPS.register("elastic", b"F", "migrate_finalize")
WIRE_OPS.register("elastic", b"d", "done")
WIRE_OPS.register("elastic", b"s", "stop")
# serving-replica protocol (gateway.ReplicaServer._dispatch)
WIRE_OPS.register("replica", b"g", "generate")
WIRE_OPS.register("replica", b"h", "health")
WIRE_OPS.register("replica", b"w", "swap_weights")
WIRE_OPS.register("replica", b"v", "variables")
WIRE_OPS.register("replica", b"q", "quiesce")
WIRE_OPS.register("replica", b"s", "stop")
# disaggregated prefill/decode handoff: kv_probe asks how
# many leading prompt blocks a replica's prefix store already holds,
# kv_export streams them out, kv_import installs a shipped block set
WIRE_OPS.register("replica", b"y", "kv_probe")
WIRE_OPS.register("replica", b"x", "kv_export")
WIRE_OPS.register("replica", b"k", "kv_import")
# KV page-block interchange payload (serving.pack_kv_blocks /
# unpack_kv_blocks): ONE gather-sent frame = the block-set op byte, an
# 8-byte BE meta length, the msgpack meta (prompt, per-leaf shape/
# dtype templates), then every block's raw leaf bytes back to back —
# zero-copy on the send side (page memoryviews ride ``sendmsg``)
WIRE_OPS.register("kv", b"K", "page_blocks")
# hierarchical aggregation tier (hier_ps.HierPSServer._dispatch): one
# pre-reduced group window — seq + per-worker staleness vector + the
# folded delta — answered with the root's new center
WIRE_OPS.register("hier", b"u", "upstream_commit")


# -- trace-context wire header --------------------------------------
#
# When tracing is enabled, PS requests prepend a 17-byte header to the
# frame body: ``b"t" + trace_id(8B BE) + span_id(8B BE)``.  ``b"t"`` is
# not a PS command byte, so the server peeks one byte to tell a traced
# request from a bare one — and when tracing is off the header is the
# EMPTY byte string, adding zero wire bytes.

_TRACE_HEADER = struct.Struct(">QQ")
TRACE_HEADER_LEN = 1 + _TRACE_HEADER.size  # magic + two 64-bit ids


def trace_header() -> bytes:
    """The 17-byte trace-context header for the CURRENT thread's
    innermost live span, or ``b""`` (zero bytes) when no span is open
    — i.e. always when telemetry is disabled."""
    ctx = telemetry.current_trace()
    if ctx is None:
        return b""
    return b"t" + _TRACE_HEADER.pack(ctx[0], ctx[1])


def split_trace_header(body: memoryview | bytes
                       ) -> tuple[tuple[int, int] | None, Any]:
    """Strip a leading trace-context header off a received frame body:
    returns ``((trace_id, span_id), rest)`` when present, ``(None,
    body)`` otherwise — the caller dispatches on ``rest`` exactly as it
    would have on an untraced body."""
    if len(body) >= TRACE_HEADER_LEN and bytes(body[:1]) == b"t":
        trace_id, span_id = _TRACE_HEADER.unpack(
            bytes(body[1:TRACE_HEADER_LEN]))
        return (trace_id, span_id), body[TRACE_HEADER_LEN:]
    return None, body
