"""Host-side concurrent parameter server — the *faithful* async arm
(design 5a of SURVEY.md §7: "host-side PS process, per-host async client
threads, faithful staleness behavior"); the port of
``distkeras_tpu/parallel/host_ps.py``, speaking the same wire.

Where ``ps_emulator`` compiles the whole commit round into one XLA
program with *deterministic* staleness, this module runs the reference's
actual concurrency model: worker threads free-running against a central
server whose commits are serialized by a mutex, staleness emerging from
real scheduling races (SURVEY.md §2.1 SocketParameterServer: accept
loop, handler per connection, lock around center updates).  It reuses
the very same ``UpdateRule`` objects as the emulator — the server law,
payload kind, window normalization and pull law are shared code — which
is what makes the two arms comparable: any convergence difference is
attributable to staleness semantics, not to reimplemented math
(VERDICT.md round-1 Missing #4).

Two transports:
* in-process — workers call the server object directly (the common case:
  one host, threads driving device steps);
* socket — a TCP server thread speaking the L1 framing
  (``parallel.transport``): single-byte commands ``b"p"`` (pull) /
  ``b"c"`` (commit payload) / ``b"s"`` (stop).  Raw parameter
  payloads ride ``pack_params``'s template-implied encoding
  (concatenated leaf bytes in canonical pytree order — both endpoints
  hold the same template, so the wire carries only data);
  compressed commits ride the negotiated codec's bytes.  The
  reference's wire protocol, minus pickle.

The server holds what the JAX package's holds: the center as a tree of
host numpy leaves (the flax ``params`` tree, walked in
``jax.tree_util``'s order by ``parallel.trees``), so a port worker can
commit to a JAX ``PSServer`` and a JAX worker to the port's, and the
centers come out byte for byte the same.  The rules are the port's
(``parallel.update_rules``) applied to numpy leaves, in the JAX numpy
path's order of operations and dtypes (``utils.tree_axpy``/
``tree_lerp`` take leaf-dtype scalars), so the arithmetic is the same
too.  Replication (``attach_replicator``, ``apply_replicated``,
``ResilientPSClient.for_replicas``), the elastic client
(``for_elastic``) and hierarchical group commits (``commit_group``)
belong to ``replicated_ps``, ``elastic_ps`` and ``hier_ps``, which are
not ported yet: they raise, naming ROADMAP.md §1 item 10.
"""

from __future__ import annotations

import contextlib
import os
import socket
import threading
import time
from typing import Any, Callable, Optional

import numpy as np

from distkeras_tpu_torch import flight_recorder, telemetry
from distkeras_tpu_torch.analysis import racecheck
from distkeras_tpu_torch.parallel import transport
from distkeras_tpu_torch.parallel.trees import tree_leaves, tree_map
from distkeras_tpu_torch.parallel.trees import tree_to_numpy as _to_numpy
from distkeras_tpu_torch.parallel.trees import tree_unflatten
from distkeras_tpu_torch.parallel.update_rules import PSState, UpdateRule

Pytree = Any


def _item10(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to distkeras_tpu_torch yet (ROADMAP.md §1 "
        f"item 10)")


def apply_rule(rule: UpdateRule, center: list, payload: list,
               staleness: int, local: list | None = None
               ) -> tuple[list, list]:
    """One commit of ``rule`` on leaf lists (numpy, template order):
    ``(new center leaves, the committing worker's pulled leaves)``.
    The port's rules take dicts; the leaves ride under their indices,
    so the per-leaf arithmetic is the rule's own."""
    state = PSState(center=dict(enumerate(center)), clock=0)
    new = rule.commit(state, dict(enumerate(payload)), np.int32(staleness))
    pulled = rule.worker_pull(
        None if local is None else dict(enumerate(local)),
        state.center, new.center)
    n = len(center)
    return ([np.asarray(new.center[i]) for i in range(n)],
            [np.asarray(pulled[i]) for i in range(n)])


def _readonly_view(x: np.ndarray) -> np.ndarray:
    """A no-copy read-only view: what ``pull``/``commit`` hand out so
    the in-process arm cannot alias-and-mutate server state (arrays
    built on read-only buffers — ``frombuffer`` views — already are)."""
    if not x.flags.writeable:
        return x
    v = x.view()
    v.flags.writeable = False
    return v


def _readonly_tree(tree: Pytree) -> Pytree:
    return tree_map(_readonly_view, tree)


def pack_params(tree, template=None) -> bytes:
    """Raw-buffer wire encoding: leaves in canonical pytree order,
    concatenated ``tobytes()``.  Shapes/dtypes ride the TEMPLATE both
    endpoints already hold (PSServer and PSClient are constructed with
    the same center tree), so the wire carries only data.  ``template`` casts each leaf to the wire dtype
    (the msgpack path did the cast on the receive side; e.g. a worker
    computing f64 deltas against an f32 center)."""
    leaves = tree_leaves(tree)
    if template is not None:
        temps = tree_leaves(template)
        if len(temps) != len(leaves):
            raise ValueError(
                f"payload has {len(leaves)} leaves, template "
                f"{len(temps)}")
        leaves = [np.asarray(x, dtype=t.dtype)
                  for x, t in zip(leaves, temps)]
    return b"".join(
        np.ascontiguousarray(x).tobytes() for x in leaves)


def unpack_params(template, data: bytes):
    """Inverse of ``pack_params``: zero-copy ``frombuffer`` views
    sliced per the template's leaf shapes/dtypes (read-only arrays —
    every consumer treats pulled/committed trees as immutable)."""
    buf = memoryview(data)
    out, off = [], 0
    for t in tree_leaves(template):
        n = int(t.nbytes)
        arr = np.frombuffer(buf[off:off + n],
                            dtype=t.dtype).reshape(t.shape)
        out.append(arr)
        off += n
    if off != len(data):
        raise ValueError(
            f"wire payload is {len(data)} bytes but the template "
            f"expects {off} (mismatched model between worker and PS)")
    return tree_unflatten(template, out)


# Wire value for "no sequence number" (dedupe off) in commit frames.
_NO_SEQ = 2 ** 64 - 1


class PSFencedError(ConnectionError):
    """The server refused a commit because it has been deposed: a newer
    primary holds a higher replication epoch (``replicated_ps``).  A
    deposed primary must reject rather than apply — two servers
    applying commits for the same training run is a split brain.
    Subclasses ``ConnectionError`` so ``ResilientPSClient`` treats it
    like a dead server and fails over to the next replica address."""



class HostParameterServer:
    """Threaded central state: ``pull``/``commit`` under a mutex.

    Staleness bookkeeping matches the reference DynSGD server: a global
    commit clock; a commit's staleness is the number of commits applied
    since the committing worker's last pull (SURVEY.md §2.1
    DynSGDParameterServer).

    ``staleness_log`` keeps only the last ``STALENESS_LOG_WINDOW``
    entries (a long run would otherwise grow one int per commit
    forever); the unbounded-horizon record is the
    ``ps_commit_staleness`` telemetry histogram, which aggregates
    without growing.
    """

    #: entries retained in ``staleness_log`` (the newest ones); the
    #: telemetry histogram is the full-horizon record.  Trimming is
    #: amortized: the list briefly overshoots by 25% before a cut.
    STALENESS_LOG_WINDOW = 100_000

    def __init__(self, rule: UpdateRule, center: Pytree, *,
                 snapshot_path: str | os.PathLike | None = None,
                 snapshot_every: int = 0):
        """``snapshot_path`` + ``snapshot_every=N``: every N-th commit
        atomically writes a warm-restart snapshot (center + clocks +
        commit-seq dedupe table) BEFORE the commit's reply is released
        — so with ``snapshot_every=1`` every acked commit is durable
        and a kill/restart cycle is exactly-once end to end (a commit
        applied-but-unacked is either in the snapshot, in which case
        the retry dedupes, or lost with the snapshot, in which case
        the retry re-applies it once).  Larger N amortizes the write:
        commits after the last snapshot are recovered only if the
        client retries them (unacked); acked ones are rolled back."""
        self.rule = rule
        self._lock = racecheck.lock("host_ps")
        self._center = _to_numpy(center)  # guarded-by: _lock
        self._clock = 0  # guarded-by: _lock
        self._pull_clock: dict[int, int] = {}
        self.staleness_log: list[int] = []
        self.num_commits = 0
        self.num_snapshots = 0
        self._snapshot_path = snapshot_path
        self._snapshot_every = int(snapshot_every)
        if self._snapshot_every and snapshot_path is None:
            raise ValueError(
                "snapshot_every needs a snapshot_path to write to")
        self._last_seen: dict[int, float] = {}
        # worker -> (seq, packed reply bytes).  Packed — not a live
        # tree — so the cache's footprint is explicit and measurable
        # (``ps_reply_cache_bytes`` gauge) instead of a hidden full
        # param copy per worker pinned by aliasing.
        self._last_reply: dict[int, tuple[int, bytes]] = {}
        self._reply_bytes = 0
        # the fencing epoch (the wire's ``b"E"`` probe) and the deposed
        # flag: written rarely (``fence``), read inside the commit lock
        self.epoch = 0
        self._fenced = False

    # -- the two verbs -----------------------------------------------------

    def pull(self, worker_id: int) -> Pytree:
        """Returns READ-ONLY views of the center (no copy): the
        in-process arm must not be able to mutate server state through
        the pulled tree (every consumer treats pulls as immutable; the
        views enforce it)."""
        telemetry.metrics().counter("ps_pulls_total").inc()
        with self._lock:
            self._pull_clock[worker_id] = self._clock
            self._last_seen[worker_id] = telemetry.now()
            return _readonly_tree(self._center)

    def commit(self, worker_id: int, payload: Pytree,
               local: Pytree | None = None,
               seq: int | None = None) -> Pytree:
        """Apply one commit; returns the worker's new local params (the
        rule's pull law, evaluated against the same center the server
        used — commit-and-pull is one atomic exchange, as in the
        reference where the handler thread holds the connection).

        ``seq`` is the worker's commit sequence number (monotonic per
        worker), used to dedupe retries: when a commit was applied but
        its *reply* was lost (a socket dying between apply and ack),
        the retried commit carries the same seq and gets the cached
        reply back instead of applying the window's delta twice —
        at-most-once application.  Any ``seq <=`` the worker's last
        applied seq is a duplicate (a straggler handler can deliver an
        old retransmit arbitrarily late); stragglers older than the
        last commit get the cached latest reply, which lands on a dead
        connection anyway."""
        # normalize to host numpy up front: the in-process arm may hand
        # tensors straight in, and the rules must run on numpy leaves
        payload = _to_numpy(payload)
        if local is not None:
            local = _to_numpy(local)
        m = telemetry.metrics()
        # the span encloses the mutex wait, so its duration shows both
        # apply cost and serialization contention on the timeline
        with telemetry.span("ps_commit", worker=worker_id), self._lock:
            if self._fenced:
                raise PSFencedError(
                    f"commit rejected: this server was deposed (a "
                    f"newer primary holds epoch > {self.epoch})")
            if seq is not None:
                last = self._last_reply.get(worker_id)
                if last is not None and seq <= last[0]:
                    self._last_seen[worker_id] = telemetry.now()
                    m.counter("ps_commit_dedup_total").inc()
                    # lint: allow(blocking-call-under-lock): the dedup
                    # decision must hit the flight log before the
                    # cached reply escapes (acked => recorded)
                    flight_recorder.record("commit_dedup",
                                           worker=worker_id, seq=seq)
                    return unpack_params(self._center, last[1])
            staleness = self._clock - self._pull_clock.get(worker_id, 0)
            new_leaves, pulled_leaves = apply_rule(
                self.rule, tree_leaves(self._center), tree_leaves(payload),
                staleness,
                None if local is None else tree_leaves(local))
            self._center = tree_unflatten(self._center, new_leaves)
            pulled = tree_unflatten(self._center, pulled_leaves)
            self._clock += 1
            self._pull_clock[worker_id] = self._clock
            self.staleness_log.append(int(staleness))
            if len(self.staleness_log) > self.STALENESS_LOG_WINDOW * 5 // 4:
                del self.staleness_log[:-self.STALENESS_LOG_WINDOW]
            self.num_commits += 1
            self._last_seen[worker_id] = telemetry.now()
            m.counter("ps_commits_total").inc()
            m.histogram("ps_commit_staleness",
                        buckets=telemetry.STALENESS_BUCKETS
                        ).observe(int(staleness))
            # lint: allow(blocking-call-under-lock): acked => durable —
            # the commit event must be on disk before the reply leaves
            # the lock (the warm-restart story depends on it)
            flight_recorder.record("commit", worker=worker_id, seq=seq,
                                   clock=self._clock,
                                   staleness=int(staleness))
            pulled = _to_numpy(pulled)
            if seq is not None:
                self._cache_reply_locked(worker_id, seq, pack_params(pulled))
            if (self._snapshot_every
                    and self.num_commits % self._snapshot_every == 0):
                # inside the lock, BEFORE the reply escapes: an acked
                # commit is durable (see __init__)
                self._write_snapshot_locked()
            return _readonly_tree(pulled)

    def _cache_reply_locked(self, worker_id: int, seq: int,
                            packed: bytes) -> None:
        old = self._last_reply.get(worker_id)
        if old is not None:
            self._reply_bytes -= len(old[1])
        self._last_reply[worker_id] = (seq, packed)
        self._reply_bytes += len(packed)
        telemetry.metrics().gauge("ps_reply_cache_bytes").set(
            self._reply_bytes)

    def commit_packed(self, worker_id: int, payload: Pytree,
                      local: Pytree | None = None,
                      seq: int | None = None) -> bytes:
        """``commit`` returning the WIRE encoding of the reply
        (``pack_params`` bytes): the socket handler's path, which packs
        exactly once — the same bytes land in the dedupe cache and on
        the socket (a dedupe hit returns the cached bytes with no
        repack at all)."""
        pulled = self.commit(worker_id, payload, local, seq=seq)
        if seq is not None:
            # commit() just cached this reply's pack — reuse it (one
            # pack per commit, shared between cache and wire)
            with self._lock:
                last = self._last_reply.get(worker_id)
                if last is not None and last[0] == seq:
                    return last[1]
        return pack_params(pulled)

    def commit_group(self, leader_id: int, fold: Pytree,
                     staleness, workers,
                     seq: int | None = None) -> Pytree:
        """A hierarchical leader's pre-reduced window (``hier_ps``)."""
        raise _item10("hierarchical aggregation (commit_group)")

    @property
    def center(self) -> Pytree:
        with self._lock:
            return _readonly_tree(self._center)

    def register(self, worker_id: int) -> None:
        """Start liveness monitoring before first contact, so a worker
        that hangs before ever reaching the server is still flagged by
        ``idle_workers`` instead of being invisible."""
        with self._lock:
            self._last_seen.setdefault(worker_id, telemetry.now())
            n = len(self._last_seen)
        telemetry.metrics().gauge("ps_registered_workers").set(n)

    def retire(self, worker_id: int) -> None:
        """A worker finished cleanly: stop monitoring it (so
        ``idle_workers`` never flags it) and drop its dedupe reply."""
        with self._lock:
            self._last_seen.pop(worker_id, None)
            dropped = self._last_reply.pop(worker_id, None)
            if dropped is not None:
                self._reply_bytes -= len(dropped[1])
                telemetry.metrics().gauge("ps_reply_cache_bytes").set(
                    self._reply_bytes)

    def clear_reply_cache(self) -> None:
        """Drop all cached dedupe replies (a full packed param copy
        per worker) — for when no client can retry anymore."""
        with self._lock:
            self._last_reply.clear()
            self._reply_bytes = 0
            telemetry.metrics().gauge("ps_reply_cache_bytes").set(0)

    def idle_workers(self, timeout: float) -> list[int]:
        """Failure *detection* (SURVEY.md §5 row the reference left
        empty): workers silent — no pull or commit — for more than
        ``timeout`` seconds.  PS traffic is the natural heartbeat: an
        alive PS-family worker contacts the server every communication
        window; one that is silent is stalled, partitioned, or dead.

        Heartbeats are stamped with ``telemetry.now()`` — the same
        monotonic clock as every other host timestamp in the repo —
        so idleness compares cleanly against serving/trainer spans."""
        now = telemetry.now()
        with self._lock:
            idle = sorted(w for w, seen in self._last_seen.items()
                          if now - seen > timeout)
            n = len(self._last_seen)
        telemetry.metrics().gauge("ps_idle_workers").set(len(idle))
        telemetry.metrics().gauge("ps_registered_workers").set(n)
        return idle

    def last_acked_seqs(self) -> dict[int, int]:
        """Per-worker last acked commit seq — the dedupe table's view,
        i.e. the at-most-once state a warm restart carries forward.
        ``scripts/postmortem.py`` cross-checks this against the flight
        recorder's pre-crash record."""
        with self._lock:
            return {int(w): int(seq)
                    for w, (seq, _) in self._last_reply.items()}

    # -- replication (replicated_ps) --------------------------------------

    def attach_replicator(self, replicator) -> None:
        """Primary-side log shipping (``replicated_ps``)."""
        raise _item10("PS replication (attach_replicator)")

    def fence(self, epoch: int) -> None:
        """Depose this server: a newer primary (higher ``epoch``) owns
        the training run now.  Every later commit raises
        ``PSFencedError`` — the client's cue to fail over."""
        with self._lock:
            self._fenced = True
            self.epoch = max(self.epoch, int(epoch))
        telemetry.metrics().counter("ps_fenced_total").inc()

    def apply_replicated(self, worker_id: int, payload: bytes,
                         seq: int | None, staleness: int,
                         reply: bytes) -> None:
        """Standby-side replay of a primary commit (``replicated_ps``)."""
        raise _item10("PS replication (apply_replicated)")

    # -- snapshot / warm restart ------------------------------------------

    def _snapshot_locked(self) -> dict:
        # numpy leaves are replaced, never mutated, by commit — shallow
        # references are a consistent point-in-time copy under the lock
        return {
            "center": self._center,
            "epoch": self.epoch,
            "clock": self._clock,
            "num_commits": self.num_commits,
            "pull_clock": {str(w): c
                           for w, c in self._pull_clock.items()},
            "staleness_log": np.asarray(self.staleness_log, np.int64),
            "last_reply": {str(w): {"seq": np.uint64(seq),
                                    "packed": packed}
                           for w, (seq, packed)
                           in self._last_reply.items()},
        }

    def snapshot(self) -> dict:
        """Point-in-time warm-restart state: center, commit clock,
        per-worker pull clocks, staleness log, and the commit-seq
        dedupe table (``last_reply`` — WITHOUT it a restarted server
        would re-apply a retried commit whose ack was lost)."""
        with self._lock:
            return self._snapshot_locked()

    def _write_snapshot_locked(self) -> None:
        from distkeras_tpu_torch import checkpoint as ckpt

        with telemetry.span("ps_snapshot", commits=self.num_commits):
            ckpt.save_ps_snapshot(self._snapshot_path,
                                  self._snapshot_locked())
        self.num_snapshots += 1
        telemetry.metrics().counter("ps_snapshots_total").inc()
        flight_recorder.record(
            "snapshot", path=os.fspath(self._snapshot_path),
            num_commits=self.num_commits,
            last_acked={str(w): int(seq)
                        for w, (seq, _) in self._last_reply.items()})

    def save_snapshot(self, path: str | os.PathLike) -> str:
        """Write ``snapshot()`` atomically (``checkpoint`` machinery:
        tmp + rename, msgpack encoding) — never observed half-written."""
        from distkeras_tpu_torch import checkpoint as ckpt

        return ckpt.save_ps_snapshot(path, self.snapshot())

    @classmethod
    def from_snapshot(cls, rule: UpdateRule,
                      snapshot: dict | str | os.PathLike, *,
                      snapshot_path: str | os.PathLike | None = None,
                      snapshot_every: int = 0) -> "HostParameterServer":
        """Warm-restart a server from ``snapshot()`` output or a path
        written by ``save_snapshot``/periodic snapshotting.  The rule
        must match the one that produced the snapshot (the center IS
        the rule's durable state; the commit clock and dedupe table
        restore staleness bookkeeping and at-most-once semantics for
        reconnecting clients)."""
        if isinstance(snapshot, (str, os.PathLike)):
            from distkeras_tpu_torch import checkpoint as ckpt

            snapshot = ckpt.load_ps_snapshot(snapshot)
        if "sharded" in snapshot:
            raise ValueError(
                "this snapshot came from a ShardedParameterServer "
                f"(K={int(snapshot['sharded'])}); restore it with "
                "sharded_ps.ShardedParameterServer.from_snapshot")
        ps = cls(rule, snapshot["center"], snapshot_path=snapshot_path,
                 snapshot_every=snapshot_every)
        ps.epoch = int(snapshot.get("epoch", 0))
        ps._clock = int(snapshot["clock"])
        ps.num_commits = int(snapshot["num_commits"])
        ps._pull_clock = {int(w): int(c) for w, c
                          in snapshot["pull_clock"].items()}
        ps.staleness_log = [int(s) for s
                            in np.asarray(snapshot["staleness_log"])]
        for w, e in snapshot["last_reply"].items():
            packed = (bytes(e["packed"]) if "packed" in e
                      else pack_params(e["pulled"]))  # pre-round-8 file
            ps._cache_reply_locked(int(w), int(e["seq"]), packed)
        return ps


class PSServer:
    """TCP front end for a ``HostParameterServer``.

    Protocol (all messages framed by ``transport``): first message on a
    connection is the worker id (4-byte big-endian int).  Then requests:
    ``b"p"`` -> center params; ``b"c" + 8-byte seq + params`` (+
    optional second frame with local params for pull-uses-local rules)
    -> new local params, where ``seq`` is the worker's monotonic commit
    counter (dedupes retried commits whose ack was lost; the all-ones
    value means "no seq" and disables dedupe for that commit).  ``b"s"``
    shuts the server down.
    """

    def __init__(self, ps, template: Pytree,
                 host: str = "127.0.0.1", port: int = 0):
        """``ps`` is a ``HostParameterServer`` or a
        ``sharded_ps.ShardedParameterServer`` — the latter additionally
        serves the shard-addressed ops ``b"P"`` (version-delta pull)
        and ``b"C"`` (per-shard commit) over the zero-copy
        scatter-gather wire (``transport.send_msg_gather`` /
        ``recv_msg_into``); the classic ``b"p"``/``b"c"`` verbs keep
        working against either server.

        The handshake frame is ``4-byte worker id`` optionally
        followed by a codec name (``parallel.compression``): commits on
        that connection then arrive codec-encoded instead of via the
        raw template-implied ``pack_params`` encoding — the wire-compression arm."""
        self.ps = ps
        self._template = _to_numpy(template)
        # duck-typed (no import cycle): the sharded server exposes the
        # per-shard verbs and its plan
        self._sharded = getattr(ps, "num_shards", 1) > 1 or \
            hasattr(ps, "pull_since")
        if self._sharded:
            tleaves = tree_leaves(self._template)
            self._shard_templates = [[tleaves[i] for i in idx]
                                     for idx in ps.plan]
        self._sock = socket.socket()
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen()
        self.address = self._sock.getsockname()
        self._threads: list[threading.Thread] = []
        self._conns: list[socket.socket] = []
        self._stop = threading.Event()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True)

    def start(self) -> "PSServer":
        self._accept_thread.start()
        return self

    def _accept_loop(self):
        try:
            # inside the try: kill() may close the socket before this
            # thread gets scheduled, and that race must not traceback
            try:
                self._sock.settimeout(0.2)
            except OSError:
                return
            while not self._stop.is_set():
                try:
                    conn, _ = self._sock.accept()
                except socket.timeout:
                    continue
                except OSError:
                    break
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY,
                                1)
                self._conns.append(conn)
                t = threading.Thread(target=self._serve, args=(conn,),
                                     daemon=True)
                t.start()
                self._threads.append(t)
        finally:
            # however the loop exits (stop() or the b"s" command), stop
            # listening — a bound-but-dead port accepts TCP connects
            # from health checks/reconnects that then hang
            try:
                self._sock.close()
            except OSError:
                pass

    def _serve(self, conn: socket.socket):
        # per-direction wire totals (message bodies; the 4-byte frame
        # headers are omitted — negligible against parameter payloads)
        rx = telemetry.metrics().counter("ps_wire_bytes_total",
                                         direction="rx")
        tx = telemetry.metrics().counter("ps_wire_bytes_total",
                                         direction="tx")
        with conn:
            try:
                hello = transport.recv_msg(conn)
                rx.inc(len(hello))
                worker_id = int.from_bytes(hello[:4], "big")
                codec = None
                if len(hello) > 4:
                    from distkeras_tpu_torch.parallel.compression import (
                        resolve_codec)

                    codec = resolve_codec(hello[4:].decode())
                while True:
                    msg = transport.recv_msg_into(conn)
                    rx.inc(len(msg))
                    # optional 17-byte trace-context header (zero bytes
                    # when client tracing is off): link the handler
                    # span back to the client span and complete the
                    # client→server flow arrow
                    link, msg = transport.split_trace_header(msg)
                    cmd, body = bytes(msg[:1]), msg[1:]
                    with contextlib.ExitStack() as rpc:
                        if link is not None:
                            rpc.enter_context(telemetry.span(
                                "ps_rpc", cmd=cmd.decode(),
                                worker=worker_id,
                                link_trace=format(link[0], "x"),
                                link_span=format(link[1], "x")))
                            telemetry.flow_end("wire", link[1],
                                               cmd=cmd.decode())
                        self._dispatch(conn, worker_id, codec, cmd,
                                       body, rx, tx)
                        if self._stop.is_set():
                            return
            except PSFencedError as e:
                # deposed primary: refuse the commit and drop the
                # connection — the client's ConnectionError sends it
                # to the next replica address.  Recorded (not printed):
                # fencing is the protocol working, not a handler bug.
                flight_recorder.record("ps_fenced", worker=worker_id,
                                       detail=str(e))
                return
            except (ConnectionError, OSError):
                return  # client gone; reference handlers did the same
            except Exception as e:
                # malformed frame / decode failure: drop the connection
                # with a diagnostic instead of dying silently (the
                # client sees a ConnectionError and retries/fails)
                import sys

                print(f"[distkeras_tpu_torch] PS handler error (worker "
                      f"connection dropped): {e!r}", file=sys.stderr,
                      flush=True)
                return

    def _dispatch(self, conn: socket.socket, worker_id: int, codec,
                  cmd: bytes, body, rx, tx) -> None:
        """One request: dispatch ``cmd`` against the PS and reply.
        Split from ``_serve`` so the trace-linked rpc span can wrap
        exactly one request."""
        if cmd == b"p":
            wire = pack_params(
                self.ps.pull(worker_id), self._template)
            tx.inc(len(wire))
            transport.send_msg(conn, wire)
        elif cmd == b"c":
            seq = int.from_bytes(body[:8], "big")
            if seq == _NO_SEQ:
                seq = None
            if codec is not None:
                payload = codec.decode(body[8:], self._template)
            else:
                payload = unpack_params(self._template, body[8:])
            local = None
            if self.ps.rule.pull_uses_local:
                raw = transport.recv_msg(conn)
                rx.inc(len(raw))
                local = unpack_params(self._template, raw)
            if hasattr(self.ps, "commit_packed"):
                # single pack, shared with the dedupe cache
                wire = self.ps.commit_packed(
                    worker_id, payload, local, seq=seq)
            else:
                wire = pack_params(
                    self.ps.commit(worker_id, payload, local, seq=seq),
                    self._template)
            tx.inc(len(wire))
            transport.send_msg(conn, wire)
        elif cmd == b"P" and self._sharded:
            from distkeras_tpu_torch.parallel.sharded_ps import (
                leaf_buffers)

            k = self.ps.num_shards
            since = [int.from_bytes(body[8 * i:8 * i + 8], "big")
                     for i in range(k)]
            included, _, _ = self.ps.pull_since(worker_id, since)
            head = len(included).to_bytes(2, "big") + \
                b"".join(s.to_bytes(2, "big") + c.to_bytes(8, "big")
                         for s, c, _ in included)
            parts = [head]
            for s, _, leaves in included:
                parts.extend(leaf_buffers(
                    leaves, self._shard_templates[s]))
            tx.inc(transport.send_msg_gather(conn, *parts))
        elif cmd == b"C" and self._sharded:
            from distkeras_tpu_torch.parallel.sharded_ps import (
                leaf_buffers, unpack_leaves)

            k = int.from_bytes(body[:2], "big")
            seq = int.from_bytes(body[2:10], "big")
            if seq == _NO_SEQ:
                seq = None
            temps = self._shard_templates[k]
            if codec is not None:
                leaves = codec.decode_leaves(body[10:], temps)
            else:
                leaves = unpack_leaves(temps, body[10:])
            local = None
            if self.ps.rule.pull_uses_local:
                # elastic family: the worker's local slice for THIS
                # shard rides as a second frame (the b"c" convention,
                # shard-scoped)
                raw = transport.recv_msg(conn)
                rx.inc(len(raw))
                local = unpack_leaves(temps, raw)
            clock, pulled = self.ps.commit_shard(
                worker_id, k, leaves, local, seq=seq)
            tx.inc(transport.send_msg_gather(
                conn, clock.to_bytes(8, "big"),
                *leaf_buffers(pulled, temps)))
        elif cmd == b"E":
            # replication epoch probe: 8-byte big-endian epoch (0 for
            # an unreplicated server) — lets trainers record which
            # epoch served the run and clients spot a deposed primary
            wire = int(getattr(self.ps, "epoch", 0)).to_bytes(8, "big")
            tx.inc(len(wire))
            transport.send_msg(conn, wire)
        elif cmd == b"V":
            # template-free center fetch (msgpack): the gateway's
            # rolling_update(source=[(host, port), ...]) pulls promoted
            # weights without holding the training template
            wire = transport.pack_obj({
                "center": _to_numpy(self.ps.center),
                "epoch": int(getattr(self.ps, "epoch", 0)),
                "num_commits": int(getattr(self.ps, "num_commits", 0)),
            })
            tx.inc(len(wire))
            transport.send_msg(conn, wire)
        elif cmd == b"d":
            # clean worker finish: retire from liveness monitoring and
            # drop its dedupe reply
            self.ps.retire(worker_id)
        elif cmd == b"s":
            self._stop.set()
        else:
            raise ValueError(f"unknown command {cmd!r}")

    def stop(self):
        self._stop.set()
        # No more clients: the dedupe replies have nothing to answer.
        self.ps.clear_reply_cache()
        try:
            self._sock.close()
        except OSError:
            pass

    def kill(self):
        """Crash simulation: drop the listening socket AND every live
        connection mid-exchange, keeping NO graceful-shutdown courtesy
        (the dedupe cache is not cleared — a real crash would not
        either; durable state is whatever the snapshots hold).  Clients
        see ``ConnectionError`` and retry against ``restart_from``."""
        # kill-path flight record, fsynced BEFORE the sockets die: the
        # postmortem's crash marker must survive whatever follows
        flight_recorder.record(
            "ps_kill", port=self.address[1],
            num_commits=int(getattr(self.ps, "num_commits", 0)))
        flight_recorder.flush(fsync=True)
        self._stop.set()
        for s in (self._sock, *self._conns):
            try:
                s.close()
            except OSError:
                pass

    @classmethod
    def restart_from(cls, snapshot: dict | str | os.PathLike,
                     rule: UpdateRule, template: Pytree, *,
                     host: str = "127.0.0.1", port: int = 0,
                     snapshot_path: str | os.PathLike | None = None,
                     snapshot_every: int = 0) -> "PSServer":
        """Warm restart: bring a killed PS back (typically on its old
        port so reconnecting ``ResilientPSClient``s find it) from a
        snapshot dict or file.  Commit-seq dedupe survives the restart,
        so a client retrying a commit the dead server already applied
        (and snapshotted) gets its cached reply instead of
        double-applying the delta.  Dispatches on the snapshot's
        ``"sharded"`` key, so a ``ShardedParameterServer`` snapshot
        restarts sharded (same K, plan re-derived from the saved
        center).  Returns a STARTED server."""
        if isinstance(snapshot, (str, os.PathLike)):
            from distkeras_tpu_torch import checkpoint as ckpt

            snapshot = ckpt.load_ps_snapshot(snapshot)
        if "sharded" in snapshot:
            from distkeras_tpu_torch.parallel.sharded_ps import (
                ShardedParameterServer)

            ps = ShardedParameterServer.from_snapshot(
                rule, snapshot, snapshot_path=snapshot_path,
                snapshot_every=snapshot_every)
        else:
            ps = HostParameterServer.from_snapshot(
                rule, snapshot, snapshot_path=snapshot_path,
                snapshot_every=snapshot_every)
        telemetry.metrics().counter("ps_restarts_total").inc()
        telemetry.instant("ps_restart", commits=ps.num_commits)
        flight_recorder.record(
            "ps_restart", num_commits=int(ps.num_commits),
            last_acked={str(w): s
                        for w, s in ps.last_acked_seqs().items()})
        return cls(ps, template, host=host, port=port).start()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class PSClient:
    """Worker-side connection to a ``PSServer`` (one per worker thread,
    as the reference opened one socket per Spark task)."""

    def __init__(self, host: str, port: int, worker_id: int,
                 template: Pytree, codec=None):
        """``codec`` (a ``parallel.compression`` codec or name): commits
        are sent codec-encoded — pass pre-encoded ``bytes`` to
        ``commit`` (the worker loop encodes once and keeps the residual
        for error feedback)."""
        from distkeras_tpu_torch.parallel.compression import resolve_codec

        self._sock = transport.connect(host, port, timeout=30.0)
        self._template = _to_numpy(template)
        self.codec = resolve_codec(codec)
        self.worker_id = int(worker_id)
        hello = int(worker_id).to_bytes(4, "big")
        if self.codec is not None:
            # The wire carries only the codec NAME; the server decodes
            # with its own name-resolved instance.  A custom codec class
            # (or a subclass shadowing a built-in name) would be decoded
            # by the stock codec — corrupting every update silently —
            # so require name-resolution to reproduce this exact class.
            try:
                server_side = resolve_codec(self.codec.name)
            except KeyError:
                server_side = None
            if server_side is None or \
                    type(server_side) is not type(self.codec):
                raise ValueError(
                    f"codec {type(self.codec).__name__}(name="
                    f"{self.codec.name!r}) cannot be reconstructed "
                    f"server-side from its name; custom codecs work "
                    f"only over the in-process transport")
            hello += self.codec.name.encode()
        transport.send_msg(self._sock, hello)

    def pull(self) -> Pytree:
        # the span pushes trace context; trace_header() reads it back,
        # so the wire carries (trace_id, span_id) only while tracing —
        # hdr is b"" (zero wire bytes) when telemetry is off
        with telemetry.span("ps_client_pull",
                            worker=self.worker_id) as sp:
            hdr = transport.trace_header()
            transport.send_msg(self._sock, hdr + b"p")
            if hdr:
                # arrow tail AFTER a successful send: an arrow exists
                # only for requests that actually left this process
                telemetry.flow_start("wire", sp.span_id, op="pull")
            return unpack_params(self._template,
                                 transport.recv_msg(self._sock))

    def commit(self, payload: Pytree, local: Pytree | None = None,
               seq: int | None = None) -> Pytree:
        """``seq``: monotonic per-worker commit counter enabling
        server-side retry dedupe; ``None`` (default) disables dedupe
        for this commit.  Pass explicit seqs if you retry commits."""
        wire_seq = _NO_SEQ if seq is None else int(seq)
        if seq is not None and not 0 <= wire_seq < _NO_SEQ:
            raise ValueError(
                f"seq out of range [0, 2**64-1): {seq}")
        if isinstance(payload, bytes):
            if self.codec is None:
                raise ValueError(
                    "pre-encoded commit bytes need a codec declared at "
                    "connect time (PSClient(codec=...))")
            body = payload
        elif self.codec is not None:
            # codec connection, tree payload: encode here (the server
            # decodes everything on this connection with the codec) —
            # callers wanting error feedback encode themselves and pass
            # bytes, keeping the residual
            body = self.codec.encode(payload)
        else:
            body = pack_params(_to_numpy(payload), self._template)
        with telemetry.span("ps_client_commit", worker=self.worker_id,
                            seq=seq) as sp:
            hdr = transport.trace_header()
            transport.send_msg(
                self._sock,
                hdr + b"c" + wire_seq.to_bytes(8, "big"), body)
            if local is not None:
                transport.send_msg(self._sock,
                                   pack_params(_to_numpy(local),
                                               self._template))
            if hdr:
                telemetry.flow_start("wire", sp.span_id, op="commit",
                                     seq=seq)
            return unpack_params(self._template,
                                 transport.recv_msg(self._sock))

    def done(self):
        """Announce a clean finish (retires this worker from the
        server's liveness monitoring) — call before ``close``."""
        transport.send_msg(self._sock, b"d")

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


class PSRetryExhausted(ConnectionError):
    """An operation kept failing past its retry budget; the last
    underlying error is ``__cause__``.  Distinct from a transient
    failure so callers (the trainer's round loop) can tell "the budget
    is spent, die" from "recompute and try again"."""


class _InProcessClient:
    """The in-process arm behind the same client face as ``PSClient``:
    direct method calls on a ``HostParameterServer``."""

    def __init__(self, ps: HostParameterServer, worker_id: int):
        self._ps = ps
        self._w = worker_id

    def pull(self) -> Pytree:
        return self._ps.pull(self._w)

    def commit(self, payload, local=None, seq=None) -> Pytree:
        return self._ps.commit(self._w, payload, local, seq=seq)

    def done(self):
        self._ps.retire(self._w)

    def close(self):
        pass


class ResilientPSClient:
    """Self-healing PS client: reconnect + exponential backoff with
    deterministic jitter + an explicit retry budget + at-most-once
    commit seqs — the recovery logic that used to live inline in
    ``trainers._train_host``'s worker loop, shared by trainers and
    scripts.

    The underlying connection is built lazily by ``factory`` (so the
    FIRST contact consumes the same budget as any later one) and
    rebuilt after every failure.  ``commit`` stamps a monotonic
    per-client sequence number and retries with the IDENTICAL payload
    bytes/tree, so a commit whose *ack* was lost is deduped server-side
    instead of applied twice (``HostParameterServer.commit``); the seq
    advances only after a confirmed reply.  Budget exhaustion raises
    ``PSRetryExhausted`` (from the last error) rather than the raw
    transport exception.

    ``on_retry(attempt, exc)`` fires before each backoff sleep — the
    trainer uses it to record ``worker_round_retries`` history and
    ``worker_retry`` trace instants.  Jitter draws from a seeded rng,
    so a chaos run's sleep schedule is reproducible.
    """

    def __init__(self, factory: Callable[[], Any], *, retries: int = 0,
                 backoff_base: float = 0.05, backoff_max: float = 2.0,
                 jitter: float = 0.5, seed: int = 0,
                 use_seq: bool = True,
                 retry_deadline: float | None = None,
                 on_retry: Optional[Callable[[int, Exception], None]]
                 = None, worker: int | None = None):
        """``retry_deadline`` (seconds, wall clock) bounds each
        operation's WHOLE retry ladder alongside the attempt-count
        budget: a generous ``retries`` with exponential backoff can
        otherwise stall a worker for the full ladder even after
        failover has already produced a live server elsewhere.  Either
        budget tripping raises ``PSRetryExhausted`` (the message says
        which)."""
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        if not 0.0 <= jitter <= 1.0:
            raise ValueError(f"jitter={jitter} outside [0, 1]")
        if retry_deadline is not None and retry_deadline <= 0:
            raise ValueError(
                f"retry_deadline must be > 0 seconds, got "
                f"{retry_deadline}")
        self.worker = worker  # identity for traces / flight records
        self._factory = factory
        self.retries = int(retries)
        self.retry_deadline = (None if retry_deadline is None
                               else float(retry_deadline))
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self.jitter = float(jitter)
        self.use_seq = bool(use_seq)
        self.on_retry = on_retry
        self._rng = np.random.default_rng(seed)
        self._raw = None
        self._seq = 0
        self.retry_count = 0

    @classmethod
    def for_address(cls, host: str, port: int, *, worker_id: int,
                    template: Pytree, codec=None, shards: int = 1,
                    shard_stats: dict | None = None, **kwargs
                    ) -> "ResilientPSClient":
        """Socket arm: (re)connects a ``PSClient`` — or, with
        ``shards > 1``, a ``sharded_ps.ShardedPSClient`` speaking the
        shard-addressed zero-copy wire (``shard_stats`` accumulates its
        version-delta pull savings across reconnects) — to a
        ``PSServer``.  Retries are shard-aware for free: the one seq
        stamped per logical commit rides every shard, so a retry after
        a partial application re-applies exactly the missed shards."""
        kwargs.setdefault("worker", worker_id)
        if shards > 1:
            from distkeras_tpu_torch.parallel.sharded_ps import (
                ShardedPSClient)

            return cls(lambda: ShardedPSClient(
                host, port, worker_id=worker_id, template=template,
                num_shards=shards, codec=codec, stats=shard_stats),
                **kwargs)
        return cls(lambda: PSClient(host, port, worker_id=worker_id,
                                    template=template, codec=codec),
                   **kwargs)

    @classmethod
    def for_replicas(cls, addresses, *, worker_id: int,
                     template: Pytree, **kwargs) -> "ResilientPSClient":
        """Multi-address socket arm for a replicated PS
        (``replicated_ps``)."""
        raise _item10("the replicated PS client (for_replicas)")

    @classmethod
    def for_server(cls, ps: HostParameterServer, worker_id: int,
                   **kwargs) -> "ResilientPSClient":
        """In-process arm.  Commits there are atomic (apply-and-reply
        under the server mutex — no lost-ack window), so dedupe seqs
        default off and no reply cache is kept per worker."""
        kwargs.setdefault("use_seq", False)
        kwargs.setdefault("worker", worker_id)
        return cls(lambda: _InProcessClient(ps, worker_id), **kwargs)

    @classmethod
    def for_elastic(cls, seeds, *, worker_id: int, template: Pytree,
                    stats: dict | None = None, **kwargs
                    ) -> "ResilientPSClient":
        """Elastic socket arm (``elastic_ps``)."""
        raise _item10("the elastic PS client (for_elastic)")

    # -- retry machinery ---------------------------------------------------

    def _backoff_delay(self, attempt: int) -> float:
        delay = min(self.backoff_max,
                    self.backoff_base * (2.0 ** (attempt - 1)))
        if self.jitter:
            # full-jitter downward: desynchronizes a worker herd
            # reconnecting to a restarted PS, deterministic per seed
            delay *= 1.0 - self.jitter * float(self._rng.random())
        return delay

    def _close_raw(self) -> None:
        if self._raw is not None:
            try:
                self._raw.close()
            except Exception:
                pass
            self._raw = None

    def _op(self, op: Callable[[Any], Pytree],
            kind: str = "op") -> Pytree:
        attempt = 0
        m = telemetry.metrics()
        deadline = (None if self.retry_deadline is None
                    else telemetry.now() + self.retry_deadline)
        # one span over the WHOLE retry loop: every attempt's
        # ps_client_commit/pull span nests under it and inherits its
        # trace id, so a retry storm reads as one causal chain in the
        # merged trace
        with telemetry.span("ps_op", op=kind, worker=self.worker):
            while True:
                try:
                    if self._raw is None:
                        self._raw = self._factory()
                    return op(self._raw)
                except Exception as e:
                    # Exception, not BaseException: KeyboardInterrupt /
                    # MemoryError must not be retried
                    self._close_raw()
                    attempt += 1
                    self.retry_count += 1
                    m.counter("ps_client_retries_total").inc()
                    flight_recorder.record("retry", op=kind,
                                           worker=self.worker,
                                           attempt=attempt,
                                           error=repr(e))
                    if attempt > self.retries:
                        raise PSRetryExhausted(
                            f"PS operation failed {attempt} time(s); "
                            f"retry budget retries={self.retries} "
                            f"(attempt count) exhausted "
                            f"(last: {e!r})") from e
                    remaining = (None if deadline is None
                                 else deadline - telemetry.now())
                    if remaining is not None and remaining <= 0:
                        raise PSRetryExhausted(
                            f"PS operation failed {attempt} time(s); "
                            f"retry budget retry_deadline="
                            f"{self.retry_deadline}s (wall clock) "
                            f"exhausted (last: {e!r})") from e
                    if self.on_retry is not None:
                        self.on_retry(attempt, e)
                    delay = self._backoff_delay(attempt)
                    if remaining is not None:
                        # never sleep past the wall-clock budget: the
                        # last attempt before the deadline still runs
                        delay = min(delay, remaining)
                    m.histogram(
                        "ps_client_backoff_seconds").observe(delay)
                    time.sleep(delay)

    # -- the client face ---------------------------------------------------

    def pull(self) -> Pytree:
        return self._op(lambda c: c.pull(), kind="pull")

    def commit(self, payload, local: Pytree | None = None) -> Pytree:
        """At-most-once commit: the seq is stamped once and reused
        across every internal retry (identical payload → the server
        either applies it or returns the cached reply), advancing only
        on success."""
        seq = self._seq if self.use_seq else None
        pulled = self._op(lambda c: c.commit(payload, local, seq=seq),
                          kind="commit")
        self._seq += 1
        return pulled

    def done(self) -> None:
        """Courtesy clean-finish announcement (retires this worker from
        server liveness monitoring); best-effort — a PS that is already
        gone must not fail a worker that finished its work."""
        if self._raw is not None:
            try:
                self._raw.done()
            except Exception:
                pass

    def close(self) -> None:
        self._close_raw()

    def __enter__(self) -> "ResilientPSClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def stop_server(host: str, port: int):
    """Ask a ``PSServer`` to shut down (the reference's stop command)."""
    sock = transport.connect(host, port, timeout=10.0)
    try:
        transport.send_msg(sock, (0).to_bytes(4, "big"))
        transport.send_msg(sock, b"s")
    finally:
        sock.close()


#: hello worker id used by management probes (epoch / center fetch) —
#: outside any trainer's worker-id range, never registered for liveness
_PROBE_WORKER = 2 ** 32 - 1


def fetch_epoch(host: str, port: int, timeout: float = 10.0) -> int:
    """The server's replication epoch (0 when unreplicated) via the
    ``b"E"`` wire verb — how trainers record ``ps_epoch`` history and
    tools identify which replica currently answers an address."""
    sock = transport.connect(host, port, timeout=timeout)
    try:
        transport.send_msg(sock, _PROBE_WORKER.to_bytes(4, "big"))
        transport.send_msg(sock, b"E")
        return int.from_bytes(transport.recv_msg(sock), "big")
    finally:
        sock.close()


def fetch_center_obj(host: str, port: int,
                     timeout: float = 30.0) -> dict:
    """Template-free center fetch via the ``b"V"`` wire verb: returns
    ``{"center": pytree, "epoch": int, "num_commits": int}``.  The
    serving gateway's ``rolling_update(source=[(host, port), ...])``
    uses this to pull promoted weights from whichever replica of a
    training PS is alive."""
    sock = transport.connect(host, port, timeout=timeout)
    try:
        transport.send_msg(sock, _PROBE_WORKER.to_bytes(4, "big"))
        transport.send_msg(sock, b"V")
        obj = transport.unpack_obj(transport.recv_msg(sock))
    finally:
        sock.close()
    return {"center": obj["center"], "epoch": int(obj["epoch"]),
            "num_commits": int(obj["num_commits"])}
