"""Sharded host parameter server — per-shard locks, zero-copy
scatter-gather wire, version-delta pulls; the port of
``distkeras_tpu/parallel/sharded_ps.py``, on the same wire and the same
shard plan.

``HostParameterServer`` serializes every ``pull``/``commit`` across all
workers behind ONE mutex and ships the full parameter set both ways on
every exchange, paying ``pack_params``'s double host copy on the path
the JAX package measured as its PS ceiling.  This module shards that hot
loop the way the DistBelief lineage does (Dean et al. partition the
parameter space across server shards; ZeRO partitions optimizer state
the same way):

* the parameter pytree's LEAVES are partitioned into K byte-balanced
  shards (``plan_shards`` — greedy largest-first bin packing, a pure
  function of the template, so both endpoints derive the same plan and
  the wire never carries structure);
* each shard owns its lock, commit clock, per-worker pull clocks,
  bounded staleness window and commit-seq dedupe cache, so commits
  from different workers convoy only when they touch the same shard at
  the same instant — semantically exact for BOTH rule families: every
  rule's ``commit``/``worker_pull`` is per-leaf math (DOWNPOUR/ADAG/
  DynSGD apply additive deltas; the elastic family lerps each leaf
  against the center with the same per-shard staleness a K=1 server
  would compute under a serial schedule, its local tree riding the
  wire as a second frame per shard — the ``b"c"`` convention,
  shard-scoped), and a shard's clock advances exactly like the global
  clock under any full-tree commit schedule;
* the wire speaks shard-addressed ops over the existing framing:
  commits and replies ride ``transport.send_msg_gather`` (one
  ``sendmsg`` over memoryviews of the already-contiguous leaves — no
  ``tobytes`` materialization, no join copy) and are received with
  ``transport.recv_msg_into`` (single-buffer ``recv_into``, leaves
  sliced as zero-copy ``frombuffer`` views);
* pulls are version-delta: the client sends its last-seen per-shard
  clocks and the server ships ONLY shards whose clock advanced — a
  stale-polling or partially-caught-up worker pays bytes proportional
  to what actually changed (``ps_pull_shards_skipped_total`` /
  ``ps_pull_bytes_saved_total``).

Retry semantics are shard-aware for free: ``ResilientPSClient`` stamps
one seq per LOGICAL commit and reuses it across retries, and each
shard dedupes independently — a retry after a mid-commit failure
re-applies exactly the shards that missed and dedupes the ones that
landed (at-most-once per shard, hence per logical commit).

Snapshots are single-file and warm-restart compatible with
``PSServer.restart_from`` (which dispatches on the ``"sharded"`` key);
the periodic form triggers on the LAST shard of a logical commit and
writes under all shard locks before that shard's reply escapes, so an
acked logical commit is durable (``snapshot_every=1`` ⇒ exactly-once
across kill/restart, per-shard dedupe repairing any partially-applied
retry).

Replication of shard commits and hierarchical group commits
(``replicated_ps``, ``hier_ps``) are not ported yet: those entry points
raise, naming ROADMAP.md §1 item 10.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Sequence

import numpy as np

from distkeras_tpu_torch import flight_recorder, telemetry
from distkeras_tpu_torch.analysis import racecheck
from distkeras_tpu_torch.parallel import transport
from distkeras_tpu_torch.parallel.host_ps import (
    _NO_SEQ,
    _item10,
    _readonly_view,
    _to_numpy,
    apply_rule,
    HostParameterServer,
    PSFencedError,
)
from distkeras_tpu_torch.parallel.trees import tree_leaves, tree_unflatten
from distkeras_tpu_torch.parallel.update_rules import UpdateRule

Pytree = Any

#: wire value for "I have never seen this shard" in versioned pulls
#: (the server ships the shard regardless of its clock)
NEVER_PULLED = 2 ** 64 - 1


def plan_shards(template: Pytree, num_shards: int) -> list[list[int]]:
    """Partition the template's leaves into ``num_shards`` byte-balanced
    groups of flat leaf indices: greedy largest-first onto the lightest
    shard (deterministic — size-desc then index order, ties to the
    lowest shard id), indices re-sorted so every shard preserves
    canonical pytree order.  K is clamped to the leaf count (a shard
    must own at least one leaf); both endpoints compute the identical
    plan from the template they already share, so shard structure
    never crosses the wire."""
    leaves = tree_leaves(template)
    if not leaves:
        raise ValueError("cannot shard an empty parameter tree")
    k = max(1, min(int(num_shards), len(leaves)))
    sizes = [int(np.asarray(x).nbytes) for x in leaves]
    order = sorted(range(len(leaves)), key=lambda i: (-sizes[i], i))
    load = [0] * k
    plan: list[list[int]] = [[] for _ in range(k)]
    for i in order:
        j = min(range(k), key=lambda s: (load[s], s))
        plan[j].append(i)
        load[j] += sizes[i]
    for p in plan:
        p.sort()
    return plan


def leaf_nbytes(leaves: Sequence[np.ndarray]) -> int:
    return sum(int(np.asarray(x).nbytes) for x in leaves)


def pack_leaves(leaves, template=None) -> bytes:
    """``host_ps.pack_params`` for a leaf LIST (one shard's slice):
    concatenated contiguous bytes in shard order.  Used only where a
    materialized buffer is required (the dedupe cache, snapshots); the
    wire path gather-sends ``leaf_buffers`` instead."""
    return b"".join(leaf_buffers(leaves, template))


def leaf_buffers(leaves, template=None) -> list[memoryview]:
    """Zero-copy byte views of ``leaves`` for scatter-gather sends
    (copying only leaves that need a dtype cast or are non-contiguous
    — parameter leaves never are in practice)."""
    temps = list(template) if template is not None else None
    out = []
    for i, x in enumerate(leaves):
        arr = np.asarray(x)
        if temps is not None and arr.dtype != temps[i].dtype:
            arr = arr.astype(temps[i].dtype)
        arr = np.ascontiguousarray(arr)
        out.append(memoryview(arr.reshape(-1)).cast("B"))
    return out


def unpack_leaves(template_leaves, data) -> list[np.ndarray]:
    """Zero-copy inverse of the shard wire encoding: read-only
    ``frombuffer`` views sliced per the shard template's leaves."""
    buf = memoryview(data)
    out, off = [], 0
    for t in template_leaves:
        t = np.asarray(t)
        n = int(t.nbytes)
        out.append(np.frombuffer(buf[off:off + n],
                                 dtype=t.dtype).reshape(t.shape))
        off += n
    if off != len(buf):
        raise ValueError(
            f"shard payload is {len(buf)} bytes but the shard "
            f"template expects {off} (mismatched model or shard plan)")
    return out


class _Shard:
    """One shard's whole world: its leaves, lock, clocks and caches."""

    __slots__ = ("idx", "lock", "center", "clock", "pull_clock",
                 "staleness_log", "num_commits", "last_reply",
                 "reply_bytes", "nbytes")

    def __init__(self, idx: list[int], center: list[np.ndarray]):
        self.idx = idx
        self.lock = racecheck.lock("sharded_ps.shard")
        self.center = center
        self.clock = 0
        self.pull_clock: dict[int, int] = {}
        self.staleness_log: list[int] = []
        self.num_commits = 0
        self.last_reply: dict[int, tuple[int, bytes]] = {}
        self.reply_bytes = 0
        self.nbytes = leaf_nbytes(center)


class ShardedParameterServer:
    """Drop-in for ``HostParameterServer`` (same full-tree
    ``pull``/``commit``/liveness/snapshot face, so ``PSServer``,
    ``ResilientPSClient.for_server`` and the trainers compose
    unchanged) plus the per-shard verbs the sharded wire speaks."""

    STALENESS_LOG_WINDOW = HostParameterServer.STALENESS_LOG_WINDOW

    def __init__(self, rule: UpdateRule, center: Pytree,
                 num_shards: int, *,
                 snapshot_path: str | os.PathLike | None = None,
                 snapshot_every: int = 0):
        if int(num_shards) < 1:
            raise ValueError(
                f"num_shards must be >= 1, got {num_shards}")
        self.rule = rule
        self._template = _to_numpy(center)
        leaves = tree_leaves(self._template)
        self._n_leaves = len(leaves)
        self.plan = plan_shards(leaves, num_shards)
        self.num_shards = len(self.plan)
        self._shards = [_Shard(idx, [leaves[i] for i in idx])
                        for idx in self.plan]
        self._seen_lock = racecheck.lock("sharded_ps.seen")
        self._last_seen: dict[int, float] = {}
        # hier_ps leaders: leader id -> (upstream seq, packed center)
        # — group-level dedupe for pre-reduced window commits, kept
        # apart from the per-shard tables (a group commit touches
        # every shard atomically from the leader's point of view)
        self._group_replies: dict[int, tuple[int, bytes]] = {}
        # the fencing epoch and the deposed flag, as on the unsharded
        # server: written at fence, read per commit
        self.epoch = 0
        self._fenced = False
        self.num_snapshots = 0
        self._snapshot_path = snapshot_path
        self._snapshot_every = int(snapshot_every)
        if self._snapshot_every and snapshot_path is None:
            raise ValueError(
                "snapshot_every needs a snapshot_path to write to")

    # -- liveness (one small lock, never nested with shard locks) ----------

    def _stamp(self, worker_id: int) -> None:
        with self._seen_lock:
            self._last_seen[worker_id] = telemetry.now()

    def register(self, worker_id: int) -> None:
        with self._seen_lock:
            self._last_seen.setdefault(worker_id, telemetry.now())
            n = len(self._last_seen)
        telemetry.metrics().gauge("ps_registered_workers").set(n)

    def retire(self, worker_id: int) -> None:
        with self._seen_lock:
            self._last_seen.pop(worker_id, None)
        for shard in self._shards:
            with shard.lock:
                dropped = shard.last_reply.pop(worker_id, None)
                if dropped is not None:
                    shard.reply_bytes -= len(dropped[1])
        self._set_reply_gauge()

    def idle_workers(self, timeout: float) -> list[int]:
        now = telemetry.now()
        with self._seen_lock:
            idle = sorted(w for w, seen in self._last_seen.items()
                          if now - seen > timeout)
            n = len(self._last_seen)
        telemetry.metrics().gauge("ps_idle_workers").set(len(idle))
        telemetry.metrics().gauge("ps_registered_workers").set(n)
        return idle

    def last_acked_seqs(self) -> dict[int, int]:
        """Per-worker last FULLY-acked logical commit seq: the minimum
        across shard dedupe tables (a logical commit is acked only when
        its last shard replied, so a partially-applied commit reports
        the seq its laggard shards hold)."""
        out: dict[int, int] = {}
        for s in self._shards:
            with s.lock:
                for w, (seq, _) in s.last_reply.items():
                    out[int(w)] = min(out.get(int(w), int(seq)),
                                      int(seq))
        return out

    def clear_reply_cache(self) -> None:
        for shard in self._shards:
            with shard.lock:
                shard.last_reply.clear()
                shard.reply_bytes = 0
        with self._seen_lock:
            self._group_replies.clear()
        self._set_reply_gauge()

    def _set_reply_gauge(self) -> None:
        telemetry.metrics().gauge("ps_reply_cache_bytes").set(
            sum(s.reply_bytes for s in self._shards))

    # -- replication (replicated_ps) --------------------------------------

    def attach_replicator(self, replicator) -> None:
        """Primary-side log shipping (``replicated_ps``)."""
        raise _item10("PS replication (attach_replicator)")

    def fence(self, epoch: int) -> None:
        """Depose this server (see ``HostParameterServer.fence``)."""
        self._fenced = True
        self.epoch = max(self.epoch, int(epoch))
        telemetry.metrics().counter("ps_fenced_total").inc()

    def apply_replicated_shard(self, shard: int, worker_id: int,
                               payload: bytes, seq: int | None,
                               staleness: int, reply: bytes) -> None:
        """Standby-side replay of one shard commit (``replicated_ps``)."""
        raise _item10("PS replication (apply_replicated_shard)")

    # -- per-shard verbs (the sharded wire) --------------------------------

    def shard_clocks(self) -> list[int]:
        return [s.clock for s in self._shards]

    def pull_shard(self, worker_id: int, shard: int
                   ) -> tuple[int, list[np.ndarray]]:
        """One shard's ``(clock, read-only leaves)``; stamps the
        worker's pull clock for that shard's staleness bookkeeping."""
        s = self._shards[shard]
        with s.lock:
            s.pull_clock[worker_id] = s.clock
            return s.clock, [_readonly_view(x) for x in s.center]

    def pull_since(self, worker_id: int, since: Sequence[int]
                   ) -> tuple[list[tuple[int, int, list[np.ndarray]]],
                              int, int]:
        """Version-delta pull: ``(included, skipped_shards,
        skipped_bytes)`` where ``included`` lists ``(shard, clock,
        read-only leaves)`` for every shard whose clock advanced past
        ``since[shard]`` (``NEVER_PULLED`` forces inclusion).  Every
        shard — shipped or skipped — stamps the worker's pull clock:
        a skipped shard's center is, by definition of the skip, exactly
        what the worker already holds."""
        if len(since) != self.num_shards:
            raise ValueError(
                f"versioned pull carries {len(since)} clocks, server "
                f"has {self.num_shards} shards (mismatched plan)")
        m = telemetry.metrics()
        m.counter("ps_pulls_total").inc()
        included, skipped, saved = [], 0, 0
        for k, s in enumerate(self._shards):
            with s.lock:
                s.pull_clock[worker_id] = s.clock
                if since[k] != NEVER_PULLED and s.clock <= since[k]:
                    skipped += 1
                    saved += s.nbytes
                    continue
                included.append(
                    (k, s.clock, [_readonly_view(x)
                                  for x in s.center]))
        self._stamp(worker_id)
        if skipped:
            m.counter("ps_pull_shards_skipped_total").inc(skipped)
            m.counter("ps_pull_bytes_saved_total").inc(saved)
        return included, skipped, saved

    def commit_shard(self, worker_id: int, shard: int,
                     leaves: Sequence[np.ndarray],
                     local: Optional[Sequence[np.ndarray]] = None,
                     seq: int | None = None
                     ) -> tuple[int, list[np.ndarray]]:
        """Apply one shard's slice of a logical commit under THAT
        shard's lock only; returns ``(shard clock after, read-only
        pulled leaves)``.  ``seq`` dedupes per shard — a retried
        logical commit re-applies exactly the shards that missed."""
        s = self._shards[shard]
        m = telemetry.metrics()
        leaves = [np.asarray(x) for x in leaves]
        if local is not None:
            local = [np.asarray(x) for x in local]
        wait0 = telemetry.now()
        waiters = m.gauge("ps_commit_waiters")
        waiters.inc()
        s.lock.acquire()
        waiters.dec()
        m.counter("ps_lock_wait_seconds_total").inc(
            telemetry.now() - wait0)
        try:
            with telemetry.span("ps_shard_commit", worker=worker_id,
                                shard=shard):
                if self._fenced:
                    raise PSFencedError(
                        f"commit rejected: this server was deposed "
                        f"(a newer primary holds epoch > "
                        f"{self.epoch})")
                if seq is not None:
                    last = s.last_reply.get(worker_id)
                    if last is not None and seq <= last[0]:
                        self._stamp(worker_id)
                        m.counter("ps_commit_dedup_total").inc()
                        return s.clock, unpack_leaves(s.center,
                                                      last[1])
                staleness = s.clock - s.pull_clock.get(worker_id, 0)
                s.center, pulled = apply_rule(self.rule, s.center, leaves,
                                              staleness, local)
                s.clock += 1
                s.pull_clock[worker_id] = s.clock
                s.staleness_log.append(int(staleness))
                if len(s.staleness_log) > \
                        self.STALENESS_LOG_WINDOW * 5 // 4:
                    del s.staleness_log[:-self.STALENESS_LOG_WINDOW]
                s.num_commits += 1
                m.counter("ps_shard_commits_total").inc()
                m.histogram("ps_commit_staleness",
                            buckets=telemetry.STALENESS_BUCKETS
                            ).observe(int(staleness))
                pulled = [np.asarray(x) for x in pulled]
                if seq is not None:
                    old = s.last_reply.get(worker_id)
                    if old is not None:
                        s.reply_bytes -= len(old[1])
                    reply_packed = pack_leaves(pulled)
                    s.last_reply[worker_id] = (seq, reply_packed)
                    s.reply_bytes += len(reply_packed)
                if shard == self.num_shards - 1:
                    m.counter("ps_commits_total").inc()
                    # one flight event per LOGICAL commit (its last
                    # shard), not one per shard — the recorder stays
                    # proportional to commits
                    # lint: allow(blocking-call-under-lock): acked =>
                    # durable — recorded under the last shard's lock so
                    # no later commit can be acked first
                    flight_recorder.record(
                        "commit", worker=worker_id, seq=seq,
                        clock=s.clock, shards=self.num_shards,
                        staleness=int(staleness))
                    if (self._snapshot_every and s.num_commits
                            % self._snapshot_every == 0):
                        # the logical commit's other shards applied
                        # before this one (shard order is the client
                        # contract); snapshot under ALL locks before
                        # this last reply escapes: acked ⇒ durable
                        self._write_snapshot_holding(shard)
                self._stamp(worker_id)
                return s.clock, [_readonly_view(x) for x in pulled]
        finally:
            s.lock.release()
            if seq is not None:
                self._set_reply_gauge()

    def commit_group(self, leader_id: int, fold: Pytree,
                     staleness, workers,
                     seq: int | None = None) -> Pytree:
        """A hierarchical leader's pre-reduced window (``hier_ps``)."""
        raise _item10("hierarchical aggregation (commit_group)")

    # -- the full-tree face (in-process arm, PSClient compat) --------------

    def pull(self, worker_id: int) -> Pytree:
        telemetry.metrics().counter("ps_pulls_total").inc()
        out: list = [None] * self._n_leaves
        for s in self._shards:
            with s.lock:
                s.pull_clock[worker_id] = s.clock
                for i, x in zip(s.idx, s.center):
                    out[i] = _readonly_view(x)
        self._stamp(worker_id)
        return tree_unflatten(self._template, out)

    def commit(self, worker_id: int, payload: Pytree,
               local: Pytree | None = None,
               seq: int | None = None) -> Pytree:
        """Full-tree commit as K shard commits in shard order (the
        same order the sharded wire client uses, which is what makes
        the last shard the snapshot trigger); shard locks are taken
        one at a time — never nested — so commits from different
        workers interleave per shard instead of convoying."""
        leaves = tree_leaves(_to_numpy(payload))
        if len(leaves) != self._n_leaves:
            raise ValueError(
                f"payload has {len(leaves)} leaves, server template "
                f"has {self._n_leaves}")
        local_leaves = (None if local is None
                        else tree_leaves(_to_numpy(local)))
        out: list = [None] * self._n_leaves
        for k, s in enumerate(self._shards):
            _, pulled = self.commit_shard(
                worker_id, k, [leaves[i] for i in s.idx],
                None if local_leaves is None
                else [local_leaves[i] for i in s.idx], seq=seq)
            for i, x in zip(s.idx, pulled):
                out[i] = x
        return tree_unflatten(self._template, out)

    @property
    def center(self) -> Pytree:
        out: list = [None] * self._n_leaves
        for s in self._shards:
            with s.lock:
                for i, x in zip(s.idx, s.center):
                    out[i] = _readonly_view(x)
        return tree_unflatten(self._template, out)

    @property
    def staleness_log(self) -> list[int]:
        """Shard 0's (bounded) staleness window — the representative
        sequence: every logical commit touches every shard, so under
        any serial schedule shard 0's log equals the unsharded
        server's.  Per-shard distributions live in the
        ``ps_commit_staleness`` telemetry histogram."""
        return self._shards[0].staleness_log

    @property
    def num_commits(self) -> int:
        """Logical commits (every one touches shard 0)."""
        return self._shards[0].num_commits

    # -- snapshot / warm restart ------------------------------------------

    def _snapshot_holding(self, held: int | None) -> dict:
        """Build the snapshot dict, acquiring every shard lock not
        already ``held`` (in index order — the only multi-lock path in
        the class, so ordering is trivially safe)."""
        taken = []
        try:
            for k, s in enumerate(self._shards):
                if k != held:
                    s.lock.acquire()
                    taken.append(s)
            return self._build_snapshot_all_locked()
        finally:
            for s in taken:
                s.lock.release()

    def _build_snapshot_all_locked(self) -> dict:
        center: list = [None] * self._n_leaves
        shards = []
        for s in self._shards:
            for i, x in zip(s.idx, s.center):
                center[i] = x
            shards.append({
                "clock": s.clock,
                "num_commits": s.num_commits,
                "pull_clock": {str(w): c
                               for w, c in s.pull_clock.items()},
                "staleness_log": np.asarray(s.staleness_log,
                                            np.int64),
                "last_reply": {str(w): {"seq": np.uint64(seq),
                                        "packed": packed}
                               for w, (seq, packed)
                               in s.last_reply.items()},
            })
        return {
            "sharded": self.num_shards,
            "epoch": self.epoch,
            "center": tree_unflatten(self._template, center),
            "shards": shards,
        }

    def snapshot(self) -> dict:
        """Point-in-time warm-restart state across ALL shards (taken
        under every shard lock): full center plus per-shard clocks,
        pull clocks, staleness windows and dedupe caches."""
        return self._snapshot_holding(None)

    def _write_snapshot_holding(self, held: int) -> None:
        from distkeras_tpu_torch import checkpoint as ckpt

        with telemetry.span("ps_snapshot",
                            commits=self._shards[held].num_commits):
            snap = self._snapshot_holding(held)
            ckpt.save_ps_snapshot(self._snapshot_path, snap)
        self.num_snapshots += 1
        telemetry.metrics().counter("ps_snapshots_total").inc()
        # fully-acked seq per worker = min across the shard dedupe
        # tables just captured (same law as ``last_acked_seqs``)
        acked: dict[str, int] = {}
        for saved in snap["shards"]:
            for w, e in saved["last_reply"].items():
                seq = int(e["seq"])
                acked[w] = min(acked.get(w, seq), seq)
        flight_recorder.record(
            "snapshot", path=os.fspath(self._snapshot_path),
            num_commits=int(self._shards[0].num_commits),
            last_acked=acked)

    def save_snapshot(self, path: str | os.PathLike) -> str:
        from distkeras_tpu_torch import checkpoint as ckpt

        return ckpt.save_ps_snapshot(path, self.snapshot())

    @classmethod
    def from_snapshot(cls, rule: UpdateRule,
                      snapshot: dict | str | os.PathLike, *,
                      snapshot_path: str | os.PathLike | None = None,
                      snapshot_every: int = 0
                      ) -> "ShardedParameterServer":
        """Warm restart; the shard plan is recomputed from the saved
        center (same deterministic function of the template), so the
        snapshot carries no structure beyond the shard count."""
        if isinstance(snapshot, (str, os.PathLike)):
            from distkeras_tpu_torch import checkpoint as ckpt

            snapshot = ckpt.load_ps_snapshot(snapshot)
        if "sharded" not in snapshot:
            raise ValueError(
                "not a sharded PS snapshot; restore with "
                "HostParameterServer.from_snapshot")
        ps = cls(rule, snapshot["center"],
                 int(snapshot["sharded"]),
                 snapshot_path=snapshot_path,
                 snapshot_every=snapshot_every)
        ps.epoch = int(snapshot.get("epoch", 0))
        if len(snapshot["shards"]) != ps.num_shards:
            raise ValueError(
                f"snapshot holds {len(snapshot['shards'])} shards, "
                f"plan derived {ps.num_shards}")
        for s, saved in zip(ps._shards, snapshot["shards"]):
            s.clock = int(saved["clock"])
            s.num_commits = int(saved["num_commits"])
            s.pull_clock = {int(w): int(c) for w, c
                            in saved["pull_clock"].items()}
            s.staleness_log = [int(x) for x
                               in np.asarray(saved["staleness_log"])]
            s.last_reply = {int(w): (int(e["seq"]),
                                     bytes(e["packed"]))
                            for w, e in saved["last_reply"].items()}
            s.reply_bytes = sum(len(p) for _, p
                                in s.last_reply.values())
        ps._set_reply_gauge()
        return ps


class ShardedPSClient:
    """Worker-side connection speaking the shard-addressed wire ops
    against a ``PSServer`` fronting a ``ShardedParameterServer``.

    Same face as ``PSClient`` (``pull``/``commit``/``done``/``close``)
    so ``ResilientPSClient`` wraps it unchanged; a reconnect rebuilds
    the client with empty version caches (the first pull after a
    failure is a full pull — correct, just unsaved bytes).

    ``commit`` splits the payload by the shared shard plan and walks
    the shards in order, one request/reply per shard, each applied
    under only that shard's server-side lock; the SAME logical seq
    rides every shard, so a retried commit is deduped or applied
    independently per shard (at-most-once per shard).  ``pull`` is
    version-delta: unchanged shards are served from the client's own
    cache and never touch the wire.
    """

    def __init__(self, host: str, port: int, worker_id: int,
                 template: Pytree, num_shards: int, codec=None,
                 stats: Optional[dict] = None):
        """``num_shards`` is the deployment contract: client and server
        derive the identical plan from (template, K) — a mismatched K
        surfaces as a clock-count/shard-id error on the first op.
        ``stats`` (optional dict) accumulates ``pull_shards_skipped``
        / ``pull_bytes_saved`` across ops — shared by the trainer's
        worker threads to feed history."""
        from distkeras_tpu_torch.parallel.compression import resolve_codec

        self.worker_id = int(worker_id)
        self._template = _to_numpy(template)
        self._template_leaves = tree_leaves(self._template)
        self._bind_plan(int(num_shards))
        self.codec = resolve_codec(codec)
        self._stats = stats if stats is not None else {}
        self._stats.setdefault("pull_shards_skipped", 0)
        self._stats.setdefault("pull_bytes_saved", 0)
        self._sock = transport.connect(host, port, timeout=30.0)
        hello = int(worker_id).to_bytes(4, "big")
        if self.codec is not None:
            server_side = resolve_codec(self.codec.name)
            if type(server_side) is not type(self.codec):
                raise ValueError(
                    f"codec {type(self.codec).__name__} cannot be "
                    "reconstructed server-side from its name")
            hello += self.codec.name.encode()
        transport.send_msg(self._sock, hello)

    def _bind_plan(self, num_shards: int) -> None:
        self.plan = plan_shards(self._template_leaves, num_shards)
        self.num_shards = len(self.plan)
        self._shard_templates = [[self._template_leaves[i]
                                  for i in idx] for idx in self.plan]
        self._clocks = [NEVER_PULLED] * self.num_shards
        self._have: list[Optional[list[np.ndarray]]] = \
            [None] * self.num_shards

    def _assemble(self) -> Pytree:
        out: list = [None] * len(self._template_leaves)
        for idx, leaves in zip(self.plan, self._have):
            for i, x in zip(idx, leaves):
                out[i] = x
        return tree_unflatten(self._template, out)

    def pull(self) -> Pytree:
        body = b"".join(int(c).to_bytes(8, "big")
                        for c in self._clocks)
        with telemetry.span("ps_client_pull",
                            worker=self.worker_id) as sp:
            hdr = transport.trace_header()
            transport.send_msg(self._sock, hdr + b"P", body)
            if hdr:
                telemetry.flow_start("wire", sp.span_id, op="pull")
            reply = transport.recv_msg_into(self._sock)
        count = int.from_bytes(reply[:2], "big")
        off = 2 + 10 * count
        fresh = set()
        for e in range(count):
            head = reply[2 + 10 * e: 2 + 10 * e + 10]
            k = int.from_bytes(head[:2], "big")
            clock = int.from_bytes(head[2:], "big")
            temps = self._shard_templates[k]
            n = leaf_nbytes(temps)
            self._have[k] = unpack_leaves(temps, reply[off:off + n])
            self._clocks[k] = clock
            fresh.add(k)
            off += n
        skipped = saved = 0
        for k in range(self.num_shards):
            if k in fresh:
                continue
            if self._have[k] is None:
                raise ConnectionError(
                    f"server skipped shard {k} this client never "
                    "pulled (mismatched shard plan?)")
            skipped += 1
            saved += leaf_nbytes(self._shard_templates[k])
        self._stats["pull_shards_skipped"] += skipped
        self._stats["pull_bytes_saved"] += saved
        return self._assemble()

    def commit(self, payload, local: Pytree | None = None,
               seq: int | None = None) -> Pytree:
        wire_seq = _NO_SEQ if seq is None else int(seq)
        if seq is not None and not 0 <= wire_seq < _NO_SEQ:
            raise ValueError(f"seq out of range [0, 2**64-1): {seq}")
        if isinstance(payload, (list, tuple)):  # pre-encoded per shard
            if self.codec is None:
                raise ValueError(
                    "pre-encoded shard bytes need a codec declared at "
                    "connect time")
            if len(payload) != self.num_shards:
                raise ValueError(
                    f"{len(payload)} encoded shards for "
                    f"{self.num_shards}-shard plan")
            bodies = list(payload)
        else:
            leaves = tree_leaves(_to_numpy(payload))
            shards = [[leaves[i] for i in idx] for idx in self.plan]
            if self.codec is not None:
                bodies = [self.codec.encode_leaves(s) for s in shards]
            else:
                bodies = shards
        local_shards = None
        if local is not None:
            # elastic family (pull_uses_local): the local slice for
            # each shard rides as a second frame after the commit
            # frame — the shard-scoped twin of the b"c" convention
            if isinstance(payload, (list, tuple)):
                raise ValueError(
                    "pre-encoded shard bytes cannot carry a local "
                    "tree (the elastic family does not compress)")
            local_leaves = tree_leaves(_to_numpy(local))
            local_shards = [[local_leaves[i] for i in idx]
                            for idx in self.plan]
        with telemetry.span("ps_client_commit",
                            worker=self.worker_id, seq=seq):
            for k, body in enumerate(bodies):
                head = (b"C" + int(k).to_bytes(2, "big")
                        + wire_seq.to_bytes(8, "big"))
                # per-shard sub-span: each shard request is its own
                # wire round trip, so each gets its own flow arrow
                with telemetry.span("ps_client_shard_commit",
                                    shard=k) as sp:
                    hdr = transport.trace_header()
                    if isinstance(body, (bytes, bytearray)):
                        transport.send_msg_gather(
                            self._sock, hdr + head, body)
                    else:
                        transport.send_msg_gather(
                            self._sock, hdr + head,
                            *leaf_buffers(body,
                                          self._shard_templates[k]))
                    if local_shards is not None:
                        transport.send_msg_gather(
                            self._sock,
                            *leaf_buffers(local_shards[k],
                                          self._shard_templates[k]))
                    if hdr:
                        telemetry.flow_start(
                            "wire", sp.span_id, op="shard_commit",
                            shard=k, seq=seq)
                    reply = transport.recv_msg_into(self._sock)
                self._clocks[k] = int.from_bytes(reply[:8], "big")
                self._have[k] = unpack_leaves(
                    self._shard_templates[k], reply[8:])
        return self._assemble()

    def done(self):
        transport.send_msg(self._sock, b"d")

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass
