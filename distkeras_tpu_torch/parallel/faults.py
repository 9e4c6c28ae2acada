"""Chaos transport — deterministic, seed-scheduled socket fault
injection for the host-PS wire path; the port's copy of
``distkeras_tpu/parallel/faults.py``.  It patches the PORT's transport
functions, and its decisions come from numpy generators seeded as the
JAX package seeds them, so one seed gives one schedule in both.

The repo already had an in-process chaos hook (``fault_injector`` on
the host-arm trainers), but it raises from INSIDE the worker loop — it
never exercises the real transport failure modes the retry machinery
exists for: a peer resetting mid-exchange, a frame truncated between
header and body, a stalled link, a partition during reconnect.
``ChaosTransport`` wraps the module-level ``transport.connect`` /
``send_msg`` / ``recv_msg`` functions (the single choke point every
socket byte in the repo crosses: ``PSServer`` handlers, ``PSClient``,
``stop_server``) and injects those faults on a schedule drawn from a
pinned seed, so a chaos run is reproducible: the k-th transport
operation always draws the same fault decision.

Fault classes (SURVEY.md §5's failure-model rows, now executable):

* ``reset``    — the socket is closed and ``ConnectionResetError``
  raised before the operation touches the wire (peer died between
  exchanges);
* ``truncate`` — ``send_msg`` writes a strict prefix of the frame and
  closes the socket (peer died MID-frame; the receiver sees a framing
  error, the sender an I/O error — the lost-ack shape that commit-seq
  dedupe exists for);
* ``delay``    — the operation is stalled ``delay_s`` seconds first
  (congestion / GC pause; trips watchdogs, not retries);
* ``partition``— a one-shot window starting at a scheduled operation
  index during which every ``connect`` is refused (the reconnect path
  itself must survive, consuming backoff rather than retry budget).

Ops are counted globally under a lock, so the *schedule* of injected
faults is a pure function of the seed even though racing worker
threads interleave nondeterministically — the chaos sweep asserts
completion-within-budget, and ``counts`` reports exactly what fired.

Usage::

    with ChaosTransport(seed=7, reset_rate=0.05, truncate_rate=0.02,
                        delay_rate=0.1, max_injections=6):
        trainer.train(data)          # transport='socket'

Injections are visible as ``chaos_injected_total{kind}`` counters on
the telemetry registry and in ``.counts``.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from distkeras_tpu_torch import flight_recorder, telemetry
from distkeras_tpu_torch.analysis import racecheck
from distkeras_tpu_torch.parallel import transport

KINDS = ("reset", "truncate", "delay", "partition")

# serializes install/uninstall across instances and threads: the
# module-binding swap must be atomic with the "are the current
# bindings mine?" check in ``uninstall``
_install_lock = threading.Lock()


class ChaosTransport:
    """Installable fault injector over ``parallel.transport``.

    Args:
      seed: pins the whole fault schedule (same seed → same decisions
        at the same operation indices).
      reset_rate / truncate_rate / delay_rate: per-operation injection
        probabilities (truncation only applies to sends; the draw is
        made — and the schedule stays aligned — on every op).
      delay_s: stall length for ``delay`` faults.
      partition_at: global op index at which a ONE-SHOT partition
        begins (``None``: never); for the next ``partition_ops``
        operations every ``connect`` raises ``ConnectionRefusedError``.
      partition_ops: width of the partition window, in operations.
      partition_every: make the partition RECURRING: after
        ``partition_at``, a fresh ``partition_ops``-wide window opens
        every ``partition_every`` operations (``None``: the original
        one-shot).  The window function is arithmetic on the op index —
        no extra rng draws — so the schedule stays a pure function of
        (seed, op index) and a failover drill can flap the link
        repeatedly on an exact, reproducible cadence.
      partition_ports: restrict the PARTITION to connects whose peer
        port is in this set, independently of ``target_ports``
        (``None``: the partition hits every targeted connect).  This is
        the asymmetric-partition knob the failover drill needs: with
        ``partition_ports={primary_worker_port}`` the worker→primary
        hop is cut while the primary↔standby replication link (other
        ports) stays up, so the standby observes a live primary and
        correctly refuses to usurp.
      max_injections: hard cap on injected reset+truncate faults (so a
        seeded run provably fits a retry budget; delays and the
        partition window do not consume it — they cost time, not
        retries).
      skip_ops: operations at the very start of the run that are never
        faulted (lets the handshake/first pull establish a baseline).
      target_ports: restrict injection to operations whose PEER port is
        in this set (``None``: every operation is injectable — the
        original behavior).  The rng is still consumed on EVERY op, so
        the schedule stays a pure function of (seed, op index); only
        the *firing* is filtered.  This is how a process hosting both a
        PS and gateway replicas attacks ONE hop: e.g.
        ``target_ports={replica_port}`` chaoses the gateway→replica
        wire while the training exchange stays clean.
      windows: WALL-CLOCK fault phases beside the op-counter schedule:
        ``[(t_start, t_end, kinds)]`` with times in seconds on the
        injector's clock and ``kinds`` a subset of ``KINDS``.  While
        ``t_start <= t < t_end`` every transport op additionally draws
        a window fault: ``"partition"`` in ``kinds`` refuses every
        ``connect`` in the window deterministically (no rng); the other
        kinds fire with total probability ``window_rate`` per op, split
        evenly among the window's drawable kinds.  Window draws come
        from a SEPARATE rng stream seeded ``[seed, 7]``, so the base
        op-counter schedule is bit-identical with or without windows —
        the schedule stays a pure function of (seed, op index, clock
        readings).  Window ``reset``/``truncate`` fires share the
        ``max_injections`` budget.  This is the phase-aligned knob the
        traffic simulator uses: a ``ChaosSchedule`` hands in a sim-time
        clock so "faults during the flash crowd" is literally a window
        over the load curve.
      window_rate: per-op probability that an active window injects one
        of its non-partition kinds (default 0.25).
      clock: zero-arg callable returning seconds for window matching
        (``None``: wall seconds since ``install()``).  Inject a
        deterministic counter to make window decisions — not just the
        base schedule — a pure function of the constructor arguments.
    """

    def __init__(self, seed: int = 0, *, reset_rate: float = 0.0,
                 truncate_rate: float = 0.0, delay_rate: float = 0.0,
                 delay_s: float = 0.02,
                 partition_at: Optional[int] = None,
                 partition_ops: int = 4,
                 partition_every: Optional[int] = None,
                 partition_ports: Optional[set] = None,
                 max_injections: Optional[int] = None,
                 skip_ops: int = 0,
                 target_ports: Optional[set] = None,
                 windows=(),
                 window_rate: float = 0.25,
                 clock=None):
        for name, rate in (("reset_rate", reset_rate),
                           ("truncate_rate", truncate_rate),
                           ("delay_rate", delay_rate),
                           ("window_rate", window_rate)):
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"{name}={rate} outside [0, 1]")
        self.windows = _validate_windows(windows)
        self.window_rate = float(window_rate)
        self._clock = clock
        self._t0 = None  # wall anchor when no clock is injected
        self._rng = np.random.default_rng(seed)
        # window decisions draw from their own stream so adding (or
        # widening) windows never perturbs the base op-counter schedule
        self._wrng = np.random.default_rng([seed, 7])
        self._rates = {"reset": float(reset_rate),
                       "truncate": float(truncate_rate),
                       "delay": float(delay_rate)}
        self.delay_s = float(delay_s)
        self.partition_at = partition_at
        self.partition_ops = int(partition_ops)
        if partition_every is not None and (
                int(partition_every) <= int(partition_ops)):
            raise ValueError(
                f"partition_every={partition_every} must exceed "
                f"partition_ops={partition_ops} (the link must heal "
                f"between windows)")
        self.partition_every = (None if partition_every is None
                                else int(partition_every))
        self.partition_ports = (None if partition_ports is None
                                else {int(p) for p in partition_ports})
        self.max_injections = max_injections
        self.skip_ops = int(skip_ops)
        self.target_ports = (None if target_ports is None
                             else {int(p) for p in target_ports})
        self._lock = racecheck.lock("chaos")
        self._op = 0  # guarded-by: _lock
        self._injected = 0  # guarded-by: _lock
        self.counts: dict[str, int] = {k: 0 for k in KINDS}
        self._orig = None  # guarded-by: _install_lock
        self._installed = False  # guarded-by: _install_lock

    # -- schedule ----------------------------------------------------------

    def _note(self, kind: str, window: bool = False) -> None:
        self.counts[kind] += 1
        telemetry.metrics().counter("chaos_injected_total",
                                    kind=kind).inc()
        if window:
            telemetry.metrics().counter("chaos_window_injected_total",
                                        kind=kind).inc()
        # called under self._lock, so op index matches the draw that
        # scheduled this injection
        flight_recorder.record("chaos", fault=kind, op=self._op,
                               window=window)

    def _draw(self, op_kind: str, port: Optional[int] = None):
        """One scheduled decision; returns the fault to inject (or
        None).  Called under the lock so op indices — and therefore the
        rng stream — are globally ordered.  ``port`` is the operation's
        peer port (None when unknowable, e.g. an already-dead socket):
        with ``target_ports`` set, a non-targeted op still consumes its
        rng draw but never fires.  The base op-counter decision is made
        first; only when it declines does an active wall-clock window
        get its (separately-streamed) draw."""
        with self._lock:
            op = self._op
            self._op += 1
            # the rng is consumed on EVERY op, injectable or not, so
            # the schedule is a pure function of (seed, op index)
            u = float(self._rng.random())
            fault = self._base_decision(op, u, op_kind, port)
            if fault is not None or not self.windows:
                return fault
            return self._window_decision(op_kind, port)

    def _base_decision(self, op: int, u: float, op_kind: str,
                       port: Optional[int]):
        # guarded-by: _lock (via _draw)
        if op < self.skip_ops:
            return None
        targeted = (self.target_ports is None
                    or (port is not None
                        and port in self.target_ports))
        part_targeted = (targeted
                         and (self.partition_ports is None
                              or (port is not None
                                  and port
                                  in self.partition_ports)))
        if (part_targeted and op_kind == "connect"
                and self._in_partition_window(op)):
            self._note("partition")
            return "partition"
        budget_left = (self.max_injections is None
                       or self._injected < self.max_injections)
        edge = 0.0
        for kind in ("reset", "truncate", "delay"):
            edge += self._rates[kind]
            if u < edge:
                if kind == "truncate" and op_kind != "send":
                    return None  # only sends can truncate
                if not targeted:
                    return None  # drawn, but this hop is off-limits
                if kind in ("reset", "truncate"):
                    if not budget_left:
                        return None
                    # lint: allow(guarded-write) — under _lock via _draw
                    self._injected += 1
                self._note(kind)
                return kind
        return None

    def _window_decision(self, op_kind: str, port: Optional[int]):
        """The wall-clock side of the schedule.  Consumes the WINDOW
        rng stream only for ops that fall inside an active window, so
        the base stream stays untouched.  Guarded-by: _lock."""
        kinds = self._active_window_kinds()
        if kinds is None:
            return None
        targeted = (self.target_ports is None
                    or (port is not None
                        and port in self.target_ports))
        if "partition" in kinds and op_kind == "connect":
            # deterministic: the whole window is a refused link
            if not targeted:
                return None
            self._note("partition", window=True)
            return "partition"
        drawable = [k for k in ("reset", "truncate", "delay")
                    if k in kinds]
        if not drawable:
            return None
        w = float(self._wrng.random())
        if w >= self.window_rate:
            return None
        kind = drawable[min(int(w * len(drawable) / self.window_rate),
                            len(drawable) - 1)]
        if kind == "truncate" and op_kind != "send":
            return None  # only sends can truncate
        if not targeted:
            return None
        if kind in ("reset", "truncate"):
            # window fires share the retry budget with the base
            # schedule — a seeded drill still provably fits it
            if (self.max_injections is not None
                    and self._injected >= self.max_injections):
                return None
            # lint: allow(guarded-write) — under _lock via _draw
            self._injected += 1
        self._note(kind, window=True)
        return kind

    def _active_window_kinds(self):
        """Kinds of the first window covering the current clock
        reading, or None outside every window.  Guarded-by: _lock."""
        if self._clock is not None:
            t = float(self._clock())
        else:
            if self._t0 is None:
                self._t0 = telemetry.now()
            t = telemetry.now() - self._t0
        for t_start, t_end, kinds in self.windows:
            if t_start <= t < t_end:
                return kinds
        return None

    def _in_partition_window(self, op: int) -> bool:
        """Pure arithmetic on the op index (NO rng): is ``op`` inside a
        partition window?  One-shot by default; with
        ``partition_every`` a fresh window opens on that cadence."""
        if self.partition_at is None or op < self.partition_at:
            return False
        offset = op - self.partition_at
        if self.partition_every is None:
            return offset < self.partition_ops
        return offset % self.partition_every < self.partition_ops

    # -- wrapped operations ------------------------------------------------

    def _connect(self, host, port, timeout=None):
        fault = self._draw("connect", port=int(port))
        if fault == "partition":
            raise ConnectionRefusedError(
                "chaos: partitioned (scheduled one-shot window)")
        if fault == "delay":
            telemetry.instant("chaos_delay", op="connect")
            _sleep(self.delay_s)
        if fault == "reset":
            raise ConnectionResetError("chaos: connect reset")
        return self._orig[0](host, port, timeout=timeout)

    def _send_msg(self, sock, *parts):
        fault = self._draw("send", port=_peer_port(sock))
        if fault == "delay":
            telemetry.instant("chaos_delay", op="send")
            _sleep(self.delay_s)
        if fault == "reset":
            _hard_close(sock)
            raise ConnectionResetError("chaos: send reset")
        if fault == "truncate":
            data = transport.frame(*parts)
            cut = 1 + int(self._cut_fraction() * (len(data) - 1))
            cut = min(cut, len(data) - 1)  # ALWAYS a strict prefix
            try:
                sock.sendall(data[:cut])
            finally:
                _hard_close(sock)
            raise ConnectionError(
                f"chaos: frame truncated at {cut}/{len(data)} bytes")
        return self._orig[1](sock, *parts)

    def _cut_fraction(self) -> float:
        with self._lock:
            return float(self._rng.random())

    def _recv_msg(self, sock):
        fault = self._draw("recv", port=_peer_port(sock))
        if fault == "delay":
            telemetry.instant("chaos_delay", op="recv")
            _sleep(self.delay_s)
        if fault == "reset":
            _hard_close(sock)
            raise ConnectionResetError("chaos: recv reset")
        return self._orig[2](sock)

    def _send_msg_gather(self, sock, *parts):
        """The zero-copy scatter-gather send (the sharded-PS wire)
        crosses the same choke point: same fault classes, same
        schedule stream.  Truncation materializes the frame (a copy is
        fine on the chaos path) to cut a strict prefix."""
        fault = self._draw("send", port=_peer_port(sock))
        if fault == "delay":
            telemetry.instant("chaos_delay", op="send")
            _sleep(self.delay_s)
        if fault == "reset":
            _hard_close(sock)
            raise ConnectionResetError("chaos: send reset")
        if fault == "truncate":
            data = transport.frame(*parts)
            cut = 1 + int(self._cut_fraction() * (len(data) - 1))
            cut = min(cut, len(data) - 1)
            try:
                sock.sendall(data[:cut])
            finally:
                _hard_close(sock)
            raise ConnectionError(
                f"chaos: frame truncated at {cut}/{len(data)} bytes")
        return self._orig[3](sock, *parts)

    def _recv_msg_into(self, sock):
        fault = self._draw("recv", port=_peer_port(sock))
        if fault == "delay":
            telemetry.instant("chaos_delay", op="recv")
            _sleep(self.delay_s)
        if fault == "reset":
            _hard_close(sock)
            raise ConnectionResetError("chaos: recv reset")
        return self._orig[4](sock)

    # -- install / uninstall ----------------------------------------------

    def install(self) -> "ChaosTransport":
        with _install_lock:
            if self._installed:
                raise RuntimeError("ChaosTransport already installed")
            self._orig = (transport.connect, transport.send_msg,
                          transport.recv_msg,
                          transport.send_msg_gather,
                          transport.recv_msg_into)
            self._installed = True
            if self._clock is None and self._t0 is None:
                self._t0 = telemetry.now()  # window t=0 is install time
            transport.connect = self._connect
            transport.send_msg = self._send_msg
            transport.recv_msg = self._recv_msg
            transport.send_msg_gather = self._send_msg_gather
            transport.recv_msg_into = self._recv_msg_into
        return self

    def uninstall(self) -> None:
        """Restore the transport bindings.  Idempotent — a second (or
        concurrent) ``uninstall`` is a no-op, and an instance whose
        wrappers have already been replaced (another injector stacked
        on top, or a test monkeypatch) restores NOTHING rather than
        clobbering the newer bindings with its stale snapshot."""
        with _install_lock:
            if not self._installed:
                return
            self._installed = False
            mine = (self._connect, self._send_msg, self._recv_msg,
                    self._send_msg_gather, self._recv_msg_into)
            current = (transport.connect, transport.send_msg,
                       transport.recv_msg, transport.send_msg_gather,
                       transport.recv_msg_into)
            if current == mine:
                (transport.connect, transport.send_msg,
                 transport.recv_msg, transport.send_msg_gather,
                 transport.recv_msg_into) = self._orig
            # self._orig is deliberately KEPT: a daemon PS handler
            # thread may still be inside a wrapper (blocked on recv)
            # when the module bindings are restored — it must find the
            # originals, not a None

    def __enter__(self) -> "ChaosTransport":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    @property
    def total_injected(self) -> int:
        return sum(self.counts.values())


def _validate_windows(windows) -> tuple:
    """Normalize ``[(t_start, t_end, kinds)]`` to a tuple of
    ``(float, float, frozenset)`` triples, validating eagerly so a bad
    drill script fails at construction, not mid-run."""
    out = []
    for w in windows:
        try:
            t_start, t_end, kinds = w
        except (TypeError, ValueError):
            raise ValueError(
                f"window {w!r} is not (t_start, t_end, kinds)")
        t_start, t_end = float(t_start), float(t_end)
        if not (0.0 <= t_start < t_end):
            raise ValueError(
                f"window times ({t_start}, {t_end}) need "
                f"0 <= t_start < t_end")
        if isinstance(kinds, str):
            kinds = (kinds,)
        kinds = frozenset(kinds)
        if not kinds or not kinds <= set(KINDS):
            raise ValueError(
                f"window kinds {sorted(kinds)} must be a nonempty "
                f"subset of {KINDS}")
        out.append((t_start, t_end, kinds))
    return tuple(out)


def _peer_port(sock) -> Optional[int]:
    """Peer port of a connected socket (None when the socket is
    already dead — with ``target_ports`` set such an op never fires,
    the safe default for an unattributable operation)."""
    try:
        return int(sock.getpeername()[1])
    except (OSError, IndexError, TypeError):
        return None


def _hard_close(sock) -> None:
    try:
        sock.close()
    except OSError:
        pass


def _sleep(seconds: float) -> None:
    if seconds > 0:
        import time

        time.sleep(seconds)
