"""Crash flight recorder — a bounded on-disk ring of structured events
that survives the process that wrote it; the port's copy of
``distkeras_tpu/flight_recorder.py``.

The in-memory trace ring (``telemetry.Tracer``) dies with its process:
after a ``PSServer.kill()`` or an engine poison, the events that
explain the crash are exactly the ones that are gone.  This module is
the durable sibling: rare, structured, operationally-significant
events (commits, retries, chaos injections, snapshots, sheds, deadline
expiries, kills, restarts, SLO state flips, the serving gateway's
``replica_down`` / ``failover`` / ``weight_swap`` / ``rollback``
rollout story, and the replicated PS's ``ps_promote`` /
``ps_fenced`` / ``ps_replica_lag`` failover story) are appended as
JSON lines
to a small ring of on-disk segments, so a postmortem can reconstruct
the last N seconds before a crash from the filesystem alone and
cross-check it against the restarted server's state.

Design constraints, in order:

* **Always cheap.**  One ``json.dumps`` + buffered write + ``flush()``
  per event, under one lock.  Events are RARE (per commit / retry /
  shed, never per token or per batch), so the disabled check is the
  only cost on hot paths that gate on ``record()`` — a module-global
  ``None`` test.
* **Bounded.**  Segments rotate after ``segment_events`` lines; at most
  ``segments`` sealed segments are kept (oldest deleted first), so a
  week-long run cannot fill a disk.
* **Atomic rotation.**  The live segment is written as
  ``segment-N.jsonl.open`` and sealed by ``os.replace`` to
  ``segment-N.jsonl`` — a reader never sees a half-renamed file, and a
  crashed writer leaves at most one ``.open`` file (which readers still
  parse, line by line, tolerating a torn final line).
* **Flush on every exit path.**  ``atexit`` closes the active recorder;
  ``PSServer.kill()`` calls ``flush(fsync=True)`` explicitly before the
  listener dies, so the kill-path events are durable even against a
  following hard crash.

Every event carries ``kind`` plus three stamps: ``wall_s``
(``time.time()`` — the cross-process ordering key), ``mono_s``
(``telemetry.now()`` — same clock as the trace spans, so flight events
line up against a merged trace), and ``pid``.

Usage::

    from distkeras_tpu_torch import flight_recorder
    flight_recorder.start("/tmp/fdr")        # enable (off by default)
    ... run trainers / engine / chaos ...
    flight_recorder.record("my_event", detail=1)   # no-op when off
    events = flight_recorder.active().read_events()
    flight_recorder.stop()
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Any

from distkeras_tpu_torch import telemetry
from distkeras_tpu_torch.analysis import racecheck


class FlightRecorder:
    """Bounded JSONL segment ring in ``directory``.

    ``record(kind, **fields)`` appends one event; segments seal by
    atomic rename after ``segment_events`` events and at most
    ``segments`` sealed segments are retained.  ``read_events()``
    replays the surviving window in write order.
    """

    def __init__(self, directory: str | os.PathLike,
                 segment_events: int = 256, segments: int = 8):
        if segment_events < 1 or segments < 1:
            raise ValueError(
                f"segment_events and segments must be >= 1; got "
                f"{segment_events}, {segments}")
        self.directory = os.fspath(directory)
        self.segment_events = int(segment_events)
        self.segments = int(segments)
        os.makedirs(self.directory, exist_ok=True)
        self._lock = racecheck.lock("flight_recorder")
        self._seq = 0  # per-recorder monotone event index
        self._file = None
        self._file_events = 0
        # resume numbering past whatever a previous incarnation left
        self._segment_n = 1 + max(
            [n for n, _ in self._list_segments()], default=-1)

    # -- writing ------------------------------------------------------

    def _open_path(self, n: int) -> str:
        return os.path.join(self.directory, f"segment-{n:06d}.jsonl.open")

    def _sealed_path(self, n: int) -> str:
        return os.path.join(self.directory, f"segment-{n:06d}.jsonl")

    def record(self, kind: str, **fields: Any) -> dict:
        """Append one event (thread-safe); returns the event dict."""
        event = {"kind": kind, "wall_s": time.time(),
                 "mono_s": telemetry.now(), "pid": os.getpid(),
                 **fields}
        with self._lock:
            # the recorder's own index (NOT ``seq`` — that name
            # belongs to callers, e.g. commit events) is assigned
            # under the lock so readers can re-establish write order
            # even across a wall-clock step
            event["rec_seq"] = self._seq
            self._seq += 1
            if self._file is None:
                self._file = open(self._open_path(self._segment_n), "w")
                self._file_events = 0
            self._file.write(json.dumps(event, default=repr) + "\n")
            self._file.flush()
            self._file_events += 1
            if self._file_events >= self.segment_events:
                self._seal_locked()
        return event

    def _seal_locked(self) -> None:
        if self._file is None:
            return
        self._file.close()
        os.replace(self._open_path(self._segment_n),
                   self._sealed_path(self._segment_n))
        self._file = None
        self._segment_n += 1
        # retention: drop oldest sealed segments beyond the ring bound
        sealed = sorted(n for n, p in self._list_segments()
                        if p.endswith(".jsonl"))
        for n in sealed[:max(0, len(sealed) - self.segments)]:
            try:
                os.remove(self._sealed_path(n))
            except OSError:
                pass

    def flush(self, fsync: bool = False) -> None:
        """Push buffered events to the OS; ``fsync=True`` makes them
        durable against a machine-level crash (the kill path uses
        this)."""
        with self._lock:
            if self._file is not None:
                self._file.flush()
                if fsync:
                    os.fsync(self._file.fileno())

    def close(self) -> None:
        """Seal the live segment (idempotent)."""
        with self._lock:
            self._seal_locked()

    # -- reading ------------------------------------------------------

    def _list_segments(self) -> list[tuple[int, str]]:
        out = []
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return out
        for fn in names:
            if fn.startswith("segment-") and ".jsonl" in fn:
                try:
                    n = int(fn.split("-")[1].split(".")[0])
                except ValueError:
                    continue
                out.append((n, os.path.join(self.directory, fn)))
        return sorted(out)

    def read_events(self) -> list[dict]:
        """Every surviving event, in write order.  Tolerates a torn
        final line in a crashed writer's ``.open`` segment."""
        with self._lock:
            if self._file is not None:
                self._file.flush()
        events = []
        for _, path in self._list_segments():
            try:
                with open(path) as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            events.append(json.loads(line))
                        except json.JSONDecodeError:
                            pass  # torn tail of a crashed segment
            except FileNotFoundError:
                pass  # rotated away between list and open
        events.sort(key=lambda e: (e.get("wall_s", 0.0),
                                   e.get("pid", 0),
                                   e.get("rec_seq", 0)))
        return events

    def last(self, seconds: float,
             until_wall_s: float | None = None) -> list[dict]:
        """The events of the ``seconds``-wide window ending at
        ``until_wall_s`` (default: the newest recorded event) — the
        postmortem's "last N seconds before the crash"."""
        events = self.read_events()
        if not events:
            return []
        end = (max(e.get("wall_s", 0.0) for e in events)
               if until_wall_s is None else float(until_wall_s))
        return [e for e in events
                if end - float(seconds) <= e.get("wall_s", 0.0) <= end]


# -- the module-global recorder (off by default) -----------------------

_active: FlightRecorder | None = None
_lock = threading.Lock()
_atexit_registered = False


def start(directory: str | os.PathLike, segment_events: int = 256,
          segments: int = 8) -> FlightRecorder:
    """Install (and return) the global recorder.  Replacing an active
    recorder seals its live segment first."""
    global _active, _atexit_registered
    fr = FlightRecorder(directory, segment_events=segment_events,
                        segments=segments)
    with _lock:
        old, _active = _active, fr
        if not _atexit_registered:
            atexit.register(stop)
            _atexit_registered = True
    if old is not None:
        old.close()
    return fr


def stop() -> None:
    """Seal and deactivate the global recorder (idempotent)."""
    global _active
    with _lock:
        old, _active = _active, None
    if old is not None:
        old.close()


def active() -> FlightRecorder | None:
    return _active


def record(kind: str, **fields: Any) -> None:
    """Record onto the global recorder; a no-op (one None test) when
    no recorder is active — safe on every hot-ish path."""
    fr = _active
    if fr is not None:
        fr.record(kind, **fields)


def flush(fsync: bool = False) -> None:
    fr = _active
    if fr is not None:
        fr.flush(fsync=fsync)
