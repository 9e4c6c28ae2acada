"""Telemetry of the port, from ``distkeras_tpu/telemetry.py``: one
metrics registry and one trace timeline for the trainers and the host
parameter server.

* ``now()`` — the host-side monotonic clock every host timestamp reads
  (PS heartbeats, span boundaries, stall timers).
* ``MetricsRegistry`` — thread-safe counters, gauges, fixed-bucket
  histograms and append-only series (the backing of a trainer's
  ``history``, read through ``HistoryView``); ``snapshot()``,
  ``write_jsonl()``, ``prometheus_text()``, and ``health()``: the SLO verdict over the
  registry's signals at the JAX package's default thresholds (the
  host trainers record it as ``slo_health``).
* ``Tracer`` — ``with span("commit", worker=i):`` records thread-aware
  complete events into a bounded ring; ``write_chrome_trace`` dumps
  Chrome trace-event JSON (Perfetto); ``merge_traces`` stitches dumps
  of several processes into one timeline; ``current_trace()`` is the
  context the PS wire's trace header carries.

Disabled by default: the module-level singleton is a no-op whose metric
handles and spans are shared inert objects, until ``enable()``.  A
trainer's ``history`` uses its own always-on registry.

Not ported here: ``SLOWatchdog``'s background thread and hysteresis,
the ``Autoscaler`` and the ``/metrics`` HTTP thread (they serve the
serving stack, ROADMAP.md §1 item 6), and ``load_device_trace`` (XLA's
device profile, item 8).
"""

from __future__ import annotations

import collections
import collections.abc
import json
import math
import os
import threading
import time
from typing import Any, Iterator, Mapping

#: THE host-side monotonic clock (satellite: serving ``t_submit`` /
#: ``t_first`` / ``t_finish``, host-PS ``_last_seen``, and every span
#: boundary read this one source).  ``perf_counter`` is monotonic with
#: the highest available resolution; its origin is arbitrary, so values
#: are only meaningful as differences — never persist them as wall
#: times.
now = time.perf_counter

#: Default histogram bucket upper bounds, in seconds — latency-shaped
#: (1 ms .. 60 s).  Counts accumulate cumulatively per Prometheus
#: convention; values above the last edge land in +Inf only.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

#: Staleness-shaped buckets (commit depths, not seconds).
STALENESS_BUCKETS = (0, 1, 2, 4, 8, 16, 32, 64, 128)


def _escape_label_value(v: Any) -> str:
    """Prometheus exposition escaping for label VALUES: backslash,
    double-quote, and newline must be escaped or the emitted line is
    invalid exposition text (a label value containing ``"`` would
    terminate the value early; a newline would split the sample)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _label_key(name: str, labels: Mapping[str, Any]) -> str:
    """Prometheus-style series key: ``name{a="1",b="x"}`` (labels
    sorted, values escaped per the exposition format)."""
    if not labels:
        return name
    inner = ",".join(f'{k}="{_escape_label_value(labels[k])}"'
                     for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonically increasing count (thread-safe)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-set value (thread-safe); ``inc``/``dec`` for level-style
    gauges (queue depth, slot occupancy)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram (thread-safe): cumulative bucket counts
    per Prometheus convention, plus count/sum/min/max for snapshot
    consumers that want quick percentile estimates."""

    __slots__ = ("buckets", "_lock", "_counts", "_count", "_sum",
                 "_min", "_max")

    def __init__(self, buckets=DEFAULT_BUCKETS):
        edges = tuple(float(b) for b in buckets)
        if not edges or any(nxt <= prev
                            for nxt, prev in zip(edges[1:], edges)):
            raise ValueError(
                f"histogram buckets must be strictly increasing and "
                f"non-empty; got {buckets!r}")
        self.buckets = edges
        self._lock = threading.Lock()
        self._counts = [0] * (len(edges) + 1)  # +1: the +Inf bucket
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        i = 0
        for edge in self.buckets:
            if v <= edge:
                break
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
            lo, hi = self._min, self._max
        cum, cumulative = 0, {}
        for edge, n in zip(self.buckets, counts):
            cum += n
            cumulative[edge] = cum
        return {"count": total, "sum": s,
                "min": None if total == 0 else lo,
                "max": None if total == 0 else hi,
                "buckets": cumulative}

    def percentile(self, q: float) -> float | None:
        """Bucket-resolution estimate of the q-th percentile (q in
        [0, 1]): the upper edge of the first bucket whose cumulative
        count covers q — an over-estimate by at most one bucket width,
        the standard fixed-bucket tradeoff.  None when empty."""
        snap = self.snapshot()
        if snap["count"] == 0:
            return None
        need = q * snap["count"]
        for edge, cum in snap["buckets"].items():
            if cum >= need:
                return edge
        return snap["max"]


class Series:
    """Thread-safe append-only value log — the backing store for
    trainer ``history`` keys (per-round losses, staleness lists,
    failure records): things that are a sequence of observations, not a
    counter or a distribution."""

    __slots__ = ("_lock", "_values")

    def __init__(self):
        self._lock = threading.Lock()
        self._values: list = []

    def append(self, v) -> None:
        with self._lock:
            self._values.append(v)

    def extend(self, vs) -> None:
        with self._lock:
            self._values.extend(vs)

    def replace(self, vs) -> None:
        with self._lock:
            self._values = list(vs)

    def values(self) -> list:
        with self._lock:
            return list(self._values)

    def __len__(self) -> int:
        with self._lock:
            return len(self._values)


class _NoopMetric:
    """Shared inert metric handle: every mutator is a no-op, every read
    is empty/zero.  One instance serves every disabled call site."""

    __slots__ = ()

    def inc(self, n: float = 1.0) -> None:
        pass

    def dec(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def append(self, v) -> None:
        pass

    def extend(self, vs) -> None:
        pass

    value = 0.0
    count = 0

    def values(self) -> list:
        return []

    def snapshot(self) -> dict:
        return {}


_NOOP_METRIC = _NoopMetric()


class MetricsRegistry:
    """Thread-safe name+labels -> metric store.

    ``counter``/``gauge``/``histogram``/``series`` are get-or-create:
    the first call materializes the metric, later calls (any thread)
    return the same object, so hot paths may either cache the handle or
    re-look it up.  Export three ways: ``snapshot()`` (one nested
    dict), ``write_jsonl(path)`` (one JSON object per metric, greppable
    logs), ``prometheus_text()`` (text exposition).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, tuple[str, str, dict, Any]] = {}

    # -- get-or-create ------------------------------------------------

    def _get(self, kind: str, name: str, labels: dict, make):
        key = _label_key(name, labels)
        with self._lock:
            got = self._metrics.get(key)
            if got is None:
                got = (kind, name, {k: str(v)
                                    for k, v in labels.items()}, make())
                self._metrics[key] = got
            elif got[0] != kind:
                raise ValueError(
                    f"metric {key!r} already registered as {got[0]}, "
                    f"not {kind}")
            return got[3]

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels, Gauge)

    def histogram(self, name: str, buckets=None, **labels) -> Histogram:
        make = (Histogram if buckets is None
                else lambda: Histogram(buckets))
        return self._get("histogram", name, labels, make)

    def series(self, name: str, **labels) -> Series:
        return self._get("series", name, labels, Series)

    # -- queries ------------------------------------------------------

    def collect(self, name: str, **label_filter
                ) -> list[tuple[dict, Any]]:
        """All (labels, metric) pairs for ``name`` whose labels are a
        superset of ``label_filter`` — e.g. every per-padded-length
        prefill compile counter of one bucket."""
        want = {k: str(v) for k, v in label_filter.items()}
        with self._lock:
            items = list(self._metrics.values())
        return [(labels, m) for kind, n, labels, m in items
                if n == name and all(labels.get(k) == v
                                     for k, v in want.items())]

    def sum_counter(self, name: str, **label_filter) -> float:
        return sum(m.value
                   for _, m in self.collect(name, **label_filter))

    def snapshot(self) -> dict:
        """``{"counters": {key: value}, "gauges": {key: value},
        "histograms": {key: {...}}, "series": {key: [...]}}`` — keys
        are Prometheus-style ``name{label="v"}`` strings."""
        with self._lock:
            items = list(self._metrics.items())
        out: dict = {"counters": {}, "gauges": {}, "histograms": {},
                     "series": {}}
        for key, (kind, _, _, m) in items:
            if kind == "counter":
                out["counters"][key] = m.value
            elif kind == "gauge":
                out["gauges"][key] = m.value
            elif kind == "histogram":
                out["histograms"][key] = m.snapshot()
            else:
                out["series"][key] = m.values()
        return out

    def write_jsonl(self, path: str | os.PathLike) -> str:
        """One JSON object per metric: ``{"kind", "name", "labels",
        ...kind-specific payload}``.  Series values must be
        JSON-encodable (trainer history already is — it rides the
        msgpack checkpoint cursor as JSON)."""
        with self._lock:
            items = list(self._metrics.items())
        lines = []
        for key, (kind, name, labels, m) in items:
            rec = {"kind": kind, "name": name, "labels": labels,
                   "key": key}
            if kind == "histogram":
                snap = m.snapshot()
                snap["buckets"] = {str(k): v
                                   for k, v in snap["buckets"].items()}
                rec.update(snap)
            elif kind == "series":
                rec["values"] = m.values()
            else:
                rec["value"] = m.value
            lines.append(json.dumps(rec))
        p = os.fspath(path)
        with open(p, "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
        return p

    def prometheus_text(self) -> str:
        """Prometheus text exposition (format 0.0.4): counters and
        gauges verbatim; histograms as cumulative ``_bucket{le=}`` +
        ``_sum``/``_count``; series as an untyped last-value sample
        plus a ``_total`` observation count (full series history is a
        log concern — ``write_jsonl`` — not a scrape concern)."""
        with self._lock:
            items = list(self._metrics.items())
        by_name: dict[str, list] = {}
        kinds: dict[str, str] = {}
        for key, (kind, name, labels, m) in items:
            by_name.setdefault(name, []).append((labels, m))
            kinds[name] = kind
        out: list[str] = []
        for name in sorted(by_name):
            kind = kinds[name]
            ptype = {"counter": "counter", "gauge": "gauge",
                     "histogram": "histogram",
                     "series": "untyped"}[kind]
            out.append(f"# TYPE {name} {ptype}")
            for labels, m in by_name[name]:
                if kind in ("counter", "gauge"):
                    out.append(f"{_label_key(name, labels)} {m.value}")
                elif kind == "histogram":
                    snap = m.snapshot()
                    for edge, cum in snap["buckets"].items():
                        out.append(_label_key(
                            name + "_bucket",
                            {**labels, "le": edge}) + f" {cum}")
                    out.append(_label_key(
                        name + "_bucket", {**labels, "le": "+Inf"})
                        + f" {snap['count']}")
                    out.append(f"{_label_key(name + '_sum', labels)} "
                               f"{snap['sum']}")
                    out.append(f"{_label_key(name + '_count', labels)} "
                               f"{snap['count']}")
                else:
                    vals = m.values()
                    last = vals[-1] if vals else float("nan")
                    if not isinstance(last, (int, float, bool)):
                        last = float("nan")  # structured series entry
                    out.append(f"{_label_key(name, labels)} "
                               f"{float(last)}")
                    out.append(
                        f"{_label_key(name + '_observations', labels)}"
                        f" {len(vals)}")
        return "\n".join(out) + "\n"

    # -- health -------------------------------------------------------

    def health(self) -> dict:
        """The current SLO health verdict over this registry
        (``health_verdict``)."""
        return health_verdict(self)


class NullRegistry:
    """Disabled-path registry: every lookup returns the shared inert
    metric, every export is empty.  Keeps instrumented call sites
    branch-free."""

    def counter(self, name: str, **labels) -> _NoopMetric:
        return _NOOP_METRIC

    def gauge(self, name: str, **labels) -> _NoopMetric:
        return _NOOP_METRIC

    def histogram(self, name: str, buckets=None,
                  **labels) -> _NoopMetric:
        return _NOOP_METRIC

    def series(self, name: str, **labels) -> _NoopMetric:
        return _NOOP_METRIC

    def collect(self, name: str, **label_filter) -> list:
        return []

    def sum_counter(self, name: str, **label_filter) -> float:
        return 0.0

    def snapshot(self) -> dict:
        return {"counters": {}, "gauges": {}, "histograms": {},
                "series": {}}

    def prometheus_text(self) -> str:
        return ""

    def health(self) -> dict:
        # no signals → every threshold is "absent" → "ok"
        return health_verdict(self)


# -- trace context (cross-process propagation) -------------------------
#
# Every live ``_Span`` gets a PROCESS-UNIQUE 64-bit span id (the pid in
# the high bits disambiguates ids minted by different processes, so a
# merged multi-process trace never aliases two spans) and pushes
# ``(trace_id, span_id)`` onto a thread-local stack.  A root span's id
# doubles as the trace id; nested spans inherit the trace id, so a
# retry storm inside one ``ps_op`` span shares one trace.  Wire clients
# read ``current_trace()`` to stamp the 17-byte header the PS server
# links back to (see ``parallel.transport.trace_header``).

_span_id_lock = threading.Lock()
_span_id_next = [1]
_trace_ctx = threading.local()


def _new_span_id() -> int:
    with _span_id_lock:
        n = _span_id_next[0]
        _span_id_next[0] += 1
    # 24 pid bits | 40 counter bits: unique within a process for 2^40
    # spans, and across processes for merged traces
    return ((os.getpid() & 0xFFFFFF) << 40) | (n & 0xFFFFFFFFFF)


def current_trace() -> tuple[int, int] | None:
    """``(trace_id, span_id)`` of this thread's innermost live span —
    ``None`` when no span is open (always the case while telemetry is
    disabled: only real spans push context)."""
    stack = getattr(_trace_ctx, "stack", None)
    if not stack:
        return None
    return stack[-1]


class _Span:
    """One ``with``-scoped trace span: ts taken at enter, a Chrome
    complete ("X") event appended to the ring at exit.  Exceptions
    inside the span mark ``args["error"]`` and re-raise.  Enter pushes
    ``(trace_id, span_id)`` onto the thread's trace-context stack (for
    wire propagation); exit pops it and stamps both ids into the
    event's args."""

    __slots__ = ("_tracer", "name", "args", "_t0", "trace_id",
                 "span_id")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self):
        stack = getattr(_trace_ctx, "stack", None)
        if stack is None:
            stack = _trace_ctx.stack = []
        sid = _new_span_id()
        self.span_id = sid
        self.trace_id = stack[-1][0] if stack else sid
        stack.append((self.trace_id, sid))
        self._t0 = now()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = now()
        _trace_ctx.stack.pop()
        args = {**self.args, "trace_id": format(self.trace_id, "x"),
                "span_id": format(self.span_id, "x")}
        if exc_type is not None:
            args["error"] = exc_type.__name__
        self._tracer._complete(self.name, self._t0, t1, args)
        return False


class _NoopSpan:
    """Shared reusable disabled span — ``with`` costs two no-op calls.
    Safe to share across threads and nestings: enter/exit carry no
    state."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_SPAN = _NoopSpan()

# Trace-track thread ids: ``threading.get_ident()`` values are REUSED
# once a thread exits, which would merge sequential threads onto one
# Perfetto track under the first thread's name.  Stamp each thread with
# a process-unique id instead (module-global so every Tracer agrees).
_tid_lock = threading.Lock()
_tid_next = [1]


def _thread_trace_id() -> int:
    t = threading.current_thread()
    tid = getattr(t, "_dkt_trace_tid", None)
    if tid is None:
        with _tid_lock:
            tid = getattr(t, "_dkt_trace_tid", None)
            if tid is None:
                tid = _tid_next[0]
                _tid_next[0] += 1
                t._dkt_trace_tid = tid
    return tid


class Tracer:
    """Bounded in-memory ring of Chrome trace events.

    ``span(name, **args)`` records a complete ("X") event per thread;
    ``instant(name, **args)`` a thread-scoped instant ("i") event.
    The ring (``collections.deque(maxlen=capacity)``) keeps the LAST
    ``capacity`` events — a long run keeps its newest window, which is
    the window you are debugging.  ``write_chrome_trace(path)`` dumps
    the Chrome trace-event JSON object format (``{"traceEvents":
    [...]}``) with thread-name metadata, loadable in Perfetto /
    ``chrome://tracing``.
    """

    def __init__(self, capacity: int = 65536):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}")
        self.capacity = capacity
        self._ring: collections.deque = collections.deque(
            maxlen=capacity)
        self._lock = threading.Lock()
        self._thread_names: dict[int, str] = {}
        self._pid = os.getpid()

    # -- recording ----------------------------------------------------

    def _note_thread(self) -> int:
        tid = _thread_trace_id()
        if tid not in self._thread_names:
            with self._lock:
                self._thread_names[tid] = \
                    threading.current_thread().name
        return tid

    def _complete(self, name: str, t0: float, t1: float,
                  args: dict) -> None:
        tid = self._note_thread()
        # deque.append is atomic under the GIL; events land in ring
        # order per thread (append happens at span exit)
        self._ring.append({
            "name": name, "ph": "X", "ts": t0 * 1e6,
            "dur": max(t1 - t0, 0.0) * 1e6,
            "pid": self._pid, "tid": tid, "args": args})

    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args)

    def complete(self, name: str, t0: float, t1: float,
                 **args) -> None:
        """Record a complete event from explicit ``now()`` stamps —
        the minimal-diff alternative to ``with span(...)`` for long
        loop bodies that would otherwise re-indent wholesale."""
        self._complete(name, t0, t1, args)

    def instant(self, name: str, **args) -> None:
        tid = self._note_thread()
        self._ring.append({
            "name": name, "ph": "i", "ts": now() * 1e6, "s": "t",
            "pid": self._pid, "tid": tid, "args": args})

    def flow_start(self, name: str, flow_id: int, **args) -> None:
        """Chrome flow-start ("s"): the tail of a client→server arrow.
        ``flow_id`` must be process-unique (a span id); the matching
        ``flow_end`` on the server side completes the arrow in the
        merged trace."""
        tid = self._note_thread()
        self._ring.append({
            "name": name, "cat": "wire", "ph": "s",
            "id": format(flow_id, "x"), "ts": now() * 1e6,
            "pid": self._pid, "tid": tid, "args": args})

    def flow_end(self, name: str, flow_id: int, **args) -> None:
        """Chrome flow-finish ("f", binding point "e"): the head of the
        arrow, emitted inside the server's handler span."""
        tid = self._note_thread()
        self._ring.append({
            "name": name, "cat": "wire", "ph": "f", "bp": "e",
            "id": format(flow_id, "x"), "ts": now() * 1e6,
            "pid": self._pid, "tid": tid, "args": args})

    # -- export -------------------------------------------------------

    def events(self) -> list[dict]:
        return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)

    def clear(self) -> None:
        self._ring.clear()

    def chrome_trace(self) -> dict:
        """The Chrome trace-event JSON object: ring events plus
        process/thread-name metadata records."""
        with self._lock:
            names = dict(self._thread_names)
        meta = [{"name": "process_name", "ph": "M", "pid": self._pid,
                 "tid": 0, "args": {"name": "distkeras_tpu_torch"}}]
        for tid, tname in sorted(names.items()):
            meta.append({"name": "thread_name", "ph": "M",
                         "pid": self._pid, "tid": tid,
                         "args": {"name": tname}})
        # wall↔mono anchor taken at DUMP time: ``merge_traces`` uses it
        # to shift each process's arbitrary-origin perf_counter
        # timestamps onto one shared timeline
        return {"traceEvents": meta + self.events(),
                "displayTimeUnit": "ms",
                "wallAnchor": {"wall_s": time.time(),
                               "mono_s": now(), "pid": self._pid}}

    def write_chrome_trace(self, path: str | os.PathLike) -> str:
        p = os.fspath(path)
        with open(p, "w") as f:
            json.dump(self.chrome_trace(), f)
        return p


class NullTracer:
    """Disabled-path tracer: spans are the shared no-op span."""

    capacity = 0

    def span(self, name: str, **args) -> _NoopSpan:
        return _NOOP_SPAN

    def complete(self, name: str, t0: float, t1: float,
                 **args) -> None:
        pass

    def instant(self, name: str, **args) -> None:
        pass

    def flow_start(self, name: str, flow_id: int, **args) -> None:
        pass

    def flow_end(self, name: str, flow_id: int, **args) -> None:
        pass

    def events(self) -> list:
        return []

    def __len__(self) -> int:
        return 0

    def clear(self) -> None:
        pass


class Telemetry:
    """One metrics registry + one tracer, the pair ``enable()``
    installs globally."""

    def __init__(self, metrics: MetricsRegistry | None = None,
                 tracer: Tracer | None = None):
        self.metrics = MetricsRegistry() if metrics is None else metrics
        self.tracer = Tracer() if tracer is None else tracer

    enabled = True

    def span(self, name: str, **args):
        return self.tracer.span(name, **args)

    def instant(self, name: str, **args) -> None:
        self.tracer.instant(name, **args)


class _NullTelemetry:
    enabled = False

    def __init__(self):
        self.metrics = NullRegistry()
        self.tracer = NullTracer()

    def span(self, name: str, **args) -> _NoopSpan:
        return _NOOP_SPAN

    def instant(self, name: str, **args) -> None:
        pass


_NULL = _NullTelemetry()
_active: Any = _NULL
_active_lock = threading.Lock()


def get() -> Any:
    """The active ``Telemetry`` (or the shared no-op when disabled).
    Hot paths may cache ``get().metrics`` handles only for the scope of
    one operation — the switch can flip between operations."""
    return _active


def enabled() -> bool:
    return _active.enabled


def metrics() -> Any:
    """The active metrics registry (Null when disabled)."""
    return _active.metrics


def tracer() -> Any:
    return _active.tracer


def span(name: str, **args):
    """``with telemetry.span("commit", worker=i):`` — no-op (one shared
    inert context manager) while disabled."""
    return _active.tracer.span(name, **args)


def instant(name: str, **args) -> None:
    _active.tracer.instant(name, **args)


def complete(name: str, t0: float, **args) -> None:
    """Record a complete event from ``t0`` (a ``now()`` stamp the
    caller took at the start of the bracketed work) to now."""
    _active.tracer.complete(name, t0, now(), **args)


def flow_start(name: str, flow_id: int, **args) -> None:
    _active.tracer.flow_start(name, flow_id, **args)


def flow_end(name: str, flow_id: int, **args) -> None:
    _active.tracer.flow_end(name, flow_id, **args)


def merge_traces(*traces: Mapping | list) -> dict:
    """Stitch per-process Chrome trace dumps into ONE timeline.

    Each argument is a ``chrome_trace()``-shaped dict (or a bare event
    list).  Two alignments happen:

    * **Clock**: ``perf_counter`` origins are arbitrary per process, so
      each trace's ``wallAnchor`` (wall + mono stamp taken at dump
      time) shifts its timestamps onto the FIRST anchored trace's
      timeline.  Traces without an anchor pass through unshifted.
    * **Pid collision**: two dumps claiming one pid (e.g. a tracer
      dumped twice, or pid reuse across hosts) get the later dump
      remapped to a fresh synthetic pid so Perfetto renders them as
      distinct process tracks.

    Flow events ("s"/"f") survive untouched — their ids were minted
    process-unique — so client→server arrows span process boundaries
    in the merged view."""
    merged: list[dict] = []
    used_pids: set[int] = set()
    base_offset: float | None = None  # wall_s - mono_s of first anchor
    for t in traces:
        if isinstance(t, Mapping):
            events = list(t.get("traceEvents", []))
            anchor = t.get("wallAnchor")
        else:
            events, anchor = list(t), None
        shift_us = 0.0
        if anchor is not None:
            offset = float(anchor["wall_s"]) - float(anchor["mono_s"])
            if base_offset is None:
                base_offset = offset
            shift_us = (offset - base_offset) * 1e6
        pids = sorted({e["pid"] for e in events if "pid" in e})
        remap: dict[int, int] = {}
        for p in pids:
            q = p
            while q in used_pids:
                q += 1_000_000  # synthetic pid for the colliding dump
            remap[p] = q
            used_pids.add(q)
        for e in events:
            if shift_us and "ts" in e:
                e = {**e, "ts": e["ts"] + shift_us}
            p = e.get("pid")
            if p is not None and remap.get(p) != p:
                e = {**e, "pid": remap[p]}
            merged.append(e)
    merged.sort(key=lambda e: (0 if e.get("ph") == "M" else 1,
                               e.get("ts", 0.0)))
    return {"traceEvents": merged, "displayTimeUnit": "ms"}



def enable(ring_capacity: int = 65536,
           telemetry: Telemetry | None = None) -> Telemetry:
    """Install (and return) the global ``Telemetry``.  Idempotent-ish:
    enabling while enabled replaces the active instance (pass an
    existing ``Telemetry`` to install a pre-built one).  NOTE —
    compile-event counters are recorded at program TRACE time, so
    enable telemetry before constructing the engine/trainer whose
    compiles you want counted."""
    global _active
    with _active_lock:
        tel = telemetry if telemetry is not None else Telemetry(
            tracer=Tracer(capacity=ring_capacity))
        _active = tel
    return tel


def disable() -> None:
    """Restore the no-op fast path.  Existing handles into the old
    registry stay valid — they just stop being globally visible."""
    global _active
    with _active_lock:
        _active = _NULL


# -- SLO health -------------------------------------------------------

#: ``signal -> (degraded_at, critical_at)`` — inclusive lower bounds;
#: a signal at/above ``degraded_at`` degrades the verdict, at/above
#: ``critical_at`` makes it critical.  Signals with no samples in the
#: registry are skipped (absence of traffic is not an outage).
DEFAULT_SLO_THRESHOLDS: dict[str, tuple[float, float]] = {
    "staleness_p99": (16.0, 64.0),        # commits of center drift
    "retry_rate": (0.5, 2.0),             # client retries per commit
    "shed_rate": (0.05, 0.25),            # sheds per submitted request
    "queue_depth": (64.0, 256.0),         # queued requests, all buckets
    "ttft_p95_s": (1.0, 10.0),            # seconds to first token
    "ttft_p99": (2.0, 20.0),              # tail seconds to first token
    "inter_token_p99": (0.25, 2.5),       # tail decode gap, seconds
    "idle_worker_fraction": (0.34, 0.75),  # silent / registered
    "ps_lock_wait": (0.005, 0.05),        # lock-wait s / shard commit
    "failover_rate": (0.05, 0.5),         # gateway failovers / request
    "leader_failover_rate": (0.05, 0.5),  # leader deaths / upstream
    "prefix_hit_rate": (0.10, 0.01),      # prefix-cache hits / lookup
    "ps_standby_lag": (32.0, 256.0),      # commit-log entries behind
    "preemption_rate": (0.25, 2.0),       # preemptions per request
    "spec_accept_rate": (0.20, 0.05),     # accepted / proposed tokens
    "mfu_gap": (0.5, 0.9),                # 1 - observed/roofline MFU
}

#: Signals where LOW is bad: the comparison inverts (breach at/below
#: the threshold) and a threshold pair must satisfy
#: ``degraded_at >= critical_at``.  A collapsed prefix hit rate on a
#: shared-prompt workload means admissions silently pay full prefill
#: again (store thrash, post-swap cold start, or misrouted affinity).
#: A collapsed speculative accept rate means every engine step pays
#: the proposer AND the wide verify for baseline-or-worse throughput
#: — the workload stopped matching the proposer (turn speculation
#: off, shrink k, or switch proposers).
LOWER_IS_WORSE_SLO_SIGNALS = frozenset({"prefix_hit_rate",
                                        "spec_accept_rate"})


def _merged_percentile(registry, name: str, q: float) -> float | None:
    """Bucket-resolution percentile over EVERY histogram instance named
    ``name`` (all label sets merged); None when there are no samples.
    Instances of one name share bucket edges by construction."""
    snaps = [m.snapshot() for _, m in registry.collect(name)]
    snaps = [s for s in snaps if s.get("count")]
    if not snaps:
        return None
    total = sum(s["count"] for s in snaps)
    need = q * total
    for edge in sorted(snaps[0]["buckets"]):
        if sum(s["buckets"].get(edge, 0) for s in snaps) >= need:
            return float(edge)
    return float(max(s["max"] for s in snaps))


def slo_signals(registry) -> dict[str, float]:
    """The SLO signals ``registry`` has samples for (the JAX
    ``SLOWatchdog.signals``)."""
    r = registry
    out: dict[str, float] = {}
    p99 = _merged_percentile(r, "ps_commit_staleness", 0.99)
    if p99 is not None:
        out["staleness_p99"] = p99
    commits = r.sum_counter("ps_commits_total")
    retries = r.sum_counter("ps_client_retries_total")
    if commits or retries:
        out["retry_rate"] = retries / max(commits, 1.0)
    reqs = r.sum_counter("serving_requests_total")
    sheds = r.sum_counter("serving_shed_total")
    if reqs or sheds:
        out["shed_rate"] = sheds / max(reqs, 1.0)
    depth = r.collect("serving_queue_depth")
    if depth:
        out["queue_depth"] = float(sum(m.value for _, m in depth))
    p95 = _merged_percentile(r, "serving_ttft_seconds", 0.95)
    if p95 is not None:
        out["ttft_p95_s"] = p95
    tp99 = _merged_percentile(r, "serving_ttft_seconds", 0.99)
    if tp99 is not None:
        out["ttft_p99"] = tp99
    # decode-cadence tail: the disaggregation drill's headline —
    # a prefill flood on a monolithic fleet shows up here first,
    # while TTFT alone can look healthy
    itp99 = _merged_percentile(r, "serving_inter_token_seconds",
                               0.99)
    if itp99 is not None:
        out["inter_token_p99"] = itp99
    registered = sum(m.value for _, m
                     in r.collect("ps_registered_workers"))
    if registered > 0:
        idle = sum(m.value for _, m in r.collect("ps_idle_workers"))
        out["idle_worker_fraction"] = idle / registered
    shard_commits = r.sum_counter("ps_shard_commits_total")
    if shard_commits:
        # mean seconds a commit spent WAITING for its shard lock:
        # the PS contention signal — rising wait at flat commit
        # rate means workers are convoying on too few shards
        # (the autoscaler's split trigger)
        out["ps_lock_wait"] = (
            r.sum_counter("ps_lock_wait_seconds_total")
            / max(shard_commits, 1.0))
    groutes = r.sum_counter("gateway_requests_total")
    gfails = r.sum_counter("gateway_failovers_total")
    if groutes or gfails:
        # failovers per routed request: a replica flapping under
        # the gateway shows up here even while every request still
        # completes (the gateway hides the failures it absorbs)
        out["failover_rate"] = gfails / max(groutes, 1.0)
    ups = r.sum_counter("ps_upstream_commits_total")
    lfails = r.sum_counter("ps_leader_failovers_total")
    if ups or lfails:
        # workers degraded to direct-to-root mode per upstream
        # window: the aggregation tier is alive but leaking its
        # fan-in reduction — each degraded worker adds a full
        # root commit per round the tier was built to absorb
        out["leader_failover_rate"] = lfails / max(ups, 1.0)
    phits = r.sum_counter("serving_prefix_hits_total")
    pmiss = r.sum_counter("serving_prefix_misses_total")
    if phits or pmiss:
        # fraction of prefix-store lookups that reused cached KV;
        # inverted signal (see LOWER_IS_WORSE_SLO_SIGNALS) — a
        # LOW rate on a shared-prefix workload is the breach
        out["prefix_hit_rate"] = phits / max(phits + pmiss, 1.0)
    sprop = r.sum_counter("serving_spec_proposed_total")
    sacc = r.sum_counter("serving_spec_accepted_total")
    if sprop:
        # fraction of speculative proposals the target model
        # accepted; inverted signal — a LOW rate means the
        # engine burns proposer+verify work for baseline-or-
        # worse token throughput
        out["spec_accept_rate"] = sacc / max(sprop, 1.0)
    preempts = r.sum_counter("serving_preemptions_total")
    if preempts:
        # KV-page preemptions per submitted request: sustained
        # thrash means the paged pool is undersized for the
        # offered load (requests still finish — swap/recompute
        # readmission hides the churn, at a latency cost)
        out["preemption_rate"] = preempts / max(reqs, 1.0)
    obs = r.collect("mfu_observed")
    roof = r.collect("mfu_roofline")
    if obs and roof:
        # fraction of the roofline-predicted round throughput the
        # measured round is LEAVING on the table (1 - obs/roof,
        # from the mesh round's sampled attribution gauges).  The
        # inversion is baked into the gap itself, so thresholds
        # read the standard way: a HIGH gap is the breach — the
        # round loop regressed against its own cost model.
        o = obs[-1][1].value
        f = roof[-1][1].value
        if f > 0:
            out["mfu_gap"] = min(max(1.0 - o / f, 0.0), 1.0)
    lag = r.collect("ps_standby_lag")
    if lag:
        # how many commit-log entries the slowest PS standby is
        # behind the primary: bounds the failover data-loss window
        # in async replication mode (sync mode pins it near 0)
        out["ps_standby_lag"] = float(
            max(m.value for _, m in lag))
    return out


def health_verdict(registry) -> dict:
    """One stateless SLO evaluation of ``registry`` at
    ``DEFAULT_SLO_THRESHOLDS`` (the JAX ``SLOWatchdog(registry)
    .evaluate()`` of a fresh watchdog): ``{"state", "raw_state",
    "signals", "breaches"}``, the worst breach deciding ``ok`` /
    ``degraded`` / ``critical``.  A state other than ``ok`` drops an
    ``slo_state`` instant and flight event, as the watchdog's first
    transition does."""
    sig = slo_signals(registry)
    rank = {"ok": 0, "degraded": 1, "critical": 2}
    state, breaches = "ok", {}
    for k, v in sig.items():
        degraded_at, critical_at = DEFAULT_SLO_THRESHOLDS[k]
        if k in LOWER_IS_WORSE_SLO_SIGNALS:
            level = ("critical" if v <= critical_at else
                     "degraded" if v <= degraded_at else "ok")
        else:
            level = ("critical" if v >= critical_at else
                     "degraded" if v >= degraded_at else "ok")
        if level != "ok":
            breaches[k] = {"value": v, "level": level,
                           "degraded_at": degraded_at,
                           "critical_at": critical_at}
        if rank[level] > rank[state]:
            state = level
    if state != "ok":
        instant("slo_state", state=state, breaches=sorted(breaches))
        from distkeras_tpu_torch import flight_recorder
        flight_recorder.record("slo_state", state=state, previous="ok",
                               breaches=sorted(breaches))
    return {"state": state, "raw_state": state, "signals": sig,
            "breaches": breaches}


class HistoryView(collections.abc.Mapping):
    """Trainer ``history`` as a read view over a ``MetricsRegistry``'s
    series: one bookkeeping system for history and metrics.  ``view[key]`` returns a list copy of the series values;
    the Mapping ABC supplies ``get``/``in``/``keys``/``items``.
    Writers go through the registry (``Trainer._record``); ``replace``
    repopulates from a checkpointed plain dict on resume."""

    __slots__ = ("_registry",)

    def __init__(self, registry: MetricsRegistry):
        self._registry = registry

    def _series(self) -> dict[str, Series]:
        with self._registry._lock:
            items = list(self._registry._metrics.values())
        return {name: m for kind, name, _, m in items
                if kind == "series" and len(m) > 0}

    def __getitem__(self, key: str) -> list:
        got = self._series().get(key)
        if got is None:
            raise KeyError(key)
        return got.values()

    def __iter__(self) -> Iterator[str]:
        return iter(self._series())

    def __len__(self) -> int:
        return len(self._series())

    def __repr__(self) -> str:
        return f"HistoryView({dict(self)!r})"

    def replace(self, mapping: Mapping[str, list]) -> None:
        """Reset the backing series to ``mapping`` (checkpoint
        resume).  Series absent from ``mapping`` are emptied, so the
        view equals the checkpointed history exactly."""
        for name, s in self._series().items():
            if name not in mapping:
                s.replace([])
        for k, v in mapping.items():
            self._registry.series(k).replace(list(v))

