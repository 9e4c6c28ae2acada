"""The port's telemetry stack (``telemetry.py``, ``flight_recorder.py``,
``analysis/racecheck.py``) against the JAX package's: the same operations
on a registry give the same snapshot, JSON lines, Prometheus text and
SLO verdict; spans nest into one trace and carry the ids the wire
header reads; ``merge_traces`` stitches dumps alike; the flight recorder
rotates and reads back; the lock-order and race detectors report."""

import json
import threading

import jax
import pytest

from distkeras_tpu import telemetry as jax_telemetry
from distkeras_tpu_torch import flight_recorder, telemetry
from distkeras_tpu_torch.analysis import racecheck

jax.config.update("jax_platforms", "cpu")


def _fill(tel_module, registry):
    registry.counter("ps_commits_total").inc(40)
    registry.counter("ps_client_retries_total").inc(30)
    registry.counter("ps_wire_bytes_total", direction="rx").inc(1024)
    registry.gauge("ps_registered_workers").set(4)
    registry.gauge("ps_idle_workers").set(2)
    h = registry.histogram("ps_commit_staleness",
                           buckets=tel_module.STALENESS_BUCKETS)
    for s in (0, 1, 3, 3, 40):
        h.observe(s)
    registry.histogram("ps_client_backoff_seconds").observe(0.02)
    registry.series("round_loss").extend([1.5, 1.25])
    registry.gauge("odd", label='a"b\\c\nd').set(1)


def test_registry_exports_equal_the_jax_packages(tmp_path):
    port, ref = telemetry.MetricsRegistry(), jax_telemetry.MetricsRegistry()
    _fill(telemetry, port)
    _fill(jax_telemetry, ref)
    assert port.snapshot() == ref.snapshot()
    assert port.prometheus_text() == ref.prometheus_text()
    port.write_jsonl(tmp_path / "port.jsonl")
    ref.write_jsonl(tmp_path / "jax.jsonl")
    assert (tmp_path / "port.jsonl").read_text() \
        == (tmp_path / "jax.jsonl").read_text()
    assert port.sum_counter("ps_wire_bytes_total") == 1024
    with pytest.raises(ValueError, match="already registered"):
        port.gauge("ps_commits_total")
    with pytest.raises(ValueError, match="strictly increasing"):
        telemetry.Histogram(buckets=(1, 1))
    assert port.histogram("ps_commit_staleness").percentile(0.5) == 4.0


@pytest.mark.parametrize("case", ["ok", "degraded", "critical"])
def test_health_verdict_equals_the_jax_watchdogs(case):
    port, ref = telemetry.MetricsRegistry(), jax_telemetry.MetricsRegistry()
    for mod, reg in ((telemetry, port), (jax_telemetry, ref)):
        reg.counter("ps_commits_total").inc(100)
        h = reg.histogram("ps_commit_staleness",
                          buckets=mod.STALENESS_BUCKETS)
        for _ in range(10):
            h.observe({"ok": 1, "degraded": 20, "critical": 100}[case])
        if case == "critical":
            reg.counter("ps_client_retries_total").inc(300)
    got = port.health()
    want = jax_telemetry.SLOWatchdog(ref).evaluate()
    assert got["state"] == want["state"] == case
    assert got["signals"] == want["signals"]
    assert got["breaches"] == want["breaches"]
    assert telemetry.NullRegistry().health()["state"] == "ok"


def test_spans_nest_into_one_trace_and_export():
    tel = telemetry.enable()
    try:
        assert telemetry.current_trace() is None
        with telemetry.span("ps_op", worker=1) as outer:
            with telemetry.span("ps_client_commit") as inner:
                assert telemetry.current_trace() == (outer.span_id,
                                                     inner.span_id)
            telemetry.flow_start("wire", inner.span_id, op="commit")
            telemetry.instant("worker_retry", worker=1)
        t0 = telemetry.now()
        telemetry.complete("worker_round", t0, worker=1)
        telemetry.flow_end("wire", inner.span_id)
        events = tel.tracer.events()
        names = [e["name"] for e in events]
        assert names == ["ps_client_commit", "wire", "worker_retry",
                         "ps_op", "worker_round", "wire"]
        assert events[0]["args"]["trace_id"] == events[3]["args"]["trace_id"]
        dump = tel.tracer.chrome_trace()
        assert {e["ph"] for e in dump["traceEvents"]} >= {"M", "X", "i",
                                                          "s", "f"}
        json.dumps(dump)
    finally:
        telemetry.disable()
    assert telemetry.metrics().snapshot()["counters"] == {}
    with telemetry.span("off") as sp:
        assert telemetry.current_trace() is None and sp is not None


def test_merge_traces_equals_the_jax_packages():
    a = {"traceEvents": [{"name": "x", "ph": "X", "ts": 10.0, "pid": 1,
                          "tid": 1}],
         "wallAnchor": {"wall_s": 100.0, "mono_s": 5.0}}
    b = {"traceEvents": [{"name": "y", "ph": "X", "ts": 3.0, "pid": 1,
                          "tid": 2}, {"name": "m", "ph": "M", "pid": 1}],
         "wallAnchor": {"wall_s": 100.5, "mono_s": 2.0}}
    c = [{"name": "z", "ph": "i", "ts": 1.0, "pid": 7}]
    assert telemetry.merge_traces(a, b, c) \
        == jax_telemetry.merge_traces(a, b, c)


def test_history_view_reads_the_series():
    reg = telemetry.MetricsRegistry()
    view = telemetry.HistoryView(reg)
    reg.series("round_loss").append(0.5)
    reg.counter("not_history").inc()
    assert dict(view) == {"round_loss": [0.5]}
    view.replace({"epoch_loss": [1.0]})
    assert dict(view) == {"epoch_loss": [1.0]}
    with pytest.raises(KeyError):
        view["round_loss"]


def test_flight_recorder_rotates_and_reads_back(tmp_path):
    fr = flight_recorder.start(tmp_path, segment_events=3, segments=2)
    try:
        assert flight_recorder.active() is fr
        for i in range(10):
            flight_recorder.record("commit", worker=i % 2, seq=i)
        flight_recorder.flush(fsync=True)
        events = fr.read_events()
        # 3 sealed segments of 3 were written; the ring keeps 2 + the live
        assert [e["seq"] for e in events] == [3, 4, 5, 6, 7, 8, 9]
        assert all(e["kind"] == "commit" and "mono_s" in e for e in events)
        assert fr.last(1e9)[-1]["seq"] == 9
    finally:
        flight_recorder.stop()
    assert flight_recorder.active() is None
    flight_recorder.record("ignored")  # a no-op when off
    with pytest.raises(ValueError):
        flight_recorder.FlightRecorder(tmp_path, segment_events=0)


def test_racecheck_reports_order_cycles_races_and_deadlocks():
    racecheck.enable()
    try:
        a, b = racecheck.lock("a"), racecheck.lock("b")
        assert isinstance(a, racecheck.CheckedLock)
        with a, b:
            pass
        with b, a:
            pass
        kinds = [r.kind for r in racecheck.reports()]
        assert kinds == ["lock-order-cycle"]
        with a:
            with pytest.raises(racecheck.DeadlockError):
                a.acquire()
        shared = racecheck.Guarded({}, name="shared")

        def write(v):
            shared["x"] = v

        # this thread and a second one (alive at once, so their ids
        # differ) write with no lock held
        write(0)
        t = threading.Thread(target=write, args=(1,))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        assert "race" in [r.kind for r in racecheck.reports()]
        cond = racecheck.condition("c")
        with cond:
            cond.wait(timeout=0.01)
    finally:
        reports = racecheck.disable()
    assert len(reports) >= 3
    assert not isinstance(racecheck.lock("plain"), racecheck.CheckedLock)
