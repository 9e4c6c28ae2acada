"""What a trainer's ``history`` needs of ``distkeras_tpu/telemetry.py``:
``MetricsRegistry.series`` (thread-safe append-only value logs) and
``HistoryView``, the dict-like read view over them.  The counters,
gauges, spans, exporters and the SLO watchdog are not ported yet
(queue 4a in ROADMAP.md)."""

from __future__ import annotations

import collections.abc
import threading
from typing import Iterator

class Series:
    """Thread-safe append-only value log."""

    __slots__ = ("_lock", "_values")

    def __init__(self):
        self._lock = threading.Lock()
        self._values: list = []

    def append(self, v) -> None:
        with self._lock:
            self._values.append(v)

    def replace(self, vs) -> None:
        with self._lock:
            self._values = list(vs)

    def values(self) -> list:
        with self._lock:
            return list(self._values)

    def __len__(self) -> int:
        with self._lock:
            return len(self._values)


class MetricsRegistry:
    """Thread-safe name -> series store; ``series`` is get-or-create."""

    def __init__(self):
        self._lock = threading.Lock()
        self._series: dict[str, Series] = {}

    def series(self, name: str) -> Series:
        with self._lock:
            return self._series.setdefault(name, Series())

    def _nonempty(self) -> dict[str, Series]:
        with self._lock:
            return {k: s for k, s in self._series.items() if len(s)}


class HistoryView(collections.abc.Mapping):
    """Trainer ``history`` as a read view over a registry's series:
    ``view[key]`` is a list copy of the values; the Mapping ABC supplies
    ``get``/``in``/``keys``/``items``.  Writers go through the registry
    (``Trainer._record``); ``replace`` resets it from a checkpoint."""

    __slots__ = ("_registry",)

    def __init__(self, registry: MetricsRegistry):
        self._registry = registry

    def __getitem__(self, key: str) -> list:
        got = self._registry._nonempty().get(key)
        if got is None:
            raise KeyError(key)
        return got.values()

    def __iter__(self) -> Iterator[str]:
        return iter(self._registry._nonempty())

    def __len__(self) -> int:
        return len(self._registry._nonempty())

    def __repr__(self) -> str:
        return f"HistoryView({dict(self)!r})"

    def replace(self, mapping) -> None:
        """Reset the backing series to ``mapping`` (checkpoint resume).
        Series absent from ``mapping`` are emptied, so the view equals
        the checkpointed history exactly."""
        for name, s in self._registry._nonempty().items():
            if name not in mapping:
                s.replace([])
        for k, v in mapping.items():
            self._registry.series(k).replace(list(v))
