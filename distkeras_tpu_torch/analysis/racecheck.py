"""Runtime lockset race + deadlock detector, the port's copy of
``distkeras_tpu/analysis/racecheck.py`` (pure Python, unchanged).

Opt-in, disabled by default, with the same no-op discipline as
telemetry: the lock factories (:func:`lock`, :func:`rlock`,
:func:`condition`) hand back PLAIN ``threading`` primitives while the
detector is off, so the disabled path costs exactly one module-global
bool test at construction time and nothing at all per acquire.  Every
lock-bearing runtime module constructs its locks through these
factories; enabling the detector before constructing a PS / gateway /
engine therefore instruments that object's whole locking surface.

When enabled:

- ``CheckedLock`` / ``CheckedRLock`` maintain a per-thread held set and
  a global instance-level acquisition-order graph.  An AB/BA cycle in
  the order graph records a ``lock-order-cycle`` report the moment the
  second order is observed — no unlucky interleaving required.  A
  blocking acquire additionally walks the wait-for graph (thread ->
  wanted lock -> owning thread) and raises :class:`DeadlockError`
  instead of deadlocking; a same-thread re-acquire of a non-reentrant
  lock raises immediately (that IS a deadlock, deterministically).
- :class:`Guarded` wraps an object and feeds every attribute / item
  access through the Eraser lockset algorithm (Savage et al. 1997):
  each shared location keeps a candidate lockset, refined by
  intersection with the locks held at each access; a write-shared
  location whose lockset goes empty is a data race, reported with the
  stacks of BOTH conflicting accesses.  Passing an explicit ``lock``
  also enforces the simple discipline "never touch without it".

``enable()`` inside the host-PS tests keeps them honest: they fail on
any report, so a new nesting or unguarded access breaks a test rather
than a run.
"""

from __future__ import annotations

import threading
import traceback
from dataclasses import dataclass, field


class DeadlockError(RuntimeError):
    """A blocking acquire would complete a wait-for cycle."""


@dataclass(frozen=True)
class Report:
    kind: str  # "lock-order-cycle" | "deadlock" | "race" | "unguarded"
    detail: str
    stacks: tuple[str, ...] = ()

    def __str__(self) -> str:
        return f"[{self.kind}] {self.detail}"


@dataclass
class _VarState:
    """Eraser per-location state machine."""
    owner: int
    written: bool
    state: str = "exclusive"  # exclusive | shared | shared-modified
    lockset: frozenset[int] | None = None
    last: tuple[int, bool, str] = (0, False, "")
    reported: bool = False


@dataclass
class _Detector:
    raise_on_deadlock: bool = True
    mutex: threading.Lock = field(default_factory=threading.Lock)
    reports: list[Report] = field(default_factory=list)
    # instance-level acquisition order graph: id(outer) -> {id(inner)}
    order: dict[int, set[int]] = field(default_factory=dict)
    names: dict[int, str] = field(default_factory=dict)
    edge_sites: dict[tuple[int, int], str] = field(default_factory=dict)
    owners: dict[int, int] = field(default_factory=dict)  # lock->tid
    wanted: dict[int, object] = field(default_factory=dict)  # tid->lock
    vars: dict[object, _VarState] = field(default_factory=dict)


_enabled = False
_det = _Detector()
_tls = threading.local()


def _held() -> list:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def _depths() -> dict[int, int]:
    d = getattr(_tls, "depths", None)
    if d is None:
        d = _tls.depths = {}
    return d


def _stack(skip: int = 3) -> str:
    return "".join(traceback.format_stack()[:-skip])


def enable(raise_on_deadlock: bool = True) -> None:
    """Turn the detector on and reset all prior state.  Locks built by
    the factories AFTER this point are instrumented."""
    global _enabled, _det
    _det = _Detector(raise_on_deadlock=raise_on_deadlock)
    _enabled = True


def disable() -> list[Report]:
    """Turn the detector off and return the accumulated reports.
    Instrumented locks already in the wild degrade to a single bool
    test per acquire."""
    global _enabled
    _enabled = False
    return list(_det.reports)


def enabled() -> bool:
    return _enabled


def reports() -> list[Report]:
    return list(_det.reports)


def held_locks() -> tuple[str, ...]:
    """Names of the instrumented locks this thread currently holds."""
    return tuple(lk.name for lk in _held())


# -- lock factories (the no-op fast path) ------------------------------


def lock(name: str = "lock"):
    """A mutex: plain ``threading.Lock`` when the detector is off,
    :class:`CheckedLock` when on."""
    return CheckedLock(name) if _enabled else threading.Lock()


def rlock(name: str = "rlock"):
    return CheckedRLock(name) if _enabled else threading.RLock()


def condition(name: str = "cond"):
    """A condition over a (possibly instrumented) RLock — the gateway's
    ``Condition(RLock())`` idiom."""
    return threading.Condition(rlock(name))


# -- instrumented locks ------------------------------------------------


class _CheckedBase:
    def __init__(self, name: str, inner) -> None:
        self.name = name
        self._inner = inner

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"

    # order-graph bookkeeping, called before the inner acquire
    def _pre_acquire(self) -> None:
        me = id(self)
        held = _held()
        with _det.mutex:
            _det.names[me] = self.name
            for h in held:
                o = id(h)
                if me in _det.order.setdefault(o, set()):
                    continue
                _det.order[o].add(me)
                _det.edge_sites[(o, me)] = _stack()
                self._cycle_check(o, me, h)

    def _cycle_check(self, outer: int, inner: int, outer_lock) -> None:
        # does inner already reach outer?  (caller holds _det.mutex)
        seen, stack = set(), [inner]
        while stack:
            n = stack.pop()
            if n == outer:
                rev = _det.edge_sites.get((inner, outer), "")
                _det.reports.append(Report(
                    "lock-order-cycle",
                    f"{_det.names.get(outer, '?')} -> "
                    f"{self.name} nests here, but the reverse order "
                    f"was also observed",
                    (_stack(), rev)))
                return
            if n in seen:
                continue
            seen.add(n)
            stack.extend(_det.order.get(n, ()))

    def _blocking_acquire(self, timeout: float) -> bool:
        """Acquire with wait-for-graph deadlock detection: poll the
        inner lock and re-check the cycle each interval, so the check
        fires no matter which thread registered its intent last."""
        me = threading.get_ident()
        with _det.mutex:
            _det.wanted[me] = self
        try:
            import time
            deadline = (None if timeout is None or timeout < 0
                        else time.monotonic() + timeout)
            while True:
                step = 0.05
                if deadline is not None:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        return False
                    step = min(step, left)
                if self._inner.acquire(True, step):
                    return True
                self._waitfor_check(me)
        finally:
            with _det.mutex:
                _det.wanted.pop(me, None)

    def _waitfor_check(self, me: int) -> None:
        with _det.mutex:
            seen = {me}
            lk = self
            while True:
                owner = _det.owners.get(id(lk))
                if owner is None:
                    return
                if owner in seen:
                    rep = Report(
                        "deadlock",
                        f"wait-for cycle: thread {me} wants "
                        f"{lk.name!r} held by thread {owner} which is "
                        f"itself blocked", (_stack(),))
                    _det.reports.append(rep)
                    raise DeadlockError(str(rep))
                seen.add(owner)
                lk = _det.wanted.get(owner)
                if lk is None:
                    return

    def _got(self) -> None:
        _held().append(self)
        with _det.mutex:
            _det.owners[id(self)] = threading.get_ident()

    def _dropped(self) -> None:
        held = _held()
        if self in held:
            held.remove(self)
        with _det.mutex:
            _det.owners.pop(id(self), None)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._inner.locked()


class CheckedLock(_CheckedBase):
    def __init__(self, name: str = "lock") -> None:
        super().__init__(name, threading.Lock())

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if not _enabled:
            return self._inner.acquire(blocking, timeout)
        if self in _held():
            rep = Report(
                "deadlock",
                f"thread re-acquiring non-reentrant lock "
                f"{self.name!r} it already holds", (_stack(),))
            _det.reports.append(rep)
            raise DeadlockError(str(rep))
        self._pre_acquire()
        if self._inner.acquire(False):
            self._got()
            return True
        if not blocking:
            return False
        if self._blocking_acquire(timeout):
            self._got()
            return True
        return False

    def release(self) -> None:
        if _enabled:
            self._dropped()
        self._inner.release()


class CheckedRLock(_CheckedBase):
    """Reentrant variant.  Exposes ``_is_owned`` / ``_release_save`` /
    ``_acquire_restore`` so ``threading.Condition`` treats it exactly
    like a native RLock (``wait()`` fully releases and the held set
    tracks that)."""

    def __init__(self, name: str = "rlock") -> None:
        super().__init__(name, threading.RLock())

    def acquire(self, blocking: bool = True, timeout: float = -1):
        if not _enabled:
            return self._inner.acquire(blocking, timeout)
        depths = _depths()
        if depths.get(id(self), 0) > 0:  # recursion: no bookkeeping
            got = self._inner.acquire(blocking, timeout)
            if got:
                depths[id(self)] += 1
            return got
        self._pre_acquire()
        if self._inner.acquire(False):
            self._got()
            depths[id(self)] = 1
            return True
        if not blocking:
            return False
        if self._blocking_acquire(timeout):
            self._got()
            depths[id(self)] = 1
            return True
        return False

    def release(self) -> None:
        if _enabled:
            depths = _depths()
            n = depths.get(id(self), 0)
            if n <= 1:
                depths.pop(id(self), None)
                self._dropped()
            else:
                depths[id(self)] = n - 1
        self._inner.release()

    # Condition protocol ----------------------------------------------

    def _is_owned(self):
        return self._inner._is_owned()

    def _release_save(self):
        depths = _depths()
        n = depths.pop(id(self), 0)
        self._dropped()
        return self._inner._release_save(), n

    def _acquire_restore(self, saved):
        inner_state, n = saved
        self._inner._acquire_restore(inner_state)
        self._got()
        if n:
            _depths()[id(self)] = n


# -- Eraser lockset algorithm ------------------------------------------


def record_access(key, write: bool) -> None:
    """Feed one access to shared location ``key`` through the lockset
    state machine.  No-op while disabled."""
    if not _enabled:
        return
    me = threading.get_ident()
    held = frozenset(id(lk) for lk in _held())
    lock_names = tuple(lk.name for lk in _held())
    with _det.mutex:
        v = _det.vars.get(key)
        if v is None:
            _det.vars[key] = _VarState(
                owner=me, written=write,
                last=(me, write, _stack()))
            return
        if v.state == "exclusive" and v.owner == me:
            v.written = v.written or write
            v.last = (me, write, _stack())
            return
        if v.state == "exclusive":  # second thread arrives
            v.state = ("shared-modified" if (write or v.written)
                       else "shared")
            v.lockset = held
        else:
            v.lockset = (v.lockset or frozenset()) & held
            if write:
                v.state = "shared-modified"
        racy = (v.state == "shared-modified" and not v.lockset
                and not v.reported)
        prev = v.last
        v.last = (me, write, _stack())
        if racy:
            v.reported = True
            _det.reports.append(Report(
                "race",
                f"{key!r}: {'write' if write else 'read'} by thread "
                f"{me} holding {lock_names or '()'} conflicts with "
                f"{'write' if prev[1] else 'read'} by thread "
                f"{prev[0]} — candidate lockset is empty",
                (prev[2], v.last[2])))


class Guarded:
    """Access recorder: wrap a shared object so every attribute / item
    access feeds the lockset algorithm.  With an explicit ``lock``, an
    access made while NOT holding it is reported immediately
    (``unguarded``) in addition to the Eraser refinement."""

    __slots__ = ("_rc_obj", "_rc_lock", "_rc_name")

    def __init__(self, obj, lock=None, name: str | None = None):
        object.__setattr__(self, "_rc_obj", obj)
        object.__setattr__(self, "_rc_lock", lock)
        object.__setattr__(self, "_rc_name",
                           name or type(obj).__name__)

    def _rc_check(self, field: str, write: bool) -> None:
        if not _enabled:
            return
        lk = self._rc_lock
        if lk is not None and lk not in _held():
            _det.reports.append(Report(
                "unguarded",
                f"{self._rc_name}.{field} "
                f"{'written' if write else 'read'} without holding "
                f"{getattr(lk, 'name', lk)!r}", (_stack(),)))
        record_access((self._rc_name, field), write)

    def __getattr__(self, attr):
        self._rc_check(attr, write=False)
        return getattr(self._rc_obj, attr)

    def __setattr__(self, attr, value):
        self._rc_check(attr, write=True)
        setattr(self._rc_obj, attr, value)

    def __getitem__(self, k):
        self._rc_check(f"[{k!r}]", write=False)
        return self._rc_obj[k]

    def __setitem__(self, k, v):
        self._rc_check(f"[{k!r}]", write=True)
        self._rc_obj[k] = v

    def __delitem__(self, k):
        # dunders bypass __getattr__ (special-method lookup goes to
        # the type), so deletion needs its own interception or it
        # escapes the lockset algorithm entirely
        self._rc_check(f"[{k!r}]", write=True)
        del self._rc_obj[k]

    def pop(self, *args, **kwargs):
        # ditto for pop: via __getattr__ it records a READ of "pop",
        # not the mutation of the popped key
        field = f"[{args[0]!r}]" if args else "pop"
        self._rc_check(field, write=True)
        return self._rc_obj.pop(*args, **kwargs)

    def __len__(self):
        self._rc_check("__len__", write=False)
        return len(self._rc_obj)
