"""Program spans: named intervals of host time at the serving path's layer
boundaries, on ``time.monotonic()``'s clock.

The serving path opens a span where it enters a layer (one a dispatch, a
chunk, an eager step, a replay, ...; never one a layer of the model or a
kernel, and none inside a captured step) and records one after the fact
where an interval ends elsewhere than it began (a ticket's wait in the
queue). A :class:`Span` names its parent, the innermost span open on the
same thread when it began, and the thread it ran on.

The recorder is off by default. It records while :func:`enable` has turned
it on, and while a ``torch.profiler`` records: a profiled window gets the
host's spans beside the device's activity, on a clock that maps onto the
profiler's (a reader maps the profiler's events onto ``time.monotonic()``
once). Off, :func:`span` checks two flags and returns one shared no-op
context: it reads no clock and records nothing. The scheduler's injectable
``clock`` is never read here (tests fake it).

    from repro_torch import spans
    spans.enable()
    ...  # serve
    got = spans.drain()  # every Span recorded since the last drain

Records are kept in memory, in one list of at most :data:`CAP`; a span
recorded past it is counted (:func:`dropped`) and left out.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time

from torch.autograd import profiler as _profiler

#: Records kept between two drains; later ones are only counted.
CAP = 1 << 20

_clock = time.monotonic
_on = False
_records: list = []
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
_tls = threading.local()


@dataclasses.dataclass(slots=True)
class Span:
    name: str
    start: float  # time.monotonic() seconds
    end: float
    id: int
    parent: int | None  # the innermost span open on this thread at the start
    thread: str  # the recording thread's name
    attrs: dict


class _Open:
    """An open span: the context :func:`span` returns while recording."""

    __slots__ = ("name", "attrs", "id", "parent", "start")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.id = next(_ids)

    def __enter__(self) -> "_Open":
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        self.start = _clock()
        return self

    def __exit__(self, *exc) -> bool:
        end = _clock()
        _stack().pop()
        _keep(Span(self.name, self.start, end, self.id, self.parent,
                   threading.current_thread().name, self.attrs))
        return False


class _NoOp:
    """The one context :func:`span` returns while the recorder is off."""

    __slots__ = ()
    id = None

    def __enter__(self) -> "_NoOp":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _NoOp()


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _keep(s: Span) -> None:
    global _dropped
    with _lock:
        if len(_records) < CAP:
            _records.append(s)
        else:
            _dropped += 1


def enabled() -> bool:
    """Whether spans are recorded now: after :func:`enable`, or while a
    ``torch.profiler`` records."""
    return _on or _profiler._is_profiler_enabled


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    """Stop recording (a running ``torch.profiler`` keeps it on)."""
    global _on
    _on = False


def span(name: str, **attrs):
    """A context manager that records ``name`` from its entry to its exit;
    its ``id`` (``None`` while off) names it to later records."""
    if not (_on or _profiler._is_profiler_enabled):
        return _NOOP
    return _Open(name, attrs)


def record(name: str, t0: float, t1: float, **attrs) -> None:
    """Record ``name`` over ``[t0, t1]`` (``time.monotonic()`` seconds),
    measured by the caller; its parent is the innermost open span."""
    if not (_on or _profiler._is_profiler_enabled):
        return
    stack = _stack()
    _keep(Span(name, t0, t1, next(_ids), stack[-1] if stack else None,
               threading.current_thread().name, attrs))


def drain() -> list[Span]:
    """Every span recorded since the last drain, in the order they ended;
    empties the recorder and its :func:`dropped` count."""
    global _dropped
    with _lock:
        out = list(_records)
        _records.clear()
        _dropped = 0
    return out


def dropped() -> int:
    """Spans left out since the last drain: recorded past :data:`CAP`."""
    return _dropped
