"""Spans and counters at the port's layer boundaries.

``span(name)`` marks a stretch of host time and ``count(name, n)`` adds to
a counter.  Both record only while a ``session()`` is open; otherwise a
span is one module-level flag check that returns one shared no-op context
(no allocation, no device work, no synchronise) and a count is a flag
check.

Inside a session a span enters ``torch.profiler.record_function('sg.' +
name)``, so a running profiler places it on the timeline of the device's
activities, and the session keeps each span (name, parent, host start and
end in ns) and every counter in memory.  Nothing is written to disk: a
profiler's Chrome trace carries the spans.

    with trace.session() as s:
        step(batch)
    [(r.name, r.ms) for r in s.spans], s.counters
"""

from __future__ import annotations

import functools
import threading
import time
from contextlib import contextmanager, nullcontext

import torch

PREFIX = 'sg.'

_NOOP = nullcontext()
_session = None         # the open Session, or None


class Span:
    """One recorded span: ``name``, ``parent`` (the span it was opened in
    on the same thread, or None), host ``start_ns`` and ``end_ns``
    (``time.perf_counter_ns``; None while open)."""

    __slots__ = ('name', 'parent', 'start_ns', 'end_ns')

    def __init__(self, name: str, parent: Span | None):
        self.name, self.parent = name, parent
        self.start_ns = self.end_ns = None

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


class Session:
    """What one session recorded: ``spans`` (``Span``, in the order they
    were opened) and ``counters`` (name -> total)."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: dict[str, int] = {}
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, 'stack', None)
        if stack is None:
            stack = self._local.stack = []
        return stack


class _Recording:
    """A span inside a session: the profiler's range and the record."""

    __slots__ = ('session', 'name', 'record', 'range')

    def __init__(self, session: Session, name: str):
        self.session, self.name = session, name

    def __enter__(self) -> Span:
        stack = self.session._stack()
        rec = self.record = Span(self.name, stack[-1] if stack else None)
        self.session.spans.append(rec)
        stack.append(rec)
        self.range = torch.profiler.record_function(PREFIX + self.name)
        self.range.__enter__()
        rec.start_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc) -> bool:
        self.record.end_ns = time.perf_counter_ns()
        self.range.__exit__(*exc)
        self.session._stack().pop()
        return False


def span(name: str):
    """A context for the span ``name``: it yields the ``Span`` recorded in
    the open session, or None where no session is open."""
    if _session is None:
        return _NOOP
    return _Recording(_session, name)


def traced(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` of the open session (no-op
    without one)."""
    if _session is not None:
        c = _session.counters
        c[name] = c.get(name, 0) + n


def active() -> bool:
    """Whether a session is open."""
    return _session is not None


@contextmanager
def session():
    """Opens the process's one session and yields it; spans and counts
    record into it until the block ends."""
    global _session
    if _session is not None:
        raise RuntimeError('a trace session is open already')
    s = _session = Session()
    try:
        yield s
    finally:
        _session = None
