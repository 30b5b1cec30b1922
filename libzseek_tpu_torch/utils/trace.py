"""The port's spans: one `zseek.*` range per stage, on every thread.

    with trace.span("zseek.fetch"):
        ...

With no profiler running, span() reads one flag and returns a shared
null context: nothing is entered and nothing is stored.  While a
torch.profiler runs (the flag torch.autograd.profiler._is_profiler_enabled,
which reads True on every thread, worker threads included), a span
enters torch.profiler.record_function(name), which the profiler records
on the thread that started it, and appends one entry to the span log,
on whatever thread it runs:

    Span(name, thread, start_ns, end_ns, id, cause)

start_ns and end_ns are on the profiler's event clock (the wall clock,
time.time_ns), `thread` is the thread's name (the pools name theirs
zseek-prefetch, zseek-finish and zseek-lz4) and `cause` is the id of the
enclosing span on the same thread or, for a worker's top span, the span
that queued the work: the code that submits work to a pool passes
current() along, and the worker opens its top span with it as `cause`.

The log is kept in memory, bounded at LOG_MAX entries (later entries are
counted in dropped() and not kept), and read after the traced window:
spans() copies it, drain() empties it.  The benchmark's traced runs and
profile_write.py read it.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

LOG_MAX = 1 << 20


class Span(NamedTuple):
    name: str
    thread: str
    start_ns: int
    end_ns: int
    id: int
    cause: int | None


_NULL = contextlib.nullcontext()
_log: list[Span] = []
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()
_clock = time.time_ns


def _stack() -> list[int]:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Open:
    """One span while the profiler runs: its record_function and its log
    entry."""

    __slots__ = ("name", "cause", "id", "start", "rf")

    def __init__(self, name: str, cause: int | None):
        self.name, self.cause = name, cause

    def __enter__(self):
        st = _stack()
        if self.cause is None and st:
            self.cause = st[-1]
        self.id = next(_ids)
        st.append(self.id)
        # stamped before record_function is entered: entering releases the
        # interpreter lock after the profiler's own stamp, and the wait to
        # take it back then falls inside both intervals
        self.start = _clock()
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        end = _clock()
        _stack().pop()
        self.rf.__exit__(*exc)
        entry = Span(self.name, threading.current_thread().name, self.start,
                     end, self.id, self.cause)
        global _dropped
        with _lock:
            if len(_log) < LOG_MAX:
                _log.append(entry)
            else:
                _dropped += 1
        return False


def span(name: str, cause: int | None = None):
    """A context for one stage named `name` (see the module docstring);
    `cause` is the id of the span that queued a worker's work."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Open(name, cause)


def current() -> int | None:
    """The id of the innermost open span on the calling thread; None when
    no profiler runs or no span is open."""
    if not _profiler._is_profiler_enabled:
        return None
    st = _stack()
    return st[-1] if st else None


def spans() -> list[Span]:
    """A copy of the span log."""
    with _lock:
        return list(_log)


def drain() -> list[Span]:
    """The span log, which is emptied (and its count of dropped entries
    reset)."""
    global _log, _dropped
    with _lock:
        out, _log, _dropped = _log, [], 0
    return out


def dropped() -> int:
    """Entries not kept since the last drain(), the log being full."""
    return _dropped


def self_ns(entries) -> dict[int, int]:
    """Each span's self time: its length less the part of it that its
    children on the same thread (the spans whose cause it is) cover."""
    by_id = {s.id: s for s in entries}
    kids: dict[int, list] = {}
    for s in entries:
        p = by_id.get(s.cause)
        if p is not None and p.thread == s.thread:
            kids.setdefault(p.id, []).append((max(s.start_ns, p.start_ns),
                                              min(s.end_ns, p.end_ns)))
    out = {}
    for s in entries:
        covered, end = 0, s.start_ns
        for a, b in sorted(kids.get(s.id, ())):
            if b > end:
                covered += b - max(a, end)
                end = b
        out[s.id] = s.end_ns - s.start_ns - covered
    return out
