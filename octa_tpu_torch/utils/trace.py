"""Spans and counters of the program's own stages, on the profiler's clock.

``span(name)`` is a context manager around one stage of the work (a growth
iteration, a training step, a stage of the adapted path). It records only
while a ``torch.profiler`` session records (``train.py --profile``, the
timing tools, or any caller's own session); otherwise it returns one shared
object that does nothing: no allocation, no clock read, no device work.

While a session records, a span

- opens a profiler range of its name, so that it appears in the session's
  trace beside the torch operations it launched. The range has function
  scope (a ``cpu_op`` event): a user-scope range (``record_function``)
  would also put a device-side copy of itself on the card's timeline,
  which a reader of that timeline would count as device work;
- appends ``(name, t0_ns, t1_ns, thread id, notes)`` to a bounded
  process-wide log, stamped with ``time.time_ns()``. The profiler's events
  (``KinetoEvent.start_ns()``) are on the same Unix-epoch clock, so the
  device's busy intervals of a trace can be set against the program's
  spans: an idle gap of the card belongs to the innermost span open on the
  thread that launches the work.

Spans are also logged from threads other than the one that started the
session (the loader's thread), whose profiler ranges the session does not
record: the log is the only place where they show.

``.note(**counts)`` attaches counts to an open span (a growth batch's
iterations, redone iterations and host reads); they are logged at its exit.
``log()`` returns the entries, ``totals()`` sums them by name (what
``train.py --profile`` writes beside its trace), ``clear()`` empties the
log. Past ``CAP`` entries the log keeps nothing more and counts
``dropped()``.

A span never synchronizes with the device, reads no device tensor and does
not touch the allocator's statistics.
"""
from __future__ import annotations

import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

CAP = 1 << 20

_Range = torch._C._profiler._RecordFunctionFast
_lock = threading.Lock()
_log: list[tuple] = []
_dropped = 0


class _Off:
    """The span while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note(self, **counts):
        pass


OFF = _Off()


class _Span:
    __slots__ = ("name", "notes", "t0", "_range")

    def __init__(self, name: str):
        self.name = name
        self.notes = None

    def __enter__(self):
        self._range = _Range(self.name)
        self._range.__enter__()
        self.t0 = time.time_ns()
        return self

    def note(self, **counts):
        self.notes = {**(self.notes or {}), **counts}

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self._range.__exit__(*exc)
        _append((self.name, self.t0, t1, threading.get_ident(), self.notes))
        return False


def _append(entry: tuple):
    global _dropped
    with _lock:
        if len(_log) < CAP:
            _log.append(entry)
        else:
            _dropped += 1


def span(name: str):
    """The span of one stage: a context manager that records while a
    ``torch.profiler`` session records, and does nothing otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return OFF
    return _Span(name)


def iterate(name: str, iterable):
    """The items of ``iterable``, each fetched inside ``span(name)``."""
    it = iter(iterable)
    try:
        while True:
            with span(name):
                try:
                    item = next(it)
                except StopIteration:
                    return
            yield item
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()


def log() -> list[tuple]:
    """The logged spans, oldest first: ``(name, t0_ns, t1_ns, thread id,
    notes)``, ``notes`` a dict or None."""
    with _lock:
        return list(_log)


def totals(entries=None) -> dict[str, dict]:
    """Per span name, in order of first entry: ``count``, ``host_ms`` (the
    spans' summed length) and ``notes`` (each note summed), of ``entries``
    or of the whole log."""
    out: dict[str, dict] = {}
    for name, t0, t1, _, notes in (log() if entries is None else entries):
        d = out.setdefault(name, {"count": 0, "host_ms": 0.0, "notes": {}})
        d["count"] += 1
        d["host_ms"] += (t1 - t0) * 1e-6
        for k, v in (notes or {}).items():
            d["notes"][k] = d["notes"].get(k, 0) + v
    return out


def dropped() -> int:
    """Spans not logged because the log was full."""
    return _dropped


def clear():
    """Empty the log and its count of dropped spans."""
    global _dropped
    with _lock:
        _log.clear()
        _dropped = 0
