"""The program's own spans (``octa_tpu_torch.utils.trace``) set against the
device's busy intervals of a traced window.

The program logs each span it enters while a ``torch.profiler`` session
records, as ``(name, t0_ns, t1_ns, thread id, notes)`` stamped with
``time.time_ns()``; the profiler's device events, of which
``measure.DeviceTrace.busy`` is the union in microseconds, are on the same
Unix-epoch clock. :func:`per_span` gives, per span name, the spans' count,
their host milliseconds, the device's idle microseconds inside them, and
the idle microseconds of the pieces of the timeline where the name is the
innermost open span. Only the spans of one thread count (the thread that
launches the work; the loader's thread logs its own) and only the part of
each that lies within the window's device intervals, from the first
operation's start to the last one's end.

A program without the trace module, or a log with no span in the window,
gives nothing: the metric readers return None.
"""
from __future__ import annotations

import bisect
import threading

from octa_bench import measure


def program_log() -> list[tuple] | None:
    """The program's span log, or None where the program has none."""
    try:
        from octa_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.log()


class Busy:
    """Busy time within any interval, from sorted disjoint intervals."""

    def __init__(self, busy):
        self.starts = [s for s, _ in busy]
        self.ends = [e for _, e in busy]
        self.before = [0.0]
        for s, e in busy:
            self.before.append(self.before[-1] + e - s)

    def _upto(self, t: float) -> float:
        i = bisect.bisect_right(self.starts, t) - 1
        if i < 0:
            return 0.0
        return self.before[i] + min(t, self.ends[i]) - self.starts[i]

    def within(self, a: float, b: float) -> float:
        return self._upto(b) - self._upto(a) if b > a else 0.0


def window_spans(log, busy, thread: int | None = None) -> list[tuple]:
    """The log's entries of ``thread`` (the main thread by default) that
    overlap the window ``[first busy start, last busy end]``, as ``(start,
    end, name, notes)`` in microseconds, clipped to the window, in order of
    start."""
    if not log or not busy:
        return []
    thread = threading.main_thread().ident if thread is None else thread
    w0, w1 = busy[0][0], busy[-1][1]
    out = []
    for name, t0, t1, tid, notes in log:
        s, e = t0 * 1e-3, t1 * 1e-3
        if tid != thread or e <= w0 or s >= w1:
            continue
        out.append((max(s, w0), min(e, w1), name, notes))
    out.sort(key=lambda x: x[0])
    return out


def per_span(log, busy, thread: int | None = None) -> dict[str, dict]:
    """Per span name: ``count``, ``host_ms`` (the spans' summed length),
    ``idle_us`` (device idle inside them, nested spans included) and
    ``self_idle_us`` (device idle where the name is the innermost open
    span); ``notes``, the notes of the name's spans. Empty where no span of
    ``thread`` lies in the window."""
    spans = window_spans(log, busy, thread)
    if not spans:
        return {}
    b = Busy(busy)
    out: dict[str, dict] = {}
    for s, e, name, notes in spans:
        d = out.setdefault(name, {"count": 0, "host_ms": 0.0, "idle_us": 0.0,
                                  "self_idle_us": 0.0, "notes": []})
        d["count"] += 1
        d["host_ms"] += (e - s) * 1e-3
        d["idle_us"] += (e - s) - b.within(s, e)
        if notes:
            d["notes"].append(notes)
    for s, e, name in measure.innermost([(s, e, n) for s, e, n, _ in spans]):
        if name in out:
            out[name]["self_idle_us"] += (e - s) - b.within(s, e)
    return out


def of_record(rec: dict, thread: int | None = None) -> dict[str, dict]:
    """:func:`per_span` of the program's log against the record's traced
    window; empty without a trace or a log."""
    dt = rec.get("device_trace")
    log = program_log()
    if dt is None or not log:
        return {}
    return per_span(log, dt.busy, thread)


def noted(stats: dict, name: str, key: str) -> float | None:
    """The sum of note ``key`` over the spans ``name``, or None."""
    vals = [n[key] for n in stats.get(name, {}).get("notes", []) if key in n]
    return float(sum(vals)) if vals else None
