"""Measurement arithmetic of the benchmark: tails, the traced window's device
intervals and their union, and the breakdown of a traced run.

The device's busy time is the union of its operations' intervals, so that
work on two streams at once (the loader's stream beside the step's) counts
once. Host spans are ``torch.profiler.record_function`` ranges named
``bench.<what>``; an idle gap of the device is named by the span that covers
most of it.
"""
from __future__ import annotations

import math

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # chrome-trace names
SPAN_PREFIX = "bench."
WINDOW_SPAN = "bench.window"


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100) of all values."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def union(intervals) -> list[tuple[float, float]]:
    """Merged, sorted, disjoint intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: float, hi: float):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def innermost(spans):
    """``[(start, end, name)]`` of host spans -> the timeline as disjoint
    pieces ``(start, end, name)``, each named by the span begun last among
    those open over it ("other" where none is)."""
    marks = sorted([(s, 1, i) for i, (s, _, _) in enumerate(spans)]
                   + [(e, 0, i) for i, (_, e, _) in enumerate(spans)])
    out, open_, last = [], [], None
    for t, kind, i in marks:
        if last is not None and t > last:
            out.append((last, t, spans[open_[-1]][2] if open_ else "other"))
        last = t
        if kind:
            open_.append(i)
        else:
            open_.remove(i)
    return out


def name_gaps(gaps, spans) -> dict[str, float]:
    """Seconds of idle device time by the host span that covers most of each
    gap (gaps and spans in microseconds)."""
    pieces = innermost(spans)
    out: dict[str, float] = {}
    j = 0
    for s, e in gaps:
        while j < len(pieces) and pieces[j][1] <= s:
            j += 1
        cover: dict[str, float] = {}
        k = j
        while k < len(pieces) and pieces[k][0] < e:
            a, b, n = pieces[k]
            cover[n] = cover.get(n, 0.0) + min(b, e) - max(a, s)
            k += 1
        name = max(cover, key=cover.get) if cover else "other"
        out[name] = out.get(name, 0.0) + (e - s) * 1e-6
    return out


class DeviceTrace:
    """The device side of a traced window, from the profiler's events
    (chrome-trace dicts: ``cat``, ``name``, ``ts`` and ``dur`` in
    microseconds)."""

    def __init__(self, events: list[dict]):
        win = [e for e in events if e.get("name") == WINDOW_SPAN]
        if not win:
            raise ValueError("the trace holds no window span")
        w0 = float(win[0]["ts"])
        w1 = w0 + float(win[0]["dur"])
        self.window_s = (w1 - w0) * 1e-6
        dev = [e for e in events if e.get("cat") in DEVICE_CATS]
        iv = clip([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in dev], w0, w1)
        self.busy = union(iv)
        self.busy_s = sum(e - s for s, e in self.busy) * 1e-6
        self.ops: dict[str, list[float]] = {}
        for e in dev:
            s, t = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
            if t <= w0 or s >= w1:
                continue
            acc = self.ops.setdefault(e["name"], [0.0, 0])
            acc[0] += (min(t, w1) - max(s, w0)) * 1e-6
            acc[1] += 1
        spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                  e["name"][len(SPAN_PREFIX):]) for e in events
                 if str(e.get("name", "")).startswith(SPAN_PREFIX)
                 and e.get("name") != WINDOW_SPAN
                 and e.get("cat") in ("user_annotation", "cpu_op")]
        edges = [w0] + [x for se in self.busy for x in se] + [w1]
        idle = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
        self.gaps = name_gaps(idle, spans)

    def kernel(self, *needles: str) -> tuple[float, int]:
        """Seconds and launches of the device operations whose name holds
        every needle."""
        s, n = 0.0, 0
        for name, (sec, cnt) in self.ops.items():
            if all(x in name for x in needles):
                s, n = s + sec, n + cnt
        return s, n

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self) -> dict:
        ops = sorted(((n, v[0]) for n, v in self.ops.items()),
                     key=lambda x: -x[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda x: -x[1])[:10]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


class Tracer:
    """``torch.profiler`` over a window: ``start()`` after the set-up,
    ``stop()`` at a unit's boundary; ``stop`` returns the
    :class:`DeviceTrace`. Host spans are ``span(name)`` contexts, which cost
    nothing when the tracer is off."""

    def __init__(self, torch, on: bool):
        self.torch = torch
        self.on = on
        self.prof = None
        self._win = None

    def span(self, name: str):
        if self.prof is None:
            return _NULL
        return self.torch.profiler.record_function(SPAN_PREFIX + name)

    def _activities(self):
        tp = self.torch.profiler
        acts = [tp.ProfilerActivity.CPU]
        if self.torch.cuda.is_available():
            acts.append(tp.ProfilerActivity.CUDA)
        return acts

    def warm(self):
        """One short session in the set-up, so that the profiler's own
        start-up (CUPTI) stays out of the window."""
        if not self.on:
            return
        dev = "cuda" if self.torch.cuda.is_available() else "cpu"
        with self.torch.profiler.profile(activities=self._activities()):
            self.torch.ones(8, device=dev).sum().item()

    def start(self):
        if not self.on:
            return
        tp = self.torch.profiler
        self.prof = tp.profile(activities=self._activities())
        self.prof.__enter__()
        self._win = tp.record_function(WINDOW_SPAN)
        self._win.__enter__()

    def stop(self) -> DeviceTrace | None:
        """End the session; only the device's operations and the
        benchmark's spans are kept of its events."""
        if self.prof is None:
            return None
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self._win.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        events = []
        cpu = self.torch.autograd.DeviceType.CPU
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            span = name.startswith(SPAN_PREFIX)
            on_device = e.device_type() != cpu
            if on_device == span:  # a span's device-side twin, or a host op
                continue
            events.append({"name": name,
                           "cat": "user_annotation" if span else "kernel",
                           "ts": e.start_ns() * 1e-3,
                           "dur": e.duration_ns() * 1e-3})
        self.prof = None
        return DeviceTrace(events)


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


_NULL = _Null()
