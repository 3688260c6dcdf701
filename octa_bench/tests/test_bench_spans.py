"""The program's spans against the device's busy intervals
(``octa_bench/spans.py``) and the metrics that read them, on synthetic
logs: idle inside spans, the innermost span, one thread, clipping to the
window, and each reader's None where the program logged nothing."""
import threading

import pytest

from octa_bench import harness, measure, spans

MAIN = threading.main_thread().ident
OTHER = MAIN + 1


def _entry(name, s_us, e_us, tid=MAIN, notes=None):
    return (name, int(s_us * 1000), int(e_us * 1000), tid, notes)


def _trace(busy, ops=(("k", 1),)):
    """A ``DeviceTrace`` over a window [0, 1000] µs whose operations cover
    ``busy``; ``ops`` names them (a name for each interval, cycled)."""
    ev = [{"name": "bench.window", "cat": "user_annotation", "ts": 0,
           "dur": 1000}]
    names = [n for n, c in ops for _ in range(c)]
    for i, (s, e) in enumerate(busy):
        ev.append({"name": names[i % len(names)], "cat": "kernel", "ts": s,
                   "dur": e - s})
    return measure.DeviceTrace(ev)


def test_busy_within_sums_the_overlap():
    b = spans.Busy([(10.0, 20.0), (30.0, 40.0)])
    assert b.within(0, 100) == 20
    assert b.within(15, 35) == 10
    assert b.within(20, 30) == 0
    assert b.within(12, 13) == 1
    assert b.within(50, 40) == 0


def test_idle_inside_spans_and_the_innermost():
    busy = [(10.0, 20.0), (30.0, 40.0), (60.0, 70.0)]
    log = [_entry("a", 10, 70),            # idle 20..30, 40..60
           _entry("b", 25, 45),            # inside a: idle 25..30, 40..45
           _entry("c", 10, 70, tid=OTHER)]  # another thread
    st = spans.per_span(log, busy)
    assert set(st) == {"a", "b"}
    assert st["a"]["count"] == 1
    assert st["a"]["host_ms"] == pytest.approx(0.060)
    assert st["a"]["idle_us"] == pytest.approx(30.0)
    assert st["b"]["idle_us"] == pytest.approx(10.0)
    # a is innermost only outside b: 20..25 and 45..60
    assert st["a"]["self_idle_us"] == pytest.approx(20.0)
    assert st["b"]["self_idle_us"] == pytest.approx(10.0)
    # the other thread's own view
    assert spans.per_span(log, busy, OTHER)["c"]["idle_us"] == \
        pytest.approx(30.0)


def test_spans_are_clipped_to_the_window():
    busy = [(100.0, 110.0), (190.0, 200.0)]
    log = [_entry("before", 0, 50), _entry("after", 250, 300),
           _entry("edge", 50, 150, notes={"n": 2}),
           _entry("edge", 150, 250, notes={"n": 3})]
    st = spans.per_span(log, busy)
    assert set(st) == {"edge"}
    assert st["edge"]["count"] == 2
    assert st["edge"]["host_ms"] == pytest.approx(0.100)  # 100..200
    assert st["edge"]["idle_us"] == pytest.approx(80.0)
    assert spans.noted(st, "edge", "n") == 5
    assert spans.noted(st, "edge", "m") is None
    assert spans.per_span(log, []) == {} and spans.per_span([], busy) == {}


def _read(name, rec, log, monkeypatch):
    monkeypatch.setattr(spans, "program_log", lambda: log)
    mod = harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py",
                              "octa_bench_metric_test")
    return mod.read(rec)


def _grow_log():
    notes = {"iterations": 4, "redone": 1, "host_syncs": 3}
    return [_entry("octa.grow.batch", 0, 100, notes=notes),
            _entry("octa.grow.iteration", 10, 30),
            _entry("octa.grow.nearest", 12, 18),
            _entry("octa.grow.iteration", 30, 50),
            _entry("octa.grow.iteration", 50, 70),
            _entry("octa.grow.iteration", 70, 90),
            _entry("octa.adapt.generator", 90, 95)]


def test_growth_metrics(monkeypatch):
    # busy 0..10, 20..30, 40..60, 80..100: idle 10..20, 30..40, 60..80
    rec = {"device_trace": _trace([(0, 10), (20, 30), (40, 60), (80, 100)],
                                  ops=(("k2", 3), ("add", 5)))}
    log = _grow_log()
    assert _read("grow_iter_ms.synth", rec, log, monkeypatch) == \
        pytest.approx(0.020)
    # idle inside the iterations 10..30 (10), 30..50 (10), 50..70 (10),
    # 70..90 (10) over their 80 µs
    assert _read("grow_iter_idle_pct.synth", rec, log, monkeypatch) == \
        pytest.approx(50.0)
    assert _read("grow_redo_pct.synth", rec, log, monkeypatch) == \
        pytest.approx(25.0)
    # four operations in the window over four iterations
    assert _read("grow_ops_per_iter.synth", rec, log, monkeypatch) == \
        pytest.approx(1.0)


def test_training_and_segment_metrics(monkeypatch):
    rec = {"device_trace": _trace([(0, 10), (30, 40), (60, 100)])}
    log = [_entry("octa.train.step", 0, 50),
           _entry("octa.post.to_host", 5, 10),
           _entry("octa.post.remove_small_objects", 10, 30),
           _entry("octa.train.step", 50, 100),
           _entry("octa.post.remove_small_objects", 80, 90),
           _entry("octa.data.batch", 0, 100, tid=OTHER)]
    # idle in the steps 10..30, 40..50 and 50..60
    assert _read("step_idle_ms.train", rec, log, monkeypatch) == \
        pytest.approx(0.020)
    assert _read("remove_small_ms.train", rec, log, monkeypatch) == \
        pytest.approx(0.015)
    log = [_entry("octa.adapt.splat", 0, 10),
           _entry("octa.adapt.generator", 10, 30),
           _entry("octa.adapt.segment", 30, 50),
           _entry("octa.adapt.splat", 50, 60),
           _entry("octa.adapt.generator", 60, 80),
           _entry("octa.adapt.segment", 80, 100)]
    # idle 10..30 and 40..60 over two requests
    assert _read("adapt_idle_ms.segment", rec, log, monkeypatch) == \
        pytest.approx(0.020)


NEW = ["grow_iter_ms.synth", "grow_iter_idle_pct.synth",
       "grow_redo_pct.synth", "grow_ops_per_iter.synth",
       "step_idle_ms.train", "remove_small_ms.train",
       "adapt_idle_ms.segment"]


@pytest.mark.parametrize("name", NEW)
def test_no_span_reads_none(name, monkeypatch):
    rec = {"device_trace": _trace([(0, 10)])}
    assert _read(name, rec, [], monkeypatch) is None
    assert _read(name, rec, None, monkeypatch) is None
    assert _read(name, {"device_trace": None}, _grow_log(),
                 monkeypatch) is None
    # spans of another thread, or outside the window, are not read
    assert _read(name, rec, [_entry("octa.train.step", 0, 5, tid=OTHER)],
                 monkeypatch) is None
