"""The rate, tail and trace arithmetic over whole windows."""
import pytest

from octa_bench import measure
from octa_bench.harness import judge


def test_percentile_nearest_rank_keeps_a_stall():
    lat = [0.060] * 95 + [0.061] * 4 + [2.0]       # one stalled request
    assert measure.percentile(lat, 95) == 0.060
    assert measure.percentile(lat, 99) == 0.061
    assert measure.percentile(lat, 100) == 2.0
    lat = [0.060] * 90 + [1.5] * 10                  # a stall of ten
    assert measure.percentile(lat, 95) == 1.5


def test_rate_over_the_whole_window_counts_the_stall():
    # requests of 60 ms and one stall of 2 s: the window holds both
    done = [0.06 * i for i in range(1, 101)]
    done = done[:50] + [t + 2.0 for t in done[50:]]
    window = done[-1] - 0.0
    rate = 4 * len(done) / window
    assert rate == pytest.approx(400 / 8.0)


def test_union_counts_overlapping_streams_once():
    iv = [(0, 10), (5, 15), (20, 30), (30, 31)]
    assert measure.union(iv) == [(0, 15), (20, 31)]


def test_device_trace_idle_and_gaps():
    ev = [{"name": "bench.window", "cat": "user_annotation", "ts": 0,
           "dur": 100},
          {"name": "k1", "cat": "kernel", "ts": 10, "dur": 20},
          {"name": "k2", "cat": "kernel", "ts": 20, "dur": 20},  # overlaps
          {"name": "k1", "cat": "kernel", "ts": 90, "dur": 30},  # past end
          {"name": "bench.wait", "cat": "user_annotation", "ts": 40,
           "dur": 50},
          {"name": "bench.step", "cat": "user_annotation", "ts": 0,
           "dur": 40}]
    d = measure.DeviceTrace(ev)
    assert d.window_s == pytest.approx(100e-6)
    assert d.busy_s == pytest.approx(40e-6)           # [10, 40] and [90, 100]
    assert d.idle_pct() == pytest.approx(60.0)
    assert d.kernel("k1") == (pytest.approx(30e-6), 2)
    assert d.gaps == {"step": pytest.approx(10e-6),
                      "wait": pytest.approx(50e-6)}
    b = d.breakdown()
    assert b["device_ops"][0][0] == "k1" and len(b["idle_gaps"]) == 2


def test_judge_needs_every_limit_and_a_finite_number():
    ok, table = judge([("a", 0.5), ("b", 0.0)], {"a": 1.0, "b": 0})
    assert ok and table["a"] == {"value": 0.5, "limit": 1.0}
    assert not judge([("a", 2.0)], {"a": 1.0})[0]
    assert not judge([("a", float("nan"))], {"a": 1.0})[0]
    assert not judge([("a", 0.1)], {})[0]
    assert not judge([], {"a": 1.0})[0]
