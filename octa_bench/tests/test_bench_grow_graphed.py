"""``grow_graphed_pct.synth`` on synthetic records: 100 x the ``graphed``
notes over the ``iterations`` notes of the growth batches in the traced
window, and None where the program notes no ``graphed`` or logged
nothing."""
import threading

import pytest

from octa_bench import harness, measure, spans

MAIN = threading.main_thread().ident
NAME = "grow_graphed_pct.synth"


def _entry(name, s_us, e_us, notes=None):
    return (name, int(s_us * 1000), int(e_us * 1000), MAIN, notes)


def _record():
    """A traced window [0, 1000] µs, busy 0..100 and 900..1000."""
    ev = [{"name": "bench.window", "cat": "user_annotation", "ts": 0,
           "dur": 1000},
          {"name": "k", "cat": "kernel", "ts": 0, "dur": 100},
          {"name": "k", "cat": "kernel", "ts": 900, "dur": 100}]
    return {"device_trace": measure.DeviceTrace(ev)}


def _read(log, monkeypatch, rec=None):
    monkeypatch.setattr(spans, "program_log", lambda: log)
    mod = harness.load_module(harness.BENCH_DIR / "metrics" / f"{NAME}.py",
                              "octa_bench_metric_graphed_test")
    return mod.read(_record() if rec is None else rec)


def test_reads_graphed_over_iterations(monkeypatch):
    log = [_entry("octa.grow.batch", 0, 500,
                  {"iterations": 350, "redone": 100, "graphed": 330}),
           _entry("octa.grow.iteration", 10, 20),
           _entry("octa.grow.batch", 500, 1000,
                  {"iterations": 300, "redone": 50, "graphed": 290})]
    assert _read(log, monkeypatch) == pytest.approx(100.0 * 620 / 650)
    assert _read(log[:1], monkeypatch) == pytest.approx(100.0 * 330 / 350)


@pytest.mark.parametrize("log", [
    [_entry("octa.grow.batch", 0, 500, {"iterations": 350, "redone": 100})],
    [_entry("octa.grow.batch", 0, 500, {"iterations": 0, "graphed": 0})],
    [_entry("octa.grow.iteration", 0, 500)],
    [],
    None], ids=["no_note", "no_iterations", "no_batch", "empty", "no_log"])
def test_nothing_to_read_is_none(log, monkeypatch):
    assert _read(log, monkeypatch) is None


def test_untraced_is_none(monkeypatch):
    log = [_entry("octa.grow.batch", 0, 500,
                  {"iterations": 350, "graphed": 330})]
    assert _read(log, monkeypatch, {"device_trace": None}) is None
