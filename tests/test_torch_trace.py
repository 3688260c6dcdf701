"""The port's spans (``octa_tpu_torch.utils.trace``) on the CPU.

Off, a span is one shared object and logs nothing; under a CPU
``torch.profiler`` session each span is an event of the same name whose
stamps lie within 100 µs of the span's own, the log stops at its cap, and
``totals`` sums it by name.
A tiny growth with one capacity redo logs an ``octa.grow.iteration`` span
for every iteration run and an ``octa.grow.read`` for every host read, and
notes the batch's iterations and redone ones as ``stage_log`` has them; a
tiny segmentation step nests forward, backward and optimizer in its step.
"""
import numpy as np
import pytest
import torch

from octa_tpu_torch.sim import greenhouse as tg
from octa_tpu_torch.train import algorithms as talg
from octa_tpu_torch.utils import trace
from octa_tpu_torch.utils.enums import Phase

# one mode of two iterations whose dense candidates overflow the first sink
# forecast: the segment is run again at a larger sink capacity
CONFIG = {
    "SimulationSpace": {"no_voxel_x": 1, "no_voxel_y": 1,
                        "no_voxel_z": 0.0131},
    "d": 0.1, "r": 0.0025,
    "FAZ_radius_bound": [0.44, 0.04],
    "rotation_radius": 1.05,
    "FAZ_center": [0.5, 0.5],
    "nerve_center": [10.56, 5.16],
    "nerve_radius": 0.3,
    "param_scale": 3,
    "modes": [
        {"name": "SVC", "I": 2, "N": 1500, "eps_n": 0.18, "eps_s": 0.01,
         "eps_k": 0.135, "delta_art": 0.2925, "delta_ven": 0.2925,
         "gamma_art": 50, "gamma_ven": 50, "phi": 15, "omega": 0.3,
         "kappa": 2.55, "delta_sigma": 0.02},
    ],
}
FOREST = {"type": "stumps", "N_trees": 4,
          "source_walls": {"x0": True, "x1": True, "y0": True, "y1": True,
                           "z0": False, "z1": False}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: under the test runner's workers, torch's parallel
    regions wait on threads that are not running."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _empty_log():
    trace.clear()
    yield
    trace.clear()


def _profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _events(prof, prefix="octa."):
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith(prefix)]


def test_off_logs_nothing_and_shares_one_object():
    a, b = trace.span("octa.test.a"), trace.span("octa.test.b")
    assert a is b is trace.OFF
    with trace.span("octa.test.a") as s:
        s.note(n=1)
        torch.ones(4).sum()
    assert list(trace.iterate("octa.test.wait", [1, 2])) == [1, 2]
    assert trace.log() == [] and trace.dropped() == 0


def test_spans_are_profiler_events_on_the_same_clock():
    with _profiled() as prof:
        with trace.span("octa.test.outer") as outer:
            with trace.span("octa.test.inner"):
                torch.ones(64).sum()
            outer.note(count=3)
        assert list(trace.iterate("octa.test.wait", "ab")) == ["a", "b"]
    log = trace.log()
    events = _events(prof)
    assert sorted(e[0] for e in log) == sorted(e[0] for e in events)
    # three waits: two items and the end of the iterable
    assert [e[0] for e in log].count("octa.test.wait") == 3
    for name, t0, t1, _, notes in log:
        match = [e for e in events if e[0] == name
                 and abs(e[1] - t0) < 100_000 and abs(e[2] - t1) < 100_000]
        assert match, (name, t0, t1, events)
        assert t1 >= t0
        assert notes == ({"count": 3} if name == "octa.test.outer" else None)
    inner = next(e for e in log if e[0] == "octa.test.inner")
    outer = next(e for e in log if e[0] == "octa.test.outer")
    assert outer[1] <= inner[1] <= inner[2] <= outer[2]
    assert inner[3] == outer[3]  # the thread's id


def test_log_stops_at_its_cap(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 5)
    with _profiled():
        for _ in range(8):
            with trace.span("octa.test.x"):
                pass
    assert len(trace.log()) == 5 and trace.dropped() == 3
    trace.clear()
    assert trace.log() == [] and trace.dropped() == 0


def test_totals_sum_the_log_by_name():
    entries = [("octa.test.a", 1_000_000, 3_500_000, 1, {"n": 2}),
               ("octa.test.b", 2_000_000, 2_250_000, 1, None),
               ("octa.test.a", 5_000_000, 6_000_000, 2, {"n": 3, "m": 1})]
    assert trace.totals(entries) == {
        "octa.test.a": {"count": 2, "host_ms": 3.5, "notes": {"n": 5, "m": 1}},
        "octa.test.b": {"count": 1, "host_ms": 0.25, "notes": {}}}
    assert trace.totals() == {}
    with _profiled():
        for _ in range(3):
            with trace.span("octa.test.x") as s:
                s.note(k=1)
    got = trace.totals()
    assert list(got) == ["octa.test.x"]
    assert got["octa.test.x"]["count"] == 3
    assert got["octa.test.x"]["notes"] == {"k": 3}
    assert got["octa.test.x"]["host_ms"] == pytest.approx(
        sum(t1 - t0 for _, t0, t1, _, _ in trace.log()) * 1e-6)


def test_growth_spans_match_its_stage_log():
    g = tg.Greenhouse(CONFIG, node_capacity=1024, sink_capacity=4096,
                      seed=1, device="cpu")
    with _profiled() as prof:
        g.develop_forest(FOREST, batch=2, final_murray_sweeps=8)
    log = trace.log()
    names = [e[0] for e in log]
    counts = g.stage_counts()
    assert counts["redone"] > 0  # the first sink forecast overflowed
    assert counts["iterations"] == sum(e["seg_len"] for e in g.stage_log)
    assert counts["redone"] == sum(e["seg_len"] for e in g.stage_log
                                   if not e["accepted"])
    assert names.count("octa.grow.iteration") == counts["iterations"]
    assert names.count("octa.grow.read") == g.host_syncs == counts["host_syncs"]
    assert names.count("octa.grow.restage") == len(g.stage_log)
    assert names.count("octa.grow.final_murray") == 1
    # four nearest scans and one in-loop Murray sweep an iteration
    assert names.count("octa.grow.nearest") == 4 * counts["iterations"]
    assert names.count("octa.grow.murray") == counts["iterations"]
    batch = [e for e in log if e[0] == "octa.grow.batch"]
    assert len(batch) == 1 and batch[0][4] == counts
    assert all(batch[0][1] <= e[1] and e[2] <= batch[0][2] for e in log)
    assert sorted(names) == sorted(e[0] for e in _events(prof))


def _seg_config():
    model = {"name": "DynUNet", "spatial_dims": 2, "in_channels": 1,
             "out_channels": 1, "kernel_size": [3, 3, 3, 3],
             "strides": [1, 2, 2, 1], "upsample_kernel_size": [1, 2, 2, 1],
             "filters": [8, 16, 32, 32]}
    return {"General": {"task": "ves-seg", "seed": 3, "amp": False,
                        "model": model},
            "Train": {"lr": 1e-4, "weight_decay": 1e-3,
                      "loss": "DiceBCELoss", "epochs": 4, "epochs_decay": 2,
                      "batch_size": 2},
            "Output": {"save_dir": "unused"}}


class _Args:
    start_epoch = 0
    epoch = "latest"
    split = ""
    save_latest = True


def test_segmentation_step_nests_its_stages():
    rng = np.random.default_rng(0)
    batch = {"image": rng.random((2, 1, 32, 32)).astype(np.float32),
             "label": (rng.random((2, 1, 32, 32)) < 0.3).astype(np.float32)}
    cfg = _seg_config()
    model = talg.define_model(cfg, Phase.TRAIN, "cpu")
    model.initialize_model_and_optimizer(batch, cfg, _Args(),
                                         phase=Phase.TRAIN)
    with _profiled():
        _, losses = model.perform_training_step(batch, {})
    assert np.isfinite(losses["DiceBCELoss"])
    log = trace.log()
    (step,) = [e for e in log if e[0] == "octa.train.step"]
    inside = sorted((e for e in log if e[0] != "octa.train.step"),
                    key=lambda e: e[1])
    assert [e[0] for e in inside] == [
        "octa.train.forward", "octa.train.backward", "octa.train.optimizer",
        "octa.train.read_losses"]
    assert all(step[1] <= e[1] <= e[2] <= step[2] for e in inside)
    assert all(a[2] <= b[1] for a, b in zip(inside, inside[1:]))
