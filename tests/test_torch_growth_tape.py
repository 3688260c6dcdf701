"""Growth's iterations replayed from tapes (``octa_tpu_torch.sim.greenhouse``:
``Tape``, ``Tapes``, ``tape_key``, ``_kernel``).

On the CPU: the tape key separates what an iteration's Python bakes in; an
eager iteration makes its kernel calls through the module's globals, so
that a stand-in such as the benchmark's ``Recorder`` sees each of them in
order; and off CUDA nothing is recorded. On a card (marker ``card``;
``python -m pytest tests -m card``): segments replayed from tapes give the
eager segments' bits and the growth digests, a stand-in sees the eager
calls with the eager tensors, K6 launches once an iteration, two tapes
sharing the pool alternate soundly, and the batch's ``graphed`` and
``recorded`` counts.
"""
import pytest
import torch

from octa_bench.drivers.grow_segment import Recorder, _patched
from octa_tpu_torch.ops.spacing import SPACING
from octa_tpu_torch.sim import greenhouse as tg

CONFIG = {
    "SimulationSpace": {"no_voxel_x": 1, "no_voxel_y": 1,
                        "no_voxel_z": 0.0131},
    "d": 0.1, "r": 0.0025,
    "FAZ_radius_bound": [0.44, 0.04],
    "rotation_radius": 1.05,
    "FAZ_center": [0.5, 0.5],
    "param_scale": 3,
    "modes": [
        {"name": "SVC", "I": 30, "N": 400, "eps_n": 0.18, "eps_s": 0.135,
         "eps_k": 0.135, "delta_art": 0.2925, "delta_ven": 0.2925,
         "gamma_art": 50, "gamma_ven": 50, "phi": 15, "omega": 0.3,
         "kappa": 2.55, "delta_sigma": 0.02},
        {"name": "DVC", "I": 20, "N": 400, "eps_n": 0.09, "eps_s": 0.0675,
         "eps_k": 0.0675, "delta_art": 0.15, "delta_ven": 0.15,
         "gamma_art": 90, "gamma_ven": 90, "phi": 15, "omega": 0,
         "kappa": 2.9, "delta_sigma": 0.02},
    ],
}
FOREST = {"type": "stumps", "N_trees": 4,
          "source_walls": {"x0": True, "x1": True, "y0": True, "y1": True,
                           "z0": False, "z1": False}}
BATCH, NC, SC, SWEEPS = 2, 512, 1024, 4


@pytest.fixture(autouse=True, scope="module")
def _warm_sqrt():
    torch.sqrt(torch.rand(1 << 20))


def _state(g, batch=BATCH, nc=NC, sc=SC, seed=0):
    return tg._tree_map(lambda *xs: torch.stack(xs), *[
        g.init_state(FOREST, seed + i, node_capacity=nc, sink_capacity=sc)
        for i in range(batch)])


def _segment(g, state, mode, t0, i0, seg_len, ecap=256, tapes=None,
             sweeps=SWEEPS):
    return tg.run_mode(
        state, g.modes[mode], t0, param_scale=g.param_scale, r0=g.r,
        rotation_radius=g.rotation_radius, faz_center=g._faz_center,
        size_z=g.sizes[2], murray_sweeps=sweeps, i0=i0, seg_len=seg_len,
        nerve_center=g.nerve_center, nerve_radius=g.nerve_radius,
        geometry=g.geometry, new_cap=ecap, generator=g.generator,
        banded=g.banded, draw_rows=g._draw_rows, tapes=tapes)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

def _key(g, **change):
    """``tape_key`` of a reference iteration, with one input changed."""
    a = dict(mode=1, i=7, t=40, batch=BATCH, nc=NC, sc=SC, new_cap=256,
             sweeps=SWEEPS, banded=False, draw_rows=(4, 0, 2))
    a.update(change)
    st = tg._stack_state(_state(g, a["batch"], a["nc"], a["sc"]))
    return tg.tape_key(g.modes[a["mode"]], a["i"], a["t"], st, a["new_cap"],
                       a["sweeps"], a["banded"], a["draw_rows"])


@pytest.fixture(scope="module")
def cpu_house():
    return tg.Greenhouse(CONFIG, node_capacity=NC, sink_capacity=SC, seed=1,
                         device="cpu")


@pytest.mark.parametrize("change", [
    {"mode": 0}, {"i": 0}, {"t": 15}, {"batch": 3}, {"nc": 1024},
    {"sc": 2048}, {"new_cap": 512}, {"sweeps": 2}, {"banded": True},
    {"draw_rows": (4, 2, 4)}, {"draw_rows": None}],
    ids=lambda c: next(iter(c)))
def test_tape_key_separates(cpu_house, change):
    assert _key(cpu_house, **change) != _key(cpu_house)


@pytest.mark.parametrize("same", [{"i": 1}, {"i": 49, "t": 16}, {"t": 99}],
                         ids=["i", "i_t", "t"])
def test_tape_key_shared_within_a_segment(cpu_house, same):
    """Iterations after a mode's first share a tape on either side of
    iteration 15; their index is not part of the key."""
    assert _key(cpu_house, **same) == _key(cpu_house)


@pytest.mark.parametrize("banded", [False, True], ids=["plain", "banded"])
def test_eager_iteration_calls_kernels_through_the_module(banded):
    """One eager iteration makes 4 nearest scans and 1 + ``SWEEPS`` segment
    sums through the module's globals, which the benchmark's ``Recorder``
    numbers in this order: K2 (or K5 where banded) the fused three-row scan,
    the candidates against the arterial nodes and against the oxygen sinks,
    then K2 the sinks against the new nodes; K3 the 18-feature sum, then
    one 1-feature sum a Murray sweep."""
    g = tg.Greenhouse(CONFIG, node_capacity=NC, sink_capacity=SC, seed=1,
                      device="cpu", banded=banded)
    st = tg._stack_state(_state(g))
    g.generator.manual_seed(1)
    names = ("masked_nearest", "segment_sum", "masked_nearest_banded",
             "_blocked_greedy_spacing")
    rec = {n: Recorder(getattr(tg, n), range(8)) for n in names}
    undo = _patched(tg, **rec)
    try:
        tg._iteration(st, g.modes[0], 1, 1, param_scale=g.param_scale,
                      r0=g.r, rotation_radius=g.rotation_radius,
                      faz_center=g._faz_center, size_z=g.sizes[2],
                      n_cand=400, murray_sweeps=SWEEPS, new_cap=256,
                      generator=g.generator, banded=banded)
    finally:
        undo()
    near, band = rec["masked_nearest"], rec["masked_nearest_banded"]
    scans = ([band.kept[k] for k in range(3)] + [near.kept[0]] if banded
             else [near.kept[k] for k in range(4)])
    assert (near.calls, band.calls) == ((1, 3) if banded else (4, 0))
    sq = SC + 400
    assert [tuple(a[0].shape) for a, _, _ in scans] == [
        (3 * BATCH, sq, 3), (BATCH, 400, 3), (BATCH, 400, 3),
        (2 * BATCH, sq, 3)]
    assert [tuple(a[1].shape) for a, _, _ in scans] == [
        (3 * BATCH, NC, 3), (BATCH, NC, 3), (BATCH, SC, 3),
        (2 * BATCH, 256, 3)]
    assert [kw.get("want_idx", True) for _, kw, _ in scans] == [
        True, True, False, False]
    sums = rec["segment_sum"]
    assert sums.calls == 1 + SWEEPS
    assert [tuple(sums.kept[k][0][1].shape) for k in range(sums.calls)] == [
        (2 * BATCH, sq, 18)] + [(2 * BATCH, NC, 1)] * SWEEPS
    assert rec["_blocked_greedy_spacing"].calls == 1


def test_cpu_growth_stays_eager():
    """Off CUDA the tapes record nothing and the segment is the eager one."""
    g = tg.Greenhouse(CONFIG, node_capacity=NC, sink_capacity=SC, seed=2,
                      device="cpu")
    state = _state(g)
    g.generator.manual_seed(2)
    eager = _segment(g, state, 0, 0, 0, 4)
    g.generator.manual_seed(2)
    tapes = tg.Tapes()
    taped = _segment(g, state, 0, 0, 0, 4, tapes=tapes)
    assert len(tapes) == 0 and tapes.graphed == tapes.recorded == 0
    for a, b in zip(tg._leaves(tg._stack_state(eager)),
                    tg._leaves(tg._stack_state(taped))):
        assert torch.equal(a, b)
    g.develop_forest(FOREST, batch=2, final_murray_sweeps=2)
    counts = g.stage_counts()
    assert counts["graphed"] == counts["recorded"] == 0
    assert counts["iterations"] >= 50


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _full(banded=False, seed=0):
    from octa_tpu_torch.sim.configs import vessel_graph_gen

    cfg = vessel_graph_gen()
    return cfg, tg.Greenhouse(cfg["Greenhouse"], seed=seed, banded=banded)


def _staged(g, cfg, batch, cap, scap):
    """The batch's initial state at capacities ``cap`` / ``scap``, as
    ``develop_forest`` stages a segment."""
    g._draw_rows = (batch, 0, batch)
    state = tg._tree_map(lambda *xs: torch.stack(xs), *[
        g.init_state(cfg["Forest"], g.seed + i, node_capacity=1024,
                     sink_capacity=1024) for i in range(batch)])
    state = tg._resize_sinks(tg._resize_forests(state, cap), scap)
    return tg._restage_spatial(state) if g.banded else state


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(
        tg._leaves(tg._stack_state(a)), tg._leaves(tg._stack_state(b))))


def _both(g, state, segments, tapes):
    """The segments ``(mode, t0, i0, seg_len, ecap)`` from ``state``, each
    from the generator's state before it, eager and from ``tapes``; asserts
    each pair equal bit for bit and returns the last state."""
    for mode, t0, i0, seg_len, ecap in segments:
        gen = g.generator.get_state()
        eager = _segment(g, state, mode, t0, i0, seg_len, ecap)
        g.generator.set_state(gen)
        state = _segment(g, state, mode, t0, i0, seg_len, ecap, tapes=tapes)
        assert _equal(eager, state), (mode, t0, i0)
    return state


# SVC's first segment (mode entry eager, the FAZ rotation's start at t 16,
# so two tapes), then a segment that replays its second tape from entry
SEGMENTS = [(0, 0, 0, 24, 1024), (0, 0, 24, 10, 1024)]


@pytest.mark.card
@pytest.mark.parametrize("batch,banded", [(8, False), (32, False),
                                          (8, True)],
                         ids=["b8", "b32", "banded"])
def test_taped_segments_are_the_eager_segments(batch, banded):
    _card()
    cfg, g = _full(banded)
    state = _staged(g, cfg, batch, 6144, 6144)
    g.generator.manual_seed(0)
    tapes = tg.Tapes()
    _both(g, state, SEGMENTS, tapes)
    assert tapes.recorded == 2 and len(tapes) == 2
    assert tapes.graphed == (24 - 3) + 10


@pytest.mark.card
@pytest.mark.parametrize("batch,banded,digest", [
    (8, False, "30a8e3ea94e154f0"), (32, False, "3c0082ce8dcf2163"),
    (8, True, "1c5971e6ca377886")], ids=["b8", "b32", "banded"])
def test_grown_digests_with_tapes(batch, banded, digest):
    """The full schedule, grown twice by one Greenhouse (the second batch
    replays the tapes the first recorded), gives the eager growth's
    digests (``tools/time_growth.py``), and counts its tapes."""
    from octa_tpu_torch.tools.time_growth import forest_digest

    _card()
    cfg, g = _full(banded)
    for rep in range(2):
        launches = SPACING.launches
        state = g.develop_forest(cfg["Forest"], batch=batch)
        assert f"sha256 {digest}" in forest_digest(state)
        counts = g.stage_counts()
        iters = counts["iterations"]
        entries = sum(e["i0"] == 0 for e in g.stage_log)
        assert SPACING.launches - launches == iters
        assert counts["graphed"] + counts["recorded"] + entries <= iters
        assert counts["graphed"] >= 0.9 * iters
        if rep == 0:
            assert counts["recorded"] >= 3
        elif len(g.tapes) < tg.Tapes.MAX:  # every key kept: all replayed
            assert counts["recorded"] == 0
            assert counts["graphed"] == iters - entries


@pytest.mark.card
def test_recorder_sees_the_eager_calls():
    """A ``Recorder`` over K2 and K3, as the benchmark patches them, keeps
    the same calls with the same inputs and outputs, replayed or eager."""
    _card()
    cfg, g = _full()
    state = _staged(g, cfg, 8, 6144, 6144)
    picks = [0, 5, 9, 33, 70, 95]  # of 96 K2 and 120 K3 calls
    kept = []
    for tapes in (None, tg.Tapes(), "replay"):
        if tapes == "replay":
            tapes = kept[-1][1]
        g.generator.manual_seed(3)
        rec = {n: Recorder(getattr(tg, n), picks)
               for n in ("masked_nearest", "segment_sum")}
        undo = _patched(tg, **rec)
        try:
            _segment(g, state, 0, 0, 0, 24, 1024, tapes=tapes)
        finally:
            undo()
        kept.append((rec, tapes))
    # eager at the mode's entry; the first taped segment records two
    # tapes, the second replays them from its second iteration
    assert kept[2][1].recorded == 2 and kept[2][1].graphed == 21 + 23
    for rec, _ in kept[1:]:
        for n, r in rec.items():
            want = kept[0][0][n]
            assert r.calls == want.calls == 24 * (4 if n == "masked_nearest"
                                                  else 1 + SWEEPS)
            assert sorted(r.kept) == sorted(want.kept) == picks
            for k in picks:
                (a, kw, o), (wa, wkw, wo) = r.kept[k], want.kept[k]
                assert kw == wkw
                for x, y in zip((*a, *tg._tuple(o)), (*wa, *tg._tuple(wo))):
                    assert torch.equal(x, y) if torch.is_tensor(x) else x == y


@pytest.mark.card
def test_spacing_launches_once_an_iteration():
    _card()
    cfg, g = _full()
    state = _staged(g, cfg, 8, 6144, 6144)
    tapes = tg.Tapes()
    g.generator.manual_seed(4)
    for seg in range(2):
        launches = SPACING.launches
        state = _segment(g, state, 0, 0, 12 * seg, 12, 1024, tapes=tapes)
        assert SPACING.launches - launches == 12
    assert tapes.graphed == (12 - 3) + 12


@pytest.mark.card
def test_two_tapes_share_the_pool_alternately():
    """Two batches at different capacities (two tapes, one pool), grown a
    segment each in turn: every segment still gives the eager bits."""
    _card()
    cfg, g = _full()
    states = [_staged(g, cfg, 8, 6144, 6144), _staged(g, cfg, 8, 8192, 6144)]
    tapes = tg.Tapes()
    g.generator.manual_seed(5)
    for i0 in (1, 11, 21):
        for b in range(2):
            states[b] = _both(g, states[b], [(1, 100, i0, 10, 1024)], tapes)
    assert tapes.recorded == 2 and len(tapes) == 2
    assert tapes.graphed == 2 * 8 + 4 * 10
