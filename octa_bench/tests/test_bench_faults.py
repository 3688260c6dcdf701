"""Runs of each cell at a tiny size on the CPU (past the harness's look for
a card), sound and with the timed path broken underneath: the sound run
comes out correct; the control put in the program's place, and each fault
the cell can have, come out not correct."""
import pytest
import torch

from octa_bench import harness
from octa_bench.tests import tiny


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _correct(res):
    return res["correct"]


def test_segment_sound_and_control():
    res = tiny.run("gan_ves_seg.segment", calibrate=True)
    run = res["_run"]
    assert _correct(res), res["checks"]
    assert not harness.judge(run.control, run.cell.limits)[0]


def test_segment_half_the_batch_left_out(monkeypatch):
    from octa_tpu_torch import pipeline

    stages = pipeline.AdaptSegment.stages

    def half(self, e_in, e_lab, params, generator=None, gammas=None):
        n = e_in[0].shape[0] // 2
        out = stages(self, tuple(x[:n] for x in e_in),
                     tuple(x[:n] for x in e_lab),
                     type(params)(*(p[:n] for p in params)), generator)
        full = stages(self, e_in, e_lab, params, generator)
        return {k: torch.cat([v, v]) if k != "lab" else full[k]
                for k, v in out.items()}

    monkeypatch.setattr(pipeline.AdaptSegment, "stages", half)
    assert not _correct(tiny.run("gan_ves_seg.segment"))


def test_segment_answer_altered(monkeypatch):
    from octa_tpu_torch import pipeline

    segment = pipeline.AdaptSegment.segment

    def altered(self, fake):
        logits = segment(self, fake)
        k = logits.shape[2] // 8
        return torch.cat([-logits[:, :, :k], logits[:, :, k:]], 2)

    monkeypatch.setattr(pipeline.AdaptSegment, "segment", altered)
    assert not _correct(tiny.run("gan_ves_seg.segment"))


def test_train_sound_and_control():
    res = tiny.run("ves_seg_S.train", calibrate=True)
    run = res["_run"]
    assert _correct(res), res["checks"]
    assert not harness.judge(run.control, run.cell.limits)[0]


def test_train_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    res = tiny.run("ves_seg_S.train")
    assert not _correct(res)
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("where", ["loss", "step"])
def test_train_half_the_batch_left_out(monkeypatch, where):
    """The first half of each batch trained on, the mean taken over it: in
    the loss alone (every image's logits still returned), or in the whole
    step (the kept half's logits returned twice)."""
    from octa_tpu_torch.train.algorithms import SegAlgorithm

    step = SegAlgorithm.train_step

    def half(self, x, y):
        n = len(x) // 2
        if where == "step":
            pred, loss = step(self, x[:n], y[:n])
            return torch.cat([pred, pred]), loss
        loss_fn = self.loss_function
        self.loss_function = lambda p, t: loss_fn(p[:n], t[:n])
        try:
            return step(self, x, y)
        finally:
            self.loss_function = loss_fn

    monkeypatch.setattr(SegAlgorithm, "train_step", half)
    res = tiny.run("ves_seg_S.train")
    assert not _correct(res)
    assert res["checks"]["batch_weights"]["value"] > 0.5


def test_grow_sound_and_broken_tree(monkeypatch):
    res = tiny.run("gan_ves_seg.grow_segment")
    assert _correct(res), res["checks"]
    from octa_tpu_torch.sim import greenhouse

    develop = greenhouse.Greenhouse.develop_forest

    def broken(self, *a, **kw):
        state = develop(self, *a, **kw)
        parent = state.art.parent.clone()
        parent[:, 40] = 41             # a parent after its child
        return state._replace(art=state.art._replace(parent=parent))

    monkeypatch.setattr(greenhouse.Greenhouse, "develop_forest", broken)
    res = tiny.run("gan_ves_seg.grow_segment")
    assert not _correct(res)
    assert res["checks"]["growth_faults"]["value"] > 0


def test_grow_no_iterations(monkeypatch):
    """A growth that returns its initial stumps: the forests are sound
    trees, but nothing grew and no K2 or K3 call was made."""
    from octa_tpu_torch.sim import greenhouse

    monkeypatch.setattr(greenhouse.Greenhouse, "_run_segment",
                        lambda self, state, *a, **kw: state)
    res = tiny.run("gan_ves_seg.grow_segment")
    assert not _correct(res)
    assert res["checks"]["stump_share"]["value"] == pytest.approx(1.0)
    assert res["checks"]["growth_faults"]["value"] == 0


def test_grow_wrong_nearest(monkeypatch):
    """K2 answering with the next point's index and distance where a query
    has more than one admitted point."""
    from octa_tpu_torch.sim import greenhouse

    nearest = greenhouse.masked_nearest

    def wrong(query, points, masks, *, want_idx=True):
        d, i = nearest(query, points, masks, want_idx=True)
        j = (i.long() + 1).clamp(max=points.shape[1] - 1)
        at = torch.gather(points[:, None].expand(-1, j.shape[1], -1, -1), 2,
                          j[..., None].expand(-1, -1, -1, 3))
        d2 = (query[:, None] - at).pow(2).sum(-1).sqrt()
        admitted = torch.gather(masks, 2, j)
        d = torch.where(admitted & torch.isfinite(d), d2, d)
        i = torch.where(admitted, j, i.long()).to(i.dtype)
        return (d, i) if want_idx else d

    monkeypatch.setattr(greenhouse, "masked_nearest", wrong)
    res = tiny.run("gan_ves_seg.grow_segment")
    assert not _correct(res)
    assert res["checks"]["k2_gap"]["value"] > 1e-3


def test_grow_radii_in_bfloat16(monkeypatch):
    """The growth's Murray sweeps in bfloat16."""
    from octa_tpu_torch.sim import greenhouse

    sweep = greenhouse.murray_sweep

    def low(forest, sweeps, exact=None):
        f = sweep(forest, sweeps, exact)
        return f._replace(radius=f.radius.bfloat16().float())

    monkeypatch.setattr(greenhouse, "murray_sweep", low)
    res = tiny.run("gan_ves_seg.grow_segment")
    assert not _correct(res)
    assert res["checks"]["murray_gap"]["value"] > 1e-3
