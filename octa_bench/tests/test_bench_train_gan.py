"""The GAN-training cells (``nice_gan.train``, ``gan_ves_seg.train``, the
``train_gan`` driver): their files are found by name, the driver runs at a
tiny size on the CPU and comes out correct, and each fault the limits were
set against fails at least one number: the control (the reference one
precision below in the program's place), half the batch left out, a
spectral norm's power iteration skipped, and a dropped D step.

Tiny sizes: NICE-GAN at 96² with ngf and ndf 8 and two adaILN blocks (its
global head needs 96² or more: five halvings, then a 4x4 conv), GAN-seg at
32² and 64²; float32 steps (``amp`` off), as ``tiny.py`` runs the engine's
cells."""
import copy
import time

import pytest
import torch

from octa_bench import flops_nice_gan, harness
from octa_bench.drivers import train_gan

CELLS = ("nice_gan.train", "gan_ves_seg.train")
RES = 96
#: GAN-seg's sizes: the PatchGAN needs 32² or more (three blurred halvings
#: and four 4x4 convs)
GAN_SEG_SIZES = {1216: 64, 304: 32}
#: NICE-GAN's numbers at the tiny size: the program steps in float32 there
#: (``amp`` off) and reads 1e-7-3e-5 in these three, where the cell's
#: limits are set for bfloat16 at 304² (1e-3-1e-2); the half batch reads
#: 0.019-0.094 in ``grad_cos`` and ``loss_rel``, under the cell's limits on
#: some seeds, so the tiny size holds them to limits between the two
TINY_NICE_LIMITS = {"grad_cos": 1e-3, "loss_rel": 1e-3, "u_rel": 1e-3}
SMALL_NETS = {"gen2A": {"ngf": 8, "n_blocks": 2, "img_size": RES},
              "gen2B": {"ngf": 8, "n_blocks": 2, "img_size": RES},
              "disA": {"ndf": 8}, "disB": {"ndf": 8}}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def resized(x, sizes: dict):
    """The run config with each size of ``sizes`` replaced."""
    if isinstance(x, dict):
        return {k: resized(v, sizes) for k, v in x.items()}
    if isinstance(x, list):
        return [resized(v, sizes) for v in x]
    if isinstance(x, int) and not isinstance(x, bool):
        return sizes.get(x, x)
    return x


def overrides(cell: harness.Cell) -> dict:
    cfg = cell.config
    traffic = {"data": {"graphs": 48, "backgrounds": 4, "images": 8,
                        "res": 16},
               "loader_samples": 2, "warm_steps": 3}
    if cfg["algorithm"] == train_gan.NICE:
        run = resized(cfg["run"], {304: RES})
        run["General"]["amp"] = False
        nw = copy.deepcopy(cfg["networks"])
        for k, v in SMALL_NETS.items():
            nw[k].update(v)
            run["General"]["model"][f"{k}_config"].update(v)
        traffic["data"]["res"] = RES
        for p in cfg["passes"]["train_step"]:
            assert p["hw"] == [304, 304]
        passes = [dict(p, hw=[RES, RES]) for p in cfg["passes"]["train_step"]]
        return {"config": {"run": run, "networks": nw,
                           "passes": {"train_step": passes}},
                "traffic": traffic}
    run = resized(cfg["run"], GAN_SEG_SIZES)
    run["General"]["amp"] = False
    run["General"]["model"]["upshape"] = [64, 64]
    return {"config": {"run": run}, "traffic": traffic}


def run_tiny(name: str, seed: int = 2 ** 33 + 11, calibrate=False):
    cell = harness.Cell(name)
    if cell.config["algorithm"] == train_gan.NICE:
        cell.limits = dict(cell.limits, **TINY_NICE_LIMITS)
    return harness.run_cell(cell, seed, 0.5, False, "cpu",
                            time.perf_counter(), overrides(cell),
                            calibrate=calibrate)


@pytest.mark.parametrize("name", CELLS)
def test_cell_finds_every_file(name):
    cell = harness.Cell(name)
    assert cell.traffic["kind"] == "train_gan"
    assert cell.driver_path.name == "train_gan.py"
    want = {"render_max_abs", "grad_cos", "change_gap", "loss_rel"}
    if cell.config["algorithm"] == train_gan.NICE:
        want |= {"u_rel"}
    assert set(cell.limits) == want
    reported = {m["name"] for m in cell.per_layer()}
    assert {"train_mfu", "step_ms.train", "device_idle_pct.train",
            "step_idle_ms.train"} <= reported
    nice = {"nice_d_ms.train", "nice_g_ms.train", "nice_sn_ms.train"}
    assert (nice <= reported) == (name == "nice_gan.train")
    assert {m["name"] for m in cell.end_to_end()} == {"train_img_per_s",
                                                      "setup_s"}


def test_nice_gan_config_is_the_shipped_one():
    """The configuration's networks are the shipped YAML's, at the published
    widths; the operations a step follow from its passes."""
    cell = harness.Cell("nice_gan.train")
    cfg = cell.config
    m = cfg["run"]["General"]["model"]
    for k in ("gen2A", "gen2B", "disA", "disB"):
        assert cfg["networks"][k] == m[f"{k}_config"]
    assert m["gen2B_config"]["ngf"] == 64 and m["disA_config"]["ndf"] == 64
    assert cfg["run"]["Train"]["batch_size"] == cfg["images_per_step"] == 4
    assert cfg["run"]["General"]["amp"] is True
    gflop = flops_nice_gan.passes_flops(cfg, "train_step") / 1e9
    # 4 images x (D half: 4 trained D passes, 2 G passes without gradients;
    # G half: 2 D passes without, 2 with gradients, 6 trained G passes)
    d = flops_nice_gan.network_flops(cfg["networks"], "disA", (304, 304))
    g = flops_nice_gan.network_flops(cfg["networks"], "gen2B", (304, 304))
    assert gflop == pytest.approx(4 * (20 * d + 20 * g) / 1e9)


def test_nice_gan_sound_control_and_faults():
    res = run_tiny("nice_gan.train", calibrate=True)
    run = res["_run"]
    assert res["correct"], res["checks"]
    assert run.record["units"] >= 1 and run.record["flops"] > 0
    limits = run.cell.limits
    assert not harness.judge(run.control, limits)[0]
    assert set(run.faults) == {"half_batch", "skipped_power_iteration"}
    for name, nums in run.faults.items():
        assert not harness.judge(nums, limits)[0], name
    skipped = dict(run.faults["skipped_power_iteration"])
    assert skipped["u_rel"] > limits["u_rel"]


def test_gan_seg_sound_control_and_half_batch():
    res = run_tiny("gan_ves_seg.train", calibrate=True)
    run = res["_run"]
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == {"render_max_abs", "grad_cos", "change_gap",
                                  "loss_rel"}
    assert not harness.judge(run.control, run.cell.limits)[0]
    assert not harness.judge(run.faults["half_batch"], run.cell.limits)[0]


def test_nice_gan_program_skipping_a_power_iteration(monkeypatch):
    """The program leaving out one spectral norm's power iteration a step
    (its ``u`` kept, the weight divided by ``|W^T u|``, not counted)."""
    from octa_tpu_torch.models import layers

    iterate = layers._SpectralNorm.iterate
    calls = {"n": 0}

    def skipping(self, update_stats=True):
        calls["n"] += 1
        if calls["n"] % 72 == 8:     # one call of the 72 a step
            w = self.weight
            with torch.no_grad():
                return (w.reshape(w.shape[0], -1).T @ self.u).norm()
        return iterate(self, update_stats)

    monkeypatch.setattr(layers._SpectralNorm, "iterate", skipping)
    res = run_tiny("nice_gan.train")
    assert not res["correct"]
    assert res["checks"]["u_rel"]["value"] > res["checks"]["u_rel"]["limit"]


def test_nice_gan_program_dropping_the_d_step(monkeypatch):
    """The program's D half step computes its losses but takes no Adam
    step: the discriminators never learn."""
    from octa_tpu_torch.train import gan_algorithms

    d_step = gan_algorithms.NiceGANAlgorithm.d_step

    def dropped(self, real_A, real_B):
        step = self.opt["D_optim"].step
        self.opt["D_optim"].step = lambda closure=None: None
        try:
            return d_step(self, real_A, real_B)
        finally:
            self.opt["D_optim"].step = step

    monkeypatch.setattr(gan_algorithms.NiceGANAlgorithm, "d_step", dropped)
    res = run_tiny("nice_gan.train")
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] > 0.9


def _uncounted_iterate(layers):
    """``_SpectralNorm.iterate`` without the count and span of power
    iterations, as the program had it before them: ``sigma``."""
    def iterate(self, update_stats=True):
        w = self.weight
        with torch.autocast(w.device.type, enabled=False):
            sigma, u_new = layers._power_iteration(
                w.reshape(w.shape[0], -1), self.u)
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u_new)
        return sigma

    return iterate


def test_driver_runs_a_program_without_the_counter(monkeypatch):
    """The driver reads no power-iteration counter: a program without one
    (as the program was before the counter and its spans) runs the
    NICE-GAN cell, and ``u_rel`` alone holds its power iterations."""
    from octa_tpu_torch.models import layers
    from octa_tpu_torch.train import gan_algorithms
    from octa_tpu_torch.utils import trace

    monkeypatch.delattr(layers._SpectralNorm, "power_iterations")
    monkeypatch.setattr(layers._SpectralNorm, "iterate",
                        _uncounted_iterate(layers))
    monkeypatch.setattr(gan_algorithms, "_iterations_noted", trace.span)
    res = run_tiny("nice_gan.train")
    assert res["correct"], res["checks"]

