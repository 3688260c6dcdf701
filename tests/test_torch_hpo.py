"""Port parity: the HPO harness (``utils/hpo.py``) and the three searches
(``bayesOpt``, ``bayesOpt_skrgan``, ``bayesOpt_noise``).

The harness is numpy on the host in both packages: for one seed, space and
objective, ``tune`` and ``tune_sha`` (random and TPE samplers) propose the
same trials and return the same best result, exactly. ``bayesOpt``: a narrow
DynUNet (filters 8-16) at 64² with the JAX package's weights, read by both
from one checkpoint; the port's cached raw predictions agree with the JAX
package's within 3e-5 (float32 through five levels from equal inputs; they
read 1.7e-5 on logits up to 1.5, where ``test_torch_train.py``'s four-level
net is held to 1e-5), and the
post-processing search over one set of raw predictions (the JAX package's)
gives the JAX package's trials and DSCs exactly. ``bayesOpt_skrgan``'s
search gives the JAX package's trials over the same images.
``bayesOpt_noise``: at 32² / 64² with 2 trials, the promoted trial resumes
its run directory. The root scripts run their searches under ``__main__``
only, so the JAX side is their code over the JAX package's modules.
"""
import copy
import csv
import json
import os

import numpy as np
import pytest
import torch

from octa_tpu.utils import hpo as jhpo
from octa_tpu_torch import bayesOpt as bo
from octa_tpu_torch import bayesOpt_noise as bon
from octa_tpu_torch import bayesOpt_skrgan as bos
from octa_tpu_torch.data.transforms import CastToType
from octa_tpu_torch.tools.seg_data import make_seg_dataset, point_config_at
from octa_tpu_torch.utils import hpo as thpo
from octa_tpu_torch.utils.config import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(ROOT, "configs")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spaces(mod):
    return {"x": mod.Uniform(-1.0, 2.0), "n": mod.UniformInt(0, 40),
            "c": mod.Choice([0.1, 0.2, 0.5, 1.0, 2.0, 5.0])}


def _objective(p, budget=1, state=None):
    score = -(p["x"] - 0.3) ** 2 - 0.01 * (p["n"] - 17) ** 2 - abs(p["c"] - 0.5)
    return {"score": score * (1 + 1 / budget), "b": budget}


@pytest.mark.parametrize("seed", [0, 5])
def test_tune_proposes_the_jax_trials(seed):
    ours = thpo.tune(_spaces(thpo), _objective, "score", num_samples=30,
                     seed=seed, verbose=False)
    ref = jhpo.tune(_spaces(jhpo), _objective, "score", num_samples=30,
                    seed=seed, verbose=False)
    assert ours == ref
    assert len(ours[2]) == 30


@pytest.mark.parametrize("sampler", ["random", "tpe"])
def test_tune_sha_proposes_the_jax_trials(sampler):
    kw = dict(num_samples=27, min_budget=1, max_budget=9, reduction_factor=3,
              seed=3, verbose=False, sampler=sampler)
    ours = thpo.tune_sha(_spaces(thpo), _objective, "score", **kw)
    ref = jhpo.tune_sha(_spaces(jhpo), _objective, "score", **kw)
    assert ours == ref
    assert [h[1] for h in ours[2]].count(9) == 3 and ours[1]["b"] == 9


# ---------------------------------------------------------------------------
# bayesOpt and bayesOpt_skrgan on a stand-in validation split
# ---------------------------------------------------------------------------

class _Args:
    start_epoch = 0
    epoch = "best"
    split = ""
    save_latest = True


@pytest.fixture(scope="module")
def val_config(tmp_path_factory):
    """The S config at 64² (DynUNet 8-16 wide) on three stand-in validation
    pairs, with the JAX package's initial weights as its ``best`` model."""
    from octa_tpu.io import checkpoints as jck
    from octa_tpu.train import algorithms as jalg
    from octa_tpu.utils.enums import Phase as JPhase

    root = tmp_path_factory.mktemp("bayesopt")
    globs = make_seg_dataset(str(root / "data"), n_graphs=2, n_backgrounds=1,
                             n_val=3, background_res=32, val_res=64,
                             device="cpu", max_edges=120)
    cfg = point_config_at(load_config(os.path.join(CONFIGS, "config_ves_seg-S.yml")),
                          globs, str(root / "runs"))
    cfg["Validation"]["data_augmentation"][4]["spatial_size"] = [64, 64]
    cfg["General"]["model"]["filters"] = [8, 16, 16, 16, 16]
    cfg["General"]["amp"] = False
    j = jalg.define_model(cfg, JPhase.TRAIN)
    rng = np.random.default_rng(1)
    batch = {"image": rng.random((1, 1, 64, 64), np.float32),
             "label": (rng.random((1, 1, 64, 64)) < 0.3).astype(np.float32)}
    j.initialize_model_and_optimizer(batch, cfg, _Args(), phase=JPhase.TRAIN)
    jck.save_checkpoint(str(root / "runs" / "checkpoints" / "best_model_model.ckpt"),
                        {"epoch": 1, "model": j.params["model"]})
    return cfg


def _jax_raw(cfg):
    """The root ``bayesOpt.py``'s cache, over the JAX package."""
    from octa_tpu.data.dataset import get_dataset
    from octa_tpu.train.algorithms import define_model
    from octa_tpu.utils.enums import Phase

    cfg[Phase.VALIDATION]["batch_size"] = 1
    loader = get_dataset(cfg, Phase.VALIDATION)
    model = define_model(cfg, Phase.VALIDATION)
    model.initialize_model_and_optimizer(next(iter(loader)), cfg, _Args(),
                                         phase=Phase.VALIDATION)
    raw = []
    for mini_batch in loader:
        outputs, _ = model.inference(
            mini_batch, {"prediction": None, "label": None},
            phase=Phase.VALIDATION)
        raw.append((np.asarray(outputs["prediction"][0]),
                    np.asarray(outputs["label"][0])))
    return raw


def _jax_eval_fn(raw):
    """The root ``bayesOpt.py``'s ``eval_fn``, over the JAX package."""
    from octa_tpu.data.transforms import (Activations, AsDiscrete, CastToType,
                                          Compose, RemoveSmallObjects)
    from octa_tpu.utils.enums import Phase
    from octa_tpu.utils.metrics import MetricsManager

    def eval_fn(params):
        post = Compose([Activations(sigmoid=True),
                        AsDiscrete(threshold=params["threshold"]),
                        RemoveSmallObjects(min_size=params["min_size"])])
        metrics = MetricsManager(Phase.TRAIN)
        for pred, label in raw:
            metrics([np.asarray(post(pred))], [CastToType(dtype="uint8")(label)])
        return metrics.aggregate_and_reset(str(Phase.VALIDATION))

    return eval_fn


def test_bayesopt_caches_and_searches_as_jax(val_config):
    ref_raw = _jax_raw(copy.deepcopy(val_config))
    ours_raw = bo.cache_predictions(copy.deepcopy(val_config), _Args(), "cpu")
    assert len(ours_raw) == len(ref_raw) == 3
    for (p, lab), (rp, rlab) in zip(ours_raw, ref_raw):
        assert tuple(p.shape) == rp.shape == (1, 64, 64)
        np.testing.assert_allclose(p.numpy(), rp, atol=3e-5)
        np.testing.assert_array_equal(lab, rlab.astype(np.uint8))
    # the search over the JAX package's raw predictions, in both packages
    shared = [(torch.from_numpy(np.array(rp)), CastToType(dtype="uint8")(rlab))
              for rp, rlab in ref_raw]
    kw = dict(metric="Validation_DSC", mode="max", num_samples=16, seed=2,
              verbose=False)
    ours = thpo.tune(bo.search_space(), bo.make_eval_fn(shared), **kw)
    space = {"min_size": jhpo.UniformInt(0, 64),
             "threshold": jhpo.Choice(list(np.arange(0.01, 0.9, 0.01)))}
    ref = jhpo.tune(space, _jax_eval_fn(ref_raw), **kw)
    assert ours == ref
    dsc = [h[1]["Validation_DSC"] for h in ours[2]]
    assert len(set(dsc)) > 3 and max(dsc) > 0


def test_bayesopt_cli_runs_on_the_cpu_when_told(val_config, tmp_path,
                                                monkeypatch):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(val_config))
    for mod in (bo, bos):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.main(["--config_file", str(path)])
        monkeypatch.undo()
        best, result, history = mod.main(
            ["--config_file", str(path), "--num_samples", "3", "--device", "cpu"])
        assert len(history) == 3 and result == max(
            (h[1] for h in history), key=lambda r: r["Validation_DSC"])


def test_skrgan_search_matches_jax(val_config):
    from octa_tpu.data.dataset import get_dataset
    from octa_tpu.ops.filters import skrgan_sketch
    from octa_tpu.utils.enums import Phase
    from octa_tpu.utils.metrics import MetricsManager

    cfg = copy.deepcopy(val_config)
    cfg["Validation"]["batch_size"] = 1
    ref_samples = [(np.asarray(b["image"])[0], np.asarray(b["label"])[0])
                   for b in get_dataset(cfg, Phase.VALIDATION)]
    ours_samples = bos.load_samples(copy.deepcopy(val_config), "cpu")
    for (img, lab), (rimg, rlab) in zip(ours_samples, ref_samples, strict=True):
        np.testing.assert_allclose(img, rimg, atol=1e-6)
        np.testing.assert_array_equal(lab, rlab)

    def ref_eval(params):  # the root bayesOpt_skrgan.py's eval_fn
        metrics = MetricsManager(Phase.TRAIN)
        for img, label in ref_samples:
            sketch = skrgan_sketch(
                img, sigma=params["sigma"],
                area_threshold_open=params["area_threshold_open"],
                area_threshold_close=params["area_threshold_close"])
            pred = (sketch > params["threshold"]).astype(np.float32)
            metrics([pred[None]], [(label > 0.5).astype(np.uint8)])
        return metrics.aggregate_and_reset(str(Phase.VALIDATION))

    space = {"area_threshold_open": jhpo.UniformInt(1, 96),
             "area_threshold_close": jhpo.UniformInt(1, 96),
             "sigma": jhpo.UniformInt(0, 5), "threshold": jhpo.Uniform(0.5, 0.9)}
    kw = dict(metric="Validation_DSC", mode="max", num_samples=6, seed=4,
              verbose=False)
    ours = thpo.tune(bos.search_space(), bos.make_eval_fn(ref_samples), **kw)
    assert ours == jhpo.tune(space, ref_eval, **kw)


# ---------------------------------------------------------------------------
# bayesOpt_noise: successive halving over short trainings
# ---------------------------------------------------------------------------

def test_bayesopt_noise_promotion_resumes_the_run(tmp_path, monkeypatch):
    """2 trials of 1 epoch at 32² / 64²; the better one is promoted to 3
    epochs and resumes its run directory: a fresh sibling run that carries
    the first epoch's checkpoints and metrics and trains the other two."""
    globs = make_seg_dataset(str(tmp_path / "data"), n_graphs=2,
                             n_backgrounds=1, n_val=1, background_res=32,
                             val_res=64, device="cpu", max_edges=120)
    cfg = point_config_at(load_config(os.path.join(
        CONFIGS, "experiment_configs", "config_ves_seg-S_RA.yml")), globs,
        str(tmp_path / "runs"))
    for a in cfg["Train"]["data_augmentation"]:
        if a["name"] == "LoadGraphAndFilterByRandomRadiusd":
            a["image_resolutions"] = [[32, 32], [64, 64]]
        elif a["name"] == "Resized":
            a["spatial_size"] = [32, 32] if a["keys"] == ["background"] \
                else [64, 64]
    cfg["Validation"]["data_augmentation"][4]["spatial_size"] = [64, 64]
    cfg["General"]["model"]["filters"] = [8, 16, 16, 16, 16]
    cfg["Train"].update(batch_size=2, epochs_decay=0)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bon.main(["--config_file", str(path)])
    monkeypatch.undo()
    best, result, history = bon.main(
        ["--config_file", str(path), "--num_samples", "2", "--max_budget", "3",
         "--epochs_per_trial", "1", "--sampler", "random", "--device", "cpu"])
    assert [h[1] for h in history] == [1, 1, 3]
    first = [h[2] for h in history if h[0] == best and h[1] == 1]
    assert len(first) == 1 and result["epochs_done"] == 3
    assert result["trial_dir"] != first[0]["trial_dir"]
    assert os.path.dirname(result["trial_dir"]) == os.path.dirname(
        first[0]["trial_dir"])
    with open(os.path.join(result["trial_dir"], "metrics.csv")) as f:
        assert [r["epoch"] for r in csv.DictReader(f)] == ["0", "1", "2"]
    assert os.path.exists(os.path.join(result["trial_dir"], "checkpoints",
                                       "latest_model_model.ckpt"))
    # the trial's values reached the Train chain
    snap = load_config(os.path.join(result["trial_dir"], "config.yml"))
    chain = {a["name"]: a for a in snap["Train"]["data_augmentation"]}
    assert chain["NoiseModeld"]["lambda_speckle"] == best["lambda_speckle"]
    assert chain["RandomDecreaseResolutiond"]["max_factor"] == \
        best["max_decrease_res"]
