"""Port parity for the paper's classical baselines: ``frangi``, ``oof`` and
``skrgan`` through both packages' registries on the same seeded images, and
``python -m octa_tpu_torch.validate`` / ``test`` on
``configs/config_frangi.yml`` and ``config_oof.yml`` (parameterless models:
no checkpoint) against the JAX package's validation loop.

Tolerances with their readings on a CPU: frangi within 1e-5 absolute
(reads 3.0e-7), oof within 1e-4 absolute after its per-image normalisation
(float32 FFTs of two libraries; reads 2.4e-7), skrgan bit for bit (host numpy
and scipy in both), the validation metric dicts equal to their four printed
digits.
"""
import json
import os

import numpy as np
import pytest
import torch

from octa_tpu.data.dataset import get_dataset as jget_dataset
from octa_tpu.data.dataset import get_post_transformation as jget_post
from octa_tpu.models.registry import build_network as jbuild
from octa_tpu.train.algorithms import define_model as jdefine_model
from octa_tpu.utils.enums import Phase as JPhase
from octa_tpu.utils.metrics import MetricsManager as JMetrics
from octa_tpu_torch import test as ttest
from octa_tpu_torch import validate as tval
from octa_tpu_torch.models.registry import build_network as tbuild
from octa_tpu_torch.ops import filters
from octa_tpu_torch.tools.seg_data import make_seg_dataset, point_config_at
from octa_tpu_torch.utils.config import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(rng, b, res=48):
    """Smooth images in [0, 1] with a few bright lines, NCHW float32."""
    x = rng.random((b, 1, res, res)).astype(np.float32) * 0.2
    for i in range(b):
        for r in rng.integers(4, res - 4, 3):
            x[i, 0, r - 1:r + 2, :] += 0.6
    return np.clip(x, 0, 1)


@pytest.mark.parametrize("name,atol", [("frangi", 1e-5), ("oof", 1e-4)])
def test_baselines_match_jax(rng, name, atol):
    x = _images(rng, 2)
    ours = tbuild({"name": name})(torch.from_numpy(x))
    ref = np.asarray(jbuild({"name": name})(x))
    assert tuple(ours.shape) == ref.shape == (2, 1, 48, 48)
    np.testing.assert_allclose(ours.numpy(), ref, atol=atol)
    assert float(ours.std()) > 0


def test_skrgan_matches_jax(rng):
    x = _images(rng, 1)
    ours = tbuild({"name": "skrgan"})(torch.from_numpy(x))
    ref = jbuild({"name": "skrgan"})(x)
    assert tuple(ours.shape) == (1, 1, 48, 48)
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_oof_batches_per_sample(rng):
    """Each sample of a batch is filtered and normalised on its own."""
    x = _images(rng, 3)
    run = tbuild({"name": "oof"})
    batch = run(torch.from_numpy(x))
    for i in range(3):
        torch.testing.assert_close(batch[i:i + 1],
                                   run(torch.from_numpy(x[i:i + 1])))


@pytest.mark.parametrize("kw", [{"sigmas": (2.0,)}, {"black_ridges": True},
                                {"alpha": 0.5, "beta": 5.0}])
def test_frangi_options_match_jax(rng, kw):
    from octa_tpu.ops.filters import frangi as jfrangi

    x = _images(rng, 2)[:, 0]
    np.testing.assert_allclose(filters.frangi(torch.from_numpy(x), **kw).numpy(),
                               np.asarray(jfrangi(x, **kw)), atol=1e-5)


@pytest.fixture(scope="module")
def val_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("baselines")
    globs = make_seg_dataset(str(root / "data"), n_graphs=2, n_backgrounds=1,
                             n_val=2, background_res=32, val_res=64,
                             device="cpu", max_edges=200)
    return root, globs


def _config(root, globs, name):
    cfg = point_config_at(load_config(os.path.join(
        ROOT, "configs", f"config_{name}.yml")), globs, str(root / name))
    for phase in ("Validation", "Test"):
        for a in cfg[phase]["data_augmentation"]:
            if a["name"] == "Resized":
                a["spatial_size"] = [64, 64]
    path = root / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return str(path), cfg


def _jax_validate(cfg):
    """The root ``validate.py``'s loop in the JAX package, in process."""
    cfg = json.loads(json.dumps(cfg))
    cfg.setdefault("General", {}).setdefault("seed", 4958)
    cfg[JPhase.VALIDATION]["batch_size"] = 1
    loader = jget_dataset(cfg, JPhase.VALIDATION)
    post = jget_post(cfg, JPhase.VALIDATION)
    model = jdefine_model(cfg, JPhase.VALIDATION)
    model.initialize_model_and_optimizer(next(iter(loader)), cfg, None,
                                         phase=JPhase.VALIDATION)
    metrics = JMetrics(JPhase.VALIDATION)
    for mini_batch in loader:
        outputs, _ = model.inference(mini_batch, post, phase=JPhase.VALIDATION)
        model.compute_metric(outputs, metrics)
    result = metrics.aggregate_and_reset(str(JPhase.VALIDATION))
    return {k: round(v, 4) for k, v in result.items()}


@pytest.mark.parametrize("name", ["frangi", "oof"])
def test_validate_cli_runs_a_parameterless_model(val_data, name):
    root, globs = val_data
    path, cfg = _config(root, globs, name)
    ours = tval.main(["--config_file", path, "--device", "cpu"])
    assert not os.path.exists(os.path.join(cfg["Output"]["save_dir"],
                                           "checkpoints"))
    ref = _jax_validate(cfg)
    assert set(ours) == set(ref) >= {"Validation_DSC", "Validation_ClDice"}
    for k in ref:
        assert ours[k] == pytest.approx(ref[k], abs=1e-4), k


def test_test_cli_runs_a_parameterless_model(val_data, tmp_path):
    root, globs = val_data
    path, _ = _config(root, globs, "frangi")
    written = ttest.main(["--config_file", path, "--device", "cpu",
                          "--Test.save_dir", str(tmp_path)])
    assert sorted(os.path.basename(p) for p in written) == [
        "model_val_0.png", "model_val_1.png"]
