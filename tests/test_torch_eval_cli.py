"""The port's evaluation CLIs, ``python -m octa_tpu_torch.validate`` and
``python -m octa_tpu_torch.test``, run as subprocesses on the CPU at a small
size on data made on the spot, with the shipped checkpoints
(``docker/trained_models``): the metric dict, one PNG per sample, a clean
stop after ``--num_samples``, the refusal of a generator-only GAN-seg model
in ``validate``, and the CLIs' need for a card unless told otherwise. The
CLIs' predictions are checked against the JAX package's networks on the
same inputs.
"""
import ast
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from octa_tpu.io import checkpoints as jck
from octa_tpu.models.registry import build_network as jbuild
from octa_tpu_torch import test as ttest
from octa_tpu_torch import validate as tval
from octa_tpu_torch.io.images import load_png_gray8
from octa_tpu_torch.io.visualizer import plot_comparison, plot_single_image
from octa_tpu_torch.tools.seg_data import make_seg_dataset, point_config_at
from octa_tpu_torch.utils.config import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAN_DIR = os.path.join(ROOT, "docker", "trained_models", "GAN")
SEG_CKPT = os.path.join(ROOT, "docker", "trained_models", "ves_seg-S-GAN",
                        "10_model.ckpt")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    globs = make_seg_dataset(str(root / "data"), n_graphs=3, n_backgrounds=2,
                             n_val=2, background_res=48, val_res=64,
                             device="cpu", max_edges=120)
    return root, globs


def _run(module, *args):
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=240, env=env)


def _s_gan_config(root, globs):
    """``configs/config_ves_seg-S_GAN.yml`` validating the shipped
    segmentor on the stand-in pairs at 64²."""
    cfg = point_config_at(load_config(os.path.join(
        ROOT, "configs", "config_ves_seg-S_GAN.yml")), globs, str(root / "runs"))
    for a in cfg["Validation"]["data_augmentation"]:
        if a["name"] == "Resized":
            a["spatial_size"] = [64, 64]
    cfg["Validation"]["post_processing"]["prediction"][-1]["min_size"] = 10
    cfg["Test"]["model_path"] = SEG_CKPT
    path = root / "s_gan.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_validate_cli_on_the_cpu(data):
    root, globs = data
    r = _run("octa_tpu_torch.validate", "--config_file",
             _s_gan_config(root, globs), "--device", "cpu",
             "--General.amp", "false")
    assert r.returncode == 0, r.stdout + r.stderr
    result = ast.literal_eval(r.stdout.strip().splitlines()[-1])
    assert {"Validation_DSC", "Validation_ClDice", "Validation_AUC"} <= set(result)
    assert all(np.isfinite(v) and 0 <= v <= 1 for v in result.values())
    assert result["Validation_DSC"] > 0.1  # the shipped segmentor finds vessels


def test_validate_refuses_a_generator_only_model(data, tmp_path):
    root, globs = data
    cfg = point_config_at(load_config(os.path.join(
        ROOT, "configs", "config_gan_ves_seg.yml")), globs, str(tmp_path))
    for key in ("image", "label"):
        cfg["Validation"]["data"][key].pop("split")
    path = tmp_path / "gan.json"
    path.write_text(json.dumps(cfg))
    assert cfg["General"]["inference"] == "G"
    with pytest.raises(ValueError, match="cannot be validated"):
        tval.main(["--config_file", str(path), "--device", "cpu"])


def _gan_test_config(root, globs):
    """``docker/trained_models/GAN/config.yml`` (the shipped generator) on
    the stand-in graphs and backgrounds at 48²."""
    cfg = load_config(os.path.join(GAN_DIR, "config.yml"))
    cfg["Test"]["data"]["real_A"]["files"] = globs["graphs"]
    cfg["Test"]["data"]["background"]["files"] = globs["backgrounds"]
    cfg["Test"]["model_path"] = os.path.join(GAN_DIR, "10_G_model.ckpt")
    cfg["Test"]["save_dir"] = str(root / "generated")
    cfg["Test"]["save_comparisons"] = True
    for a in cfg["Test"]["data_augmentation"]:
        if a["name"] == "LoadGraphAndFilterByRandomRadiusd":
            a["image_resolutions"] = [[48, 48]]
    path = root / "gan_test.json"
    path.write_text(json.dumps(cfg))
    return str(path), cfg["Test"]["save_dir"]


def test_test_cli_writes_one_png_per_sample(data):
    root, globs = data
    path, out = _gan_test_config(root, globs)
    r = _run("octa_tpu_torch.test", "--config_file", path, "--device", "cpu",
             "--num_samples", "2")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "Wrote 2 predictions" in r.stdout
    assert "the first in" in r.stdout and "the other 1 at" in r.stdout
    names = sorted(os.listdir(out))
    assert names == ["G_graph_0.png", "G_graph_1.png",
                     "comparison_G_graph_0.png", "comparison_G_graph_1.png"]
    img = load_png_gray8(os.path.join(out, "G_graph_0.png"))
    assert img.shape == (48, 48) and img.std() > 0


def test_test_cli_prediction_matches_jax(data, tmp_path, monkeypatch):
    """In process: the first prediction is the JAX package's generator (the
    shipped checkpoint) applied to the input the CLI gave the model."""
    from octa_tpu_torch.train import algorithms as talg

    root, globs = data
    path, _ = _gan_test_config(root, globs)
    seen = []
    inference = talg.GanSegAlgorithm.inference

    def spy(self, mini_batch, *a, **k):
        seen.append(mini_batch["image"].clone())
        return inference(self, mini_batch, *a, **k)

    monkeypatch.setattr(talg.GanSegAlgorithm, "inference", spy)
    written = ttest.main(["--config_file", path, "--device", "cpu",
                          "--num_samples", "1", "--Test.save_dir",
                          str(tmp_path)])
    assert len(written) == len(seen) == 1
    net = jbuild({"name": "resnetGenerator9"})
    params = jck.load_checkpoint(os.path.join(GAN_DIR, "10_G_model.ckpt"))["model"]
    x = seen[0].numpy().transpose(0, 2, 3, 1)
    ref = np.asarray(net.apply({"params": jax.tree.map(np.asarray, params)}, x))
    want = np.clip(ref[0, ..., 0], 0, 1) * 255
    got = load_png_gray8(written[0]).astype(np.float32)
    # the PNG truncates to 8 bits: a level apart only where the two
    # float32 values straddle a level
    assert np.abs(got - want).max() <= 1.0 + 1e-3


def test_eval_clis_need_the_card_unless_told(data, monkeypatch, tmp_path):
    root, globs = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (tval.main, ttest.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["--config_file", _s_gan_config(root, globs)])


def test_single_image_and_comparison_writers(tmp_path):
    img = np.linspace(0, 1, 30 * 40, dtype=np.float32).reshape(1, 30, 40)
    p = plot_single_image(str(tmp_path), img, "a")
    got = load_png_gray8(p)
    np.testing.assert_array_equal(got, (img[0] * 255).astype(np.uint8))
    p = plot_single_image(str(tmp_path), img * 255 * 2, "b.png")
    assert load_png_gray8(p).max() == 255
    vol = np.random.default_rng(0).random((8, 8, 3)).astype(np.float32)
    p = plot_single_image(str(tmp_path), vol, "v")
    assert os.path.exists(str(tmp_path / "v.npy"))
    np.testing.assert_array_equal(load_png_gray8(p),
                                  (vol.max(-1) * 255).astype(np.uint8))
    assert os.path.exists(plot_comparison(str(tmp_path), img, img, "c"))
