"""Port parity for the 3D reconstruction (``configs/config_3d_recon_supervised
.yml``): a 2D DynUNet whose output channels are the z-planes of the vessel
volume under the image.

The port's own data (``tools/seg_data.py::make_recon_dataset``: fixture
graphs cut to their first 300 edges, label volumes voxelized by K4's plain
path at (64, 64, 16), planes 0-11 kept) go through the data blocks of the
JAX package's ``tests/test_3d_recon.py:30-62`` in both packages: the batches have the
JAX package's shapes, the labels are equal and the images within 1e-4. One
training step from the JAX package's initial weights, in float64 in both
(JAX under ``jax.enable_x64``): the loss within 1e-12 relative, every
gradient and updated parameter tensor within 1e-6 relative L2.
``RemoveOuterNoise`` equals the JAX package's bit for bit. Then ``python -m
octa_tpu_torch.train``, ``validate`` and ``test`` on the shipped config
pointed at the data (``point_recon_config_at``), cut to 64² and small
filters: the validation's ClDice is volumetric and ``test`` writes each
prediction as ``.npy`` and PNG after ``RemoveOuterNoise``.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octa_tpu.data import dataset as jds
from octa_tpu.data import transforms as jt
from octa_tpu.train import algorithms as jalg
from octa_tpu.utils.enums import Phase as JPhase
from octa_tpu_torch import test as ttest
from octa_tpu_torch import validate as tval
from octa_tpu_torch.data import dataset as tds
from octa_tpu_torch.data import transforms as tt
from octa_tpu_torch.io import checkpoints as tck
from octa_tpu_torch.io.images import load_png_gray8
from octa_tpu_torch.tools.seg_data import make_recon_dataset, point_recon_config_at
from octa_tpu_torch.train import algorithms as talg
from octa_tpu_torch.train import cli
from octa_tpu_torch.utils.config import load_config
from octa_tpu_torch.utils.enums import Phase

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "config_3d_recon_supervised.yml")
RES, DEPTH = 64, 16
# tests/test_3d_recon.py keeps z - 4 planes; the voxelizer scales z by the
# longest side, so at 64² the fixture graphs (z up to 0.044 of it) fill the
# first three planes: keep the first z - 4
Z_KEEP = (0, DEPTH - 4)
PLANES = Z_KEEP[1] - Z_KEEP[0]
FILTERS = [8, 16, 16, 16, 16]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this file: under the test run's several worker
    processes, torch's parallel regions wait on threads that are not
    running."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def recon_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("recon")
    return root, make_recon_dataset(str(root / "train"), n_samples=3, res=RES,
                                    depth=DEPTH, device="cpu", max_edges=300)


def _flat(tree, prefix=(), dtype=np.float64):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,), dtype))
        else:
            out[prefix + (k,)] = np.asarray(v, dtype)
    return out


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


class _Args:
    start_epoch = 0
    epoch = "latest"
    split = ""
    save_latest = True


def _jax_test_config(globs):
    """``tests/test_3d_recon.py:30-62`` on the port's data, with small
    filters."""
    return {
        "General": {"task": "ves-seg", "seed": 1, "amp": False,
                    "model": {"name": "DynUNet", "spatial_dims": 2,
                              "in_channels": 1, "out_channels": PLANES,
                              "kernel_size": [3] * 5,
                              "strides": [1, 2, 2, 2, 1],
                              "upsample_kernel_size": [1, 2, 2, 2, 1],
                              "filters": FILTERS}},
        "Train": {
            "data": {"image": {"files": globs["graphs"]},
                     "label": {"files": globs["volumes"]}},
            "epochs": 1, "epochs_decay": 0, "val_interval": 100,
            "batch_size": 2, "lr": 1e-3, "weight_decay": 1e-3,
            "loss": "DiceBCELoss", "AT": False,
            "data_augmentation": [
                {"name": "LoadImaged", "keys": ["label"], "image_only": True},
                {"name": "LoadGraphAndFilterByRandomRadiusd",
                 "keys": ["image"], "image_resolutions": [[RES, RES]],
                 "min_radius": [0], "max_dropout_prob": 0},
                {"name": "ScaleIntensityd", "keys": ["image", "label"],
                 "minv": 0, "maxv": 1},
                {"name": "EnsureChannelFirstd", "keys": ["image"],
                 "strict_check": False, "channel_dim": "no_channel"},
                {"name": "EnsureChannelFirstd", "keys": ["label"],
                 "strict_check": False, "channel_dim": 2},
                {"name": "SelectSlice", "keys": ["label"],
                 "slice_selection": [list(Z_KEEP)]},
                {"name": "AsDiscreted", "keys": ["label"], "threshold": 0.1},
                {"name": "CastToTyped", "keys": ["image", "label"],
                 "dtype": "dtype"},
            ],
            "post_processing": {
                "prediction": [{"name": "Activations", "sigmoid": True},
                               {"name": "AsDiscrete", "threshold": 0.5}],
                "label": [{"name": "CastToType", "dtype": "uint8"}],
            },
        },
        "Output": {"save_dir": "unused", "save_to_disk": False},
    }


def test_3d_recon_batches_match_jax(recon_data):
    _, globs = recon_data
    cfg = _jax_test_config(globs)
    ours = next(iter(tds.get_dataset(cfg, Phase.TRAIN, device="cpu")))
    ref = next(iter(jds.get_dataset(cfg, JPhase.TRAIN)))
    assert tuple(ours["image"].shape) == np.asarray(ref["image"]).shape \
        == (2, 1, RES, RES)
    assert tuple(ours["label"].shape) == np.asarray(ref["label"]).shape \
        == (2, PLANES, RES, RES)
    assert ours["label_path"] == list(ref["label_path"])
    np.testing.assert_array_equal(ours["label"].numpy(),
                                  np.asarray(ref["label"]))
    assert ours["label"].sum() > 0
    np.testing.assert_allclose(ours["image"].numpy(), np.asarray(ref["image"]),
                               atol=1e-4)


def test_3d_recon_training_step_matches_jax_float64(recon_data):
    """One step of the 3D-recon DynUNet (``PLANES`` output channels) on a
    loaded batch, from the JAX package's initial weights, both in float64."""
    _, globs = recon_data
    cfg = _jax_test_config(globs)
    b = next(iter(tds.get_dataset(cfg, Phase.TRAIN, device="cpu")))
    batch = {k: b[k].numpy().astype(np.float64) for k in ("image", "label")}
    j = jalg.define_model(cfg, JPhase.TRAIN)
    j.initialize_model_and_optimizer(batch, cfg, _Args(), phase=JPhase.TRAIN)
    start = jax.tree.map(np.asarray, j.params["model"])
    t = talg.define_model(cfg, Phase.TRAIN, "cpu")
    t.initialize_model_and_optimizer(batch, cfg, _Args(), phase=Phase.TRAIN)
    tck.restore_like(t.net, start)
    t.net.double()
    x, y = (torch.from_numpy(batch[k]) for k in ("image", "label"))
    pred, loss = t.train_step(x, y)
    assert tuple(pred.shape) == (2, PLANES, RES, RES)
    grads = _flat(tck.state_dict_to_flax(
        t.net, {n: p.grad for n, p in t.net.named_parameters()}))
    ours = _flat(tck.state_dict_to_flax(t.net))
    to64 = lambda tree: jax.tree.map(
        lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype.kind == "f"
        else a, tree)
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "float32", jnp.float64)
        j.dtype = jnp.float64
        j.net = j.net.clone(dtype=jnp.float64)
        j.params = {"model": to64(start)}
        j._init_optimizers(cfg)
        j._build_steps()
        xj, yj = (jnp.asarray(batch[k]).transpose(0, 2, 3, 1)
                  for k in ("image", "label"))
        ref_loss, ref_grads = jax.value_and_grad(
            lambda p: j.loss_function(j.net.apply({"params": p}, xj), yj))(
                j.params["model"])
        ref_grads = _flat(jax.tree.map(np.asarray, ref_grads))
        _, losses = j.perform_training_step(dict(batch), {})
        want = _flat(jax.tree.map(np.asarray, j.params["model"]))
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-12)
    assert losses["DiceBCELoss"] == pytest.approx(float(ref_loss), rel=1e-12)
    assert grads.keys() == ref_grads.keys() == ours.keys() == want.keys()
    for k in ref_grads:
        assert _rel_l2(grads[k], ref_grads[k]) <= 1e-6, k
        assert _rel_l2(ours[k], want[k]) <= 1e-6, k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_remove_outer_noise_matches_jax(seed):
    """Seeded volumes of boxes and sparse noise: the port's output equals
    the JAX package's, at z_axis 0 and 2."""
    rng = np.random.default_rng(seed)
    vol = rng.random((9, 20, 24)) < 0.04
    for _ in range(4):
        z, y, x = rng.integers(0, 7), rng.integers(0, 16), rng.integers(0, 20)
        vol[z:z + rng.integers(1, 4), y:y + 4, x:x + 4] = True
    for z_axis in (0, 2):
        v = np.moveaxis(vol, 0, z_axis).astype(np.float32)
        ref = jt.RemoveOuterNoise(z_axis=z_axis)(v)
        got = tt.RemoveOuterNoise(z_axis=z_axis)(torch.from_numpy(v))
        assert got.dtype == np.bool_ and got.shape == v.shape
        np.testing.assert_array_equal(got, ref)
        assert 0 < got.sum() < v.sum()
    # the JAX package's own example
    vol = np.zeros((8, 16, 16), np.float32)
    vol[3:5, 4:8, 4:8] = 1
    vol[0, 12:14, 12:14] = 1
    out = tt.RemoveOuterNoise(z_axis=0)(vol)
    assert out[4, 5, 5] and not out[0, 13, 13]


def test_recon_train_validate_test_clis(recon_data, tmp_path):
    root, train_globs = recon_data
    val_globs = make_recon_dataset(str(root / "val"), n_samples=2, res=RES,
                                   depth=DEPTH, device="cpu", max_edges=300)
    cfg = load_config(CONFIG)
    cfg["General"]["model"].update(out_channels=PLANES, filters=FILTERS)
    cfg = point_recon_config_at(cfg, train_globs, val_globs,
                                str(tmp_path / "runs"), res=RES, z_keep=Z_KEEP)
    for phase in ("Train", "Validation", "Test"):
        cfg[phase]["post_processing"]["prediction"][2]["min_size"] = 10
    assert [a["name"] for a in cfg["Test"]["post_processing"]["prediction"]] \
        == ["Activations", "AsDiscrete", "RemoveSmallObjects", "RemoveOuterNoise"]
    cfg["Train"].update(epochs=2, epochs_decay=1, batch_size=2, lr=1e-3)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    run = cli.main(["--config_file", str(path), "--device", "cpu"])
    with open(os.path.join(run, "metrics.csv")) as f:
        header = f.readline().strip().split(",")
        rows = [line.strip().split(",") for line in f]
    assert len(rows) == 2
    cl = [float(r[header.index("Validation_ClDice")]) for r in rows]
    assert all(0 <= v <= 1 for v in cl)
    # validate: the ClDice of each volume whole (two volumes, two scores)
    metrics = tval.main(["--config_file", os.path.join(run, "config.yml"),
                         "--device", "cpu", "--epoch", "latest"])
    assert {"Validation_DSC", "Validation_ClDice", "Validation_AUC"} <= set(metrics)
    assert 0 <= metrics["Validation_ClDice"] <= 1
    # test: a .npy volume and its PNG for each graph, after RemoveOuterNoise
    out = tmp_path / "test"
    written = ttest.main(["--config_file", os.path.join(run, "config.yml"),
                          "--device", "cpu", "--epoch", "latest",
                          "--Test.save_dir", str(out)])
    assert len(written) == 2
    for png in written:
        assert load_png_gray8(png).shape == (PLANES, RES)  # the last axis' max
        vol = np.load(png + ".npy")
        assert vol.shape == (PLANES, RES, RES)
        np.testing.assert_array_equal(tt.RemoveOuterNoise(z_axis=0)(vol),
                                      vol > 0)
