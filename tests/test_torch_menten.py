"""Port parity for the MICCAI-2022 augmentation baseline:
``AddVitreousFloater``, ``AddMotionArtifact`` and ``MentenAugmentationd``
against the JAX package's from one seed, and one short training run of
``configs/experiment_configs/config_ves_seg-S_Menten_aug_OCTA-500.yml``.

Decisions come from the pools' numpy streams, seeded alike in both packages;
the draws ``BinomialVesselNoised`` takes from a JAX key are replayed into the
port's pool. Tolerances: the floater's image within 1e-5 (its Gaussian
blur, sigma 10; reads 3.1e-7), the motion artifact bit for bit, the chain's
image within 1e-5 (reads 2.1e-7) and its label bit for bit. The
transform indexes label rows at 4x the image's, for a label at 4x the
image's resolution; where image and label are of one size
(``config_ves_seg_menten.yml``) and such a row lies past the label, the JAX
package's ``AddMotionArtifact`` raises ``IndexError``, and so does the
port's, at the same draw.
"""
import json
import os

import numpy as np
import jax
import pytest
import torch

from octa_tpu.data import transforms as jt
from octa_tpu_torch.data import transforms as tt
from octa_tpu_torch.tools.seg_data import (drop_splits, make_seg_dataset,
                                           point_config_at)
from octa_tpu_torch.train.engine import train
from octa_tpu_torch.utils.config import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_4X = os.path.join(ROOT, "configs", "experiment_configs",
                         "config_ves_seg-S_Menten_aug_OCTA-500.yml")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class ReplayPool(tt.RngPool):
    """A CPU pool whose ``uniform`` draws come from a queue, in order."""

    def __init__(self, seed, draws=()):
        super().__init__(seed, "cpu")
        self.queue = list(draws)

    def uniform(self, shape):
        out = torch.as_tensor(np.asarray(self.queue.pop(0)))
        assert tuple(out.shape) == tuple(shape)
        return out


def _binomial_draws(seed, shape):
    """The two uniform fields the JAX ``BinomialVesselNoised`` takes from the
    pool's first key."""
    k1, k2 = jax.random.split(jt.RngPool(seed).next_key())
    return [np.asarray(jax.random.uniform(k1, shape)),
            np.asarray(jax.random.uniform(k2, shape))]


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _pair(rng, h, w, label_rows):
    return {"image": rng.random((1, h, w)).astype(np.float32),
            "label": (rng.random((1, label_rows, w)) < 0.3).astype(np.float32)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vitreous_floater_matches_jax(rng, seed):
    data = _pair(rng, 64, 48, 64)
    ours = tt.AddVitreousFloater(["image"], floater_chance=1.0)
    ref = jt.AddVitreousFloater(["image"], floater_chance=1.0)
    ours.set_rng(tt.RngPool(seed, "cpu"))
    ref.set_rng(jt.RngPool(seed))
    out, exp = ours(dict(data)), ref(dict(data))
    np.testing.assert_allclose(_np(out["image"]), np.asarray(exp["image"]),
                               atol=1e-5)
    assert float(np.abs(_np(out["image"]) - data["image"]).max()) > 0.1
    assert ours.rng.np.random() == ref.rng.np.random()  # same stream state


@pytest.mark.parametrize("seed", range(6))
def test_motion_artifact_matches_jax(rng, seed):
    """Label at 4x the image's rows, as the JAX package indexes it: image and
    label bit for bit; over the seeds every kind of artifact is drawn."""
    data = _pair(rng, 48, 32, 192)
    ours, ref = tt.AddMotionArtifact("image", "label"), jt.AddMotionArtifact(
        "image", "label")
    ours.set_rng(tt.RngPool(seed, "cpu"))
    ref.set_rng(jt.RngPool(seed))
    out, exp = ours(dict(data)), ref(dict(data))
    for k in ("image", "label"):
        np.testing.assert_array_equal(_np(out[k]), exp[k])
        assert tuple(out[k].shape) == data[k].shape


def test_motion_artifact_where_jax_raises(rng):
    """Image and label of one size: where the JAX package raises IndexError
    (a stretch whose label row, at 4x the image's row, lies past the label)
    the port raises IndexError too, with the pool's numpy stream in the same
    state. Where the JAX package does not raise, both agree bit for bit."""
    raised = agreed = 0
    for seed in range(40):
        data = _pair(rng, 48, 32, 48)
        ours = tt.AddMotionArtifact("image", "label")
        ours.set_rng(tt.RngPool(seed, "cpu"))
        ref = jt.AddMotionArtifact("image", "label")
        ref.set_rng(jt.RngPool(seed))
        try:
            exp = ref(dict(data))
        except IndexError:
            raised += 1
            with pytest.raises(IndexError):
                ours(dict(data))
            assert ours.rng.np.random() == ref.rng.np.random(), seed
            continue
        agreed += 1
        out = ours(dict(data))
        for k in ("image", "label"):
            np.testing.assert_array_equal(_np(out[k]), exp[k])
        assert ours.rng.np.random() == ref.rng.np.random(), seed
    assert raised >= 3 and agreed >= 10, (raised, agreed)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_menten_chain_matches_jax(rng, seed):
    """``MentenAugmentationd`` with the binomial noise's draws replayed, image
    and label at 64²; where the JAX chain raises in its motion artifact,
    the image is held to the JAX chain run with a label 4x as tall."""
    data = _pair(rng, 64, 64, 64)
    ours = tt.MentenAugmentationd("image", "label")
    ours.set_rng(ReplayPool(seed, _binomial_draws(seed, (64, 64))))
    ref = jt.MentenAugmentationd("image", "label")
    ref.set_rng(jt.RngPool(seed))
    try:
        exp = ref(dict(data))
    except IndexError:
        with pytest.raises(IndexError):
            ours(dict(data))
        assert ours.rng.np.random() == ref.rng.np.random()
        ours.set_rng(ReplayPool(seed, _binomial_draws(seed, (64, 64))))
        ref.set_rng(jt.RngPool(seed))
        tall = np.zeros((1, 256, 64), np.float32)
        out, exp = ours(dict(data, label=tall)), ref(dict(data, label=tall))
    else:
        out = ours(dict(data))
    np.testing.assert_array_equal(_np(out["label"]), exp["label"])
    np.testing.assert_allclose(_np(out["image"]), np.asarray(exp["image"]),
                               atol=1e-5)
    assert ours.rng.np.random() == ref.rng.np.random()


def test_menten_config_trains(tmp_path):
    """``config_ves_seg-S_Menten_aug_OCTA-500.yml``, the Menten chain on the
    layout it was written for (the label at 4x the image: 304² / 1216² as
    shipped, 32² / 128² here, a DynUNet 8-16 wide), one epoch of 2 steps
    through the engine on data made on the spot: finite losses and a
    validation DSC."""
    globs = make_seg_dataset(str(tmp_path / "data"), n_graphs=4,
                             n_backgrounds=2, n_val=2, background_res=40,
                             val_res=64, device="cpu", max_edges=120)
    cfg = drop_splits(point_config_at(load_config(CONFIG_4X), globs,
                                      str(tmp_path / "runs")))
    for a in cfg["Train"]["data_augmentation"]:
        if a["name"] == "LoadGraphAndFilterByRandomRadiusd":
            a["image_resolutions"] = [[32, 32], [128, 128]]
        elif a["name"] == "Resized":
            a["spatial_size"] = [32, 32] if a["keys"] == ["background"] \
                else [128, 128]
    cfg["Validation"]["data_augmentation"][4]["spatial_size"] = [128, 128]
    cfg["General"]["model"]["filters"] = [8, 16, 16, 16, 16]
    for post in (cfg["Train"]["post_processing"],
                 cfg["Validation"]["post_processing"]):
        post["prediction"][-1]["min_size"] = 10
    cfg["Train"].update(epochs=1, epochs_decay=0, batch_size=2, lr=1e-3)
    steps = []

    class Args:
        start_epoch = 0
        epoch = "latest"
        split = ""
        save_latest = False

    run = train(Args(), json.loads(json.dumps(cfg)), device="cpu",
                on_step=lambda *a: steps.append(a))
    assert len(steps) == 2
    assert all(np.isfinite(s[2]["DiceBCELoss"]) for s in steps)
    with open(os.path.join(run, "metrics.csv")) as f:
        assert "Validation_DSC" in f.readline()
