"""The shipped configs that no other port test runs, in both packages.

``config_ves_seg_supervised.yml`` (PNG pairs, read by the native decoder),
``experiment_configs/config_ves_seg-S_RA.yml`` and the six
``experiment_configs/*Menten_aug*`` configs, each cut in size only, on data
made on the spot (fixture graphs cut to their first 120 edges, noise
backgrounds, validation pairs rendered from the graphs; the split files
dropped, ``tools/seg_data.py::drop_splits``)
with a DynUNet 8-16 wide:

- the port builds each phase's transform chain of the JAX package's names,
  with the same value for every parameter both objects hold;
- the first validation batch, which no random draw touches, agrees with the
  JAX package's within 1e-6;
- one epoch of 2 steps of batch 2 trains in both packages to finite losses
  and a validation DSC, or raises ``IndexError`` in both (the three
  ``Menten_Menten_aug`` configs do, at their shipped seed).

Sizes: the graphs render at 32² and 64² and the network trains and
validates at 64², as ``S_RA``; where the Menten chain runs before the
upsample (``S_Menten_aug``: image 304², label 1216² as shipped) the label
renders at 4x the image, 32² and 128², and is resized to 64² after it; the
Giarratano variants crop to 0.2965 of their side, so they render at 27²
and 108² and crop 32². ``Menten_Menten_aug`` runs the chain after the
upsample, on an image and a label of one size; its motion artifact then
indexes label rows past the label on some samples and raises
``IndexError``, in the JAX package as in the port (``ROADMAP.md``).
"""
import copy
import csv
import json
import math
import os

import flax
import jax
import numpy as np
import pytest
import torch

from octa_tpu.data import dataset as jds
from octa_tpu.data import transforms as jtr
from octa_tpu.train import engine as jengine
from octa_tpu_torch.data import dataset as tds
from octa_tpu_torch.data import transforms as ttr
from octa_tpu_torch.tools.seg_data import (drop_splits, make_seg_dataset,
                                           point_config_at)
from octa_tpu_torch.train import engine as tengine
from octa_tpu_torch.utils.config import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXP = os.path.join("configs", "experiment_configs")
SHIPPED = [os.path.join("configs", "config_ves_seg_supervised.yml"),
           os.path.join(EXP, "config_ves_seg-S_RA.yml")] + [
    os.path.join(EXP, f"config_ves_seg-{m}_Menten_aug_{d}.yml")
    for m in ("S", "Menten") for d in ("OCTA-500", "ROSE-1", "Giarratano")]
NET = 64  # the side the network trains and validates at


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _jitted_flax_init():
    """Each flax ``init`` of the JAX trainers jitted: run op by op, it
    compiles a few hundred small programs (``tests/test_torch_cut.py``'s
    ``jax_trainer`` does the same)."""
    orig = flax.linen.Module.init

    def init(self, rngs, *args, **kwargs):
        static = [i + 1 for i, a in enumerate(args) if isinstance(a, int)]
        return jax.jit(lambda r, *a: orig(self, r, *a, **kwargs),
                       static_argnums=static)(rngs, *args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Module, "init", init)
        yield


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("shipped")
    return make_seg_dataset(str(root / "data"), n_graphs=4, n_backgrounds=2,
                            n_val=4, background_res=40, val_res=NET,
                            device="cpu", max_edges=120)


def _sizes(cfg):
    """(image side, label side) the graphs render at."""
    names = [a["name"] for a in cfg["Train"]["data_augmentation"]]
    if "RandCropOrPadd" in names:
        return 27, 108
    upsample = max(i for i, n in enumerate(names) if n == "Resized")
    if "MentenAugmentationd" in names[:upsample]:
        return 32, 128
    return 32, NET


def _cut(path, data, save_dir):
    cfg = drop_splits(point_config_at(load_config(os.path.join(ROOT, path)),
                                      data, save_dir))
    if cfg["Train"]["data_augmentation"][0]["keys"] == ["image", "label"]:
        cfg["Train"]["data"] = {"image": {"files": data["val_images"]},
                                "label": {"files": data["val_labels"]}}
    image, label = _sizes(cfg)
    for a in cfg["Train"]["data_augmentation"]:
        if a["name"] == "LoadGraphAndFilterByRandomRadiusd":
            a["image_resolutions"] = [[image, image], [label, label]]
        elif a["name"] == "Resized":
            side = image if a["keys"] == ["background"] else (
                label if label != 128 else NET)
            a["spatial_size"] = [side, side]
    for a in cfg["Validation"]["data_augmentation"]:
        if a["name"] == "Resized":
            a["spatial_size"] = [NET, NET]
    cfg["General"]["model"]["filters"] = [8, 16, 16, 16, 16]
    for post in (cfg["Train"]["post_processing"],
                 cfg["Validation"]["post_processing"]):
        post["prediction"][-1]["min_size"] = 10
    cfg["Train"].update(epochs=1, epochs_decay=0, batch_size=2, lr=1e-3)
    cfg["Validation"]["batch_size"] = 2
    return json.loads(json.dumps(cfg))


def _simple(v):
    if isinstance(v, (list, tuple)):
        return all(_simple(x) for x in v)
    return isinstance(v, (bool, int, float, str))


def _listed(v):
    return [_listed(x) for x in v] if isinstance(v, (list, tuple)) else v


def _same_params(ours, ref, where):
    assert type(ours).__name__ == type(ref).__name__, where
    shared = set(vars(ours)) & set(vars(ref))
    for k in sorted(shared):
        a, b = vars(ours)[k], vars(ref)[k]
        if _simple(a) and _simple(b):
            assert _listed(a) == _listed(b), (where, k, a, b)


class _Args:
    start_epoch = 0
    epoch = "latest"
    split = ""
    save_latest = False


def _run(train, cfg, **kw):
    """('ok', training loss, validation DSC, epochs logged) or
    ('IndexError', message)."""
    try:
        run = train(_Args(), copy.deepcopy(cfg), **kw)
    except IndexError as exc:
        return ("IndexError", str(exc))
    with open(os.path.join(run, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    return ("ok", float(rows[-1]["train_DiceBCELoss"]),
            float(rows[-1]["Validation_DSC"]), len(rows))


@pytest.mark.parametrize("path", SHIPPED, ids=os.path.basename)
def test_shipped_config_in_both_packages(path, data, tmp_path):
    cfg = _cut(path, data, str(tmp_path / "port"))
    seed = cfg["General"]["seed"]
    for phase in ("Train", "Validation"):
        ours = ttr.get_data_augmentations(cfg[phase]["data_augmentation"],
                                          seed, device="cpu")
        ref = jtr.get_data_augmentations(cfg[phase]["data_augmentation"], seed)
        assert len(ours) == len(ref) == len(cfg[phase]["data_augmentation"])
        for i, (o, r) in enumerate(zip(ours, ref)):
            _same_params(o, r, (phase, i))

    b_ours = next(iter(tds.get_dataset(copy.deepcopy(cfg), "Validation",
                                       device="cpu")))
    b_ref = next(iter(jds.get_dataset(copy.deepcopy(cfg), "Validation")))
    for k in ("image", "label"):
        assert tuple(b_ours[k].shape) == (2, 1, NET, NET)
        np.testing.assert_allclose(b_ours[k].numpy(), np.asarray(b_ref[k]),
                                   atol=1e-6, err_msg=k)

    ours = _run(tengine.train, cfg, device="cpu")
    ref_cfg = json.loads(json.dumps(cfg).replace(str(tmp_path / "port"),
                                                 str(tmp_path / "jax")))
    ref = _run(jengine.train, ref_cfg)
    assert ours[0] == ref[0], (ours, ref)
    if ours[0] == "ok":
        assert ours[3] == ref[3] == 1
        for out in (ours, ref):
            assert math.isfinite(out[1]) and math.isfinite(out[2])
    else:
        assert "Menten_Menten_aug" in path, ours


@pytest.mark.parametrize("shape", [(27, 27), (10, 90), (64, 48)])
def test_gaussian_blur_reflects_past_a_short_side(shape, rng):
    """The floater's blur (sigma 10, radius 40) on a side of 40 or less, as
    the Giarratano configs give it here: the reflection repeats, as
    ``jnp.pad`` repeats it, within 1e-6."""
    import jax.numpy as jnp

    from octa_tpu.data import functional as jf
    from octa_tpu_torch.data import functional as tf

    x = rng.random(shape).astype(np.float32)
    np.testing.assert_allclose(
        tf.gaussian_blur(torch.from_numpy(x), 10.0).numpy(),
        np.asarray(jf.gaussian_blur(jnp.asarray(x), 10.0)), atol=1e-6)
