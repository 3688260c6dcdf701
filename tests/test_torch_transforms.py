"""Port parity: image primitives, transforms and the pipelines of
``configs/config_ves_seg-S.yml``.

``octa_tpu.data`` and ``octa_tpu_torch.data`` run the same seeded inputs on
the CPU: continuous results within 1e-5 (1e-4 for whole samples, which pass
K1's plain versions), discrete ones equal. Decisions come from numpy and
Python streams seeded alike in both packages. The draws the JAX package
takes from PRNG keys are replayed from ``jax.random`` (or recorded from the
JAX run) and handed to the port through :class:`ReplayPool`, which
overrides the pool's four draw methods; after a pipeline the numpy and
Python streams of both pools must be in the same state.
"""
import copy
import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from octa_tpu.data import functional as JF
from octa_tpu.data import transforms as jt
from octa_tpu.models import noise_model as jnm
from octa_tpu_torch.data import functional as TF
from octa_tpu_torch.data import transforms as tt
from octa_tpu_torch.io.images import save_png_gray8
from octa_tpu_torch.models import noise_model as tnm
from octa_tpu_torch.ops import raster
from octa_tpu_torch.utils.config import load_config

CONFIG = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs",
                      "config_ves_seg-S.yml")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this file: where test processes share the
    cores (pytest-xdist), torch's parallel regions wait on threads that are
    not running, and the plain K1 splat of a fixture graph at 128² took 123
    s instead of 2.5 s on eight threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _warm_sqrt():
    torch.sqrt(torch.rand(1 << 20))


class ReplayPool(tt.RngPool):
    """A CPU pool whose key draws come from a queue, in draw order."""

    def __init__(self, seed, draws=()):
        super().__init__(seed, "cpu")
        self.queue = list(draws)

    def _next(self):
        return self.queue.pop(0)

    def uniform(self, shape):
        out = torch.as_tensor(np.asarray(self._next()))
        assert tuple(out.shape) == tuple(shape)
        return out

    def randint(self, low, high):
        return torch.as_tensor(np.array(self._next()))

    def noise_params(self, n_batch, grid_size):
        return tnm.NoiseParams(*(torch.as_tensor(np.array(p))
                                 for p in self._next()))

    def noise_gammas(self, concentrations):
        return tuple(torch.as_tensor(np.array(self._next()))
                     for _ in concentrations)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(out, ref, atol=1e-5):
    out = out.detach().float().numpy() if torch.is_tensor(out) else np.asarray(out)
    np.testing.assert_allclose(out, np.asarray(ref, np.float32), atol=atol)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [((64, 64), (128, 128)),
                                     ((128, 96), (64, 64)),
                                     ((400, 400), (304, 304)),
                                     ((1216, 1216), (1216, 1216))])
def test_resize_bilinear(rng, src, dst):
    img = rng.random((1, *src)).astype(np.float32)
    out = TF.resize_bilinear(_t(img), dst)
    _close(out, JF.resize_bilinear(jnp.asarray(img), dst))
    if src == dst:
        np.testing.assert_array_equal(out.numpy(), img)


def test_intensity_primitives(rng):
    img = (rng.random((2, 40, 48)) * 7 - 2).astype(np.float32)
    _close(TF.scale_intensity(_t(img), 0, 1), JF.scale_intensity(jnp.asarray(img)))
    _close(TF.as_discrete(_t(img), 0.5), JF.as_discrete(jnp.asarray(img), 0.5))
    _close(TF.gaussian_blur(_t(img[0]), 1.5),
           JF.gaussian_blur(jnp.asarray(img[0]), 1.5))


def test_geometry_primitives(rng):
    img = rng.random((48, 48)).astype(np.float32)
    for k in range(4):
        ref = JF.rot90_traceable(jnp.asarray(img), jnp.int32(k))
        _close(TF.rot90_traceable(_t(img), k), ref)
        _close(TF.rot90_traceable(_t(img), torch.tensor(k)), ref)
    for ax in (0, 1):
        _close(TF.flip(_t(img), ax), JF.flip(jnp.asarray(img), ax))
    for angle in (-9.5, 3.0, 37.0):
        _close(TF.rotate_bilinear(_t(img), angle),
               JF.rotate_bilinear(jnp.asarray(img), jnp.float32(angle)))
    for f in (0.25, 0.6, 1.0):
        _close(TF.decrease_resolution(_t(img), f),
               JF.decrease_resolution(jnp.asarray(img), jnp.float32(f)))


def test_random_primitives_with_jax_draws(rng):
    img = rng.random((64, 64)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    draws = [jax.random.uniform(k, ()) for k in jax.random.split(key, 2)]
    _close(TF.rand_flip(_t(img), [float(d) for d in draws]),
           JF.rand_flip(jnp.asarray(img), key))
    # rand_crop_or_pad: the offsets JAX draws from the key
    k1, k2 = jax.random.split(key)
    sh = int(64 * 0.7)
    offs = [int(jax.random.randint(k, (), 0, 64 - sh + 1)) for k in (k1, k2)]
    _close(TF.rand_crop_or_pad(_t(img), 0.7, offs),
           JF.rand_crop_or_pad(jnp.asarray(img), key, jnp.float32(0.7)))
    start = int(jax.random.randint(key, (), 0, 64 - 9 + 1))
    _close(TF.add_line_artifact(_t(img), start),
           JF.add_line_artifact(jnp.asarray(img), key))
    bg = rng.random((64, 64)).astype(np.float32)
    _close(TF.add_random_background_noise(
               _t(img), _t(bg), _t(jax.random.uniform(key, (64, 64)))),
           JF.add_random_background_noise(jnp.asarray(img), jnp.asarray(bg), key))
    _close(TF.speckle_brightness(_t(img), _t(jax.random.uniform(k1, (9, 9))),
                                 _t(jax.random.uniform(k2, (64, 64)))),
           JF.speckle_brightness(jnp.asarray(img), key))


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def _pair(seed, draws=()):
    return jt.RngPool(seed), ReplayPool(seed, draws)


def _run(name, entry, data, seed=5, draws=(), dtype=np.float32,
         tdtype=torch.float32):
    jpool, tpool = _pair(seed, draws)
    (jtr,) = jt.get_data_augmentations([{"name": name, **entry}], seed, dtype,
                                       rng=jpool)
    (ttr,) = tt.get_data_augmentations([{"name": name, **entry}], seed, tdtype,
                                       rng=tpool)
    ref = jtr(copy.deepcopy(data)) if isinstance(jtr, jt.Transform) else jtr(data)
    out = ttr({k: _t(v) if isinstance(v, np.ndarray) else v
               for k, v in data.items()}) if isinstance(ttr, tt.Transform) \
        else ttr(_t(data))
    assert not tpool.queue
    return out, ref, jpool, tpool


def _same_streams(jpool, tpool):
    assert jpool.np.bit_generator.state == tpool.np.bit_generator.state
    assert jpool.py.getstate() == tpool.py.getstate()


@pytest.mark.parametrize("name,entry", [
    ("ScaleIntensityd", {"keys": ["image"], "minv": 0, "maxv": 1}),
    ("EnsureChannelFirstd", {"keys": ["image"], "channel_dim": "no_channel"}),
    ("Resized", {"keys": ["image"], "spatial_size": [96, 80]}),
    ("AsDiscreted", {"keys": ["image"], "threshold": 0.4}),
    ("RandFlipd", {"keys": ["image"], "prob": 0.5, "spatial_axis": [0, 1]}),
    ("Flipd", {"keys": ["image"], "spatial_axis": 1}),
    ("RandRotate90d", {"keys": ["image"], "prob": 0.75}),
    ("Rotate90d", {"keys": ["image"], "k": 3}),
    ("RandRotated", {"keys": ["image"], "prob": 1, "range_x": 0.1745}),
    ("RandCropOrPadd", {"keys": ["image"], "prob": 1, "min_factor": 0.5,
                        "max_factor": 0.9}),
    ("RandCropOrPadd", {"keys": ["image"], "prob": 1, "min_factor": 1.2,
                        "max_factor": 1.5}),
    ("RandomDecreaseResolutiond", {"keys": ["image"], "max_factor": 0.3}),
    ("SelectSlice", {"keys": ["image"], "slice_selection": [[0, 1], [4, 60]]}),
    ("AsChannelLast", {"keys": ["image"]}),
    ("CastToTyped", {"keys": ["image"], "dtype": "dtype"}),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_dict_transforms(rng, name, entry, seed):
    data = {"image": rng.random((1, 64, 64)).astype(np.float32)}
    if name == "EnsureChannelFirstd":
        data["image"] = data["image"][0]
    out, ref, jpool, tpool = _run(name, entry, data, seed=seed)
    assert tuple(out["image"].shape) == tuple(np.shape(ref["image"]))
    _close(out["image"], ref["image"])
    _same_streams(jpool, tpool)


#: every method name ``jax.image.resize`` takes (``ResizeMethod.from_string``)
RESIZE_MODES = ["nearest", "linear", "bilinear", "trilinear", "triangle",
                "cubic", "bicubic", "tricubic", "lanczos3", "lanczos5"]


@pytest.mark.parametrize("mode", RESIZE_MODES)
@pytest.mark.parametrize("src,dst", [((32, 32), (64, 64)),
                                     ((64, 64), (16, 16)),
                                     ((37, 37), (64, 64)),
                                     ((37, 50), (64, 50)),
                                     ((50, 37), (50, 16))])
def test_resize_modes_match_jax(rng, mode, src, dst):
    """``Resized`` and ``Resize`` in every mode against ``jax.image.resize``
    in float32 on inputs in [0, 1], up, down, at a non-integer ratio and
    along one axis (JAX leaves an axis of equal size as it is): nearest
    bit for bit, the weighted modes within 2e-6."""
    x = rng.random((2, 1, *src)).astype(np.float32)
    out = tt.Resized(["image"], list(dst), mode=mode)(
        {"image": torch.from_numpy(x)})["image"].numpy()
    ref = np.asarray(jt.Resized(["image"], list(dst), mode=mode)(
        {"image": x})["image"])
    plain = tt.Resize(list(dst), mode=mode)(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 1, *dst)
    np.testing.assert_array_equal(plain, out)
    if mode == "nearest":
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=0, atol=2e-6)


@pytest.mark.parametrize("mode", ["area", "nearest-exact"])
def test_unknown_resize_mode_raises(mode):
    """A mode that ``jax.image.resize`` does not know (MONAI's ``area`` and
    ``nearest-exact``) raises ``ValueError`` in both packages."""
    x = np.zeros((1, 1, 8, 8), np.float32)
    with pytest.raises(ValueError, match="Unknown resize method"):
        jt.Resized(["image"], [4, 4], mode=mode)({"image": x})
    with pytest.raises(ValueError, match="Unknown resize method"):
        tt.Resized(["image"], [4, 4], mode=mode)
    with pytest.raises(ValueError, match="Unknown resize method"):
        tt.Resize([4, 4], mode=mode)


def test_cast_to_bfloat16(rng):
    data = {"image": rng.random((1, 16, 16)).astype(np.float32)}
    out, ref, _, _ = _run("CastToTyped", {"keys": ["image"], "dtype": "dtype"},
                          data, dtype=jnp.bfloat16, tdtype=torch.bfloat16)
    assert out["image"].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["image"].float().numpy(),
                                  np.asarray(ref["image"], np.float32))


def test_key_transforms_with_jax_draws(rng):
    img = rng.random((2, 64, 64)).astype(np.float32)
    bg = rng.random((2, 64, 64)).astype(np.float32)
    # AddRandomBackgroundNoised: one key, split per channel
    keys = jax.random.split(jt.RngPool(5).next_key(), 2)
    speckle = np.stack([jax.random.uniform(k, (64, 64)) for k in keys])
    out, ref, *_ = _run("AddRandomBackgroundNoised", {"keys": ["image"]},
                        {"image": img, "background": bg}, draws=[speckle])
    _close(out["image"], ref["image"])
    assert "background" not in out and "background" not in ref
    # AddLineArtifact, SpeckleBrightnesd: one key for all channels
    key = jt.RngPool(5).next_key()
    start = jax.random.randint(key, (), 0, 64 - 9 + 1)
    out, ref, *_ = _run("AddLineArtifact", {"keys": ["image"]}, {"image": img},
                        draws=[start])
    _close(out["image"], ref["image"])
    k1, k2 = jax.random.split(key)
    out, ref, *_ = _run("SpeckleBrightnesd", {"keys": ["image"]}, {"image": img},
                        draws=[jax.random.uniform(k1, (9, 9)),
                               jax.random.uniform(k2, (64, 64))])
    _close(out["image"], ref["image"])
    out, ref, *_ = _run("BinomialVesselNoised", {"keys": ["image"]},
                        {"image": img}, draws=[jax.random.uniform(k1, (64, 64)),
                                               jax.random.uniform(k2, (64, 64))])
    _close(out["image"], ref["image"])


def _record_noise_draws(monkeypatch):
    """Record the JAX noise model's parameter and Gamma draws."""
    record = []
    sample, gamma = jnm.sample_noise_params, jax.random.gamma

    def rec_sample(*a, **k):
        p = sample(*a, **k)
        record.append(tuple(np.asarray(x) for x in p))
        return p

    def rec_gamma(*a, **k):
        g = gamma(*a, **k)
        record.append(np.asarray(g))
        return g

    monkeypatch.setattr(jnm, "sample_noise_params", rec_sample)
    monkeypatch.setattr(jax.random, "gamma", rec_gamma)
    return record


@pytest.mark.parametrize("downsample_factor", [1, 2])
def test_noise_model_transform_with_jax_draws(rng, monkeypatch,
                                              downsample_factor):
    img = rng.random((1, 48, 48)).astype(np.float32)
    bg = rng.random((1, 48, 48)).astype(np.float32)
    record = _record_noise_draws(monkeypatch)
    entry = {"keys": ["image"], "prob": 1, "lambda_delta": 1,
             "lambda_speckle": 0.7, "lambda_gamma": 0.3,
             "downsample_factor": downsample_factor}
    jpool, _ = _pair(5)
    (jtr,) = jt.get_data_augmentations([{"name": "NoiseModeld", **entry}], 5,
                                       rng=jpool)
    ref = jtr({"image": img, "background": bg})
    assert len(record) == 5  # the params, then four Gamma fields
    tpool = ReplayPool(5, [record[0], *record[1:]])
    tpool.noise_gammas = lambda conc, q=record[1:]: tuple(_t(g) for g in q)
    (ttr,) = tt.get_data_augmentations([{"name": "NoiseModeld", **entry}], 5,
                                       rng=tpool)
    out = ttr({"image": _t(img), "background": _t(bg)})
    _close(out["image"], ref["image"])
    _same_streams(jpool, tpool)


# ---------------------------------------------------------------------------
# the pipelines of config_ves_seg-S.yml
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("segdata")
    rng = np.random.default_rng(11)
    src = raster.fixture_graph_paths()
    for i in range(2):  # the first 2,500 edges of two fixture graphs
        with open(src[i]) as f:
            (root / f"g{i}.csv").write_text("".join(f.readlines()[:2501]))
    save_png_gray8(str(root / "bg.png"),
                   rng.integers(0, 256, (96, 96), dtype=np.uint8))
    Image.fromarray(rng.integers(0, 256, (100, 90, 3), dtype=np.uint8),
                    "RGB").save(root / "val.png")
    Image.fromarray(((rng.random((100, 90)) < 0.2) * 255).astype(np.uint8),
                    "L").save(root / "lab.png")
    return root


def _train_aug():
    aug = load_config(CONFIG)["Train"]["data_augmentation"]
    aug[1]["image_resolutions"] = [[64, 64], [128, 128]]
    aug[4]["spatial_size"] = [64, 64]
    aug[6]["spatial_size"] = [128, 128]
    return aug


def test_train_pipeline_matches_jax(small_data, monkeypatch):
    record = _record_noise_draws(monkeypatch)
    aug = _train_aug()
    jpool = jt.RngPool(42)
    jpipe = jt.Compose(jt.get_data_augmentations(aug, 42, np.float32, rng=jpool))
    items = [{"image": str(small_data / f"g{i}.csv"),
              "label": str(small_data / f"g{i}.csv"),
              "background": str(small_data / "bg.png")} for i in (0, 1, 0)]
    refs = [jpipe(dict(it)) for it in items]
    assert len(record) == 5 * len(items)
    params = record[0::5]
    gammas = [record[5 * i + 1:5 * i + 5] for i in range(len(items))]
    tpool = ReplayPool(42, params)
    tpool.noise_gammas = lambda conc: tuple(_t(g) for g in gammas.pop(0))
    tpipe = tt.Compose(tt.get_data_augmentations(aug, 42, torch.float32,
                                                 rng=tpool))
    for it, ref in zip(items, refs):
        out = tpipe(dict(it))
        for k in ("image", "label"):
            assert tuple(out[k].shape) == (1, 128, 128)
            assert out[k].dtype == torch.float32
            _close(out[k], ref[k], atol=1e-4)
        assert set(np.unique(out["label"].numpy())) <= {0.0, 1.0}
    _same_streams(jpool, tpool)


def test_validation_and_post_pipelines_match_jax(small_data, rng):
    cfg = load_config(CONFIG)
    aug = cfg["Validation"]["data_augmentation"]
    aug[4]["spatial_size"] = [128, 128]
    item = {"image": str(small_data / "val.png"),
            "label": str(small_data / "lab.png")}
    ref = jt.Compose(jt.get_data_augmentations(aug, 42))(dict(item))
    out = tt.Compose(tt.get_data_augmentations(aug, 42, device="cpu"))(dict(item))
    for k in ("image", "label"):
        _close(out[k], ref[k])
    logits = (rng.normal(size=(1, 64, 64)) * 2).astype(np.float32)
    for key, arg in (("prediction", logits), ("label", ref["label"])):
        entries = cfg["Validation"]["post_processing"][key]
        jpost = jt.Compose(jt.get_data_augmentations(entries, 42))
        tpost = tt.Compose(tt.get_data_augmentations(entries, 42, device="cpu"))
        r, o = jpost(np.asarray(arg)), tpost(_t(arg))
        assert isinstance(o, np.ndarray) and o.dtype == np.asarray(r).dtype
        np.testing.assert_array_equal(o, np.asarray(r))


def test_gray_scale_is_pil_l(rng):
    rgb = rng.integers(0, 256, (31, 17, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        tt.rgb_to_gray(rgb), np.asarray(Image.fromarray(rgb, "RGB").convert("L")))


def test_load_image_formats(tmp_path, rng):
    arr = rng.random((5, 6)).astype(np.float32)
    np.save(tmp_path / "a.npy", arr)
    gray = rng.integers(0, 256, (9, 7), dtype=np.uint8)
    Image.fromarray(gray, "L").save(tmp_path / "b.png")
    Image.fromarray(gray.astype(np.uint16) * 200).save(tmp_path / "c.png")
    data = {"a": str(tmp_path / "a.npy"), "b": str(tmp_path / "b.png"),
            "c": str(tmp_path / "c.png")}
    out = tt.LoadImaged(["a", "b", "c"])(dict(data))
    ref = jt.LoadImaged(["a", "b", "c"])(dict(data))
    for k in data:
        np.testing.assert_array_equal(out[k], ref[k])


def test_post_transforms_and_registry():
    x = torch.tensor([[[-1.0, 0.0, 2.0]]])
    np.testing.assert_allclose(tt.Activations(sigmoid=True)(x).numpy(),
                               np.asarray(jt.Activations(sigmoid=True)(np.asarray(x))))
    assert tt.Lambda("lambda x: x * 2")(3) == 6
    with pytest.raises(ValueError):
        tt.Lambda("import os")
    assert tt.CastToType("uint8")(x.abs()).dtype == np.uint8
    np.testing.assert_allclose(tt.Resize([2, 6])(x).numpy(),
                               np.asarray(jt.Resize([2, 6])(np.asarray(x))),
                               atol=1e-6)
    with pytest.raises(KeyError, match="not implemented in octa_tpu_torch"):
        tt.get_data_augmentations([{"name": "Nope"}], 0, device="cpu")
    assert set(tt.TRANSFORM_REGISTRY) == set(jt.TRANSFORM_REGISTRY)
