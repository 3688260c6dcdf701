"""Config-driven data transforms, name-compatible with the YAML configs.

Counterpart of ``octa_tpu/data/transforms.py``: ``RngPool`` (:28),
``Transform`` (:42), ``Compose`` (:744), ``get_data_augmentations``
(:769-815), and every transform that ``configs/config_ves_seg-S.yml`` names
or that needs nothing beyond this module: ``LoadImaged`` (:77),
``ToGrayScaled``, ``LoadGraphAndFilterByRandomRadiusd`` (:126), whose K1
splat runs on the pool's device, ``EnsureChannelFirstd``,
``AsChannelLast``, ``CastToTyped``, ``SelectSlice``, ``ScaleIntensityd``,
``Resized`` / ``Resize``, ``AsDiscreted``, ``RandFlipd``, ``Flipd``,
``RandRotate90d``, ``Rotate90d``, ``RandRotated``, ``RandCropOrPadd``,
``AddRandomBackgroundNoised``, ``NoiseModeld`` (:417),
``RandomDecreaseResolutiond``, ``AddLineArtifact``, ``SpeckleBrightnesd``,
``BinomialVesselNoised``, the MICCAI-2022 augmentation chain
``AddVitreousFloater``, ``AddMotionArtifact`` and ``MentenAugmentationd``
(:516-632), ``ImageToImageTranslationd`` (:635-650), and the
post-processing ``RemoveOuterNoise`` (:655-672), ``Activations``,
``AsDiscrete``, ``RemoveSmallObjects``, ``CastToType`` and ``Lambda``.

A sample is a dict of channel-first arrays: numpy as loaded from disk,
tensors on the pool's device once a transform computes on them. Decisions
(flip or not, rot90 counts, angles, crops) come from the pool's numpy and
Python streams exactly as in the JAX package, so one seed gives the same
decisions in both. Where the JAX package draws from a PRNG key (the noise
model, background and speckle noise), the port draws from the pool's
``torch.Generator`` through :meth:`RngPool.uniform`,
:meth:`RngPool.randint`, :meth:`RngPool.noise_params` and
:meth:`RngPool.noise_gammas`, in the JAX package's order, so that a test
can hand the JAX draws in by overriding those four methods.
"""
from __future__ import annotations

import importlib
import pickle
import random as pyrandom
from typing import Any, Sequence

import numpy as np
import torch

from octa_tpu_torch.data import functional as F
from octa_tpu_torch.device import resolve_device
from octa_tpu_torch.models import noise_model as nm
from octa_tpu_torch.ops import raster
from octa_tpu_torch.ops.morphology import (
    binary_dilation,
    keep_largest_connected_component,
    remove_small_objects,
)
from octa_tpu_torch.utils import trace


class RngPool:
    """numpy and Python streams for decisions, and a ``torch.Generator`` on
    ``device`` for the draws the JAX package takes from keys."""

    def __init__(self, seed: int, device="cuda"):
        self.np = np.random.default_rng(seed)
        self.py = pyrandom.Random(seed + 1)
        self.device = resolve_device(device)
        self.generator = torch.Generator(self.device).manual_seed(seed)

    def uniform(self, shape) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.device)

    def randint(self, low: int, high: int) -> torch.Tensor:
        """One integer in [low, high), as a tensor on the device."""
        return torch.randint(low, high, (), generator=self.generator,
                             device=self.device)

    def noise_params(self, n_batch: int, grid_size) -> nm.NoiseParams:
        return nm.sample_noise_params(n_batch, self.generator, grid_size,
                                      device=self.device)

    def noise_gammas(self, concentrations):
        return nm.draw_gammas(concentrations, self.generator)


class Transform:
    """Base dict transform."""

    def __init__(self, keys: Sequence[str] | str = (), allow_missing_keys=False,
                 **_ignored):
        self.keys = [keys] if isinstance(keys, str) else list(keys)
        self.allow_missing_keys = allow_missing_keys
        self.rng: RngPool | None = None  # injected by the pipeline

    def set_rng(self, rng: RngPool):
        self.rng = rng

    def _iter_keys(self, data):
        for k in self.keys:
            if k in data:
                yield k
            elif not self.allow_missing_keys:
                raise KeyError(f"{type(self).__name__}: missing key {k}")

    def _tensor(self, x) -> torch.Tensor:
        """``x`` as a tensor; numpy arrays go to the pool's device."""
        if torch.is_tensor(x):
            return x
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.rng.device)

    def __call__(self, data: dict[str, Any]) -> dict[str, Any]:
        raise NotImplementedError


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _tensor_any(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(
        np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# IO transforms (host)
# ---------------------------------------------------------------------------

def _optional(name: str):
    """An optional package, imported where it is used; None if absent."""
    try:
        return importlib.import_module(name)
    except ImportError:
        return None


class LoadImaged(Transform):
    """Load ``.npy``, ``.nii(.gz)`` (nibabel, optional) or image files as
    float32. A PNG is decoded by the native reader
    (``octa_tpu_torch.native.read_png_native``, its scanlines un-filtered in
    C++) where it builds; else, or where it refuses the file, by
    ``octa_tpu_torch.io.images.load_png_cached`` (numpy, the same arrays:
    alpha dropped on both paths, as the JAX package's libpng reader does);
    other formats, and PNGs neither reads, by PIL where it is installed."""

    def __init__(self, keys, image_only=True, allow_missing_keys=False, **kw):
        super().__init__(keys, allow_missing_keys)

    def __call__(self, data):
        from octa_tpu_torch import native
        from octa_tpu_torch.io.images import drop_alpha, load_png_cached

        for k in self._iter_keys(data):
            path = str(data[k])
            if path.endswith(".npy"):
                data[k] = np.load(path).astype(np.float32)
            elif path.endswith((".nii", ".nii.gz")):
                nib = _optional("nibabel")
                if nib is not None:
                    data[k] = np.asarray(
                        nib.load(path).get_fdata()).astype(np.float32)
                else:  # .nii.npy fallback written by the JAX package's CLI
                    data[k] = np.load(path + ".npy").astype(np.float32)
            else:
                img = None
                if path.endswith(".png"):
                    img = native.read_png_native(path)
                    if img is not None:
                        native.READS["png_native"] += 1
                    else:
                        try:
                            img = drop_alpha(load_png_cached(path))
                            native.READS["png_numpy"] += 1
                        except ValueError:
                            img = None  # palette or interlaced: PIL below
                if img is None:
                    pil = _optional("PIL.Image")
                    if pil is None:
                        raise RuntimeError(
                            f"{path}: this format needs PIL, which is not "
                            "installed (8-bit PNGs need nothing)")
                    img = np.asarray(pil.open(path))
                data[k] = img.astype(np.float32)
        return data


def rgb_to_gray(arr: np.ndarray) -> np.ndarray:
    """PIL's ``convert("L")``: ``(R*19595 + G*38470 + B*7471 + 0x8000) >> 16``
    on the uint8 channels (alpha ignored)."""
    rgb = arr[..., :3].astype(np.uint8).astype(np.uint32)
    y = (rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
         + 0x8000) >> 16
    return y.astype(np.uint8)


class ToGrayScaled(Transform):
    """RGB -> grayscale as PIL's 'L' mode (``data_transforms.py:389-400``)."""

    def __call__(self, data):
        for k in self._iter_keys(data):
            arr = _host(data[k])
            if arr.ndim == 3:
                data[k] = rgb_to_gray(arr).astype(np.float32)
            else:
                data[k] = arr.astype(np.float32)
        return data


class LoadGraphAndFilterByRandomRadiusd(Transform):
    """CSV graph -> rasterized grayscale image(s) with per-key min_radius and
    a shared dropout blackdict (``data_transforms.py:358-387``). K1 splats on
    the pool's device and the image stays there."""

    def __init__(self, keys, allow_missing_keys=False,
                 image_resolutions=((304, 304),), min_radius=(0,),
                 max_dropout_prob=0, MIP_axis=2, **kw):
        super().__init__(keys, allow_missing_keys)
        self.image_resolutions = [list(r) for r in image_resolutions]
        self.min_radius = list(min_radius)
        self.max_dropout_prob = max_dropout_prob
        self.mip_axis = MIP_axis

    def __call__(self, data):
        if "blackdict" in data:
            with open(data["blackdict"], "rb") as f:
                blackdict = pickle.load(f)
        else:
            blackdict = None
        arrays = None
        last_path = None
        for i, k in enumerate(self.keys):
            if k not in data:
                if self.allow_missing_keys:
                    continue
                raise KeyError(k)
            path = data[k]
            if arrays is None or path != last_path:
                arrays = raster.parse_graph_csv(path)
                last_path = path
            data[k], blackdict = raster.rasterize_forest_device(
                arrays, self.image_resolutions[i], self.mip_axis,
                min_radius=self.min_radius[i],
                max_dropout_prob=self.max_dropout_prob,
                blackdict=blackdict,
                rng=self.rng.py if self.rng else None,
                device=self.rng.device)
        return data


# ---------------------------------------------------------------------------
# Shape / dtype transforms
# ---------------------------------------------------------------------------

class EnsureChannelFirstd(Transform):
    def __init__(self, keys, channel_dim="no_channel", strict_check=False,
                 allow_missing_keys=False, **kw):
        super().__init__(keys, allow_missing_keys)
        self.channel_dim = channel_dim

    def __call__(self, data):
        for k in self._iter_keys(data):
            arr = data[k]
            if self.channel_dim == "no_channel" or arr.ndim == 2:
                data[k] = arr[None] if arr.ndim == 2 else arr
            elif arr.ndim == 3 and self.channel_dim in (-1, 2):
                data[k] = self._tensor(arr).movedim(-1, 0)
        return data


class AsChannelLast(Transform):
    def __call__(self, data):
        for k in self._iter_keys(data):
            data[k] = self._tensor(data[k]).movedim(0, -1)
        return data


_DTYPES = {
    "float32": torch.float32, "float": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "uint8": torch.uint8, "int64": torch.int64, "long": torch.int64,
    "int32": torch.int32, "bool": torch.bool,
    "dtype": torch.float32,  # substituted by the pipeline factory
}


def _torch_dtype(dt) -> torch.dtype:
    return _DTYPES[dt] if isinstance(dt, str) else dt


class CastToTyped(Transform):
    """Cast to a dtype; tensors stay tensors on their device."""

    def __init__(self, keys, dtype="float32", allow_missing_keys=False, **kw):
        super().__init__(keys, allow_missing_keys)
        self.dtype = dtype if isinstance(dtype, list) else [dtype] * len(self.keys)

    def __call__(self, data):
        for i, k in enumerate(self.keys):
            if k not in data:
                if self.allow_missing_keys:
                    continue
                raise KeyError(k)
            dt = _torch_dtype(self.dtype[min(i, len(self.dtype) - 1)])
            data[k] = self._tensor(data[k]).to(dt)
        return data


class SelectSlice(Transform):
    def __init__(self, keys, allow_missing_keys=False, slice_selection=None, **kw):
        super().__init__(keys, allow_missing_keys)
        self.sl = tuple(slice(s, e) for s, e in slice_selection) \
            if slice_selection else None

    def __call__(self, data):
        if self.sl is not None:
            for k in self._iter_keys(data):
                data[k] = data[k][self.sl]
        return data


# ---------------------------------------------------------------------------
# Intensity / geometry transforms (device)
# ---------------------------------------------------------------------------

class ScaleIntensityd(Transform):
    def __init__(self, keys, minv=0.0, maxv=1.0, allow_missing_keys=False, **kw):
        super().__init__(keys, allow_missing_keys)
        self.minv, self.maxv = minv, maxv

    def __call__(self, data):
        for k in self._iter_keys(data):
            data[k] = F.scale_intensity(self._tensor(data[k]), self.minv,
                                        self.maxv)
        return data


class Resized(Transform):
    """``jax.image.resize`` of each key to ``spatial_size`` in float32, by
    ``mode``: any method name JAX takes (``noise_model.resize_method``);
    another raises ``ValueError``."""

    def __init__(self, keys, spatial_size, mode="bilinear",
                 allow_missing_keys=False, **kw):
        super().__init__(keys, allow_missing_keys)
        self.size = tuple(spatial_size)
        self.method = nm.resize_method(mode)

    def __call__(self, data):
        for k in self._iter_keys(data):
            data[k] = nm.resize(self._tensor(data[k]).float(), self.size,
                                self.method)
        return data


class Resize:
    """Non-dict variant used in post-processing configs."""

    def __init__(self, spatial_size, mode="bilinear", **kw):
        self.size = tuple(spatial_size)
        self.method = nm.resize_method(mode)

    def __call__(self, x):
        return nm.resize(_tensor_any(x).float(), self.size, self.method)


class AsDiscreted(Transform):
    def __init__(self, keys, threshold=None, allow_missing_keys=False, **kw):
        super().__init__(keys, allow_missing_keys)
        self.threshold = threshold

    def __call__(self, data):
        for k in self._iter_keys(data):
            data[k] = F.as_discrete(self._tensor(data[k]), self.threshold)
        return data


class RandFlipd(Transform):
    def __init__(self, keys, prob=0.5, spatial_axis=(0, 1),
                 allow_missing_keys=False, **kw):
        super().__init__(keys, allow_missing_keys)
        self.prob = prob
        self.axes = [spatial_axis] if isinstance(spatial_axis, int) \
            else list(spatial_axis)

    def __call__(self, data):
        if self.rng.np.random() < self.prob:
            for k in self._iter_keys(data):
                data[k] = torch.flip(self._tensor(data[k]),
                                     dims=[a + 1 for a in self.axes])
        return data


class Flipd(Transform):
    def __init__(self, keys, spatial_axis=0, allow_missing_keys=False, **kw):
        super().__init__(keys, allow_missing_keys)
        self.axis = spatial_axis

    def __call__(self, data):
        for k in self._iter_keys(data):
            data[k] = torch.flip(self._tensor(data[k]), dims=(self.axis + 1,))
        return data


class RandRotate90d(Transform):
    def __init__(self, keys, prob=0.1, max_k=3, allow_missing_keys=False, **kw):
        super().__init__(keys, allow_missing_keys)
        self.prob, self.max_k = prob, max_k

    def __call__(self, data):
        if self.rng.np.random() < self.prob:
            k = int(self.rng.np.integers(1, self.max_k + 1))
            for key in self._iter_keys(data):
                data[key] = torch.rot90(self._tensor(data[key]), k, dims=(-2, -1))
        return data


class Rotate90d(Transform):
    def __init__(self, keys, k=1, allow_missing_keys=False, **kw):
        super().__init__(keys, allow_missing_keys)
        self.k = k

    def __call__(self, data):
        for key in self._iter_keys(data):
            data[key] = torch.rot90(self._tensor(data[key]), self.k,
                                    dims=(-2, -1))
        return data


class RandRotated(Transform):
    """Small-angle rotation, the same angle for all keys (``range_x`` in
    radians, bilinear, zero padding)."""

    def __init__(self, keys, prob=0.1, range_x=0.0, padding_mode="zeros",
                 mode="bilinear", allow_missing_keys=False, **kw):
        super().__init__(keys, allow_missing_keys)
        self.prob = prob
        self.range_x = range_x

    def __call__(self, data):
        if self.rng.np.random() < self.prob:
            angle = float(self.rng.np.uniform(-self.range_x, self.range_x))
            deg = float(np.degrees(angle))
            for k in self._iter_keys(data):
                data[k] = F.rotate_bilinear(self._tensor(data[k]).float(), deg)
        return data


class RandCropOrPadd(Transform):
    """Random zoom crop or pad (``data_transforms.py:543-585``): ``factor`` <
    1 crops (one window for all keys), ``factor`` > 1 zero-pads around the
    centre."""

    def __init__(self, keys, prob=0.1, min_factor=1.0, max_factor=1.0, **kw):
        super().__init__(keys)
        self.prob, self.min_factor, self.max_factor = prob, min_factor, max_factor

    def __call__(self, data):
        if self.rng.np.random() < self.prob:
            factor = float(self.rng.np.uniform(self.min_factor, self.max_factor))
            sl = None
            for k in self._iter_keys(data):
                x = self._tensor(data[k])
                if factor < 1:
                    if sl is None:
                        sh = int(x.shape[1] * factor)
                        sw = int(x.shape[2] * factor)
                        oy = int(self.rng.np.integers(0, x.shape[1] - sh + 1))
                        ox = int(self.rng.np.integers(0, x.shape[2] - sw + 1))
                        sl = (slice(oy, oy + sh), slice(ox, ox + sw))
                    data[k] = x[:, sl[0], sl[1]]
                elif factor > 1:
                    frame = x.new_zeros((x.shape[0], int(x.shape[1] * factor),
                                         int(x.shape[2] * factor)))
                    oy = (frame.shape[1] - x.shape[1]) // 2
                    ox = (frame.shape[2] - x.shape[2]) // 2
                    frame[:, oy:oy + x.shape[1], ox:ox + x.shape[2]] = x
                    data[k] = frame
        return data


# ---------------------------------------------------------------------------
# OCTA-specific noise transforms (device)
# ---------------------------------------------------------------------------

class AddRandomBackgroundNoised(Transform):
    def __init__(self, keys, delete_background=True, **kw):
        super().__init__(keys, True)
        self.delete_background = delete_background

    def __call__(self, data):
        for k in self._iter_keys(data):
            img = self._tensor(data[k]).float()
            if "background" in data:
                noise = self._tensor(data["background"]).float()
            else:
                noise = self.rng.uniform(img.shape)
            data[k] = F.add_random_background_noise(
                img, noise.expand(img.shape), self.rng.uniform(img.shape))
        if self.delete_background and "background" in data:
            del data["background"]
        return data


class NoiseModeld(Transform):
    """Handcrafted contrast adaptation in the pipeline
    (``data_transforms.py:435-475``), on the pool's device."""

    def __init__(self, keys, prob=1.0, allow_missing_keys=False,
                 grid_size=(9, 9), lambda_delta=1.0, lambda_speckle=0.7,
                 lambda_gamma=0.3, alpha=0.2, downsample_factor=1, **kw):
        super().__init__(keys, allow_missing_keys)
        self.prob = prob
        self.grid_size = tuple(grid_size)
        self.lambda_delta = lambda_delta
        self.lambda_speckle = lambda_speckle
        self.lambda_gamma = lambda_gamma
        self.downsample_factor = downsample_factor

    def __call__(self, data):
        if self.rng.py.random() < self.prob:
            for k in self._iter_keys(data):
                img = self._tensor(data[k]).float()  # [C, H, W]
                bg = self._tensor(data["background"]).float()
                params = self.rng.noise_params(img.shape[0], self.grid_size)
                h, w = img.shape[-2:]
                df = self.downsample_factor
                hw = (h, w) if df == 1 else (int(h / df), int(w / df))
                gammas = self.rng.noise_gammas(nm.beta_concentrations(params, hw))
                with torch.no_grad():
                    data[k] = nm.apply_noise_model(
                        params, img, bg[:img.shape[0]], gammas=gammas,
                        lambda_delta=self.lambda_delta,
                        lambda_speckle=self.lambda_speckle,
                        lambda_gamma=self.lambda_gamma, downsample_factor=df)
        return data


class RandomDecreaseResolutiond(Transform):
    def __init__(self, keys, p=1.0, max_factor=0.25, **kw):
        super().__init__(keys, True)
        self.p, self.max_factor = p, max_factor

    def __call__(self, data):
        if self.rng.py.random() < self.p:
            for k in self._iter_keys(data):
                x = self._tensor(data[k]).float()
                factor = self.rng.py.uniform(self.max_factor, 1.0)
                data[k] = F.decrease_resolution(x, factor, self.max_factor)
        return data


class AddLineArtifact(Transform):
    def __call__(self, data):
        for k in self._iter_keys(data):
            x = self._tensor(data[k]).float()
            start = self.rng.randint(0, x.shape[-2] - 9 + 1)
            data[k] = F.add_line_artifact(x, start)
        return data


class SpeckleBrightnesd(Transform):
    def __call__(self, data):
        for k in self._iter_keys(data):
            x = self._tensor(data[k]).float()
            grid = self.rng.uniform((9, 9))
            pixels = self.rng.uniform(x.shape[-2:])
            data[k] = F.speckle_brightness(x, grid, pixels)
        return data


class BinomialVesselNoised(Transform):
    """Binomial vessel-like noise, radial attenuation and quantum noise
    (``data_transforms.py:44-102``), vectorized."""

    def __init__(self, keys, allow_missing_keys=False, vessel_noise_scaling=0.5,
                 vessel_noise_blur=1.0, r=48, **kw):
        super().__init__(keys, allow_missing_keys)
        self.scaling = vessel_noise_scaling
        self.blur = vessel_noise_blur
        self.r = r

    def __call__(self, data):
        for k in self._iter_keys(data):
            x = self._tensor(data[k]).float()
            shape = tuple(x.shape[-2:])
            noise = (self.rng.uniform(shape) < 0.1).float()
            quantum = self.rng.uniform(shape) * 0.2
            noise = binary_dilation(noise, 1, connectivity=2)
            yy, xx = torch.meshgrid(torch.arange(shape[0], device=x.device),
                                    torch.arange(shape[1], device=x.device),
                                    indexing="ij")
            dist = torch.sqrt((yy - shape[0] / 2) ** 2 + (xx - shape[1] / 2) ** 2)
            for dr in [0, 3, 6, 9, 12]:
                noise = torch.where(dist < self.r - dr, noise * 0.7, noise)
            noise = F.gaussian_blur(noise, self.blur) * self.scaling
            data[k] = torch.clamp(
                (x + noise + quantum) / (1.0 + self.scaling / 1.5), 0.0, 1.0)
        return data


class AddVitreousFloater(Transform):
    """Random-walk polyline shadow (``data_transforms.py:104-185``): with
    probability ``floater_chance`` a polyline of 10-20 segments is drawn,
    dilated 10-30 times (scipy, on the host), blurred with sigma 10 on the
    pool's device and multiplied out of the image. Draws come from the
    pool's numpy stream in the JAX package's order."""

    def __init__(self, keys, allow_missing_keys=False, floater_chance=0.1,
                 floater_opacity_interval=(0.5, 1.0),
                 floater_segments_interval=(10, 20),
                 dilations_interval=(10, 30), **kw):
        super().__init__(keys, allow_missing_keys)
        self.chance = floater_chance
        self.opacity = floater_opacity_interval
        self.segments = floater_segments_interval
        self.dilations = dilations_interval

    @staticmethod
    def _line(p0, p1, shape):
        n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]))) + 1
        rr = np.linspace(p0[0], p1[0], n).round().astype(int)
        cc = np.linspace(p0[1], p1[1], n).round().astype(int)
        ok = (rr >= 0) & (rr < shape[0]) & (cc >= 0) & (cc < shape[1])
        return rr[ok], cc[ok]

    def floater_mask(self, h: int, w: int) -> np.ndarray:
        """The dilated polyline as a float32 [h, w] mask (host)."""
        from scipy.ndimage import binary_dilation as nd_dilate

        g = self.rng.np
        floater = np.zeros((h, w), np.float32)
        cur = np.array([g.integers(0, h), g.integers(0, w)])
        opacity = g.uniform(*self.opacity)
        for _ in range(int(g.integers(*self.segments))):
            nxt = cur + np.array([int(g.normal(scale=h / 10)),
                                  int(g.normal(scale=w / 10))])
            rr, cc = self._line(cur, nxt, (h, w))
            floater[rr, cc] = opacity
            cur = nxt
        return nd_dilate(floater > 0, iterations=int(
            g.integers(*self.dilations))).astype(np.float32)

    def __call__(self, data):
        if self.rng.np.random() < self.chance:
            for k in self._iter_keys(data):
                x = self._tensor(data[k]).float()
                mask = self.floater_mask(*x.shape[-2:])
                fl = F.gaussian_blur(torch.from_numpy(mask).to(x.device), 10.0)
                data[k] = x * (1 - fl)
        return data


class AddMotionArtifact(Transform):
    """Shear, stretch, buckle and whiteout row artifacts
    (``data_transforms.py:187-302``) on the host, in numpy, with the pool's
    numpy stream in the JAX package's order; the results go back to the
    pool's device. The label's artifact rows are 4x the image's: the
    transform is written for a label at 4x the image's resolution, as the
    experiment configs give it (``config_ves_seg-S_Menten_aug_*.yml``: 304²
    image, 1216² label). Where both are of one size
    (``config_ves_seg_menten.yml``) a stretch whose label row lies past the
    label raises ``IndexError``, at the same draw as in the JAX package.
    """

    def __init__(self, img_key, gt_key, artifacts=None, grace_margin=10,
                 max_shear=5, max_stretch=5, max_buckle=5, max_whiteout=1,
                 no_h_cuts=3, **kw):
        super().__init__([img_key, gt_key], False)
        self.img_key, self.gt_key = img_key, gt_key
        self.artifacts = artifacts or {
            "shear": 0.3, "stretch": 0.3, "buckle": 0.3, "whiteout": 0.1}
        self.grace_margin = grace_margin
        self.max_shear = max_shear
        self.max_stretch = max_stretch
        self.max_buckle = max_buckle
        self.max_whiteout = max_whiteout
        self.no_h_cuts = no_h_cuts

    def __call__(self, data):
        g = self.rng.np
        img = _host(data[self.img_key]).copy()
        gt = _host(data[self.gt_key]).copy()
        ishape, gshape = img.shape, gt.shape
        img, gt = img.squeeze(), gt.squeeze()
        for _ in range(int(g.integers(0, self.no_h_cuts))):
            t_img, t_gt = img.copy(), gt.copy()
            names = list(self.artifacts)
            probs = np.array([self.artifacts[n] for n in names])
            art = g.choice(names, p=probs / probs.sum())
            pos = int(g.integers(self.grace_margin,
                                 img.shape[0] - self.grace_margin))
            if art == "shear":
                s = int(g.integers(0, self.max_shear + 1))
                img[pos:, :] = np.roll(t_img[pos:, :], s, axis=1)
                img[pos:, :s] = 0
                gt[4 * pos:, :] = np.roll(t_gt[4 * pos:, :], 4 * s, axis=1)
                gt[4 * pos:, :4 * s] = 0
            elif art == "stretch":
                s = int(g.integers(1, self.max_stretch + 1))
                img[pos:pos + s, :] = t_img[pos, :]
                img[pos + s:, :] = t_img[pos:-s, :]
                gt[4 * pos:4 * pos + 4 * s, :] = t_gt[4 * pos, :]
                gt[4 * pos + 4 * s:, :] = t_gt[4 * pos:-4 * s, :]
            elif art == "buckle":
                s = int(g.integers(1, self.max_buckle + 1))
                img[pos:, :] = t_img[pos - s:-s, :]
                gt[4 * pos:, :] = t_gt[4 * pos - 4 * s:-4 * s, :]
            elif art == "whiteout":
                s = int(g.integers(1, self.max_whiteout + 1))
                img[pos:pos + s, :] = g.uniform(0.5, 1.0, (s, img.shape[1]))
        data[self.img_key] = self._tensor(img.reshape(ishape))
        data[self.gt_key] = self._tensor(gt.reshape(gshape))
        return data


class MentenAugmentationd(Transform):
    """The MICCAI-2022 baseline augmentation chain
    (``data_transforms.py:304-325``): ``BinomialVesselNoised``, then
    ``AddVitreousFloater`` on the image, then ``AddMotionArtifact`` on image
    and label, each at its defaults."""

    def __init__(self, img_key, gt_key, **kw):
        super().__init__([img_key, gt_key], False)
        self.binomial = BinomialVesselNoised([img_key], allow_missing_keys=True)
        self.floater = AddVitreousFloater([img_key], allow_missing_keys=True)
        self.motion = AddMotionArtifact(img_key, gt_key)

    def set_rng(self, rng):
        super().set_rng(rng)
        for t in (self.binomial, self.floater, self.motion):
            t.set_rng(rng)

    def __call__(self, data):
        return self.motion(self.floater(self.binomial(data)))


class ImageToImageTranslationd(Transform):
    """A frozen pretrained generator applied inside the pipeline
    (``data_transforms.py:327-356``): each key's [C, H, W] image goes
    through the network in float32 on the pool's device. The loader thread
    runs it, and grad mode and autocast are per thread in PyTorch, so the
    call sets both itself: inference mode, autocast off."""

    def __init__(self, model_path, keys, model_config=None,
                 allow_missing_keys=False, **kw):
        super().__init__(keys, allow_missing_keys)
        self.model_path = model_path
        self.model_config = model_config
        self.apply_fn = None

    def set_rng(self, rng: RngPool):
        from octa_tpu_torch.io.checkpoints import load_network_for_inference

        super().set_rng(rng)
        self.apply_fn = load_network_for_inference(
            self.model_path, self.model_config, device=rng.device)

    def __call__(self, data):
        dev = self.rng.device
        with torch.inference_mode(), torch.autocast(dev.type, enabled=False):
            for k in self._iter_keys(data):
                img = self._tensor(data[k]).to(dev, torch.float32)
                data[k] = self.apply_fn(img[None])[0]
        return data


# ---------------------------------------------------------------------------
# Post-processing (single-tensor) transforms
# ---------------------------------------------------------------------------

class RemoveOuterNoise(Transform):
    """Keep the components of a z-stack prediction that touch its central
    z-plane (3D reconstruction post-processing, ``data_transforms.py:
    418-432``): the central plane is set, the largest component of the
    volume (26-connected, on the host) is kept and the input is cut to it.
    Returns a bool numpy volume."""

    def __init__(self, z_axis=0, **kw):
        super().__init__(())
        self.z_axis = z_axis

    def __call__(self, volume):
        vol = _host(volume) > 0
        tmp = vol.copy()
        idx = [slice(None)] * tmp.ndim
        idx[self.z_axis] = tmp.shape[self.z_axis] // 2
        tmp[tuple(idx)] = True
        tmp = keep_largest_connected_component(tmp.astype(np.uint8)) > 0
        return np.logical_and(vol, tmp)


class Activations:
    def __init__(self, sigmoid=False, softmax=False, **kw):
        self.sigmoid, self.softmax = sigmoid, softmax

    def __call__(self, x):
        x = _tensor_any(x)
        if self.sigmoid:
            return torch.sigmoid(x)
        if self.softmax:
            return torch.softmax(x, dim=0)
        return x


class AsDiscrete:
    def __init__(self, threshold=None, **kw):
        self.threshold = threshold

    def __call__(self, x):
        return (_tensor_any(x) >= self.threshold).float()


class RemoveSmallObjects:
    """Remove components under ``min_size`` pixels, on the host (scipy);
    returns float32 numpy. The copy to the host is the span
    ``octa.post.to_host``, the removal ``octa.post.remove_small_objects``."""

    def __init__(self, min_size=64, connectivity=1, **kw):
        self.min_size = min_size
        self.connectivity = connectivity

    def __call__(self, x):
        with trace.span("octa.post.to_host"):
            arr = _host(x)
        with trace.span("octa.post.remove_small_objects"):
            if arr.ndim == 3:
                out = np.stack([remove_small_objects(arr[c], self.min_size,
                                                     self.connectivity)
                                for c in range(arr.shape[0])])
            else:
                out = remove_small_objects(arr, self.min_size,
                                           self.connectivity)
            return out.astype(np.float32)


_NP_DTYPES = {torch.float32: np.float32, torch.float16: np.float16,
              torch.uint8: np.uint8, torch.int64: np.int64,
              torch.int32: np.int32, torch.bool: np.bool_}


class CastToType:
    """Cast on the host: returns numpy (a tensor for bfloat16, which numpy
    lacks)."""

    def __init__(self, dtype="float32", **kw):
        self.dtype = _torch_dtype(dtype)

    def __call__(self, x):
        if self.dtype not in _NP_DTYPES:
            return _tensor_any(x).to(self.dtype)
        return _host(x).astype(_NP_DTYPES[self.dtype])


class Lambda:
    """Guarded Lambda: only ``lambda x: <expr>`` over ``np`` and ``torch``."""

    def __init__(self, func="lambda x: x", **kw):
        if not str(func).replace(" ", "").startswith("lambdax:"):
            raise ValueError("Lambda transforms must be 'lambda x: <expr>'")
        self.func = eval(func, {"__builtins__": {}}, {"np": np, "torch": torch})

    def __call__(self, x):
        return self.func(x)


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


TRANSFORM_REGISTRY = {
    c.__name__: c for c in [
        LoadImaged, ToGrayScaled, LoadGraphAndFilterByRandomRadiusd,
        EnsureChannelFirstd, AsChannelLast, CastToTyped, SelectSlice,
        ScaleIntensityd, Resized, Resize, AsDiscreted, RandFlipd, Flipd,
        RandRotate90d, Rotate90d, RandRotated, RandCropOrPadd,
        AddRandomBackgroundNoised, NoiseModeld, RandomDecreaseResolutiond,
        AddLineArtifact, SpeckleBrightnesd, BinomialVesselNoised,
        AddVitreousFloater, AddMotionArtifact, MentenAugmentationd,
        ImageToImageTranslationd, RemoveOuterNoise, Activations, AsDiscrete,
        RemoveSmallObjects, CastToType, Lambda,
    ]
}


def get_data_augmentations(aug_config, seed: int, dtype=torch.float32,
                           rng: RngPool | None = None, device="cuda"):
    """Build the transform list from a config (reference
    ``get_data_augmentations``, ``data_transforms.py:587-611``); a
    ``CastToType(d)`` to ``"dtype"`` casts to ``dtype``."""
    if aug_config is None:
        return []
    rng = rng or RngPool(seed, device)
    out = []
    for entry in aug_config:
        entry = dict(entry)
        name = entry.pop("name")
        if name not in TRANSFORM_REGISTRY:
            monai = _optional("monai.transforms")
            monai_cls = getattr(monai, name, None) if monai else None
            if monai_cls is None:
                raise KeyError(
                    f"transform '{name}' is not implemented in octa_tpu_torch "
                    "and MONAI is not installed. Supported transforms: "
                    + ", ".join(sorted(TRANSFORM_REGISTRY)) + ". "
                    "(The reference additionally dispatches arbitrary "
                    "monai.transforms names; installing MONAI restores "
                    "that fallthrough here.)")
            out.append(monai_cls(**entry))
            continue
        cls = TRANSFORM_REGISTRY[name]
        if name.startswith("CastToType"):
            dts = entry.get("dtype", "float32")
            islist = isinstance(dts, list)
            dts = dts if islist else [dts]
            dts = [dtype if d == "dtype" else d for d in dts]
            entry["dtype"] = dts if islist else dts[0]
        t = cls(**entry)
        if isinstance(t, Transform):
            t.set_rng(rng)
        out.append(t)
    return out
