"""A small segmentation-training dataset made on the spot.

The configs read their data from ``datasets/``, which a checkout does not
hold. :func:`make_seg_dataset` writes a stand-in with the same file kinds
under a directory of the caller's: the four fixture vessel graphs
(``octa_tpu_torch/assets/vessel_graphs``) copied round-robin, 8-bit
background PNGs of seeded uniform noise, validation pairs made from the
fixture graphs (the splat adapted by the noise model as the image, the
splat thresholded at 0.1 as the label) and, for the GAN-seg task, stand-ins
for its unpaired real images (``real_B``): noise-model renders of the
graphs. None of them is a real OCTA image. The PNGs are written with the Paeth
filter on every scanline, as libpng's adaptive filtering often picks for
photographs, so that reading them costs what reading such files costs
(``io/images.py`` undoes that filter in numpy). :func:`point_config_at`
points a config's data globs at it. Nothing is downloaded.

For the 3D reconstruction (``configs/config_3d_recon_supervised.yml``),
:func:`make_recon_dataset` writes graph CSVs with their label volumes,
voxelized by K4 as the dataset generator writes them, and
:func:`point_recon_config_at` gives that config the data blocks of the
JAX package's 3D-reconstruction test (``tests/test_3d_recon.py:30-62``).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from octa_tpu_torch.device import resolve_device
from octa_tpu_torch.io.images import save_png_gray8
from octa_tpu_torch.models import noise_model as nm
from octa_tpu_torch.ops import raster

PAETH = 4  # the PNG filter type of every scanline written here


def make_seg_dataset(root: str, n_graphs: int = 8, n_backgrounds: int = 8,
                     n_val: int = 4, background_res: int = 304,
                     val_res: int = 1216, seed: int = 0, device="cuda",
                     max_edges: int | None = None, n_real_b: int = 0,
                     real_b_res: int = 304) -> dict[str, str]:
    """Write graphs, backgrounds, validation pairs and ``n_real_b`` renders
    at ``real_b_res``² under ``root``; returns the glob of each kind.
    ``max_edges`` keeps only the first edges of each graph (parents come
    first, so the kept edges form trees), for small runs on the CPU."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    dirs = {k: os.path.join(root, k) for k in
            ("graphs", "backgrounds", "val_images", "val_labels", "real_b")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    _copy_graphs(dirs["graphs"], n_graphs, max_edges)
    for i in range(n_backgrounds):
        noise = rng.integers(0, 256, (background_res, background_res),
                             dtype=np.uint8)
        save_png_gray8(os.path.join(dirs["backgrounds"], f"bg_{i}.png"), noise,
                       filter_type=PAETH)
    g = torch.Generator(dev).manual_seed(seed)
    graphs = sorted(os.listdir(dirs["graphs"]))

    def render(i: int, res: int):
        """Graph ``i``'s splat at ``res``² adapted by the noise model and
        scaled to [0, 1], and the splat in [0, 1]."""
        graph = raster.parse_graph_csv(
            os.path.join(dirs["graphs"], graphs[i % len(graphs)]))
        splat, _ = raster.rasterize_forest_device(graph, [res, res], device=dev)
        splat = (splat / 255.0)[None]
        bg = torch.from_numpy(rng.random((1, res, res), np.float32)).to(dev)
        params = nm.sample_noise_params(1, g, device=dev)
        img = nm.apply_noise_model(params, splat, bg, g)
        img = (img - img.min()) / (img.max() - img.min()).clamp(min=1e-12)
        return img[0], splat[0]

    def write(kind: str, name: str, img: torch.Tensor) -> None:
        save_png_gray8(os.path.join(dirs[kind], name),
                       img.cpu().numpy().astype(np.uint8), filter_type=PAETH)

    for i in range(n_val):
        img, splat = render(i, val_res)
        write("val_images", f"val_{i}.png", (img * 255).round())
        write("val_labels", f"val_{i}.png", (splat >= 0.1) * 255)
    for i in range(n_real_b):
        img, _ = render(i + 1, real_b_res)
        write("real_b", f"real_b_{i}.png", (img * 255).round())
    return {"graphs": os.path.join(dirs["graphs"], "*.csv"),
            "backgrounds": os.path.join(dirs["backgrounds"], "*.png"),
            "val_images": os.path.join(dirs["val_images"], "*.png"),
            "val_labels": os.path.join(dirs["val_labels"], "*.png"),
            "real_b": os.path.join(dirs["real_b"], "*.png")}


def point_config_at(config: dict, globs: dict[str, str], save_dir: str) -> dict:
    """Point the data of a ``ves-seg`` or ``gan-ves-seg`` config at the globs
    of :func:`make_seg_dataset` (graphs for the synthetic inputs and labels,
    backgrounds, validation pairs, and the renders as ``real_B``; a Test
    phase's ``image`` reads the validation images) and its output at
    ``save_dir``."""
    sources = {"image": "graphs", "label": "graphs", "real_A": "graphs",
               "real_A_seg": "graphs", "background": "backgrounds",
               "real_B": "real_b"}
    for phase in ("Train", "Test"):
        for key, entry in config.get(phase, {}).get("data", {}).items():
            kind = "val_images" if (phase, key) == ("Test", "image") \
                else sources[key]
            entry["files"] = globs[kind]
    if "Validation" in config:
        val = config["Validation"]["data"]
        val["image"]["files"] = globs["val_images"]
        val["label"]["files"] = globs["val_labels"]
    config["Output"]["save_dir"] = save_dir
    return config


def drop_splits(config: dict) -> dict:
    """Every data entry's ``split`` (the experiment configs' index files,
    ``datasets/<set>/val_`` + the run's split id) taken out, so that a
    config pointed at the stand-in of :func:`make_seg_dataset`, which has no
    split files, reads every file its globs match. Returns ``config``,
    changed."""
    for phase in ("Train", "Validation", "Test"):
        for entry in config.get(phase, {}).get("data", {}).values():
            entry.pop("split", None)
    return config


def keep_image_at_background_size(config: dict) -> dict:
    """The one change ``configs/config_ves_seg-S_AA.yml`` needs to train:
    its second ``Resized`` takes ``label`` only, so that ``image`` stays at
    the background's size (304²), as in the S recipe, where the noise model
    runs at 304² before the upsample. As shipped it resizes ``image`` to
    1216² and ``background`` to 304², and ``ANTLoss``'s noise model
    multiplies the two (the JAX package's ANTLoss fails there with a
    shape error; the port's raises a ``ValueError``). ``ANTLoss`` resizes
    its sample to the label's size itself. Returns ``config``, changed."""
    resized = [a for a in config["Train"]["data_augmentation"]
               if a["name"] == "Resized"]
    image_resize = [a for a in resized if "image" in a["keys"]]
    if len(image_resize) != 1 or "label" not in image_resize[0]["keys"]:
        raise ValueError("expected one Resized of image and label in Train")
    image_resize[0]["keys"] = ["label"]
    return config


def _copy_graphs(dst_dir: str, n: int, max_edges: int | None) -> list[str]:
    """The fixture graphs copied round-robin into ``dst_dir`` as
    ``graph_{i}.csv``, each cut to its first ``max_edges`` edges where
    given; returns the paths."""
    fixtures = raster.fixture_graph_paths()
    os.makedirs(dst_dir, exist_ok=True)
    out = []
    for i in range(n):
        dst = os.path.join(dst_dir, f"graph_{i}.csv")
        with open(fixtures[i % len(fixtures)]) as f:
            lines = f.readlines()
        with open(dst, "w") as f:
            f.writelines(lines if max_edges is None else lines[:1 + max_edges])
        out.append(dst)
    return out


def make_recon_dataset(root: str, n_samples: int = 4, res: int = 1216,
                       depth: int = 53, device="cuda",
                       max_edges: int | None = None) -> dict[str, str]:
    """Write ``n_samples`` fixture graphs (``graphs/graph_{i}.csv``) and
    their label volumes (``volumes/graph_{i}.npy``: K4's uint8 (res, res,
    depth) voxelization, as the generator writes ``art_ven_img_gray.npy``)
    under ``root``; returns the glob of each kind. The generator
    (``octa_tpu_torch.generate_vessel_graph``) makes the same pair from
    grown graphs."""
    dev = resolve_device(device)
    graphs = _copy_graphs(os.path.join(root, "graphs"), n_samples, max_edges)
    vol_dir = os.path.join(root, "volumes")
    os.makedirs(vol_dir, exist_ok=True)
    for path in graphs:
        vol, _ = raster.voxelize_forest_device(
            raster.parse_graph_csv(path), [res, res, depth], device=dev)
        name = os.path.splitext(os.path.basename(path))[0]
        np.save(os.path.join(vol_dir, name + ".npy"), vol.cpu().numpy())
    return {"graphs": os.path.join(root, "graphs", "*.csv"),
            "volumes": os.path.join(vol_dir, "*.npy")}


def _recon_loading(res: int, z_keep: tuple[int, int], label: bool) -> list:
    """The loading transforms of ``tests/test_3d_recon.py:40-56``: the image
    rendered from the graph at ``res``² (K1), the label volume's planes
    ``z_keep`` as channels, thresholded at 0.1."""
    out = []
    if label:
        out.append({"name": "LoadImaged", "keys": ["label"], "image_only": True})
    out += [{"name": "LoadGraphAndFilterByRandomRadiusd", "keys": ["image"],
             "image_resolutions": [[res, res]], "min_radius": [0],
             "max_dropout_prob": 0},
            {"name": "ScaleIntensityd", "keys": ["image", "label"] if label
             else ["image"], "minv": 0, "maxv": 1},
            {"name": "EnsureChannelFirstd", "keys": ["image"],
             "strict_check": False, "channel_dim": "no_channel"}]
    if label:
        out += [{"name": "EnsureChannelFirstd", "keys": ["label"],
                 "strict_check": False, "channel_dim": 2},
                {"name": "SelectSlice", "keys": ["label"],
                 "slice_selection": [list(z_keep)]},
                {"name": "AsDiscreted", "keys": ["label"], "threshold": 0.1}]
    out.append({"name": "CastToTyped", "keys": ["image", "label"] if label
                else ["image"], "dtype": "dtype"})
    return out


def point_recon_config_at(config: dict, train: dict[str, str],
                          val: dict[str, str], save_dir: str, res: int = 1216,
                          z_keep: tuple[int, int] = (4, 48)) -> dict:
    """The z-stack variant of :func:`point_config_at`, for
    ``configs/config_3d_recon_supervised.yml``: Train and Validation read
    the graphs (``image``, rendered at ``res``²) and label volumes
    (``label``, planes ``z_keep`` kept: 44 of the generator's 53 at the
    default) of ``train`` and ``val`` (globs as :func:`make_recon_dataset`
    returns them); Test renders ``val``'s graphs and adds
    ``RemoveOuterNoise`` to its prediction post-processing. Model,
    optimizer, loss, batch size and the other post-processing stay as the
    config has them; ``General.model.out_channels`` must equal the planes
    kept. Returns ``config``, changed."""
    planes = z_keep[1] - z_keep[0]
    if int(config["General"]["model"]["out_channels"]) != planes:
        raise ValueError(f"out_channels {config['General']['model']['out_channels']}"
                         f" but {planes} planes kept")
    for phase, globs in (("Train", train), ("Validation", val)):
        config[phase]["data"] = {"image": {"files": globs["graphs"]},
                                 "label": {"files": globs["volumes"]}}
        config[phase]["data_augmentation"] = _recon_loading(res, z_keep, True)
    config["Test"]["data"] = {"image": {"files": val["graphs"]}}
    config["Test"]["data_augmentation"] = _recon_loading(res, z_keep, False)
    config["Test"]["post_processing"]["prediction"].append(
        {"name": "RemoveOuterNoise", "z_axis": 0})
    config["Output"]["save_dir"] = save_dir
    return config
