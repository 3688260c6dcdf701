"""A small segmentation-training dataset made on the spot.

The configs read their data from ``datasets/``, which a checkout does not
hold. :func:`make_seg_dataset` writes a stand-in with the same file kinds
under a directory of the caller's: the four fixture vessel graphs
(``octa_tpu_torch/assets/vessel_graphs``) copied round-robin, 8-bit
background PNGs of seeded uniform noise, and validation pairs made from the
fixture graphs (the splat adapted by the noise model as the image, the
splat thresholded at 0.1 as the label). The PNGs are written with the Paeth
filter on every scanline, as libpng's adaptive filtering often picks for
photographs, so that reading them costs what reading such files costs
(``io/images.py`` undoes that filter in numpy). :func:`point_config_at`
points a config's data globs at it. Nothing is downloaded.
"""
from __future__ import annotations

import os
import shutil

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
                     max_edges: int | None = None) -> dict[str, str]:
    """Write graphs, backgrounds and validation pairs under ``root``;
    returns the glob of each kind. ``max_edges`` keeps only the first edges
    of each graph (parents come first, so the kept edges form trees), for
    small runs on the CPU."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    fixtures = raster.fixture_graph_paths()
    dirs = {k: os.path.join(root, k) for k in
            ("graphs", "backgrounds", "val_images", "val_labels")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    for i in range(n_graphs):
        dst = os.path.join(dirs["graphs"], f"graph_{i}.csv")
        if max_edges is None:
            shutil.copyfile(fixtures[i % len(fixtures)], dst)
        else:
            with open(fixtures[i % len(fixtures)]) as f:
                lines = f.readlines()[:1 + max_edges]
            with open(dst, "w") as f:
                f.writelines(lines)
    for i in range(n_backgrounds):
        noise = rng.integers(0, 256, (background_res, background_res),
                             dtype=np.uint8)
        save_png_gray8(os.path.join(dirs["backgrounds"], f"bg_{i}.png"), noise,
                       filter_type=PAETH)
    g = torch.Generator(dev).manual_seed(seed)
    graphs = sorted(os.listdir(dirs["graphs"]))
    for i in range(n_val):
        graph = raster.parse_graph_csv(
            os.path.join(dirs["graphs"], graphs[i % len(graphs)]))
        splat, _ = raster.rasterize_forest_device(
            graph, [val_res, val_res], device=dev)
        splat = (splat / 255.0)[None]
        bg = torch.from_numpy(rng.random((1, val_res, val_res), np.float32)).to(dev)
        params = nm.sample_noise_params(1, g, device=dev)
        img = nm.apply_noise_model(params, splat, bg, g)
        img = (img - img.min()) / (img.max() - img.min()).clamp(min=1e-12)
        save_png_gray8(os.path.join(dirs["val_images"], f"val_{i}.png"),
                       (img[0] * 255).round().byte().cpu().numpy(),
                       filter_type=PAETH)
        save_png_gray8(os.path.join(dirs["val_labels"], f"val_{i}.png"),
                       ((splat[0] >= 0.1) * 255).byte().cpu().numpy(),
                       filter_type=PAETH)
    return {"graphs": os.path.join(dirs["graphs"], "*.csv"),
            "backgrounds": os.path.join(dirs["backgrounds"], "*.png"),
            "val_images": os.path.join(dirs["val_images"], "*.png"),
            "val_labels": os.path.join(dirs["val_labels"], "*.png")}


def point_config_at(config: dict, globs: dict[str, str], save_dir: str) -> dict:
    """Point the Train and Validation data of a ``ves-seg`` config at the
    globs of :func:`make_seg_dataset` and its output at ``save_dir``."""
    train = config["Train"]["data"]
    train["image"]["files"] = train["label"]["files"] = globs["graphs"]
    train["background"]["files"] = globs["backgrounds"]
    if "Validation" in config:
        val = config["Validation"]["data"]
        val["image"]["files"] = globs["val_images"]
        val["label"]["files"] = globs["val_labels"]
    config["Output"]["save_dir"] = save_dir
    return config
