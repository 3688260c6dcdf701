"""Generate synthetic vessel graphs, 3D volumes and 2D images.

Counterpart of the JAX package's ``generate_vessel_graph.py`` (the
reference-compatible dataset generator): grow ``--num_samples`` simulations
batched on the device, and per sample write into a new directory under the
config's ``output.directory``:

- ``config.json``           the configuration used,
- ``<name>.csv``            the arterial and venous trees (``save_trees``),
- ``art_ven_img_gray.npy``  the uint8 volume, the maximum of the arterial and
                            the venous voxelization (``save_3D_volumes: npy``;
                            ``art_ven_img_gray.nii.npy`` for ``nifti``, as the
                            JAX package's CLI writes it without nibabel, and
                            as ``LoadImaged`` reads a ``.nii`` path),
- ``art_ven_img_gray.png``  the uint8 image, the maximum of the two 2D
                            rasterizations (``save_2D_image``).

Run it as ``python3 -m octa_tpu_torch.generate_vessel_graph --config_file
builtin --num_samples 8 --output.image_scale_factor 1216
--output.save_3D_volumes npy``. ``--config_file`` takes a ``.json`` file, a
``.yml`` file where PyYAML is installed, or ``builtin`` for
``configs/vessel_graph_gen.yml`` as :mod:`octa_tpu_torch.sim.configs` holds
it; dotted arguments override config keys. It runs on the card unless
``--device cpu`` is given; ``--banded`` grows with the banded nearest scans.

The volume and the image stay on the device until the one copy to the host
that writes each file. ``output.save_stats`` (needs matplotlib) is not
ported and raises.
"""
from __future__ import annotations

import argparse
import datetime
import os
import time
import uuid

import torch

from octa_tpu_torch.device import resolve_device
from octa_tpu_torch.io import images
from octa_tpu_torch.ops import raster
from octa_tpu_torch.sim import greenhouse as gh
from octa_tpu_torch.sim.configs import vessel_graph_gen
from octa_tpu_torch.utils.config import (apply_cli_overrides, dump_config,
                                         load_config)


def prepare_output_dir(out_cfg: dict) -> str:
    stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    out = os.path.join(out_cfg["directory"], f"{stamp}_{uuid.uuid4().hex[:8]}")
    os.makedirs(out, exist_ok=True)
    return out


def check_output_config(out_cfg: dict) -> None:
    """Raise on the output options that are not ported."""
    vol = out_cfg.get("save_3D_volumes")
    if vol not in (None, "npy", "nifti"):
        raise ValueError(f"Invalid save_3D_volumes option {vol}")
    if out_cfg.get("save_stats"):
        raise NotImplementedError(
            "output.save_stats is not ported (it plots with matplotlib); "
            "set it to false")


def generate(config: dict, num_samples: int = 1, *, seed: int = 0,
             batch_size: int | None = None, banded: bool = False,
             device="cuda", timings: dict | None = None,
             log=print) -> list[str]:
    """Grow ``num_samples`` simulations in batches and write each sample's
    files; returns the sample directories. ``timings``, when given, receives
    the seconds spent in ``grow``, ``voxelize``, ``rasterize`` and ``write``
    (each stage ends in a device synchronization or a copy to the host)."""
    dev = resolve_device(device)
    out_cfg = config["output"]
    check_output_config(out_cfg)
    spent = {"grow": 0.0, "voxelize": 0.0, "rasterize": 0.0, "write": 0.0}

    def lap(stage: str, t0: float) -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        spent[stage] += t1 - t0
        return t1

    g = gh.Greenhouse(config["Greenhouse"], seed=seed, device=dev,
                      banded=banded)
    batch = batch_size or min(num_samples, 64)
    scale = out_cfg["image_scale_factor"]
    volume_dimension = [int(d * scale) for d in g.sizes]
    axis = out_cfg["proj_axis"]
    out_dirs: list[str] = []
    while len(out_dirs) < num_samples:
        b = min(batch, num_samples - len(out_dirs))
        g.seed = seed + len(out_dirs)
        t = time.perf_counter()
        state = g.develop_forest(config["Forest"], batch=b)
        t = lap("grow", t)
        for i in range(b):
            out_dir = prepare_output_dir(out_cfg)
            dump_config(config, os.path.join(out_dir, "config.json"))
            art = gh.forest_to_edges(state.art, i)
            ven = gh.forest_to_edges(state.ven, i)
            name = os.path.basename(out_dir)
            if out_cfg.get("save_trees"):
                gh.save_edges_csv([art, ven],
                                  os.path.join(out_dir, name + ".csv"))
            t = lap("write", t)

            if out_cfg.get("save_3D_volumes"):
                art_vol, _ = raster.voxelize_forest_device(
                    art, volume_dimension, device=dev)
                ven_vol, _ = raster.voxelize_forest_device(
                    ven, volume_dimension, device=dev)
                vol = torch.maximum(art_vol, ven_vol)
                t = lap("voxelize", t)
                suffix = ".npy" if out_cfg["save_3D_volumes"] == "npy" \
                    else ".nii.npy"
                images.save_npy(
                    os.path.join(out_dir, "art_ven_img_gray" + suffix),
                    vol.cpu().numpy())
                t = lap("write", t)

            if out_cfg.get("save_2D_image"):
                image_res = [*volume_dimension]
                del image_res[axis]
                art_img, _ = raster.rasterize_forest_device(
                    art, image_res, MIP_axis=axis, device=dev)
                ven_img, _ = raster.rasterize_forest_device(
                    ven, image_res, MIP_axis=axis, device=dev)
                img = torch.maximum(art_img, ven_img).to(torch.uint8)
                t = lap("rasterize", t)
                images.save_png_gray8(
                    os.path.join(out_dir, "art_ven_img_gray.png"),
                    img.cpu().numpy())
                t = lap("write", t)
            out_dirs.append(out_dir)
            log(f"[{len(out_dirs)}/{num_samples}] {out_dir}")
    if timings is not None:
        timings.update(spent)
    return out_dirs


def main(argv=None) -> list[str]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config_file", type=str, required=True,
                        help="a .json config, a .yml one where PyYAML is "
                        "installed, or 'builtin'")
    parser.add_argument("--num_samples", type=int, default=1)
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--threads", type=int, default=-1,
                        help="kept for CLI parity; batching replaces it")
    parser.add_argument("--batch_size", type=int, default=None,
                        help="simulations grown per device batch")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--banded", action="store_true",
                        help="grow with the banded nearest scans (K5)")
    parser.add_argument("--device", type=str, default="cuda")
    args, unknown = parser.parse_known_args(argv)

    if args.debug:
        import warnings

        warnings.filterwarnings("error")

    config = (vessel_graph_gen() if args.config_file == "builtin"
              else load_config(args.config_file))
    apply_cli_overrides(config, unknown)
    return generate(config, args.num_samples, seed=args.seed,
                    batch_size=args.batch_size, banded=args.banded,
                    device=args.device)


if __name__ == "__main__":
    main()
