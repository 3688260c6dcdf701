"""Re-render stored vessel-graph CSVs as 2D images or 3D volumes.

Counterpart of the JAX package's ``visualize_vessel_graphs.py`` (the
reference-compatible CLI). Run it as ``python3 -m
octa_tpu_torch.visualize_vessel_graphs --source_dir <dir with csv files>
--out_dir <dir> --resolution 1216,1216,16 [--save_3d] [--binarize]``. It runs
on the card unless ``--device cpu`` is given, and keeps each image or volume
on the device until the one copy to the host that writes the file (8-bit
PNG, or ``.npy``). ``--save_3d_as`` is taken and, as in the JAX package's
CLI, a volume is written as ``.npy`` whatever it names.
"""
from __future__ import annotations

import argparse
import os
import pickle
from glob import glob

import torch

from octa_tpu_torch.device import resolve_device
from octa_tpu_torch.io import images
from octa_tpu_torch.ops import raster


def _binarize(x: torch.Tensor) -> torch.Tensor:
    return ((x / 255.0) > 0.1).to(torch.uint8) * 255


def main(argv=None) -> list[str]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source_dir", type=str, required=True)
    parser.add_argument("--out_dir", type=str, required=True)
    parser.add_argument("--resolution", type=str, default="1216,1216,16")
    parser.add_argument("--binarize", action="store_true")
    parser.add_argument("--save_3d", action="store_true")
    parser.add_argument("--save_3d_as", type=str, default="npy")
    parser.add_argument("--mip_axis", type=int, default=2)
    parser.add_argument("--max_dropout_prob", type=float, default=0)
    parser.add_argument("--save_blackdict", action="store_true")
    parser.add_argument("--blackdict_dir", type=str, default=None)
    parser.add_argument("--ignore_z", action="store_true")
    parser.add_argument("--num_samples", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    resolution = [int(r) for r in args.resolution.split(",")]
    csvs = sorted(glob(os.path.join(args.source_dir, "**", "*.csv"),
                       recursive=True))
    if args.num_samples:
        csvs = csvs[: args.num_samples]
    if not csvs:
        raise FileNotFoundError(f"No csv files found under {args.source_dir}")

    written = []
    for path in csvs:
        name = os.path.splitext(os.path.basename(path))[0]
        arrays = raster.parse_graph_csv(path)
        blackdict = None
        if args.blackdict_dir:
            bd_path = os.path.join(args.blackdict_dir, name + "_blackdict.pkl")
            if os.path.exists(bd_path):
                with open(bd_path, "rb") as f:
                    blackdict = pickle.load(f)
        if args.save_3d:
            vol, blackdict = raster.voxelize_forest_device(
                arrays, resolution, max_dropout_prob=args.max_dropout_prob,
                blackdict=blackdict, ignore_z=args.ignore_z, device=dev)
            if args.binarize:
                vol = _binarize(vol)
            out = os.path.join(args.out_dir, name + ".npy")
            images.save_npy(out, vol.cpu().numpy())
        else:
            image_res = [*resolution]
            if len(image_res) == 3:
                del image_res[args.mip_axis]
            img, blackdict = raster.rasterize_forest_device(
                arrays, image_res, args.mip_axis,
                max_dropout_prob=args.max_dropout_prob, blackdict=blackdict,
                device=dev)
            img = _binarize(img) if args.binarize else img.to(torch.uint8)
            out = os.path.join(args.out_dir, name + ".png")
            images.save_png_gray8(out, img.cpu().numpy())
        written.append(out)
        if args.save_blackdict and blackdict:
            with open(os.path.join(args.out_dir, name + "_blackdict.pkl"),
                      "wb") as f:
                pickle.dump(blackdict, f)
        print(f"rendered {name}")
    return written


if __name__ == "__main__":
    main()
