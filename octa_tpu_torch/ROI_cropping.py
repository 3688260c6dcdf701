"""Automatic ROI detection, then crop or pad: the port's ``ROI_cropping.py``.

Counterpart of the root ``ROI_cropping.py`` (reference
``ROI_cropping.py:22-187``): four edge-difference detectors (x and y
gradients, on the image and on the image flipped) vote on the ROI's origin;
each image is cropped to ``--roi_size`` and zero-padded where it is smaller,
written under ``--output_dir`` (keeping the input's subdirectories), and
the crops of the wrong shape are listed in ``problematic.csv``:

    python -m octa_tpu_torch.ROI_cropping --input_dir <dir> \\
        --output_dir <dir> [--roi_size 512] [--problem_threshold 0.15]

The images are read by the port's loader (``LoadImaged``: the native reader,
else the numpy decoder; alpha dropped) and turned gray as PIL's ``convert("L")``
does (``ToGrayScaled``); the crops are written by ``io/images.py::
save_png_gray8``. It needs neither PIL nor a card: it runs on the host.
"""
from __future__ import annotations

import argparse
import csv
import glob
import os

import numpy as np

from octa_tpu_torch.data.dataset import natsorted


def calculate_roi_coordinates(img: np.ndarray, image_size: int,
                              roi_size: int):
    """Majority vote over four edge-difference detectors."""
    third = image_size // 3

    def detect(im):
        dxx = (im[:third, third:third * 2]
               - im[1:third + 1, third:third * 2]).sum(axis=1)
        dxy = np.abs(im[:third, third:third * 2]
                     - im[:third, third + 1:third * 2 + 1]).sum(axis=1)
        x_a = int(np.argmax(dxx)) + 1
        x_b = int(np.argmin(dxy[:-1] - dxy[1:])) + 1
        dyx = np.abs(im[third:third * 2, :third]
                     - im[third + 1:third * 2 + 1, :third]).sum(axis=0)
        dyy = (im[third:third * 2, :third]
               - im[third:third * 2, 1:third + 1]).sum(axis=0)
        y_a = int(np.argmin(dyx[:-1] - dyx[1:])) + 1
        y_b = int(np.argmax(dyy)) + 1
        return x_a, x_b, y_a, y_b

    xxs, xys, yxs, yys = detect(img)
    fxx, fxy, fyx, fyy = detect(np.flip(np.flip(img, axis=0), axis=1))
    xs_list = [xxs, xys, image_size - fxx - roi_size,
               image_size - fxy - roi_size]
    ys_list = [yxs, yys, image_size - fyx - roi_size,
               image_size - fyy - roi_size]
    xs = max(set(xs_list), key=xs_list.count)
    ys = max(set(ys_list), key=ys_list.count)
    return xs, ys


def read_gray(path: str) -> np.ndarray:
    """The image at ``path`` as float32 [H, W] gray levels, as
    ``np.array(Image.open(path).convert("L")).astype(np.float32)`` reads
    it. Raises ``OSError`` (or ``RuntimeError`` where a file needs PIL and
    PIL is absent) for a file no reader takes."""
    from octa_tpu_torch.data.transforms import LoadImaged, ToGrayScaled

    data = ToGrayScaled(["img"])(LoadImaged(["img"])({"img": path}))
    return np.asarray(data["img"], np.float32)


def main(argv=None) -> list[dict]:
    """Crop every PNG under ``--input_dir``; returns the problematic
    entries as written to ``problematic.csv``."""
    from octa_tpu_torch.io.images import save_png_gray8

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--input_dir", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--roi_size", type=int, default=512)
    parser.add_argument("--problem_threshold", type=float, default=0.15)
    args = parser.parse_args(argv)

    roi_size = args.roi_size
    files = natsorted(glob.glob(f"{args.input_dir}/**/*.png", recursive=True))
    assert len(files) > 0, f"No input files found for path {args.input_dir}"
    in_norm = os.path.normpath(args.input_dir)
    has_sub = any(os.path.dirname(os.path.normpath(p)) != in_norm
                  for p in files)

    problematic = []
    for path in files:
        name = os.path.basename(path).replace(".PNG", ".png")
        cohort = ""
        if has_sub:
            rel = os.path.relpath(os.path.dirname(path), args.input_dir)
            cohort = "" if rel == "." else rel
        try:
            img = read_gray(path)
        except (OSError, RuntimeError):
            problematic.append({"path": path, "save_path": None,
                                "shape": None, "xs": None, "ys": None})
            continue
        h, w = img.shape
        image_size = min(h, w)
        if h > roi_size + 1 and w > roi_size + 1:
            xs, ys = calculate_roi_coordinates(img, image_size, roi_size)
            cropped = img[xs:xs + roi_size, ys:ys + roi_size].astype(np.uint8)
        else:
            xs = ys = 0
            cropped = img[:roi_size, :roi_size].astype(np.uint8)

        out_dir = os.path.join(args.output_dir, cohort) if cohort \
            else args.output_dir
        os.makedirs(out_dir, exist_ok=True)
        save_path = os.path.join(out_dir, name)

        wrong_shape = cropped.shape[0] != roi_size or cropped.shape[1] != roi_size
        if wrong_shape:  # the root script's test, whatever near_edge says
            problematic.append({"path": path, "save_path": save_path,
                                "shape": cropped.shape, "xs": xs, "ys": ys})

        final = np.zeros((roi_size, roi_size), np.uint8)
        final[:cropped.shape[0], :cropped.shape[1]] = \
            cropped[:roi_size, :roi_size]
        save_png_gray8(save_path, final)

    os.makedirs(args.output_dir, exist_ok=True)
    with open(f"{args.output_dir}/problematic.csv", "w+", newline="") as f:
        w = csv.writer(f)
        if problematic:
            w.writerow(list(problematic[0].keys()))
            for e in problematic:
                w.writerow(e.values())
        else:
            w.writerow(["ALL CLEAR"])
    print(f"Cropped {len(files)} images, {len(problematic)} problematic.")
    return problematic


if __name__ == "__main__":
    main()
