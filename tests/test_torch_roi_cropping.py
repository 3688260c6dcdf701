"""Port parity: ``python -m octa_tpu_torch.ROI_cropping`` against the root
``ROI_cropping.py``.

The same inputs (gray and RGB PNGs with a bright ROI, one in a
subdirectory, one smaller than the ROI, one file that is not a PNG) give
the same crops, pixel for pixel, and the same ``problematic.csv``, byte for
byte but for the output directory's name. The gray conversion of RGB
inputs is PIL's ``convert("L")`` exactly (the port reads without PIL), and
``calculate_roi_coordinates`` equals the root script's on random images.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from octa_tpu_torch import ROI_cropping as roi

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def inputs(tmp_path, rng):
    from PIL import Image

    inp = tmp_path / "in"
    (inp / "cohort").mkdir(parents=True)
    gray = np.zeros((200, 210), np.uint8)
    gray[40:160, 45:165] = rng.integers(100, 255, (120, 120))
    Image.fromarray(gray).save(inp / "a.png")
    rgb = np.zeros((230, 220, 3), np.uint8)
    rgb[20:150, 60:190] = rng.integers(0, 256, (130, 130, 3))
    Image.fromarray(rgb).save(inp / "cohort" / "b.png")
    Image.fromarray(rng.integers(0, 256, (70, 95), dtype=np.uint8)).save(
        inp / "cohort" / "small.png")
    (inp / "broken.png").write_bytes(b"this is not a PNG file")
    return inp


def test_crops_and_csv_equal_the_root_script(inputs, tmp_path):
    from PIL import Image

    r = subprocess.run(
        [sys.executable, "ROI_cropping.py", "--input_dir", str(inputs),
         "--output_dir", str(tmp_path / "ref"), "--roi_size", "100"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-2000:]
    problems = roi.main(["--input_dir", str(inputs), "--output_dir",
                         str(tmp_path / "ours"), "--roi_size", "100"])
    assert len(problems) == 2
    names = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "ref")
                   for d, _, fs in os.walk(tmp_path / "ref") for f in fs)
    assert names == sorted(
        os.path.relpath(os.path.join(d, f), tmp_path / "ours")
        for d, _, fs in os.walk(tmp_path / "ours") for f in fs)
    assert names == ["a.png", "cohort/b.png", "cohort/small.png",
                     "problematic.csv"]
    for name in names[:-1]:
        ref = np.asarray(Image.open(tmp_path / "ref" / name))
        ours = np.asarray(Image.open(tmp_path / "ours" / name))
        assert ours.shape == (100, 100) and ours.dtype == np.uint8
        np.testing.assert_array_equal(ours, ref, err_msg=name)
    ref_csv = (tmp_path / "ref" / "problematic.csv").read_text()
    ours_csv = (tmp_path / "ours" / "problematic.csv").read_text()
    assert ours_csv == ref_csv.replace(str(tmp_path / "ref"),
                                       str(tmp_path / "ours"))
    assert "broken.png" in ours_csv and "(70, 95)" in ours_csv


def test_gray_conversion_is_pils(tmp_path, rng):
    from PIL import Image

    arr = rng.integers(0, 256, (64, 48, 3), dtype=np.uint8)
    arr[0, :8] = [[255, 255, 255], [0, 0, 0], [255, 0, 0], [0, 255, 0],
                  [0, 0, 255], [1, 1, 1], [128, 128, 127], [254, 1, 254]]
    path = str(tmp_path / "rgb.png")
    Image.fromarray(arr).save(path)
    ref = np.asarray(Image.open(path).convert("L")).astype(np.float32)
    np.testing.assert_array_equal(roi.read_gray(path), ref)


def test_roi_coordinates_equal_the_root_script(rng):
    sys.path.insert(0, ROOT)
    try:
        import ROI_cropping as ref
    finally:
        sys.path.remove(ROOT)
    for size in (150, 301):
        img = rng.integers(0, 256, (size, size)).astype(np.float32)
        img[size // 5:, size // 4:] += 200
        assert roi.calculate_roi_coordinates(img, size, 100) == \
            ref.calculate_roi_coordinates(img, size, 100)
