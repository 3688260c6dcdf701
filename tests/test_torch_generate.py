"""The port's dataset generator and its helpers, on the CPU at a cut size.

``octa_tpu_torch.generate_vessel_graph`` runs the whole path (grow, CSV, 3D
volume, 2D image) with ``--device cpu`` on a schedule of a few iterations at
scale 76; every file it writes is read back: the PNG with PIL (the port's
writer uses zlib and struct only) against the array rendered from the CSV,
the volume against ``voxelize_forest`` of the CSV, the CSV against the
graph parser. The command-line overrides are held to
``octa_tpu.utils.config`` (which parses values with PyYAML) on the same
argument lists; the renderers' numerics are held to the JAX package in
``test_torch_splat3d.py``.
"""
import copy
import json
import os
import pickle

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from octa_tpu.utils import config as jc
from octa_tpu_torch import generate_vessel_graph as gen
from octa_tpu_torch import visualize_vessel_graphs as viz
from octa_tpu_torch.io import images
from octa_tpu_torch.ops import raster as tr
from octa_tpu_torch.sim import configs
from octa_tpu_torch.utils import config as tc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("[{name: SVC, I: 6, N: 300, eps_n: 0.18, eps_s: 0.135, eps_k: 0.135, "
         "delta_art: 0.2925, delta_ven: 0.2925, gamma_art: 50, gamma_ven: 50, "
         "phi: 15, omega: 0.3, kappa: 2.55, delta_sigma: 0.02}]")


@pytest.fixture(scope="module", autouse=True)
def _warm_threads():
    """See ``test_torch_banded.py``: the first multi-threaded ``torch.sqrt``
    of a process is taken here, not inside a comparison."""
    torch.sqrt(torch.rand(1 << 20))


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """Two samples written by the command-line entry point (banded growth,
    3D volumes on), and the directory they went to."""
    out = tmp_path_factory.mktemp("gen")
    dirs = gen.main([
        "--config_file", "builtin", "--num_samples", "2", "--batch_size", "2",
        "--seed", "4", "--device", "cpu", "--banded",
        "--output.directory", str(out), "--output.image_scale_factor", "76",
        "--output.save_3D_volumes", "npy", "--Greenhouse.modes", MODES])
    return out, dirs


def test_generate_writes_every_file(generated):
    out, dirs = generated
    assert len(dirs) == 2 and len(set(dirs)) == 2
    for d in dirs:
        name = os.path.basename(d)
        assert os.path.dirname(d) == str(out)
        assert sorted(os.listdir(d)) == sorted(
            ["config.json", name + ".csv", "art_ven_img_gray.npy",
             "art_ven_img_gray.png"])
        with open(os.path.join(d, "config.json")) as f:
            cfg = json.load(f)
        assert cfg["output"]["image_scale_factor"] == 76
        assert cfg["output"]["save_3D_volumes"] == "npy"
        assert cfg["Greenhouse"]["modes"][0]["I"] == 6
        assert cfg["Forest"] == configs.VESSEL_GRAPH_GEN["Forest"]


def test_generated_files_read_back(generated):
    _, dirs = generated
    counts = []
    for d in dirs:
        name = os.path.basename(d)
        graph = tr.parse_graph_csv(os.path.join(d, name + ".csv"))
        n = len(graph["radius"])
        counts.append(n)
        assert n > 30 and graph["node1"].shape == (n, 3)
        assert (graph["radius"] > 0).all() and graph["node1"].min() > -0.2
        # the PNG, read with PIL, against the image rendered from the CSV.
        # The file holds the maximum of the two trees' images, the CSV's
        # rendering composites both trees: never darker than the file (the
        # CSV keeps 8 decimals: one level), brighter only where they cross
        png = np.asarray(Image.open(os.path.join(d, "art_ven_img_gray.png")))
        assert png.shape == (76, 76) and png.dtype == np.uint8
        assert np.array_equal(png, images.load_png_gray8(
            os.path.join(d, "art_ven_img_gray.png")))
        img, _ = tr.rasterize_forest(graph, [76, 76], device="cpu")
        over = img.astype(np.uint8).astype(int) - png
        assert over.min() >= -1 and (over > 1).mean() < 0.02
        assert png.max() > 30
        vol = np.load(os.path.join(d, "art_ven_img_gray.npy"))
        assert vol.shape == (76, 76, 4) and vol.dtype == np.uint8
        ref, _ = tr.voxelize_forest(graph, [76, 76, 0], device="cpu")
        assert np.abs(vol.astype(int) - ref.astype(int)).max() <= 1
        assert vol.max() > 30
        # the volume's z-maximum lies over the image
        mip, im = vol.max(-1) > 10, png > 10
        dice = 2 * (mip & im).sum() / (mip.sum() + im.sum())
        assert dice > 0.6, dice
    assert counts[0] != counts[1]  # two seeds, two forests


def test_generate_function_batches_and_times(tmp_path):
    cfg = configs.vessel_graph_gen()
    cfg["Greenhouse"]["modes"] = yaml.safe_load(MODES)
    cfg["Greenhouse"]["modes"][0]["I"] = 3
    cfg["output"].update(directory=str(tmp_path), image_scale_factor=76,
                         save_2D_image=False, save_trees=False)
    timings, lines = {}, []
    dirs = gen.generate(cfg, 3, seed=1, batch_size=2, device="cpu",
                        timings=timings, log=lines.append)
    assert len(dirs) == 3 and len(lines) == 3 and lines[-1].startswith("[3/3]")
    assert set(timings) == {"grow", "voxelize", "rasterize", "write"}
    assert timings["grow"] > 0 and timings["voxelize"] == 0
    assert all(os.listdir(d) == ["config.json"] for d in dirs)


@pytest.mark.parametrize("key,value,err", [
    ("save_3D_volumes", "tiff", ValueError),
    ("save_stats", True, NotImplementedError)])
def test_generate_refuses_what_is_not_ported(tmp_path, key, value, err):
    cfg = configs.vessel_graph_gen()
    cfg["output"].update({"directory": str(tmp_path), key: value})
    with pytest.raises(err):
        gen.generate(cfg, 1, device="cpu")
    assert not os.listdir(tmp_path)


def test_generate_writes_the_nifti_fallback(tmp_path):
    """``save_3D_volumes: nifti`` writes ``art_ven_img_gray.nii.npy``, as
    the JAX package's CLI does without nibabel, and ``LoadImaged`` reads it
    back through the ``.nii`` path."""
    from octa_tpu_torch.data import transforms as tt

    cfg = configs.vessel_graph_gen()
    cfg["Greenhouse"]["modes"] = yaml.safe_load(MODES)
    cfg["Greenhouse"]["modes"][0]["I"] = 3
    cfg["output"].update(directory=str(tmp_path), image_scale_factor=76,
                         save_2D_image=False, save_trees=False,
                         save_3D_volumes="nifti")
    (d,) = gen.generate(cfg, 1, seed=1, device="cpu", log=lambda line: None)
    assert sorted(os.listdir(d)) == ["art_ven_img_gray.nii.npy", "config.json"]
    vol = np.load(os.path.join(d, "art_ven_img_gray.nii.npy"))
    assert vol.dtype == np.uint8 and vol.shape == (76, 76, 4) and vol.any()
    load = tt.LoadImaged(keys=["label"])
    got = load({"label": os.path.join(d, "art_ven_img_gray.nii")})["label"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, vol.astype(np.float32))


def test_visualize_renders_csvs(generated, tmp_path):
    out, dirs = generated
    common = ["--source_dir", str(out), "--device", "cpu"]
    pngs = viz.main(common + ["--out_dir", str(tmp_path / "a"),
                              "--resolution", "76,76,16"])
    assert len(pngs) == 2 and all(p.endswith(".png") for p in pngs)
    name = os.path.basename(sorted(dirs)[0])
    graph = tr.parse_graph_csv(os.path.join(out, name, name + ".csv"))
    img, _ = tr.rasterize_forest(graph, [76, 76], device="cpu")
    got = np.asarray(Image.open(tmp_path / "a" / (name + ".png")))
    assert np.array_equal(got, img.astype(np.uint8))
    # binarized volumes, one sample, the drop-out dictionary saved; the
    # drop-out probability is random.random() ** 10 * 0.9: seed 2 draws 0.956
    import random

    random.seed(2)
    vols = viz.main(common + [
        "--out_dir", str(tmp_path / "b"), "--resolution", "76,76,16",
        "--save_3d", "--binarize", "--num_samples", "1", "--ignore_z",
        "--max_dropout_prob", "0.9", "--save_blackdict"])
    assert len(vols) == 1
    vol = np.load(vols[0])
    assert vol.shape == (76, 76, 16) and vol.dtype == np.uint8
    assert set(np.unique(vol)) <= {0, 255} and vol.any()
    assert not vol[:, :, :4].any()   # ignore_z: everything on the mid slice
    first = os.path.splitext(os.path.basename(vols[0]))[0]
    with open(tmp_path / "b" / (first + "_blackdict.pkl"), "rb") as f:
        assert len(pickle.load(f)) > 0
    with pytest.raises(FileNotFoundError, match="No csv files"):
        viz.main(["--source_dir", str(tmp_path / "b"), "--out_dir",
                  str(tmp_path / "c"), "--device", "cpu"])
    # --save_3d_as is taken, and a volume is written as .npy (JAX's CLI)
    nii = viz.main(common + ["--out_dir", str(tmp_path / "c"), "--save_3d",
                             "--save_3d_as", "nifti", "--num_samples", "1",
                             "--resolution", "76,76,4"])
    assert [os.path.basename(p) for p in nii] == [first + ".npy"]
    assert np.load(nii[0]).shape == (76, 76, 4)


@pytest.mark.parametrize("shape", [(1, 1), (37, 53), (304, 304)])
def test_png_writer_round_trips_through_pil(tmp_path, rng, shape):
    img = (rng.random(shape) * 256).astype(np.uint8)
    path = str(tmp_path / "sub" / "a.png")
    images.save_png_gray8(path, img)
    with Image.open(path) as im:
        assert im.mode == "L" and im.size == shape[::-1]
        assert np.array_equal(np.asarray(im), img)
    assert np.array_equal(images.load_png_gray8(path), img)
    Image.fromarray(img).save(str(tmp_path / "pil.png"))  # PIL may filter
    with pytest.raises(ValueError):
        images.save_png_gray8(path, img.astype(np.float32))
    with pytest.raises(ValueError):
        images.load_png_gray8(os.path.join(ROOT, "pyproject.toml"))


def _unfilter_bytewise(rows, bpp):
    """The PNG specification's reconstruction, one byte at a time: the
    oracle of ``images._unfilter`` on small inputs."""
    out = np.zeros((rows.shape[0], rows.shape[1] - 1), np.int64)
    for y, (kind, *line) in enumerate(rows.astype(np.int64)):
        for x, v in enumerate(line):
            a = out[y, x - bpp] if x >= bpp else 0
            b = out[y - 1, x] if y else 0
            c = out[y - 1, x - bpp] if y and x >= bpp else 0
            p = a + b - c
            paeth = min((abs(p - a), 0, a), (abs(p - b), 1, b),
                        (abs(p - c), 2, c))[2]
            out[y, x] = (v + (0, a, b, (a + b) // 2, paeth)[kind]) & 0xFF
    return out.astype(np.uint8)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6])
def test_png_unfilter_matches_the_bytewise_rule(rng, bpp):
    rows = rng.integers(0, 256, (23, 1 + 19 * bpp), dtype=np.uint8)
    rows[:, 0] = rng.integers(0, 5, 23)
    rows[5:12, 0] = 4  # a run of Paeth rows, then one of mixed 3 and 4
    rows[14:20, 0] = rng.choice([3, 4], 6)
    np.testing.assert_array_equal(images._unfilter(rows, bpp),
                                  _unfilter_bytewise(rows, bpp))
    rows[3, 0] = 5
    with pytest.raises(ValueError, match="filter type 5"):
        images._unfilter(rows, bpp)


@pytest.mark.parametrize("filter_type", range(5))
def test_png_filters_write_and_read(tmp_path, rng, filter_type):
    img = rng.integers(0, 256, (41, 67), dtype=np.uint8)
    img[10:30, 20:50] = np.arange(30, dtype=np.uint8)[None] * 7  # smooth part
    path = str(tmp_path / "f.png")
    images.save_png_gray8(path, img, filter_type=filter_type)
    with Image.open(path) as im:
        assert np.array_equal(np.asarray(im), img)
    assert np.array_equal(images.load_png(path), img)


@pytest.mark.parametrize("channels", [1, 2, 3, 4, 16])
def test_png_reads_what_pil_writes(tmp_path, channels):
    """PIL picks a filter per scanline: on this smooth image Paeth for
    most, sub and up for the rest. ``16`` is a 16-bit grayscale file, read
    as its high bytes (libpng's strip)."""
    yy, xx = np.mgrid[:96, :80]
    smooth = ((np.sin(xx / 9) + np.cos(yy / 13)) * 60 + 128).astype(np.uint8)
    if channels == 16:
        arr = smooth.astype(np.uint16) * 257 + (xx % 7).astype(np.uint16)
        want = (arr >> 8).astype(np.uint8)
    else:
        arr = np.stack([np.roll(smooth, 5 * k, 1) for k in range(channels)], -1)
        want = arr = arr[..., 0] if channels == 1 else arr
    path = str(tmp_path / "p.png")
    Image.fromarray(arr).save(path)
    assert np.array_equal(images.load_png(path), want)


def test_png_cache_rereads_a_changed_file(tmp_path, rng):
    path = str(tmp_path / "c.png")
    a = rng.integers(0, 256, (12, 9), dtype=np.uint8)
    images.save_png_gray8(path, a, filter_type=4)
    first = images.load_png_cached(path)
    assert np.array_equal(first, a) and not first.flags.writeable
    assert images.load_png_cached(path) is first
    b = rng.integers(0, 256, (12, 10), dtype=np.uint8)  # another size
    images.save_png_gray8(path, b, filter_type=3)
    assert np.array_equal(images.load_png_cached(path), b)


OVERRIDES = [
    ["--output.image_scale_factor", "1216", "--num_samples", "3"],
    ["--output.save_3D_volumes=npy", "--Greenhouse.d=0.05"],
    ["--output.save_stats", "--output.proj_axis", "1", "--debug"],
    ["--Greenhouse.FAZ_center", "[0.4, 0.6]", "--Forest.N_trees=12"],
    ["--output.save_3D_volumes", "null", "--output.directory", "./x/y"],
    ["--Greenhouse.modes", MODES],
    ["--New.section.key", "1e-3", "--New.flag", "--New.other", "1.5e+3",
     "--New.s", "'quoted'", "--New.b", "off", "--New.h", "0x1F"],
    ["positional", "--Greenhouse.SimulationSpace", "{no_voxel_x: 1, no_voxel_z: 0.02}"],
]


@pytest.mark.parametrize("argv", OVERRIDES)
def test_cli_overrides_equal_the_jax_package(argv):
    assert tc.parse_cli_overrides(argv) == jc.parse_cli_overrides(argv)
    ours, theirs = configs.vessel_graph_gen(), configs.vessel_graph_gen()
    tc.apply_cli_overrides(ours, argv)
    jc.apply_cli_overrides(theirs, argv)
    assert ours == theirs
    assert json.dumps(ours, sort_keys=True) == json.dumps(theirs, sort_keys=True)
    assert ours != configs.VESSEL_GRAPH_GEN


@pytest.mark.parametrize("text", [
    "1", "-3", "0.5", "1e-3", "1.5e3", "1.5e+3", "true", "False", "null", "~",
    "", "abc", "[1, 2.5, x]", "[76,76,16]", "'q'", "{a: 1, b: [2]}", "0x10",
    "010", "1_000", ".5", "-.5", "5.", "yes", "off", "./results/x", "+7",
    "-.inf", "[[1,2],[3]]", "[]", "6.0e-2"])
def test_parse_scalar_reads_what_yaml_reads(text):
    ours, theirs = tc.parse_scalar(text), yaml.safe_load(text)
    assert ours == theirs and type(ours) is type(theirs)


def test_config_files(tmp_path, monkeypatch):
    cfg = configs.vessel_graph_gen()
    with open(os.path.join(ROOT, "configs", "vessel_graph_gen.yml")) as f:
        assert cfg == yaml.safe_load(f)     # the output block included
    path = str(tmp_path / "run" / "config.json")
    tc.dump_config(cfg, path)
    assert tc.load_config(path) == cfg
    yml = os.path.join(ROOT, "configs", "vessel_graph_gen.yml")
    assert tc.load_config(yml) == jc.load_config(yml) == cfg
    tc.dump_config(cfg, str(tmp_path / "c.yml"))
    assert jc.load_config(str(tmp_path / "c.yml")) == cfg
    with pytest.raises(FileNotFoundError):
        tc.load_config(str(tmp_path / "missing.json"))
    # a host without PyYAML: a .yml path is read by the block-YAML reader,
    # and writing YAML raises
    monkeypatch.setattr(tc, "_yaml", lambda: None)
    assert tc.load_config(yml) == cfg
    with pytest.raises(RuntimeError, match="yaml"):
        tc.dump_config(cfg, str(tmp_path / "d.yaml"))
    assert tc.load_config(path) == cfg
    before = copy.deepcopy(cfg)
    tc.apply_cli_overrides(cfg, ["--num_samples", "2"])  # no dotted key
    assert cfg == before
