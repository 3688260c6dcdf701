"""Port parity: K4 (3D capsule voxelizer) and the two renderers against the
JAX package.

The same numpy-seeded edges go through ``octa_tpu.ops.raster``
``splat_capsules_3d`` (the oracle), ``octa_tpu.ops.pallas_splat``
``splat_capsules_3d_pallas`` in interpret mode, and the port's plain PyTorch
version, which is what :func:`octa_tpu_torch.ops.splat3d.splat_capsules_3d`
runs for CPU tensors (the CUDA kernel runs only on a card; ``chip_smoke.py``
holds it to the plain version there).

Tolerances. Plain K4 against the oracle and the Pallas kernel: 1e-5 absolute
at these dims (the oracle projects as ``c - (a + t s)`` with a division, the
port as ``(c - a) - t s`` with a reciprocal: float32 rounding at coordinates
below 50). ``voxelize_forest``: uint8 volumes at most one level apart on at
most 0.1 % of the voxels (truncation turns a last-bit difference into a
level at a boundary). ``rasterize_forest``: 2e-3 of 255 (the splat's own
tolerance, ``test_torch_raster.py``).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octa_tpu.ops import raster as jr
from octa_tpu.ops.pallas_splat import splat_capsules_3d_pallas
from octa_tpu_torch.ops import raster as tr
from octa_tpu_torch.ops import splat3d

ATOL = 1e-5
DIMS = (48, 40, 12)


@pytest.fixture(scope="module", autouse=True)
def _warm_threads():
    """The first multi-threaded ``torch.sqrt`` of a process has been seen to
    return one thread's share a few 1e-4 off on some hosts; take it here, so
    that the tests compare arithmetic and not that."""
    torch.sqrt(torch.rand(1 << 20))


def _t(*xs):
    return tuple(torch.from_numpy(np.asarray(x)) for x in xs)


def _random_edges(rng, n=64, dims=DIMS):
    a = (rng.random((n, 3)) * np.array(dims)).astype(np.float32)
    b = (a + rng.normal(size=(n, 3)) * 6).astype(np.float32)
    r = (rng.random(n) * 2.5 + 0.3).astype(np.float32)
    v = rng.random(n) < 0.85
    return a, b, r, v


def _oracle(a, b, r, v, dims):
    tile = (64, 64, 16)
    k = jr.select_k_3d(a, b, r, v, dims, tile)
    assert k < 8192, "the oracle would drop edges: not a no-overflow case"
    return np.asarray(jr.splat_capsules_3d(a, b, r, v, dims=dims, tile=tile,
                                           k_max=k))


def _pallas(a, b, r, v, dims, tile=(16, 128)):
    k = jr._select_k_3d_xy(a, b, r, v, dims, tile)
    ext = np.abs(a - b) + 2.0 * (r * math.sqrt(2.0))[:, None] + 2.0
    span = tuple(max(2, int(math.ceil(float(ext[:, i].max()) / tile[i])) + 1)
                 for i in range(2))
    return np.asarray(splat_capsules_3d_pallas(
        a, b, r, v, dims=dims, tile=tile, k_max=k, span_=span,
        interpret=True))


def _fixture_edges(scale, dims3, n=None, ignore_z=False):
    g = tr.parse_graph_csv(tr.fixture_graph_paths()[0])
    if n is not None:
        g = {k: x[:n] for k, x in g.items()}
    keep = np.ones(len(g["radius"]), bool)
    return tr.voxel_edges(g, keep, [scale, scale, dims3], ignore_z)


@pytest.mark.parametrize("case", ["random", "zero_length", "off_volume",
                                  "all_invalid"])
def test_plain_k4_matches_oracle_and_pallas(rng, case):
    a, b, r, v = _random_edges(rng)
    if case == "zero_length":
        b[:8] = a[:8]
        v[:8] = True
    if case == "off_volume":       # x far outside; z-bbox above; z-bbox below
        a[0:4, 0] += 500
        b[0:4, 0] += 500
        a[4:8, 2] = b[4:8, 2] = DIMS[2] + 30
        a[8:12, 2] = b[8:12, 2] = -30
        v[:12] = True
    if case == "all_invalid":
        v[:] = False
    out = splat3d.splat_capsules_3d(*_t(a, b, r, v), dims=DIMS).numpy()
    ref = _oracle(a, b, r, v, DIMS)
    assert out.shape == DIMS and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    np.testing.assert_allclose(out, _pallas(a, b, r, v, DIMS), atol=ATOL,
                               rtol=0)
    assert out.min() >= 0 and out.max() <= 1
    if case == "all_invalid":
        assert not out.any()
    else:
        assert 0.1 < (out > 0).mean() < 0.9 and out.max() == 1.0


def test_plain_k4_invalid_edges_count_nowhere(rng):
    a, b, r, v = _random_edges(rng)
    full = splat3d.splat_capsules_3d(*_t(a, b, r, v), dims=DIMS)
    kept = splat3d.splat_capsules_3d(*_t(a[v], b[v], r[v], v[v]), dims=DIMS)
    assert torch.equal(full, kept)
    # far smaller chunks of pairs: the same bits
    small = splat3d.splat_capsules_3d_plain(*_t(a, b, r, v), dims=DIMS,
                                            pairs=1000)
    assert torch.equal(full, small)


@pytest.mark.parametrize("ignore_z", [False, True])
def test_plain_k4_fixture_graph(ignore_z):
    """2,500 edges of a fixture graph at scale 48, slab padded to 12."""
    a, b, r, v, dims = _fixture_edges(48, 12, n=2500, ignore_z=ignore_z)
    out = splat3d.splat_capsules_3d(*_t(a, b, r, v), dims=dims).numpy()
    np.testing.assert_allclose(out, _oracle(a, b, r, v, dims), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(out, _pallas(a, b, r, v, dims), atol=ATOL,
                               rtol=0)
    assert out.max() > 0.5 and 0.02 < (out > 0).mean() < 0.9


def test_inside_rule_at_end_points_moves_values_by_rounding_only(rng):
    """Voxel centres that project exactly onto an end point (t = 0 or 1):
    the strict ``0 < t < 1`` may fall either way between the oracle's and
    the port's form of t; both terms are then equal up to rounding."""
    dims = (24, 24, 8)
    # axis-parallel edges whose end points are voxel centres
    a = np.array([[4.5, 6.5, 3.5], [10.5, 4.5, 2.5], [3.5, 15.5, 4.5]],
                 np.float32)
    b = np.array([[14.5, 6.5, 3.5], [10.5, 18.5, 2.5], [3.5, 15.5, 6.5]],
                 np.float32)
    r = np.array([1.2, 0.8, 1.6], np.float32)
    v = np.ones(3, bool)
    out = splat3d.splat_capsules_3d(*_t(a, b, r, v), dims=dims).numpy()
    np.testing.assert_allclose(out, _oracle(a, b, r, v, dims), atol=ATOL,
                               rtol=0)


def test_k4_wrapper_checks_and_dispatch():
    a, b, r, v = _t(np.zeros((4, 3), np.float32), np.ones((4, 3), np.float32),
                    np.ones(4, np.float32), np.ones(4, bool))
    with pytest.raises(ValueError, match="expected a, b"):
        splat3d.splat_capsules_3d(a, b[:3], r, v, dims=DIMS)
    with pytest.raises(ValueError, match="bad dims"):
        splat3d.splat_capsules_3d(a, b, r, v, dims=(4, 4))
    with pytest.raises(ValueError, match="unsupported device"):
        splat3d.splat_capsules_3d(*(x.to("meta") for x in (a, b, r, v)),
                                  dims=DIMS)
    assert splat3d.SPLAT3D.launches == 0  # the CPU path launches nothing


def test_select_k_3d_equal(rng):
    a, b, r, v = _random_edges(rng, n=300)
    for tile in ((64, 64, 16), (16, 16, 4)):
        assert tr.select_k_3d(a, b, r, v, DIMS, tile) == \
            jr.select_k_3d(a, b, r, v, DIMS, tile)
    for tile_xy in ((32, 128), (8, 8)):
        assert tr._select_k_3d_xy(a, b, r, v, DIMS, tile_xy) == \
            jr._select_k_3d_xy(a, b, r, v, DIMS, tile_xy)
    fa, fb, fr, fv, fdims = _fixture_edges(76, 16)
    assert tr._select_k_3d_xy(fa, fb, fr, fv, fdims, (8, 8)) == \
        jr._select_k_3d_xy(fa, fb, fr, fv, fdims, (8, 8)) > 64
    assert tr.select_k_3d(fa, fb, fr, fv, fdims, (16, 16, 16), cap=1 << 20) == \
        jr.select_k_3d(fa, fb, fr, fv, fdims, (16, 16, 16), cap=1 << 20) > 64


def _sub_graph(n):
    g = tr.parse_graph_csv(tr.fixture_graph_paths()[1])
    return {k: x[:n] for k, x in g.items()}


@pytest.mark.parametrize("kwargs", [
    {}, {"ignore_z": True}, {"min_radius": 0.002, "max_radius": 0.01},
    {"max_dropout_prob": 0.9}])
def test_voxelize_forest_matches(kwargs):
    """6,000 edges of a fixture graph at [76, 76, 16]: the JAX package's CPU
    path caps a 64x64 tile at 8,192 edges and drops the rest, so the whole
    graph (13,000 edges, two tiles' worth) is no no-overflow case there."""
    import random

    g = _sub_graph(6000)
    rl_t, rl_j = [], []
    vt, bd_t = tr.voxelize_forest(g, [76, 76, 16], radius_list=rl_t,
                                  rng=random.Random(5), device="cpu", **kwargs)
    vj, bd_j = jr.voxelize_forest(g, [76, 76, 16], radius_list=rl_j,
                                  rng=random.Random(5), **kwargs)
    assert vt.shape == vj.shape == (76, 76, 16) and vt.dtype == np.uint16
    levels = np.abs(vt.astype(int) - vj.astype(int))
    assert levels.max() <= 1 and (levels > 0).mean() <= 1e-3
    assert vt.max() > 100 and rl_t == rl_j and bd_t == bd_j
    if "max_dropout_prob" in kwargs:
        assert 0 < len(rl_t) < 6000 and bd_t


def test_voxelize_forest_pads_a_thin_slab_and_takes_edge_lists():
    g = _sub_graph(3000)
    forest = [{"node1": a, "node2": b, "radius": r} for a, b, r in
              zip(g["node1"], g["node2"], g["radius"])]
    vt, _ = tr.voxelize_forest(forest, [76, 76, 1], device="cpu")
    vj, _ = jr.voxelize_forest(forest, [76, 76, 1])
    assert vt.shape == vj.shape == (76, 76, 4)   # min_dim = ceil(1 + 2.28)
    levels = np.abs(vt.astype(int) - vj.astype(int))
    assert levels.max() <= 1 and (levels > 0).mean() <= 1e-3
    dev_vol, _ = tr.voxelize_forest_device(forest, [76, 76, 1], device="cpu")
    assert dev_vol.dtype == torch.uint8
    assert np.array_equal(dev_vol.numpy(), vt)


@pytest.mark.parametrize("res,axis", [([76, 76], 2), ([64, 76], 2),
                                      ([76, 16], 1)])
def test_rasterize_forest_matches(res, axis):
    """1,500 edges of a fixture graph: the plain splat walks a bin's edges
    16 at a time, and the whole graph lies in one bin at this size."""
    g = _sub_graph(1500)
    rl_t, rl_j = [], []
    it, _ = tr.rasterize_forest(g, res, axis, radius_list=rl_t, device="cpu")
    ij, _ = jr.rasterize_forest(g, res, axis, radius_list=rl_j)
    assert it.shape == ij.shape == (res[1], res[0]) and it.dtype == np.float32
    np.testing.assert_allclose(it, ij, atol=2e-3, rtol=0)
    assert it.max() > 100 and rl_t == rl_j


def test_volume_maximum_along_z_overlaps_the_image():
    """The measure ``chip_smoke.py`` holds the generator to: Dice of the
    volume's z-maximum against the 2D image, both thresholded at 0.1."""
    g = _sub_graph(4000)
    vol, _ = tr.voxelize_forest(g, [304, 304, 3], device="cpu")
    img, _ = tr.rasterize_forest(g, [304, 304], device="cpu")
    mip, im = vol.max(-1) > 25, img > 25
    dice = 2 * (mip & im).sum() / (mip.sum() + im.sum())
    flipped = 2 * (mip.T & im).sum() / (mip.sum() + im.sum())
    assert dice > 0.85 and flipped < dice - 0.1
