"""K4's one-root arithmetic, its uint8 store, the renderer around it, and
``edge_dropout``'s path for renders that drop nothing.

The CUDA kernel runs only on a card (``chip_smoke.py`` holds it bit for bit
to the plain version there); these tests hold what it relies on:

- the contribution taken as ``f(sqrt(min(|c-a|², |c-b|², inside ? |d0 - t
  s|² : inf)))`` is bit for bit the three-root, two-division form
  (``max(f(sqrt(.)), ...)``) on a million seeded (voxel, edge) pairs, in
  IEEE float32 as the kernel computes it (numpy) and in the plain version's
  PyTorch ops;
- the kernel's cull of a column by its distance in (x, y), mirrored here in
  numpy float32, never drops a pair that contributes;
- the uint8 store is ``(vol * 255.0).clamp(0, 255).to(torch.uint8)`` of
  the float store, bit for bit;
- ``voxelize_forest_device`` gives the volume of the three-root form
  quantised after the splat (the renderer before the uint8 store), and stays
  within one level of the JAX package's ``voxelize_forest``;
- ``edge_dropout`` without a loop where nothing can be dropped gives the
  loop's kept edges, blacklist and random state.
"""
import math
import random

import numpy as np
import pytest
import torch

from octa_tpu.ops import raster as jr
from octa_tpu_torch.ops import raster as tr
from octa_tpu_torch.ops import splat3d

F32 = np.float32
DIAG, HALF = F32(math.sqrt(3.0)), F32(math.sqrt(3.0) / 2)


@pytest.fixture(scope="module", autouse=True)
def _warm_threads():
    """The first multi-threaded ``torch.sqrt`` of a process has been seen to
    return one thread's share a few 1e-4 off on some hosts; take it here."""
    torch.sqrt(torch.rand(1 << 20))


def _pairs(n=1 << 20, seed=0):
    """(c, a, b, r) float32 [n, 3] / [n]: voxel centres near seeded edges,
    with end points on voxel centres (c == a, c == b), projections exactly
    at t = 0 and t = 1, zero-length edges and radii below sqrt3/2, at small
    coordinates and near 1000 as at (1216, 1216, 53)."""
    rng = np.random.default_rng(seed)
    base = np.where(rng.random((n, 1)) < 0.5, 0.0, 1000.0)
    a = (base + rng.random((n, 3)) * 40).astype(F32)
    b = (a + rng.normal(size=(n, 3)) * rng.choice([0.5, 3.0, 12.0], (n, 1))
         ).astype(F32)
    r = (rng.random(n) * rng.choice([0.8, 4.0, 16.0], n)).astype(F32)
    c = (np.floor(a + rng.normal(size=(n, 3)) * (r[:, None] + 3)) + 0.5
         ).astype(F32)
    q = n // 8
    b[:q] = a[:q]                                   # zero-length edges
    r[q:2 * q] *= F32(0.86602540378443860 / 16.0)   # radii below sqrt3/2
    # axis-parallel edges between voxel centres, centres in the planes
    # through a (t = 0) and b (t = 1), and centres on a and b
    k = np.arange(2 * q, 4 * q)
    axis = k % 3
    a[k] = np.floor(a[k]) + 0.5
    b[k] = a[k]
    b[k, axis] += rng.integers(1, 9, len(k))
    c[k] = np.where((k % 4 < 2)[:, None], a[k], b[k])
    off = rng.integers(-3, 4, len(k)).astype(F32)
    c[k, (axis + 1) % 3] += np.where(k % 2 == 0, off, 0)
    return c, a, b, r


def _three_root_numpy(c, a, b, r):
    """The contribution as K4 took it before its redesign, in IEEE float32:
    three square roots, two divisions."""
    s = b - a
    d0 = c - a
    invd = F32(1) / np.maximum((s[:, 0] * s[:, 0] + s[:, 1] * s[:, 1])
                               + s[:, 2] * s[:, 2], F32(1e-12))
    t = ((d0[:, 0] * s[:, 0] + d0[:, 1] * s[:, 1]) + d0[:, 2] * s[:, 2]) * invd
    p = d0 - t[:, None] * s
    e = c - b
    sq = lambda v: (v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]) + v[:, 2] * v[:, 2]
    base = r - HALF
    d_end = np.minimum(np.sqrt(sq(d0)), np.sqrt(sq(e)))
    c_end = F32(1) - (d_end - base) / DIAG
    c_seg = F32(1) - (np.sqrt(sq(p)) - base) / DIAG
    inside = (t > 0) & (t < 1)
    return np.where(inside, np.maximum(c_seg, c_end), c_end), t


def _one_root_numpy(c, a, b, r):
    s = b - a
    d0 = c - a
    invd = F32(1) / np.maximum((s[:, 0] * s[:, 0] + s[:, 1] * s[:, 1])
                               + s[:, 2] * s[:, 2], F32(1e-12))
    t = ((d0[:, 0] * s[:, 0] + d0[:, 1] * s[:, 1]) + d0[:, 2] * s[:, 2]) * invd
    p = d0 - t[:, None] * s
    e = c - b
    sq = lambda v: (v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]) + v[:, 2] * v[:, 2]
    q = np.minimum(sq(d0), sq(e))
    q = np.where((t > 0) & (t < 1), np.minimum(q, sq(p)), q)
    return F32(1) - (np.sqrt(q) - (r - HALF)) / DIAG


def _three_root_torch(c, a, b, seg, invd, base, diag):
    """``capsule_contrib``'s arguments, the three-root form in PyTorch ops
    (the plain version before the redesign)."""
    d = c - a
    tpar = (d[:, 0] * seg[:, 0] + d[:, 1] * seg[:, 1]
            + d[:, 2] * seg[:, 2]) * invd
    p = d - tpar[:, None] * seg
    e = c - b
    norm = lambda v: torch.sqrt(v[:, 0] * v[:, 0] + v[:, 1] * v[:, 1]
                                + v[:, 2] * v[:, 2])
    c_end = 1.0 - (torch.minimum(norm(d), norm(e)) - base) / diag
    c_seg = 1.0 - (norm(p) - base) / diag
    inside = (tpar > 0.0) & (tpar < 1.0)
    return torch.where(inside, torch.maximum(c_seg, c_end), c_end)


def test_one_root_form_is_the_three_root_form_in_ieee_float32():
    c, a, b, r = _pairs()
    three, t = _three_root_numpy(c, a, b, r)
    one = _one_root_numpy(c, a, b, r)
    assert np.array_equal(one.view(np.int32), three.view(np.int32))
    # the cases are there: end points, t exactly 0 and 1, contributions on
    # both sides of 0 and above 1
    assert (t == 0).sum() > 1000 and (t == 1).sum() > 1000
    assert (c == a).all(-1).sum() > 1000 and (c == b).all(-1).sum() > 1000
    assert (three > 0).mean() > 0.2 and (three <= 0).mean() > 0.2
    assert (three > 1).sum() > 1000


def test_plain_contribution_is_the_three_root_form():
    c, a, b, r = (torch.from_numpy(x) for x in _pairs(seed=1))
    seg = b - a
    invd = 1.0 / (seg[:, 0] * seg[:, 0] + seg[:, 1] * seg[:, 1]
                  + seg[:, 2] * seg[:, 2]).clamp(min=1e-12)
    base = r - math.sqrt(3.0) / 2
    diag = torch.full((), math.sqrt(3.0))
    one = splat3d.capsule_contrib(c, a, b, seg, invd, base, diag)
    three = _three_root_torch(c, a, b, seg, invd, base, diag)
    assert torch.equal(one, three)


def _shadow_cull_passes(c, a, b, r):
    """The gather kernel's column cull (``csrc/splat3d.cu``), in float32:
    whether the column of centre c keeps edge (a, b, r)."""
    s = b - a
    base = r - HALF
    reach = (base + DIAG) * F32(1 + 2 ** -18) + F32(2 ** -18)
    length = (np.abs(s[:, 0]) + np.abs(s[:, 1])) + (np.abs(s[:, 2])
                                                    + np.abs(reach))
    shadow = reach + (F32(2 ** -7) + length * F32(2 ** -16))
    cull = np.where(shadow > 0, shadow * shadow * F32(1 + 2 ** -16), F32(0))
    inv2 = F32(1) / np.maximum(s[:, 0] * s[:, 0] + s[:, 1] * s[:, 1],
                               F32(1e-12))
    dx, dy = c[:, 0] - a[:, 0], c[:, 1] - a[:, 1]
    t2 = np.clip((dx * s[:, 0] + dy * s[:, 1]) * inv2, 0, 1)
    wx, wy = dx - t2 * s[:, 0], dy - t2 * s[:, 1]
    return wx * wx + wy * wy <= cull


def test_column_cull_keeps_every_contributing_pair():
    c, a, b, r = _pairs(seed=2)
    # vertical and near-vertical edges: a column is then nearly a point
    k = np.arange(0, len(r), 7)
    b[k, :2] = a[k, :2] + np.float32(1e-4) * (k % 3)[:, None]
    contrib = _one_root_numpy(c, a, b, r)
    passes = _shadow_cull_passes(c, a, b, r)
    assert passes[contrib > 0].all()
    # and it culls: most pairs that cannot contribute are skipped
    assert (~passes[contrib <= 0]).mean() > 0.5


def _random_edges(rng, n=80, dims=(40, 36, 20)):
    a = (rng.random((n, 3)) * np.array(dims)).astype(np.float32)
    b = (a + rng.normal(size=(n, 3)) * 6).astype(np.float32)
    r = (rng.random(n) * 2.5 + 0.3).astype(np.float32)
    v = rng.random(n) < 0.85
    b[:6] = a[:6]
    r[6:12] = 0.4
    return tuple(torch.from_numpy(x) for x in (a, b, r, v)), dims


def test_plain_uint8_store_is_the_quantised_float_store(rng):
    (a, b, r, v), dims = _random_edges(rng)
    vol = splat3d.splat_capsules_3d(a, b, r, v, dims=dims)
    vol8 = splat3d.splat_capsules_3d(a, b, r, v, dims=dims,
                                     out_dtype=torch.uint8)
    assert vol8.dtype == torch.uint8 and vol8.shape == dims
    assert torch.equal(vol8, (vol * 255.0).clamp(0, 255).to(torch.uint8))
    assert torch.equal(vol8, splat3d.quantise(vol))
    assert int(vol8.max()) == 255 and 0.05 < float((vol8 > 0).float().mean())
    # chunked differently: the same bits
    small = splat3d.splat_capsules_3d_plain(a, b, r, v, dims=dims,
                                            out_dtype=torch.uint8, pairs=500)
    assert torch.equal(vol8, small)


def test_k4_out_dtype_and_bin_tile():
    a = torch.zeros(4, 3)
    args = (a, a + 1, torch.ones(4), torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="out_dtype"):
        splat3d.splat_capsules_3d(*args, dims=(8, 8, 8),
                                  out_dtype=torch.float16)
    # about ten bins a side, multiples of 16 from 16 to 128
    assert [splat3d.bin_tile(d, d) for d in (76, 304, 1216, 4096)] == \
        [16, 32, 128, 128]
    assert splat3d.bin_tile(64, 900) == 96
    assert splat3d.SPLAT3D.launches == 0


def test_voxelize_forest_device_is_the_renderer_before_the_uint8_store(
        monkeypatch):
    """The uint8 volume equals the three-root contribution splatted in
    float32 and quantised afterwards, as the renderer did before K4 stored
    uint8, and stays within one level of the JAX package's."""
    g = tr.parse_graph_csv(tr.fixture_graph_paths()[2])
    g = {k: x[:1500] for k, x in g.items()}
    dims = [76, 76, 16]
    vol, _ = tr.voxelize_forest_device(g, dims, device="cpu")
    keep = np.ones(1500, bool)
    *arrs, pdims = tr.voxel_edges(g, keep, dims)
    monkeypatch.setattr(splat3d, "capsule_contrib", _three_root_torch)
    before = splat3d.splat_capsules_3d(*(torch.from_numpy(x) for x in arrs),
                                       dims=pdims)
    assert vol.dtype == torch.uint8 and vol.shape == tuple(pdims)
    assert torch.equal(vol, (before * 255.0).clamp(0, 255).to(torch.uint8))
    vj, _ = jr.voxelize_forest(g, dims)
    levels = np.abs(vol.numpy().astype(int) - vj.astype(int))
    assert levels.max() <= 1 and (levels > 0).mean() <= 1e-3
    assert int(vol.max()) > 100


def _tree():
    g = tr.parse_graph_csv(tr.fixture_graph_paths()[0])
    half = len(g["radius"]) // 2
    return {k: x[:half] for k, x in g.items()}


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("max_p,black,loop", [
    (0.0, None, False), (0.0, "empty", False), (0.0, "one", True),
    (0.9, None, True), (0.9, "empty", False), (0.9, "one", True)])
def test_edge_dropout_without_drops_matches_the_loop(monkeypatch, seed, max_p,
                                                     black, loop):
    """Against the JAX package's loop: the kept edges, the blacklist, the
    radii the renderers record and the next random number. A blacklist
    passed in means no new random drops (p = 0); a non-empty one cascades,
    and a positive ``max_dropout_prob`` drops: both take the loop."""
    g = _tree()
    n1, n2, radius = g["node1"], g["node2"], g["radius"]
    rkeep = (radius >= 0.002) & (radius <= 0.01)
    assert 0 < rkeep.sum() < len(rkeep)
    start = {None: None, "empty": {},
             "one": {tuple(n2[int(np.argmax(rkeep))]): True}}[black]
    skips = []
    real_skip = tr._skip_draws
    monkeypatch.setattr(tr, "_skip_draws",
                        lambda rng, n: skips.append(n) or real_skip(rng, n))
    rng_t, rng_j = random.Random(seed), random.Random(seed)
    keep_t, bd_t = tr.edge_dropout(n1, n2, rkeep, max_p,
                                   None if start is None else dict(start),
                                   rng_t)
    keep_j, bd_j = jr.edge_dropout(n1, n2, rkeep, max_p,
                                   None if start is None else dict(start),
                                   rng_j)
    np.testing.assert_array_equal(keep_t, keep_j)
    assert bd_t == bd_j
    assert (radius[keep_t] * 1.3).tolist() == (radius[keep_j] * 1.3).tolist()
    assert rng_t.random() == rng_j.random()
    assert (skips == []) == loop
    if not loop:
        assert skips == [int(rkeep.sum())] and not bd_t
        np.testing.assert_array_equal(keep_t, rkeep)
    if black == "one":
        assert keep_t.sum() < rkeep.sum() and bd_t


def test_edge_dropout_without_drops_on_the_module_generator():
    """``rng=None`` draws from the ``random`` module's generator."""
    g = _tree()
    rkeep = g["radius"] >= 0.002
    random.seed(11)
    keep_t, _ = tr.edge_dropout(g["node1"], g["node2"], rkeep)
    after_t = random.random()
    random.seed(11)
    keep_j, _ = jr.edge_dropout(g["node1"], g["node2"], rkeep)
    np.testing.assert_array_equal(keep_t, keep_j)
    assert after_t == random.random()
