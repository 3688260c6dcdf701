"""Port parity: host graph utilities and the K1 splat's plain path.

The same numpy inputs (from a seeded generator) go through
``octa_tpu.ops.raster`` / ``octa_tpu.ops.pallas_splat`` (Pallas in
interpret mode) and through ``octa_tpu_torch.ops``. Host utilities must agree
exactly; the splat within atol 1e-4, as ``tests/test_pallas_splat.py:30``
(float products taken in another order).
"""
import random

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bench
import chip_smoke
from octa_tpu.ops import raster as jr
from octa_tpu.ops.pallas_splat import splat_lines_2d_pallas
from octa_tpu_torch.ops import raster as tr
from octa_tpu_torch.ops import splat as ts

ATOL = 1e-4


def _write_csv(path, rng, e=50):
    n1, n2 = rng.random((e, 3)), rng.random((e, 3))
    r = rng.random(e) * 0.01
    with open(path, "w") as f:
        f.write("node1,node2,radius\n")
        for i in range(e):
            f.write("[%.8f %.8f %.8f],[%.8f %.8f %.8f],%.9f\n"
                    % (*n1[i], *n2[i], r[i]))


def test_parse_graph_csv_matches(tmp_path, rng):
    p = tmp_path / "g.csv"
    _write_csv(p, rng)
    ref, out = jr.parse_graph_csv(str(p)), tr.parse_graph_csv(str(p))
    for k in ("node1", "node2", "radius"):
        np.testing.assert_array_equal(out[k], ref[k])
        assert out[k].dtype == np.float64


def test_fixture_graphs_parse():
    paths = tr.fixture_graph_paths()
    assert len(paths) == 4
    g = tr.parse_graph_csv(paths[0])
    np.testing.assert_array_equal(g["radius"], jr.parse_graph_csv(paths[0])["radius"])
    assert 10_000 < len(g["radius"]) < 20_000


def test_forest_to_arrays_matches(rng):
    forest = [{"node1": rng.random(3), "node2": rng.random(3),
               "radius": float(rng.random())} for _ in range(5)]
    forest.append({"node1": "[0.1 0.2 0.3]", "node2": "[0.4 0.5 0.6]",
                   "radius": 0.01})
    ref, out = jr.forest_to_arrays(forest), tr.forest_to_arrays(forest)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k])
    assert tr.forest_to_arrays([])["node1"].shape == (0, 3)


@pytest.mark.parametrize("max_p,paired", [(0.9, False), (0.0, False),
                                          (0.9, True)])
def test_edge_dropout_matches(rng, max_p, paired):
    e = 200
    n1 = rng.integers(0, 40, (e, 3)).astype(float)
    n2 = rng.integers(0, 40, (e, 3)).astype(float)
    rkeep = rng.random(e) > 0.1
    black = {tuple(n2[3]): True} if paired else None
    k_ref, b_ref = jr.edge_dropout(n1, n2, rkeep, max_p,
                                   dict(black) if black else None,
                                   random.Random(5))
    k_out, b_out = tr.edge_dropout(n1, n2, rkeep, max_p,
                                   dict(black) if black else None,
                                   random.Random(5))
    np.testing.assert_array_equal(k_out, k_ref)
    assert b_out == b_ref


@pytest.mark.parametrize("seed", [3, 11, 29])
def test_edge_dropout_matches_on_a_fixture_graph(seed):
    """A fixture graph (13.5k edges; ``p = U**10 * 0.3``, so seeds 3 and 11
    drop nothing and 29 drops and blacklists): the kept edges, the
    blacklist and the state the draws leave ``rng`` in, first and paired
    render."""
    g = tr.parse_graph_csv(tr.fixture_graph_paths()[seed % 4])
    rkeep = g["radius"] >= 0.002
    p_ref, p_out = random.Random(seed), random.Random(seed)
    black_ref = black_out = None
    for _ in range(2):
        k_ref, black_ref = jr.edge_dropout(g["node1"], g["node2"], rkeep,
                                           0.3, black_ref, p_ref)
        k_out, black_out = tr.edge_dropout(g["node1"], g["node2"], rkeep,
                                           0.3, black_out, p_out)
        np.testing.assert_array_equal(k_out, k_ref)
        assert black_out == black_ref
        assert p_out.getstate() == p_ref.getstate()


def test_pad_edges_and_select_k_match(rng):
    e = 700
    n1, n2 = rng.random((e, 2)) * 300, rng.random((e, 2)) * 300
    r = rng.random(e) * 6
    v = rng.random(e) > 0.2
    ref, out = jr.pad_edges(n1, n2, r, v), tr.pad_edges(n1, n2, r, v)
    for x, y in zip(out, ref):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype
    a, b, w, vv = out
    assert tr.select_k_2d(a, b, w, vv, (304, 304)) == jr.select_k_2d(
        a, b, w, vv, (304, 304))


def test_edge_prep_matches(rng):
    samples = [{"node1": rng.random((n, 3)), "node2": rng.random((n, 3)),
                "radius": rng.random(n) * 0.01} for n in (30, 2100)]
    ref = bench._pad_batch_edges(samples, 304, 1216)
    out = tr.pad_batch_edges(samples, 304, 1216)
    for tag in ("in", "lab"):
        for x, y in zip(out[tag], ref[tag]):
            np.testing.assert_array_equal(x, y)
    for ax in (0, 1, 2):
        for x, y in zip(tr.edges_to_px_2d(samples[0], (304, 200), ax),
                        jr._edges_to_px_2d(samples[0], (304, 200), ax)):
            np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# splat
# ---------------------------------------------------------------------------

def _random_edges(rng, e=300, res=304, wmax=8.0):
    a = rng.random((e, 2)).astype(np.float32) * res
    b = (a + rng.normal(0, 20, (e, 2))).astype(np.float32)
    w = (rng.random(e) * wmax + 0.5).astype(np.float32)
    v = np.ones(e, bool)
    v[e - e // 4:] = False
    return a, b, w, v


def _wide_edges():
    a = np.array([[64.0, 10.0], [150.0, 40.0], [0.0, 0.0]], np.float32)
    b = np.array([[64.0, 240.0], [250.0, 220.0], [300.0, 300.0]], np.float32)
    w = np.array([30.0, 48.0, 3.0], np.float32)
    return a, b, w, np.ones(3, bool)


def _off_image_edges(rng):
    a, b, w, v = _random_edges(rng)
    a[:50] -= 250.0
    b[:50] -= 250.0
    a[50:60] += 1e6  # far off the image: no bin at all
    b[50:60] += 1e6
    return a, b, w, v


def _torch(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _oracle(a, b, w, v, res, k):
    if a.ndim == 3:
        return np.stack([_oracle(*x, res, k) for x in zip(a, b, w, v)])
    return np.asarray(jr.splat_lines_2d(jnp.asarray(a), jnp.asarray(b),
                                        jnp.asarray(w), jnp.asarray(v),
                                        height=res, width=res, k_max=k))


def _span(a, b, w, tile=128):
    reach = w * 0.5 + 1.0
    ext = np.abs(a - b) + 2.0 * reach[..., None]
    return max(2, int(np.ceil(ext.max() / tile)) + 1)


CASES = {
    "random": lambda rng: (_random_edges(rng), 304, 512),
    "off_image": lambda rng: (_off_image_edges(rng), 304, 512),
    "wide": lambda rng: (_wide_edges(), 304, 64),
    "overflow": lambda rng: (_random_edges(rng, e=400, wmax=12.0), 304, 8),
    "ragged_200": lambda rng: (_random_edges(rng, e=200, res=200), 200, 256),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_splat_matches_oracle(rng, case):
    (a, b, w, v), res, k = CASES[case](rng)
    ref = _oracle(a, b, w, v, res, k)
    out = ts.splat_lines_2d(*_torch(a, b, w, v), height=res, width=res,
                            k_max=k)
    assert out.shape == (res, res) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    if case == "overflow":  # the cap really dropped edges here
        full = _oracle(a, b, w, v, res, 512)
        assert np.abs(full - ref).max() > 0.1


@pytest.mark.parametrize("case", ["random", "off_image", "wide"])
def test_plain_splat_matches_pallas_interpret(rng, case):
    (a, b, w, v), res, k = CASES[case](rng)
    ref = np.asarray(splat_lines_2d_pallas(
        *[jnp.asarray(x) for x in (a, b, w, v)], height=res, width=res,
        k_max=k, span_=_span(a, b, w), interpret=True))
    out = ts.splat_lines_2d(*_torch(a, b, w, v), height=res, width=res,
                            k_max=k)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_plain_splat_batched(rng):
    a, b, w, v = _random_edges(rng, e=150)
    ab, bb = np.stack([a, a + 3.0]), np.stack([b, b + 3.0])
    wb, vb = np.stack([w, w]), np.stack([v, v])
    out = ts.splat_lines_2d(*_torch(ab, bb, wb, vb), height=304, width=304,
                            k_max=256)
    assert out.shape == (2, 304, 304)
    np.testing.assert_allclose(out.numpy(), _oracle(ab, bb, wb, vb, 304, 256),
                               atol=ATOL)


def test_plain_splat_no_valid_edge():
    a, b = np.zeros((8, 2), np.float32), np.ones((8, 2), np.float32)
    w, v = np.ones(8, np.float32), np.zeros(8, bool)
    out = ts.splat_lines_2d(*_torch(a, b, w, v), height=128, width=128,
                            k_max=8)
    assert float(out.max()) == 0.0
    ids, counts = ts.bin_edges_plain(
        *_torch(a[None], b[None], w[None], v[None]), height=128, width=128,
        k_max=8)
    assert ids.shape == (1, 1, 8) and int(counts.sum()) == 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_bin_edges_match_oracle_topk(rng, case):
    """The binning's per-bin edge lists (ids in order, counts clamped to
    k_max) are exactly the oracle's ``_tile_topk_edges`` lists, in order;
    bins overflow in the "overflow" case (k_max 8)."""
    (a, b, w, v), res, k = CASES[case](rng)
    tile = 128
    ids, counts = ts.bin_edges_plain(
        *_torch(a[None], b[None], w[None], v[None]), height=res, width=res,
        tile=tile, k_max=k)
    ids, counts = ids[0], counts[0]
    nty = ntx = -(-res // tile)
    t = np.arange(nty * ntx)
    tile_lo = np.stack([(t // ntx) * tile, (t % ntx) * tile], -1).astype(np.float32)
    reach = w * 0.5 + 1.0
    kk = min(k, len(w))
    idx, mask = jr._tile_topk_edges(
        jnp.asarray(np.minimum(a, b) - reach[:, None]),
        jnp.asarray(np.maximum(a, b) + reach[:, None]),
        jnp.asarray(tile_lo), jnp.asarray(tile_lo + tile), jnp.asarray(v), kk)
    idx, mask = np.asarray(idx), np.asarray(mask)
    assert ids.shape == (nty * ntx, kk) and ids.dtype == torch.int32
    for i in range(nty * ntx):
        n = int(counts[i])
        assert n == int(mask[i].sum())
        np.testing.assert_array_equal(ids[i, :n].numpy(), idx[i, :n])
        assert not bool(ids[i, n:].any())
    if case == "overflow":
        assert int(counts.max()) == k


def test_dispatch_rejects_unknown_device(rng):
    a, b, w, v = _torch(*_random_edges(rng, e=8))
    with pytest.raises(ValueError):
        ts.splat_lines_2d(a.to("meta"), b.to("meta"), w.to("meta"),
                          v.to("meta"), height=128, width=128, k_max=8)


def test_bbox_pixel_edges_brute_force(rng):
    a, b, w, v = _random_edges(rng, e=60, res=200, wmax=30.0)
    res, k = 200, 16
    t = _torch(a[None], b[None], w[None], v[None])
    ids, counts = ts.bin_edges_plain(*t, height=res, width=res, k_max=k)
    got = chip_smoke.bbox_pixel_edges(*t[:3], ids, counts, height=res,
                                      width=res)
    reach = w * 0.5 + 1.0
    lo, hi = np.minimum(a, b) - reach[:, None], np.maximum(a, b) + reach[:, None]
    c = np.arange(res) + 0.5
    want = 0
    for i in range(4):  # 2x2 bins of 128 over a 200² image
        n = int(counts[0, i])
        rows = (c >= (i // 2) * 128) & (c < (i // 2) * 128 + 128)
        cols = (c >= (i % 2) * 128) & (c < (i % 2) * 128 + 128)
        for e in ids[0, i, :n].numpy():
            ry = rows & (c >= lo[e, 0]) & (c <= hi[e, 0])
            rx = cols & (c >= lo[e, 1]) & (c <= hi[e, 1])
            want += int(ry.sum()) * int(rx.sum())
    assert got == want > 0


def test_bin_edges_batched_matches_single(rng):
    """Binning a batch of two different images gives each image the lists
    it gets alone."""
    (a0, b0, w0, v0), _, _ = CASES["random"](rng)
    (a1, b1, w1, v1), _, _ = CASES["off_image"](rng)
    batch = _torch(np.stack([a0, a1]), np.stack([b0, b1]), np.stack([w0, w1]),
                   np.stack([v0, v1]))
    ids, counts = ts.bin_edges_plain(*batch, height=304, width=304, k_max=512)
    assert ids.shape == (2, 9, 300) and counts.shape == (2, 9)
    for i, single in enumerate([(a0, b0, w0, v0), (a1, b1, w1, v1)]):
        i1, c1 = ts.bin_edges_plain(*_torch(*[x[None] for x in single]),
                                    height=304, width=304, k_max=512)
        np.testing.assert_array_equal(counts[i], c1[0])
        np.testing.assert_array_equal(ids[i], i1[0])
    assert int(counts[1].sum()) < int(counts[0].sum())


def _forest(rng, e=2000):
    """Unit-cube edges: short segments of vessel-like radii."""
    n1 = rng.random((e, 3))
    n2 = np.clip(n1 + rng.normal(0, 0.01, (e, 3)), 0, 1)
    return {"node1": n1, "node2": n2, "radius": rng.random(e) * 0.004 + 0.001}


@pytest.mark.parametrize("cap", [16384, 64])
def test_rasterize_k_cap_equals_select_k_route(rng, monkeypatch, cap):
    """``rasterize_forest_device`` passes ``k_max = K_CAP_2D`` where the
    reference sizes it with ``select_k_2d``: the same image, with no bin
    overflowing (the cap at 16384) and with bins that overflow it (64)."""
    monkeypatch.setattr(tr, "K_CAP_2D", cap)
    forest, res = _forest(rng), (304, 304)
    img, _ = tr.rasterize_forest_device(forest, res, device="cpu")
    a, b = tr.edges_to_px_2d(forest, res, 2)
    w = forest["radius"] * tr._RADIUS_FUDGE * 304 * tr._PT_TO_PX
    a_p, b_p, w_p, v_p = tr.pad_edges(a, b, w)
    k = tr.select_k_2d(a_p, b_p, w_p, v_p, res, cap=cap)
    ref = ts.splat_lines_2d(*_torch(a_p, b_p, w_p, v_p), height=304,
                            width=304, k_max=k) * 255.0
    assert torch.equal(img, ref)
    _, counts = ts.bin_edges_plain(*_torch(a_p[None], b_p[None], w_p[None],
                                           v_p[None]), height=304, width=304,
                                   k_max=len(w_p))
    assert (int(counts.max()) > cap) == (cap == 64)
