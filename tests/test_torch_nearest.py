"""Port parity: K2 masked nearest-neighbour distances, plain path.

The same seeded numpy inputs go through the JAX package — the Pallas kernel
``masked_nearest_pallas`` in interpret mode and the chunked-scan oracle
``_chunked_nearest2`` — and through ``octa_tpu_torch.ops.nearest``.
Distances: atol 2e-3 against the Pallas kernel (the limit of
``tests/test_pallas_nearest.py``) and 1e-6 against the scan (the same
difference-form arithmetic; XLA may fuse a multiply-add). Indices: more than
99 % equal to the Pallas kernel's, all equal to the scan's.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from octa_tpu.ops.pallas_nearest import masked_nearest_pallas
from octa_tpu.sim.greenhouse import _chunked_nearest, _chunked_nearest2
from octa_tpu_torch.ops import nearest as tn


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    R, Q, N = 3, 300, 520
    q = rng.random((R, Q, 3)).astype(np.float32)
    p = rng.random((R, N, 3)).astype(np.float32)
    ma = rng.random((R, N)) < 0.6
    mb = rng.random((R, N)) < 0.9
    return q, p, np.stack([ma, mb], axis=1)


def _port(q, p, masks, **kw):
    out = tn.masked_nearest(torch.from_numpy(q), torch.from_numpy(p),
                            torch.from_numpy(masks), **kw)
    if isinstance(out, tuple):
        return tuple(o.numpy() for o in out)
    return out.numpy()


def test_plain_matches_pallas_interpret(data):
    q, p, masks = data
    d, i = _port(q, p, masks)
    jd, ji = masked_nearest_pallas(jnp.asarray(q), jnp.asarray(p),
                                   jnp.asarray(masks), tq=128, blk=256,
                                   interpret=True)
    assert d.shape == (3, 2, 300) and i.dtype == np.int32
    np.testing.assert_allclose(d, np.asarray(jd), atol=2e-3)
    assert (i == np.asarray(ji)).mean() > 0.99


def test_plain_matches_chunked_scan(data):
    q, p, masks = data
    d, i = _port(q, p, masks)
    da, ia, db, ib = jax.vmap(
        lambda qq, pp, a, b: _chunked_nearest2(qq, pp, a, b, chunk=128))(
            jnp.asarray(q), jnp.asarray(p), jnp.asarray(masks[:, 0]),
            jnp.asarray(masks[:, 1]))
    np.testing.assert_allclose(d[:, 0], np.asarray(da), atol=1e-6)
    np.testing.assert_allclose(d[:, 1], np.asarray(db), atol=1e-6)
    np.testing.assert_array_equal(i[:, 0], np.asarray(ia))
    np.testing.assert_array_equal(i[:, 1], np.asarray(ib))


@pytest.mark.parametrize("chunk", [7, 64, 520, 4096])
def test_plain_is_chunk_invariant(data, chunk):
    q, p, masks = data
    ref = tn.masked_nearest_plain(torch.from_numpy(q), torch.from_numpy(p),
                                  torch.from_numpy(masks))
    out = tn.masked_nearest_plain(torch.from_numpy(q), torch.from_numpy(p),
                                  torch.from_numpy(masks), chunk=chunk)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


def test_distances_only_and_no_valid_point():
    """A row whose mask admits no point: +inf and index 0, as the scan
    oracle returns (the Pallas kernel returns ~1e15 there)."""
    rng = np.random.default_rng(1)
    q = rng.random((2, 64, 3)).astype(np.float32)
    p = rng.random((2, 100, 3)).astype(np.float32)
    masks = np.zeros((2, 1, 100), bool)
    masks[1] = True
    d, i = _port(q, p, masks)
    assert np.isinf(d[0]).all() and (i[0] == 0).all()
    assert np.isfinite(d[1]).all()
    jd, ji = _chunked_nearest(jnp.asarray(q[0]), jnp.asarray(p[0]),
                              jnp.asarray(masks[0, 0]), chunk=32)
    assert np.isinf(np.asarray(jd)).all() and (np.asarray(ji) == 0).all()
    only_d = _port(q, p, masks, want_idx=False)
    np.testing.assert_array_equal(only_d, d)


def test_ties_take_the_lowest_index():
    rng = np.random.default_rng(2)
    base = rng.random((1, 40, 3)).astype(np.float32)
    p = np.concatenate([base, base, base], axis=1)     # every point 3 times
    q = rng.random((1, 50, 3)).astype(np.float32)
    masks = np.ones((1, 2, 120), bool)
    masks[0, 1, :40] = False                           # first copies masked
    d, i = _port(q, p, masks)
    assert (i[0, 0] < 40).all()
    assert ((i[0, 1] >= 40) & (i[0, 1] < 80)).all()
    np.testing.assert_array_equal(i[0, 1] - 40, i[0, 0])
    jd, ji = _chunked_nearest(jnp.asarray(q[0]), jnp.asarray(p[0]),
                              jnp.asarray(masks[0, 1]), chunk=16)
    np.testing.assert_array_equal(i[0, 1], np.asarray(ji))


def test_no_catastrophic_cancellation():
    """Difference-form d² stays accurate far from the origin, where the
    expanded form loses about 7 digits
    (``tests/test_pallas_nearest.py:68``)."""
    rng = np.random.default_rng(7)
    base = rng.random((256, 3)).astype(np.float32) + 100.0
    q = base[:128] + rng.normal(0, 2e-4, (128, 3)).astype(np.float32)
    exact = np.sqrt(((q.astype(np.float64)[:, None]
                      - base.astype(np.float64)[None]) ** 2).sum(-1)).min(1)
    d = _port(q[None], base[None], np.ones((1, 1, 256), bool),
              want_idx=False)[0, 0]
    rel = np.abs(d - exact) / np.maximum(exact, 1e-12)
    assert rel.max() < 1e-3, rel.max()


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros(1, 4, 3)
    p = torch.zeros(1, 5, 3)
    with pytest.raises(ValueError, match="expected query"):
        tn.masked_nearest(q, p, torch.ones(1, 1, 4, dtype=torch.bool))
    with pytest.raises(ValueError, match="bool"):
        tn.masked_nearest(q, p, torch.ones(1, 1, 5))
    assert tn.NEAREST.launches == 0  # the CPU path never counts a launch


def _growth_masks(kind):
    """Masks the kernel's chunk trimming is sensitive to: valid on a prefix
    only (the tail chunks wholly empty), or masked points lying nearer to
    every query than any valid point."""
    rng = np.random.default_rng(9)
    R, Q, N = 2, 200, 1100
    q = rng.random((R, Q, 3)).astype(np.float32)
    p = rng.random((R, N, 3)).astype(np.float32)
    if kind == "prefix":
        ma = np.arange(N) < np.array([[300], [520]])
        mb = ma & (rng.random((R, N)) < 0.7)
    else:
        p[:, :Q] = q                       # masked copies of the queries
        ma = np.broadcast_to(np.arange(N) >= Q, (R, N))
        mb = ma & (np.arange(N) < 900)
        p[:, 600:610] += 10.0              # far valid points among them
    return q, p, np.stack([ma, mb], axis=1)


@pytest.mark.parametrize("kind", ["prefix", "masked nearer"])
def test_plain_matches_pallas_and_scan_growth_masks(kind):
    q, p, masks = _growth_masks(kind)
    d, i = _port(q, p, masks)
    jd, ji = masked_nearest_pallas(jnp.asarray(q), jnp.asarray(p),
                                   jnp.asarray(masks), tq=128, blk=256,
                                   interpret=True)
    np.testing.assert_allclose(d, np.asarray(jd), atol=2e-3)
    assert (i == np.asarray(ji)).mean() > 0.99
    da, ia, db, ib = jax.vmap(
        lambda qq, pp, a, b: _chunked_nearest2(qq, pp, a, b, chunk=128))(
            jnp.asarray(q), jnp.asarray(p), jnp.asarray(masks[:, 0]),
            jnp.asarray(masks[:, 1]))
    np.testing.assert_allclose(d[:, 0], np.asarray(da), atol=1e-6)
    np.testing.assert_allclose(d[:, 1], np.asarray(db), atol=1e-6)
    np.testing.assert_array_equal(i[:, 0], np.asarray(ia))
    np.testing.assert_array_equal(i[:, 1], np.asarray(ib))
    assert bool(np.take_along_axis(masks, i.astype(np.int64), 2).all())


@pytest.mark.parametrize("r,q,n", [(24, 34768, 16384), (8, 2000, 16384),
                                   (8, 2000, 32768), (16, 34768, 1024),
                                   (8, 2000, 12288), (3, 300, 520)])
def test_plan_splits_small_grids_in_whole_chunks(r, q, n):
    """The kernel's launch on a card of 132 SMs: the point range is cut into
    whole 1,024-point chunks that cover it, and only grids under 8 blocks an
    SM are cut."""
    plan = tn.nearest_plan(r, q, n, 132)
    tiles, rows, splits = plan.grid(r, q)
    assert rows == r and splits == plan.splits
    assert tiles * tn.NEAREST_THREADS * tn.NEAREST_QPT >= q
    assert plan.per_split % tn.NEAREST_CHUNK == 0
    assert (splits - 1) * plan.per_split < n <= splits * plan.per_split
    assert (splits == 1) == (tiles * r >= 8 * 132 or n <= tn.NEAREST_CHUNK)


@pytest.mark.parametrize("r,q,n", [(24, 34768, 16384), (8, 2000, 16384),
                                   (8, 2000, 32768), (24, 22480, 12288),
                                   (3, 300, 520)])
def test_banded_plan_tiles_and_splits(r, q, n):
    """K5's launch on a card of 132 SMs: a block a 128-query tile (the
    pruning tile of the plain version), whole chunks that cover the point
    range, at most ``BAND_SPLIT_CHUNKS`` of them a split, and K2's split
    rule counted in 128-query blocks."""
    plan = tn.banded_plan(r, q, n, 132)
    tiles, rows, splits = plan.grid(r, q)
    assert tn.BAND_TILE == 128 and tiles == -(-q // tn.BAND_TILE) and rows == r
    assert plan.per_split % tn.BAND_CHUNK == 0
    assert plan.per_split <= tn.BAND_SPLIT_CHUNKS * tn.BAND_CHUNK
    assert (splits - 1) * plan.per_split < n <= splits * plan.per_split
    k2 = tn.nearest_plan(r, q, n, 132, tn.BAND_TILE)
    assert plan.per_split == min(k2.per_split,
                                 tn.BAND_SPLIT_CHUNKS * tn.BAND_CHUNK)
