"""Port parity: K3 segment sum, plain path.

The same seeded numpy inputs go through the JAX package — the Pallas kernel
``segsum_onehot_pallas`` in interpret mode and the exact scatter-add of the
CPU growth path — and through ``octa_tpu_torch.ops.segsum``. rtol/atol 1e-4
against the Pallas kernel (the limit of ``tests/test_pallas_segsum.py``: its
bf16 hi/lo split costs a few 1e-5); 1e-6 against the scatter-add (the same
float32 sums, possibly in another order).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from octa_tpu.ops.pallas_segsum import segsum_onehot_pallas
from octa_tpu_torch.ops import segsum as tsg


def _scatter(seg, feats, nc):
    return np.asarray(jnp.zeros((nc + 1, feats.shape[-1]), jnp.float32)
                      .at[jnp.asarray(seg)].add(jnp.asarray(feats))[:nc])


def _inputs(sq, nc, f, r=2, seed=0):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, nc + 1, (r, sq)).astype(np.int32)
    seg = np.where(rng.random((r, sq)) < 0.25, nc, seg).astype(np.int32)
    feats = rng.normal(size=(r, sq, f)).astype(np.float32)
    return seg, feats


@pytest.mark.parametrize("sq,nc,f", [
    (2048, 2048, 18),   # exactly tiled
    (3072, 1024, 18),   # sink_cap + candidates onto a small node array
    (3000, 1000, 18),   # nothing divisible
    (2048, 2048, 1),    # the Murray sweep's shape
    (1000, 1000, 1),
])
def test_plain_matches_pallas_and_scatter(sq, nc, f):
    seg, feats = _inputs(sq, nc, f)
    out = tsg.segment_sum(torch.from_numpy(seg), torch.from_numpy(feats),
                          nc).numpy()
    assert out.shape == (2, nc, f)
    for r in range(2):
        pallas = np.asarray(segsum_onehot_pallas(
            jnp.asarray(seg[r]), jnp.asarray(feats[r]), nc=nc,
            interpret=True))
        np.testing.assert_allclose(out[r], pallas, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(out[r], _scatter(seg[r], feats[r], nc),
                                   rtol=1e-6, atol=1e-6)


def test_sentinel_rows_contribute_nowhere():
    seg = torch.full((1, 2048), 100, dtype=torch.int32)
    out = tsg.segment_sum(seg, torch.ones(1, 2048, 18), 100)
    assert float(out.abs().max()) == 0.0


def test_int64_ids_and_rows_are_independent():
    seg, feats = _inputs(500, 64, 3, r=3, seed=4)
    both = tsg.segment_sum(torch.from_numpy(seg).long(),
                           torch.from_numpy(feats), 64)
    for r in range(3):
        one = tsg.segment_sum(torch.from_numpy(seg[r:r + 1]),
                              torch.from_numpy(feats[r:r + 1]), 64)
        assert torch.equal(both[r], one[0])


def test_plain_adds_in_row_order():
    """The order the CUDA kernel reproduces: each node's rows added one
    after the other, ascending, from 0."""
    seg, feats = _inputs(4000, 50, 2, r=1, seed=5)
    out = tsg.segment_sum_plain(torch.from_numpy(seg),
                                torch.from_numpy(feats), 50).numpy()
    want = np.zeros((50, 2), np.float32)
    for s in range(4000):
        if seg[0, s] < 50:
            want[seg[0, s]] += feats[0, s]
    np.testing.assert_array_equal(out[0], want)


def test_wrapper_rejects_bad_inputs():
    with pytest.raises(ValueError, match="expected seg"):
        tsg.segment_sum(torch.zeros(4, dtype=torch.int32),
                        torch.zeros(4, 2), 3)
    with pytest.raises(ValueError, match="int32/int64"):
        tsg.segment_sum(torch.zeros(1, 4), torch.zeros(1, 4, 2), 3)
    assert tsg.SEGSUM.launches == 0  # the CPU path never counts a launch


def _structured(kind, seed=6):
    """Ids the kernel's design is sensitive to: one node taking most of a
    row's sources beside random ones, or a binary tree's parent ids (at most
    two children a node, roots and the empty tail on the sentinel)."""
    rng = np.random.default_rng(seed)
    if kind == "skewed":
        r, sq, nc, f = 2, 3000, 1000, 18
        seg = rng.integers(0, nc, (r, sq))
        seg[:, rng.permutation(sq)[:1600]] = 7
        seg = np.where(rng.random((r, sq)) < 0.2, nc, seg)
    else:
        r, nc, f = 2, 1024, 1
        sq = nc
        seg = np.full((r, sq), nc)
        for b in range(r):
            lab = rng.permutation(nc)
            i = np.arange(1, 700 + 100 * b)
            seg[b, lab[i]] = lab[(i - 1) // 2]
    feats = rng.normal(size=(r, sq, f)).astype(np.float32)
    return seg.astype(np.int32), feats, nc


@pytest.mark.parametrize("kind", ["skewed", "parent ids"])
def test_plain_matches_pallas_and_scatter_structured(kind):
    seg, feats, nc = _structured(kind)
    out = tsg.segment_sum(torch.from_numpy(seg), torch.from_numpy(feats),
                          nc).numpy()
    for r in range(seg.shape[0]):
        pallas = np.asarray(segsum_onehot_pallas(
            jnp.asarray(seg[r]), jnp.asarray(feats[r]), nc=nc,
            interpret=True))
        np.testing.assert_allclose(out[r], pallas, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(out[r], _scatter(seg[r], feats[r], nc))
    if kind == "parent ids":  # at most two children a node
        assert max(np.bincount(row[row < nc]).max() for row in seg) == 2


@pytest.mark.parametrize("nc,r,f,tile", [(16384, 16, 1, 1024),
                                         (16384, 16, 18, 512),
                                         (12288, 16, 1, 512),
                                         (4096, 16, 18, 256),
                                         (16384, 16, 3, 256)])
def test_kernel_tile_keeps_two_blocks_an_sm(nc, r, f, tile):
    """On a card of 132 SMs, the largest tile the kernel takes for F that
    still gives 256 blocks, and a grid that covers every node and feature."""
    got, (tiles, rows, fblocks) = tsg.segsum_plan(nc, r, f, 132)
    assert got == tile and tiles * tile >= nc > (tiles - 1) * tile
    assert rows == r and fblocks * (f if f in (1, 18) else 4) >= f
