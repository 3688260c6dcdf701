"""Edge dropout's per-edge pass in C++ (``native/edge_dropout.cpp``,
through ``ops/raster.py::edge_dropout``) against the JAX package's Python
loop: the kept edges, the blacklist (its keys and their order) and the
state the draws leave the generator in, on the fixture graphs (13.5k
edges, cascades down whole subtrees) and on graphs whose nodes repeat;
numpy's Mersenne Twister against ``random.Random``; and the cases that
take Python's loop instead (no library, another generator, keys that are
not three floats), which give the same."""
import random

import numpy as np
import pytest

from octa_tpu.ops import raster as jr
from octa_tpu_torch import native
from octa_tpu_torch.ops import raster as tr


def _both(n1, n2, rkeep, max_p, black, rng_t, rng_j):
    """The port's and the JAX package's dropout of one render, checked
    equal; returns the port's."""
    keep_t, bd_t = tr.edge_dropout(n1, n2, rkeep, max_p,
                                   None if black is None else dict(black),
                                   rng_t)
    keep_j, bd_j = jr.edge_dropout(n1, n2, rkeep, max_p,
                                   None if black is None else dict(black),
                                   rng_j)
    np.testing.assert_array_equal(keep_t, keep_j)
    assert list(bd_t.values()) == list(bd_j.values())
    np.testing.assert_array_equal(  # keys in order; a NaN equals a NaN
        np.array(list(bd_t), float), np.array(list(bd_j), float))
    assert rng_t.getstate() == rng_j.getstate()
    return keep_t, bd_t


@pytest.fixture(scope="module")
def graphs():
    return [tr.parse_graph_csv(p) for p in tr.fixture_graph_paths()]


def test_the_library_builds():
    assert native.EDGE_DROPOUT.get() is not None, native.EDGE_DROPOUT.status


@pytest.mark.parametrize("max_p", [0.02, 0.3, 1.0])
def test_fixture_graphs_first_and_paired_render(graphs, max_p):
    """Twelve seeds on each fixture graph; the second render takes the
    first one's blacklist, as a paired label does."""
    dropped = 0
    for g in graphs:
        rkeep = g["radius"] >= 0.002
        for seed in range(12):
            rng_t, rng_j = random.Random(seed), random.Random(seed)
            keep, black = _both(g["node1"], g["node2"], rkeep, max_p, None,
                                rng_t, rng_j)
            dropped += int(rkeep.sum() - keep.sum())
            _both(g["node1"], g["node2"], rkeep, max_p, black, rng_t, rng_j)
    assert dropped > 0


@pytest.mark.parametrize("seed", range(6))
def test_repeated_nodes_cascade_alike(seed):
    """Integer nodes on a small grid: most nodes repeat, so a drop
    blacklists many edges' proximal nodes at once."""
    rng = np.random.default_rng(seed)
    e = 3000
    n1 = rng.integers(0, 12, (e, 3)).astype(float)
    n2 = rng.integers(0, 12, (e, 3)).astype(float)
    rkeep = rng.random(e) > 0.1
    for black in (None, {tuple(n2[int(np.argmax(rkeep))]): True}):
        _both(n1, n2, rkeep, 0.05, black, random.Random(seed),
              random.Random(seed))


def test_signed_zero_and_nan_nodes_compare_as_python_does():
    """-0.0 is 0.0 in the blacklist; a NaN node matches nothing."""
    n1 = np.array([[0.0, 1.0, 2.0], [np.nan, 0.0, 0.0], [5.0, 5.0, 5.0]])
    n2 = np.array([[9.0, 9.0, 9.0], [-0.0, 1.0, 2.0], [np.nan, 0.0, 0.0]])
    keeps = [_both(n1, n2, np.ones(3, bool), 0.0, black, random.Random(1),
                   random.Random(1))[0].tolist()
             for black in ({(0.0, 1.0, 2.0): True},
                           {(np.nan, 0.0, 0.0): True})]
    assert keeps == [[True, False, True], [True, True, True]]


def test_the_loop_where_the_library_is_missing(monkeypatch, graphs):
    g = graphs[2]
    rkeep = g["radius"] >= 0.002
    want = tr.edge_dropout(g["node1"], g["node2"], rkeep, 1.0, None,
                           random.Random(4))
    monkeypatch.setattr(native.EDGE_DROPOUT, "get", lambda: None)
    got = _both(g["node1"], g["node2"], rkeep, 1.0, None, random.Random(4),
                random.Random(4))
    np.testing.assert_array_equal(got[0], want[0])
    assert list(got[1].items()) == list(want[1].items())


class _Shifted(random.Random):
    """A generator whose numbers are not the Mersenne Twister's."""

    def random(self):
        return super().random() * 0.5


def test_other_generators_and_keys_take_the_loop(graphs, monkeypatch):
    g = graphs[1]
    rkeep = g["radius"] >= 0.002
    assert tr._twister(_Shifted(3)) is None
    calls = []
    monkeypatch.setattr(native, "edge_dropout_native",
                        lambda *a: calls.append(a))
    _both(g["node1"], g["node2"], rkeep, 1.0, None, _Shifted(3), _Shifted(3))
    key = tuple(int(v) for v in g["node2"][0]) + (0,)
    _both(g["node1"], g["node2"], rkeep, 0.0, {key: True}, random.Random(3),
          random.Random(3))
    assert calls == []


@pytest.mark.parametrize("n", [0, 1, 311, 624, 5000])
def test_the_twister_and_advance_are_random_randoms(n):
    rng, ref = random.Random(n), random.Random(n)
    rng.random()
    ref.random()
    draws = tr._twister(rng).random_sample(n)
    assert draws.tolist() == [ref.random() for _ in range(n)]
    assert tr._advance(rng, n)
    assert rng.getstate() == ref.getstate()
    random.seed(n)
    tr._skip_draws(random, n)
    after = random.random()
    random.seed(n)
    for _ in range(n):
        random.random()
    assert after == random.random()
