"""Port parity: K5 (banded nearest scan) and the banded growth configuration
against the JAX package.

K5's plain PyTorch version, which :func:`octa_tpu_torch.ops.nearest
.masked_nearest_banded` runs for CPU tensors, is held to
``masked_nearest_banded_pallas`` in interpret mode wherever the contract
fixes the result (alive queries whose nearest point lies within the band:
distances to 1e-6, indices equal; beyond the band both report more than the
band) and to the port's own K2 (equal bit for bit inside the band, and
everywhere under a covering band). The CUDA kernel runs only on a card;
``chip_smoke.py`` holds it bit-equal to the plain version there.

Everything of ``sim/greenhouse.py`` that exists for K5 is held to the JAX
package's under ``OCTA_TPU_BANDED=1``: the restage (exact: a stable sort and
gathers), the tail-first sink append (exact), one banded iteration with
JAX's draws replayed (integer and boolean state equal, floats to 1e-5, the
tolerances of ``test_torch_greenhouse.py``) and a banded ``develop_forest``
on a tiny schedule (node counts within 30 %, the JAX test's own bound: the
two packages draw different random numbers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octa_tpu.ops.pallas_nearest import masked_nearest_banded_pallas
from octa_tpu.sim import greenhouse as jg
from octa_tpu_torch.ops import nearest as tn
from octa_tpu_torch.sim import greenhouse as tg

ATOL = 1e-5
CONFIG = {
    "SimulationSpace": {"no_voxel_x": 1, "no_voxel_y": 1,
                        "no_voxel_z": 0.0131},
    "d": 0.1, "r": 0.0025, "FAZ_radius_bound": [0.44, 0.04],
    "rotation_radius": 1.05, "FAZ_center": [0.5, 0.5], "param_scale": 3,
    "modes": [{"name": "SVC", "I": 10, "N": 400, "eps_n": 0.18,
               "eps_s": 0.135, "eps_k": 0.135, "delta_art": 0.2925,
               "delta_ven": 0.2925, "gamma_art": 50, "gamma_ven": 50,
               "phi": 15, "omega": 0.3, "kappa": 2.55, "delta_sigma": 0.02}],
}
FOREST = {"type": "stumps", "N_trees": 4,
          "source_walls": {"x0": True, "x1": True, "y0": True, "y1": True,
                           "z0": False, "z1": False}}
BATCH, NC, SC, WARM = 2, 512, 1024, 14


@pytest.fixture(scope="module", autouse=True)
def _warm_threads():
    """The first multi-threaded ``torch.sqrt`` of a process has been seen to
    return one thread's share a few 1e-4 off on some hosts; take it here, so
    that the tests compare arithmetic and not that."""
    torch.sqrt(torch.rand(1 << 20))


def _t(x):
    return torch.from_numpy(np.array(x))


def _scan_inputs(seed, r, q, n, sorted_pts):
    rng = np.random.default_rng(seed)
    pts = rng.random((r, n, 3), dtype=np.float32)
    pts[..., 2] *= 0.01
    if sorted_pts:
        pts = np.take_along_axis(
            pts, np.argsort(pts[..., 1], axis=1)[..., None], axis=1)
    qry = rng.random((r, q, 3), dtype=np.float32)
    qry[..., 2] *= 0.01
    if sorted_pts:
        qry = np.take_along_axis(
            qry, np.argsort(qry[..., 1], axis=1)[..., None], axis=1)
    valid = rng.random((r, 1, n)) < 0.8
    alive = rng.random((r, q)) < 0.7
    return qry, pts, valid, alive


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sorted_pts", [True, False])
@pytest.mark.parametrize("want_idx", [True, False])
def test_plain_k5_matches_pallas_inside_the_band(sorted_pts, want_idx):
    r, q, n = 2, 300, 4096
    band = np.asarray([0.012, 0.006], np.float32)
    qry, pts, valid, alive = _scan_inputs(7, r, q, n, sorted_pts)
    ref = masked_nearest_banded_pallas(
        jnp.asarray(qry), jnp.asarray(pts), jnp.asarray(valid),
        jnp.asarray(alive), jnp.asarray(band), want_idx=want_idx,
        interpret=True)
    out = tn.masked_nearest_banded(_t(qry), _t(pts), _t(valid), _t(alive),
                                   _t(band), want_idx=want_idx)
    full = tn.masked_nearest(_t(qry), _t(pts), _t(valid))[0].numpy()
    d = (out[0] if want_idx else out).numpy()
    d_ref = np.asarray(ref[0] if want_idx else ref)
    assert d.shape == (r, 1, q) and d.dtype == np.float32
    inside = alive[:, None] & (full <= band[:, None, None])
    beyond = alive[:, None] & (full > band[:, None, None])
    assert inside.sum() > 50 and beyond.sum() > 50
    np.testing.assert_allclose(d[inside], d_ref[inside], atol=1e-6, rtol=0)
    assert (d[beyond] > np.broadcast_to(band[:, None, None], d.shape)[beyond]).all()
    assert (d_ref[beyond] > np.broadcast_to(band[:, None, None], d.shape)[beyond]).all()
    if want_idx:
        assert out[1].dtype == torch.int32
        np.testing.assert_array_equal(out[1].numpy()[inside],
                                      np.asarray(ref[1])[inside])


@pytest.mark.parametrize("sorted_pts", [True, False])
def test_plain_k5_equals_k2_inside_the_band(sorted_pts):
    """The contract, against the port's own K2: equal bit for bit, distance
    and index, at every alive query whose K2 distance is within the band.
    On y-sorted points chunks are really skipped, and some results beyond
    the band differ."""
    r, q, n = 3, 700, 5000         # ragged last tile and last chunk
    band = _t(np.float32([0.03, 0.01, 0.06]))
    qry, pts, valid, alive = (_t(x) for x in _scan_inputs(3, r, q, n,
                                                          sorted_pts))
    valid[2, 0, :4000] = False     # row 2: only the last chunk's tail counts
    d, i = tn.masked_nearest_banded(qry, pts, valid, alive, band)
    d2, i2 = tn.masked_nearest(qry, pts, valid)
    inside = alive[:, None] & (d2 <= band[:, None, None])
    assert int(inside[:2].sum()) > 100 and int(inside[2].sum()) > 10
    assert torch.equal(d[inside], d2[inside])
    assert torch.equal(i[inside], i2[inside])
    assert bool((d >= d2).all())   # fewer points scanned: never nearer
    hit = tn.banded_hits(qry, pts, valid, alive, band)
    assert hit.shape == (r, 6, 5)
    if sorted_pts:
        assert 0.2 < float(hit.float().mean()) < 0.9
        # the low-y tiles of row 2 scan nothing: +inf where K2 finds a point
        assert not bool(hit[2, 0].any()) and bool(torch.isinf(d[2, 0, :128]).all())
        assert bool(torch.isfinite(d2[2]).all()) and int((d != d2).sum()) > 0
    else:
        # nothing to prune but row 2's all-invalid chunks: a full scan
        assert bool(hit[:2].all()) and not bool(hit[2, :, :3].any())
        assert torch.equal(d, d2) and torch.equal(i, i2)


def test_plain_k5_with_a_covering_band_equals_k2():
    r, q, n = 3, 257, 1024
    qry, pts, valid, _ = (_t(x) for x in _scan_inputs(5, r, q, n, False))
    alive = torch.ones(r, q, dtype=torch.bool)
    band = torch.full((r,), 10.0)
    d, i = tn.masked_nearest_banded(qry, pts, valid, alive, band)
    d2, i2 = tn.masked_nearest(qry, pts, valid)
    assert torch.equal(d, d2) and torch.equal(i, i2)
    ref_d, ref_i = masked_nearest_banded_pallas(
        jnp.asarray(qry.numpy()), jnp.asarray(pts.numpy()),
        jnp.asarray(valid.numpy()), jnp.asarray(alive.numpy()),
        jnp.asarray(band.numpy()), interpret=True)
    np.testing.assert_allclose(d.numpy(), np.asarray(ref_d), atol=1e-6)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))


def test_plain_k5_dead_tiles_and_empty_chunks():
    r, q, n = 2, 300, 3000
    qry, pts, valid, alive = (_t(x) for x in _scan_inputs(9, r, q, n, True))
    band = torch.full((r,), 0.05)
    alive[0, 128:256] = False      # an all-dead query tile
    valid[1, 0, 1024:2048] = False  # an all-invalid chunk
    valid[0] = False               # a row with no valid point
    d, i = tn.masked_nearest_banded(qry, pts, valid, alive, band)
    hit = tn.banded_hits(qry, pts, valid, alive, band)
    assert not bool(hit[0].any()) and not bool(hit[1, :, 1].any())
    assert bool(torch.isinf(d[0]).all()) and bool((i[0] == 0).all())
    d2, i2 = tn.masked_nearest(qry, pts, valid)
    inside = alive[:, None] & (d2 <= band[:, None, None])
    assert torch.equal(d[inside], d2[inside]) and torch.equal(i[inside], i2[inside])
    assert int(inside[1].sum()) > 20


def test_k5_wrapper_checks_and_dispatch():
    q, p = torch.zeros(1, 4, 3), torch.zeros(1, 8, 3)
    m, al, band = (torch.ones(1, 1, 8, dtype=torch.bool),
                   torch.ones(1, 4, dtype=torch.bool), torch.ones(1))
    with pytest.raises(ValueError, match="exactly one mask"):
        tn.masked_nearest_banded(q, p, torch.ones(1, 2, 8, dtype=torch.bool),
                                 al, band)
    with pytest.raises(ValueError, match="q_alive"):
        tn.masked_nearest_banded(q, p, m, al.float(), band)
    with pytest.raises(ValueError, match="band must be"):
        tn.masked_nearest_banded(q, p, m, al, torch.ones(2))
    with pytest.raises(ValueError, match="unsupported device"):
        tn.masked_nearest_banded(*(x.to("meta") for x in (q, p, m, al, band)))
    assert tn.NEAREST_BANDED.launches == 0  # the CPU path launches nothing
    assert (tn.BAND_TILE, tn.BAND_CHUNK) == (128, 1024)


# ---------------------------------------------------------------------------
# the banded growth configuration
# ---------------------------------------------------------------------------

def _jax_state(np_state, keys):
    """The port's state (numpy leaves) as a JAX ``GrowthState``."""
    def forest(f):
        return jg.ForestState(*(jnp.asarray(x) for x in f))

    def sinks(s):
        return jg.SinkState(*(jnp.asarray(x) for x in s))

    return jg.GrowthState(
        forest(np_state.art), forest(np_state.ven), sinks(np_state.oxy),
        sinks(np_state.co2), jnp.asarray(np_state.sigma_t),
        jnp.asarray(np_state.d_cur), jnp.asarray(np_state.d_start),
        jnp.asarray(np_state.faz_radius), keys, jnp.asarray(np_state.sat))


@pytest.fixture(scope="module")
def grown():
    """(greenhouse, JAX mid-growth state, the same state in the port carried
    over with ``state_from_numpy``), batch 2, grown unbanded by the port."""
    g = tg.Greenhouse(CONFIG, node_capacity=NC, sink_capacity=SC, seed=3,
                      device="cpu", banded=True)
    state = tg._tree_map(lambda *xs: torch.stack(xs),
                         *[g.init_state(FOREST, 3 + i) for i in range(BATCH)])
    g.generator.manual_seed(3)
    state = tg.run_mode(
        state, g.modes[0], 0, param_scale=g.param_scale, r0=g.r,
        rotation_radius=g.rotation_radius, faz_center=g._faz_center,
        size_z=g.sizes[2], murray_sweeps=4, i0=0, seg_len=WARM, new_cap=256,
        generator=g.generator)
    assert int(state.sat.max()) == 0 and int(state.art.n_nodes.min()) > 30
    assert int(state.co2.alive.sum()) > 0
    keys = jnp.stack([jax.random.PRNGKey(20 + b) for b in range(BATCH)])
    jstate = _jax_state(tg.state_to_numpy(state), keys)
    return g, jstate, tg.state_from_numpy(jstate, device="cpu")


def _assert_forest_equal(out, ref, exact=True):
    for name in tg.ForestState._fields:
        a, b = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        if exact or a.dtype.kind in "ib":
            np.testing.assert_array_equal(a, b, name)
        else:
            np.testing.assert_allclose(a, b, atol=ATOL, err_msg=name)


def test_ysort_forest_equals_jax(grown):
    _, jstate, state = grown
    for name in ("art", "ven"):
        out = tg._ysort_forest(getattr(state, name))
        ref = jax.vmap(jg._ysort_forest)(getattr(jstate, name))
        _assert_forest_equal(out, ref)
        n = int(out.n_nodes[0])
        assert (np.diff(out.pos[0, :n, 1].numpy()) >= 0).all()
        assert not torch.equal(out.pos, getattr(state, name).pos)
        # a relabelling: -1 stays -1, and first_child points back
        assert bool(((out.parent[0, :n] >= 0) != out.is_root[0, :n]).all())
        assert bool((out.parent[0, n:] == -1).all())
        fc = out.first_child[0, :n].long()
        has = fc >= 0
        assert torch.equal(out.parent[0, fc[has]].long(),
                           torch.arange(n)[has])
    # unbatched, as the JAX function is written
    one = tg._ysort_forest(tg.ForestState(*(x[1] for x in state.art)))
    both = tg._ysort_forest(state.art)
    assert all(torch.equal(a, b[1]) for a, b in zip(one, both))


def test_ysort_sinks_and_restage_equal_jax(grown):
    _, jstate, state = grown
    out = tg._ysort_sinks(state.oxy)
    ref = jax.vmap(jg._ysort_sinks)(jstate.oxy)
    np.testing.assert_array_equal(out.alive.numpy(), np.asarray(ref.alive))
    np.testing.assert_array_equal(out.pos.numpy(), np.asarray(ref.pos))
    k = int(out.alive[0].sum())
    assert k > 0 and bool(out.alive[0, :k].all()) and not bool(out.alive[0, k:].any())
    rs, jrs = tg._restage_spatial(state), jg._restage_spatial(jstate)
    for name in ("art", "ven"):
        _assert_forest_equal(getattr(rs, name), getattr(jrs, name))
    for name in ("oxy", "co2"):
        for a, b in zip(getattr(rs, name), getattr(jrs, name)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for name in ("sigma_t", "d_cur", "d_start", "faz_radius", "sat"):
        assert torch.equal(getattr(rs, name), getattr(state, name))


@pytest.mark.parametrize("n_accept,n_free,max_append", [
    (40, 300, 2048),    # everything placed
    (200, 300, 64),     # append window overflows
    (200, 50, 2048),    # sink array overflows
])
def test_append_sinks_tail_first_equals_jax(rng, monkeypatch, n_accept,
                                            n_free, max_append):
    monkeypatch.setenv("OCTA_TPU_BANDED", "1")
    sc, sq = 400, 700
    alive = np.ones(sc, bool)
    alive[rng.choice(sc, n_free, replace=False)] = False
    spos = rng.random((sc, 3)).astype(np.float32)
    pos = rng.random((sq, 3)).astype(np.float32)
    accept = np.zeros(sq, bool)
    accept[rng.choice(sq, n_accept, replace=False)] = True
    ref, ref_win, ref_cap = jg._append_sinks(
        jg.SinkState(jnp.asarray(spos), jnp.asarray(alive)),
        jnp.asarray(pos), jnp.asarray(accept), max_append=max_append)
    out, win, cap = tg._append_sinks(
        tg.SinkState(_t(spos), _t(alive)), _t(pos), _t(accept),
        max_append=max_append, tail_first=True)
    np.testing.assert_array_equal(out.alive.numpy(), np.asarray(ref.alive))
    np.testing.assert_array_equal(out.pos.numpy(), np.asarray(ref.pos))
    assert bool(win) == bool(ref_win) and bool(cap) == bool(ref_cap)
    placed = np.flatnonzero(out.alive.numpy() & ~alive)
    free = np.flatnonzero(~alive)
    np.testing.assert_array_equal(placed, free[len(free) - len(placed):])
    head, _, _ = tg._append_sinks(tg.SinkState(_t(spos), _t(alive)), _t(pos),
                                  _t(accept), max_append=max_append)
    assert int(head.alive.sum()) == int(out.alive.sum())
    if len(placed) < n_free:
        assert not torch.equal(head.alive, out.alive)


def _jax_draws(key, n_cand, nc):
    """The numbers ``_iteration`` draws from ``key``, as
    ``test_torch_greenhouse.py`` replays them."""
    key, k_cand, k_art, k_ven = jax.random.split(key, 4)
    k1, k2 = jax.random.split(k_cand)
    vox = jax.random.randint(k1, (n_cand, 2), 0, jg.GEOMETRY_SIZE)
    jitter = jax.random.uniform(k2, (n_cand, 3))
    u = []
    for kk in (k_art, k_ven):
        a, b, _ = jax.random.split(kk, 3)
        u.append((jax.random.uniform(a, (nc,)), jax.random.uniform(b, (nc,))))
    return (np.asarray(vox), np.asarray(jitter),
            np.stack([np.asarray(u[0][0]), np.asarray(u[1][0])]),
            np.stack([np.asarray(u[0][1]), np.asarray(u[1][1])]))


@pytest.mark.parametrize("i,t", [(0, 0), (WARM, 20)])
def test_banded_iteration_matches(grown, monkeypatch, i, t):
    """One banded ``_iteration`` of the port (plain K5 on the CPU) on a
    restaged state against the JAX function under ``OCTA_TPU_BANDED=1``
    (sorted candidates, full scans on the CPU), same state, same draws."""
    monkeypatch.setenv("OCTA_TPU_BANDED", "1")
    g, jstate, state = grown
    jstate, state = jg._restage_spatial(jstate), tg._restage_spatial(state)
    mp_t = g.modes[0]
    mp_j = jg.ModeParams(*mp_t)
    kw = dict(param_scale=g.param_scale, r0=g.r,
              rotation_radius=g.rotation_radius, size_z=g.sizes[2],
              n_cand=mp_t.N, murray_sweeps=4, new_cap=256)

    def jstep(s):
        out = jg._iteration(jg._stack_state(s), mp_j, i, t, s.d_start,
                            faz_center=jnp.asarray(g.faz_center), **kw)
        return jg._unstack_state(out)

    ref = jax.jit(jax.vmap(jstep))(jstate)
    parts = [_jax_draws(jstate.key[b], mp_t.N, NC) for b in range(BATCH)]
    draws = tg.IterationDraws(*(_t(np.stack([p[k] for p in parts]))
                                for k in range(4)))
    before = tn.NEAREST_BANDED.launches
    out = tg._unstack_state(tg._iteration(
        tg._stack_state(state), mp_t, i, t, faz_center=_t(g.faz_center),
        draws=draws, banded=True, **kw))
    assert tn.NEAREST_BANDED.launches == before

    for fname in ("art", "ven"):
        _assert_forest_equal(getattr(out, fname), getattr(ref, fname),
                             exact=False)
    assert (out.art.n_nodes > state.art.n_nodes).all()
    for sname in ("oxy", "co2"):
        so, sr = getattr(out, sname), getattr(ref, sname)
        alive = np.asarray(sr.alive)
        np.testing.assert_array_equal(so.alive.numpy(), alive, sname)
        np.testing.assert_allclose(so.pos.numpy()[alive],
                                   np.asarray(sr.pos)[alive], atol=1e-7)
    assert not torch.equal(out.oxy.alive, state.oxy.alive)
    for name in ("sigma_t", "d_cur", "d_start", "faz_radius"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=1e-6,
                                   err_msg=name)
    np.testing.assert_array_equal(out.sat.numpy(), np.asarray(ref.sat))
    # and the unbanded arm from the same state and draws grows the same
    # forests: the same candidates are accepted, only slots differ
    plain = tg._unstack_state(tg._iteration(
        tg._stack_state(state), mp_t, i, t, faz_center=_t(g.faz_center),
        draws=draws, **kw))
    assert torch.equal(plain.art.n_nodes, out.art.n_nodes)
    assert torch.equal(plain.oxy.alive.sum(-1), out.oxy.alive.sum(-1))


def test_banded_develop_forest_statistical_parity(monkeypatch):
    """The tiny schedule of the JAX package's own banded test, batch 1: the
    port's banded growth against the JAX package's under
    ``OCTA_TPU_BANDED=1`` and against the port's unbanded growth."""
    monkeypatch.setenv("OCTA_TPU_BANDED", "1")
    jgh = jg.Greenhouse(CONFIG, node_capacity=2048, sink_capacity=1024,
                        seed=11)
    ref = jgh.develop_forest(FOREST, batch=1, final_murray_sweeps=32)
    n_ref = int(ref.art.n_nodes[0]) + int(ref.ven.n_nodes[0])
    counts = {}
    for banded in (True, False):
        g = tg.Greenhouse(CONFIG, node_capacity=2048, sink_capacity=1024,
                          seed=11, device="cpu", banded=banded)
        g.SEG_LEN = 5  # a restage in mid-growth too
        out = g.develop_forest(FOREST, batch=1, final_murray_sweeps=32)
        counts[banded] = int(out.art.n_nodes[0]) + int(out.ven.n_nodes[0])
        assert len(g.stage_log) >= 2
        for f in (out.art, out.ven):
            n = int(f.n_nodes[0])
            par = f.parent[0, :n]
            assert n >= 8 and bool(((par >= -1) & (par < n)).all())
            assert bool(((par >= 0) != f.is_root[0, :n]).all())
            assert bool(torch.isfinite(f.radius[0, :n]).all())
    assert abs(counts[True] - n_ref) / n_ref < 0.3, (counts, n_ref)
    assert abs(counts[True] - counts[False]) / counts[False] < 0.3, counts
    with pytest.raises(NotImplementedError, match="mesh"):
        g.develop_forest(FOREST, batch=1, mesh=object())
    with pytest.raises(NotImplementedError, match="matplotlib"):
        g.save_stats(out, None, "stats")
