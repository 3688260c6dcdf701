"""Port parity: the growth engine's pieces against the JAX package.

The same inputs — a mid-growth state (grown on the CPU by the port at a
small size and carried into JAX as numpy arrays), seeded numpy data, and the
random numbers JAX draws from its keys, replayed with ``jax.random`` and
injected into the port — go through ``octa_tpu.sim.greenhouse`` on the CPU
and through ``octa_tpu_torch.sim.greenhouse``. Integer and boolean state
(``n_nodes``, ``parent``, ``n_children``, alive masks) must be equal;
positions and radii agree to atol 1e-5 (float32 transcendentals of two
libraries; XLA may fuse multiply-adds).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from octa_tpu.sim import greenhouse as jg
from octa_tpu_torch.sim import greenhouse as tg

ATOL = 1e-5
CONFIG = {
    "SimulationSpace": {"no_voxel_x": 1, "no_voxel_y": 1,
                        "no_voxel_z": 0.0131},
    "d": 0.1, "r": 0.0025,
    "FAZ_radius_bound": [0.44, 0.04],
    "rotation_radius": 1.05,
    "FAZ_center": [0.5, 0.5],
    "nerve_center": [10.56, 5.16],
    "nerve_radius": 0.3,
    "param_scale": 3,
    "modes": [
        {"name": "SVC", "I": 30, "N": 400, "eps_n": 0.18, "eps_s": 0.135,
         "eps_k": 0.135, "delta_art": 0.2925, "delta_ven": 0.2925,
         "gamma_art": 50, "gamma_ven": 50, "phi": 15, "omega": 0.3,
         "kappa": 2.55, "delta_sigma": 0.02},
    ],
}
FOREST = {"type": "stumps", "N_trees": 4,
          "source_walls": {"x0": True, "x1": True, "y0": True, "y1": True,
                           "z0": False, "z1": False}}
BATCH, NC, SC, WARM = 2, 512, 1024, 14


def _t(x):
    return torch.from_numpy(np.array(x))


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
    """(greenhouse, mid-growth state of the port on the CPU, batch 2)."""
    g = tg.Greenhouse(CONFIG, node_capacity=NC, sink_capacity=SC, seed=3,
                      device="cpu")
    state = tg._tree_map(lambda *xs: torch.stack(xs),
                         *[g.init_state(FOREST, 3 + i) for i in range(BATCH)])
    g.generator.manual_seed(3)
    state = g._run_segment(state, 0, 0, 0, WARM, 4, False, 256)
    assert int(state.sat.max()) == 0
    assert int(state.art.n_nodes.min()) > 30
    assert int(state.co2.alive.sum()) > 0
    return g, state


def _jax_draws(key, n_cand, nc):
    """The numbers ``_iteration`` draws from ``key`` (:736, :285-288,
    :529-531), and the key it hands on."""
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


# ---------------------------------------------------------------------------
# helpers, one by one
# ---------------------------------------------------------------------------

def test_geometry_helpers_match(rng):
    u = rng.normal(size=(50, 3)).astype(np.float32)
    v = rng.normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_allclose(tg._norm(_t(u)).numpy(),
                               np.asarray(jg._norm(jnp.asarray(u))), atol=1e-6)
    np.testing.assert_allclose(
        tg._angle_deg(_t(u), _t(v)).numpy(),
        np.asarray(jg._angle_deg(jnp.asarray(u), jnp.asarray(v))), atol=1e-3)
    r = (rng.random(50) * 0.01).astype(np.float32)
    np.testing.assert_allclose(
        tg._oxygen_distance(_t(r), 3).numpy(),
        np.asarray(jg._oxygen_distance(jnp.asarray(r), 3)), rtol=1e-5)
    th = (rng.random(50) * 180).astype(np.float32)
    axis = np.asarray(jg._norm(jnp.asarray(v)))
    np.testing.assert_allclose(
        tg._rodrigues(_t(u), _t(axis), _t(th)).numpy(),
        np.asarray(jg._rodrigues(jnp.asarray(u), jnp.asarray(axis),
                                 jnp.asarray(th))), atol=1e-5)


def test_power_iteration_matches(rng):
    a = rng.normal(size=(40, 3, 3)).astype(np.float32)
    m = a @ a.transpose(0, 2, 1)
    out = tg._power_iteration_3x3(_t(m)).numpy()
    ref = np.asarray(jg._power_iteration_3x3(jnp.asarray(m)))
    np.testing.assert_allclose(out, ref, atol=1e-4)
    # and it is the principal eigenvector
    w, vec = np.linalg.eigh(m.astype(np.float64))
    well = (w[:, 2] - w[:, 1]) / w[:, 2] > 0.5
    cos = np.abs((out * vec[:, :, 2]).sum(-1))
    assert (cos[well] > 0.999).all()


@pytest.mark.parametrize("mode", ["faz", "nerve", "geometry"])
def test_sample_candidates_match(mode):
    key = jax.random.PRNGKey(4)
    n = 3000
    k1, k2 = jax.random.split(key)
    vox = np.asarray(jax.random.randint(k1, (n, 2), 0, 76))
    jitter = np.asarray(jax.random.uniform(k2, (n, 3)))
    kw_j, kw_t = {}, {}
    if mode == "nerve":
        kw_j = dict(nerve_center=jnp.asarray([0.8, 0.3]), nerve_radius=0.15)
        kw_t = dict(nerve_center=torch.tensor([0.8, 0.3]), nerve_radius=0.15)
    if mode == "geometry":
        mask = np.ones((76, 76), bool)
        mask[:38] = False
        kw_j, kw_t = dict(geometry=jnp.asarray(mask)), dict(geometry=_t(mask))
    ref_pos, ref_valid = jg._sample_candidates(
        key, n, jnp.asarray([0.5, 0.5]), jnp.float32(0.3), 0.0131, **kw_j)
    pos, valid = tg._sample_candidates(
        _t(vox), _t(jitter), torch.tensor([0.5, 0.5]), torch.tensor(0.3),
        0.0131, **kw_t)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    np.testing.assert_allclose(pos.numpy(), np.asarray(ref_pos), atol=1e-7)
    assert 0.05 < valid.float().mean() < 1.0


@pytest.mark.parametrize("n,eps", [(500, 0.05), (2000, 0.02), (64, 0.2)])
def test_blocked_greedy_spacing_matches(rng, n, eps):
    pos = rng.random((n, 3)).astype(np.float32) * np.float32([1, 1, 0.01])
    valid = rng.random(n) < 0.8
    ref = np.asarray(jg._blocked_greedy_spacing(
        jnp.asarray(pos), jnp.asarray(valid), eps))
    out = tg._blocked_greedy_spacing(_t(pos), _t(valid), eps).numpy()
    np.testing.assert_array_equal(out, ref)
    # batched: every row as if alone, each with its own eps
    both = tg._blocked_greedy_spacing(
        _t(np.stack([pos, pos[::-1]])), _t(np.stack([valid, valid[::-1]])),
        torch.tensor([eps, eps * 2]))
    np.testing.assert_array_equal(both[0].numpy(), ref)
    assert 0 < both[1].sum() < both[0].sum()


@pytest.mark.parametrize("n_accept,n_free,max_append", [
    (40, 300, 2048),    # everything placed
    (200, 300, 64),     # append window overflows
    (200, 50, 2048),    # sink array overflows
])
def test_append_sinks_matches(rng, n_accept, n_free, max_append):
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
        max_append=max_append)
    np.testing.assert_array_equal(out.alive.numpy(), np.asarray(ref.alive))
    np.testing.assert_array_equal(out.pos.numpy(), np.asarray(ref.pos))
    assert bool(win) == bool(ref_win) and bool(cap) == bool(ref_cap)
    assert bool(win) == (n_accept > max_append)
    assert bool(cap) == (min(n_accept, max_append) > n_free)


# ---------------------------------------------------------------------------
# state carrying, edges
# ---------------------------------------------------------------------------

def test_state_from_numpy_round_trip():
    jgh = jg.Greenhouse(CONFIG, node_capacity=64, sink_capacity=32, seed=0)
    js = jgh.init_state(FOREST, 7)
    ts = tg.state_from_numpy(js, device="cpu")
    assert ts.art.parent.dtype == torch.int32
    assert ts.art.is_root.dtype == torch.bool and ts.sat.dtype == torch.int32
    back = tg.state_to_numpy(ts)
    for name in ("art", "ven", "oxy", "co2"):
        for a, b in zip(getattr(back, name), getattr(js, name)):
            np.testing.assert_array_equal(a, np.asarray(b))
    for name in ("sigma_t", "d_cur", "d_start", "faz_radius", "sat"):
        np.testing.assert_array_equal(getattr(back, name),
                                      np.asarray(getattr(js, name)))
    # a batched state goes through stack / unstack unchanged
    batched = tg._tree_map(lambda *xs: torch.stack(xs), ts, ts)
    again = tg._unstack_state(tg._stack_state(batched))
    for a, b in zip(again.art + again.co2, batched.art + batched.co2):
        assert torch.equal(a, b)


def test_forest_edges_device_and_edge_list_match(grown, tmp_path):
    _, state = grown
    ns = tg.state_to_numpy(state)
    jart = jg.ForestState(*(jnp.asarray(x) for x in ns.art))
    for out, ref in zip(tg.forest_edges_device(state.art),
                        jg.forest_edges_device(jart)):
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    e, je = tg.forest_to_edges(state.art, 1), jg.forest_to_edges(jart, 1)
    for k in ("node1", "node2", "radius"):
        np.testing.assert_array_equal(e[k], je[k])
    assert len(e["radius"]) == int(state.art.n_nodes[1]) - FOREST["N_trees"]
    a, b = tmp_path / "t.csv", tmp_path / "j.csv"
    tg.save_edges_csv([e], str(a))
    jg.save_edges_csv([je], str(b))
    assert a.read_text() == b.read_text()


# ---------------------------------------------------------------------------
# growth core, Murray sweeps, one iteration
# ---------------------------------------------------------------------------

def test_murray_sweep_matches(grown, rng):
    _, state = grown
    f = state.art
    bumped = f._replace(radius=f.radius * _t(
        rng.uniform(0.5, 1.5, f.radius.shape).astype(np.float32)))
    jf = jg.ForestState(*(jnp.asarray(x.numpy()) for x in bumped))
    for exact in (None, True):
        out = tg.murray_sweep(bumped, 3, exact=exact)
        ref = jax.vmap(lambda x: jg.murray_sweep(x, 3, exact=exact))(jf)
        np.testing.assert_allclose(out.radius.numpy(), np.asarray(ref.radius),
                                   rtol=1e-5, atol=1e-9)
    assert not torch.equal(out.radius, bumped.radius)
    # unbatched, as the JAX function is written
    one = tg.murray_sweep(tg.ForestState(*(x[0] for x in bumped)), 3)
    assert torch.equal(one.radius, out.radius[0])


def test_murray_uses_per_node_kappa():
    """``tests/test_sim.py:170``: the PARENT's creation kappa."""
    nc = 8
    f = tg.ForestState(
        pos=torch.zeros(nc, 3),
        radius=torch.tensor([1.0, 0.5, 0.2, 0.3, 0, 0, 0, 0]),
        parent=torch.tensor([-1, 0, 1, 1, -1, -1, -1, -1], dtype=torch.int32),
        first_child=torch.tensor([1, 2, -1, -1, -1, -1, -1, -1],
                                 dtype=torch.int32),
        n_children=torch.tensor([1, 2, 0, 0, 0, 0, 0, 0], dtype=torch.int32),
        is_root=torch.tensor([1, 0, 0, 0, 0, 0, 0, 0], dtype=torch.bool),
        n_nodes=torch.tensor(4, dtype=torch.int32),
        kappa=torch.tensor([4.0, 2.55, 2.9, 2.9, 4, 4, 4, 4]),
        pkappa=torch.tensor([4.0, 4.0, 2.55, 2.55, 4, 4, 4, 4]))
    out = tg.murray_sweep(f, 1)
    want = (0.2 ** 2.55 + 0.3 ** 2.55) ** (1 / 2.55)
    assert abs(float(out.radius[1]) - want) < 1e-6
    assert float(out.radius[0]) == 1.0
    assert float(out.radius[2]) == pytest.approx(0.2)


@pytest.mark.parametrize("forest,t,first_mode,new_cap", [
    ("art", 20, True, 256),    # rotation field on
    ("art", 5, False, 256),    # rotation field off
    ("art", 20, False, 4),     # emission window overflows
])
def test_grow_core_matches(grown, forest, t, first_mode, new_cap):
    g, state = grown
    b = 0
    f = tg.ForestState(*(x[b] for x in getattr(state, forest)))
    sinks = tg.SinkState(*(x[b] for x in
                           (state.oxy if forest == "art" else state.co2)))
    nc = f.pos.shape[0]
    active = (f.n_children < 2) & (torch.arange(nc) < f.n_nodes)
    dist, idx = tg.masked_nearest(sinks.pos[None], f.pos[None],
                                  active[None, None])
    dist, idx = dist[0, 0], idx[0, 0]
    jf = jg.ForestState(*(jnp.asarray(x.numpy()) for x in f))
    jd, ji = jg._chunked_nearest(jnp.asarray(sinks.pos.numpy()), jf.pos,
                                 jnp.asarray(active.numpy()), chunk=128)
    np.testing.assert_allclose(dist.numpy(), np.asarray(jd), atol=1e-6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))

    key = jax.random.PRNGKey(9)
    k1, k2, _ = jax.random.split(key, 3)
    u_bif = np.asarray(jax.random.uniform(k1, (nc,)))
    u_sprout = np.asarray(jax.random.uniform(k2, (nc,)))
    mp = g.modes[0]
    kw = dict(gamma=mp.gamma_art, d=0.7 * g.d, r=g.r, kappa=mp.kappa,
              phi=mp.phi, omega=mp.omega, rotation_radius=g.rotation_radius,
              first_mode=first_mode, t=t, murray_sweeps=4, new_cap=new_cap)
    delta = mp.delta_art / 3.3
    faz_r = float(state.faz_radius[b])
    ref, ref_sat = jg._grow_core(
        jf, jnp.asarray(sinks.pos.numpy()), jnp.asarray(sinks.alive.numpy()),
        jd, ji, delta=jnp.float32(delta), faz_center=jnp.asarray(g.faz_center),
        faz_radius=jnp.float32(faz_r), key=key, **kw)
    out, sat = tg._grow_core(
        f, sinks.pos, sinks.alive, dist, idx, delta=delta,
        faz_center=_t(g.faz_center), faz_radius=faz_r, u_bif=_t(u_bif),
        u_sprout=_t(u_sprout), **kw)
    assert int(out.n_nodes) == int(ref.n_nodes) > int(f.n_nodes)
    assert bool(sat) == bool(ref_sat) == (new_cap == 4)
    for name in ("parent", "first_child", "n_children", "is_root"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    for name in ("pos", "radius", "kappa", "pkappa"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("i,t", [(0, 0), (WARM, 20)])
def test_iteration_matches(grown, i, t):
    """One ``_iteration`` of the port on the batch against the JAX function
    vmapped over it, from the same state with the same random numbers."""
    g, state = grown
    ns = tg.state_to_numpy(state)
    keys = jnp.stack([jax.random.PRNGKey(20 + b) for b in range(BATCH)])
    jstate = _jax_state(ns, keys)
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
    parts = [_jax_draws(keys[b], mp_t.N, NC) for b in range(BATCH)]
    draws = tg.IterationDraws(*(_t(np.stack([p[k] for p in parts]))
                                for k in range(4)))
    out = tg._unstack_state(tg._iteration(
        tg._stack_state(state), mp_t, i, t, faz_center=_t(g.faz_center),
        draws=draws, **kw))

    for fname in ("art", "ven"):
        fo, fr = getattr(out, fname), getattr(ref, fname)
        np.testing.assert_array_equal(fo.n_nodes.numpy(),
                                      np.asarray(fr.n_nodes), fname)
        for name in ("parent", "first_child", "n_children"):
            np.testing.assert_array_equal(getattr(fo, name).numpy(),
                                          np.asarray(getattr(fr, name)),
                                          f"{fname}.{name}")
        for name in ("pos", "radius", "kappa", "pkappa"):
            np.testing.assert_allclose(getattr(fo, name).numpy(),
                                       np.asarray(getattr(fr, name)),
                                       atol=ATOL, err_msg=f"{fname}.{name}")
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


def test_run_mode_consumes_injected_draws(grown):
    """``run_mode`` with a list of draws equals the iterations one by one,
    resets sigma at mode entry and collects one stats row per iteration."""
    g, state = grown
    mp = g.modes[0]
    gen = torch.Generator().manual_seed(1)
    draws = [tg.draw_iteration(gen, BATCH, mp.N, NC, tg.GEOMETRY_SIZE, "cpu")
             for _ in range(2)]
    kw = dict(param_scale=g.param_scale, r0=g.r,
              rotation_radius=g.rotation_radius, faz_center=_t(g.faz_center),
              size_z=g.sizes[2], murray_sweeps=4, new_cap=256)
    out, stats = tg.run_mode(state, mp, 0, i0=0, seg_len=2, draws=draws,
                             collect_stats=True, **kw)
    st = tg._stack_state(state._replace(
        sigma_t=torch.ones_like(state.sigma_t), d_start=state.d_cur))
    for k in range(2):
        st = tg._iteration(st, mp, k, k, n_cand=mp.N, draws=draws[k], **kw)
    want = tg._unstack_state(st)
    assert torch.equal(out.art.pos, want.art.pos)
    assert torch.equal(out.oxy.alive, want.oxy.alive)
    assert stats.shape == (BATCH, 2, 5)
    assert torch.equal(stats[:, -1, 0], out.art.n_nodes.float())
    np.testing.assert_allclose(stats[:, -1, 4].numpy(), 1.04, rtol=1e-6)
