"""Port parity: ``Greenhouse.develop_forest`` as a whole.

Both packages grow a batch of 4 at the small two-mode config of
``tests/test_sim.py`` on the CPU. Their random streams differ (a torch
generator against JAX keys), so the comparison is statistical, with the
bounds of ``tests/test_sim_parity.py:90-104``: mean arterial node count
within 35 %, alive oxygen sinks at the end within 25 %, radius median within
1e-4. The structural checks of ``tests/test_sim.py:40-135`` run on the
port's forests. Initial states are equal for the same seed, and the port's
config dictionary equals ``configs/vessel_graph_gen.yml``.
"""
import os
import warnings

import numpy as np
import pytest
import torch
import yaml

from octa_tpu.ops import raster as jraster
from octa_tpu.sim import greenhouse as jg
from octa_tpu_torch import pipeline as tp
from octa_tpu_torch.sim import configs
from octa_tpu_torch.sim import greenhouse as tg

# the config of tests/test_sim.py:7-30
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
        {"name": "SVC", "I": 12, "N": 500, "eps_n": 0.18, "eps_s": 0.135,
         "eps_k": 0.135, "delta_art": 0.2925, "delta_ven": 0.2925,
         "gamma_art": 50, "gamma_ven": 50, "phi": 15, "omega": 0.3,
         "kappa": 2.55, "delta_sigma": 0.02},
        {"name": "DVC", "I": 6, "N": 500, "eps_n": 0.09, "eps_s": 0.0675,
         "eps_k": 0.0675, "delta_art": 0.14625, "delta_ven": 0.14625,
         "gamma_art": 90, "gamma_ven": 90, "phi": 15, "omega": 0,
         "kappa": 2.9, "delta_sigma": 0.02},
    ],
}
FOREST = {"type": "stumps", "N_trees": 4,
          "source_walls": {"x0": True, "x1": True, "y0": True, "y1": True,
                           "z0": False, "z1": False}}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BATCH = 4


@pytest.fixture(scope="module")
def grown():
    g = tg.Greenhouse(CONFIG, node_capacity=2048, sink_capacity=1024, seed=1,
                      device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)  # no capacity ceiling
        state, stats = g.develop_forest(FOREST, batch=BATCH,
                                        collect_stats=True)
    return g, state, stats


@pytest.fixture(scope="module")
def grown_jax():
    g = jg.Greenhouse(CONFIG, node_capacity=2048, sink_capacity=1024, seed=1)
    return g.develop_forest(FOREST, batch=BATCH, collect_stats=True)


def test_config_dict_equals_yaml():
    with open(os.path.join(ROOT, "configs", "vessel_graph_gen.yml")) as f:
        ref = yaml.safe_load(f)
    assert configs.VESSEL_GRAPH_GEN["Greenhouse"] == ref["Greenhouse"]
    assert configs.VESSEL_GRAPH_GEN["Forest"] == ref["Forest"]
    fresh = configs.vessel_graph_gen()
    fresh["Greenhouse"]["modes"][0]["I"] = 1
    assert configs.VESSEL_GRAPH_GEN["Greenhouse"]["modes"][0]["I"] == 100


@pytest.mark.parametrize("forest", [
    FOREST, {"type": "nerve", "N_trees": 6}])
def test_init_state_equals_jax(forest):
    cfg = dict(CONFIG, nerve_center=[2.7, 2.7], nerve_radius=0.3)
    js = jg.Greenhouse(cfg, node_capacity=256, sink_capacity=128,
                       seed=3).init_state(forest, rng_seed=5)
    g = tg.Greenhouse(cfg, node_capacity=256, sink_capacity=128, seed=3,
                      device="cpu")
    ts = tg.state_to_numpy(g.init_state(forest, rng_seed=5))
    for name in ("art", "ven", "oxy", "co2"):
        for a, b in zip(getattr(ts, name), getattr(js, name)):
            np.testing.assert_array_equal(a, np.asarray(b))
    for name in ("sigma_t", "d_cur", "d_start", "faz_radius", "sat"):
        np.testing.assert_array_equal(getattr(ts, name),
                                      np.asarray(getattr(js, name)))
    assert g.nerve_radius == pytest.approx(0.1)  # the disc is in the FOV
    np.testing.assert_allclose(g.nerve_center.numpy(), [0.9, 0.9], rtol=1e-6)


def test_growth_statistics_match_jax(grown, grown_jax):
    _, state, stats = grown
    jstate, jstats = grown_jax
    ours, ref = state.art.n_nodes.numpy(), np.asarray(jstate.art.n_nodes)
    assert abs(ours.mean() - ref.mean()) / ref.mean() < 0.35, (ours, ref)
    oxy, joxy = stats[:, -1, 2].numpy(), np.asarray(jstats)[:, -1, 2]
    assert abs(oxy.mean() - joxy.mean()) / joxy.mean() < 0.25, (oxy, joxy)
    radii = np.concatenate([tg.forest_to_edges(state.art, b)["radius"]
                            for b in range(BATCH)])
    jradii = np.concatenate([jg.forest_to_edges(jstate.art, b)["radius"]
                             for b in range(BATCH)])
    assert abs(np.median(radii) - np.median(jradii)) < 1e-4
    q90, jq90 = np.quantile(radii, 0.9), np.quantile(jradii, 0.9)
    assert abs(q90 - jq90) / jq90 < 0.3, (q90, jq90)
    assert stats.shape == tuple(np.asarray(jstats).shape) == (BATCH, 18, 5)
    np.testing.assert_allclose(stats[:, :, 4].numpy(),
                               np.asarray(jstats)[:, :, 4], rtol=1e-6)


def test_forest_grows(grown):
    _, state, _ = grown
    n_art, n_ven = state.art.n_nodes.numpy(), state.ven.n_nodes.numpy()
    assert n_art.shape == (BATCH,)
    assert (n_art > 30).all(), n_art
    assert (n_ven >= 8).all(), n_ven
    assert len(set(n_art.tolist())) > 1  # batch members differ


def test_positions_and_radii_sane(grown):
    _, state, _ = grown
    for b in range(BATCH):
        edges = tg.forest_to_edges(state.art, b)
        n = int(state.art.n_nodes[b])
        assert len(edges["radius"]) == n - 4
        assert np.isfinite(edges["node1"]).all()
        assert (edges["node1"][:, :2] > -0.2).all()
        assert (edges["node1"][:, :2] < 1.2).all()
        assert (edges["radius"] > 0).all()


def test_murray_radius_monotonic(grown):
    _, state, _ = grown
    f = state.art
    n = int(f.n_nodes[0])
    parent = f.parent[0, :n].numpy()
    radius = f.radius[0, :n].numpy()
    is_root = f.is_root[0, :n].numpy()
    child = (parent >= 0) & ~is_root[np.clip(parent, 0, n - 1)]
    assert (radius[parent[child]] >= radius[child] - 1e-5).mean() > 0.99


@pytest.mark.parametrize("name", ["art", "ven"])
def test_tree_structure_consistency(grown, name):
    _, state, _ = grown
    f = getattr(state, name)
    for b in range(BATCH):
        n = int(f.n_nodes[b])
        parent = f.parent[b, :n].numpy()
        n_children = f.n_children[b, :n].numpy()
        assert (parent < np.arange(n))[parent >= 0].all()
        counted = np.bincount(parent[parent >= 0], minlength=n)
        np.testing.assert_array_equal(counted, n_children)
        assert (n_children <= 2).all()
        assert (f.parent[b, n:] == -1).all() and (f.radius[b, n:] == 0).all()


def test_final_murray_reaches_the_fixed_point(grown):
    _, state, _ = grown
    f = state.art
    n = int(f.n_nodes[0])
    parent = f.parent[0, :n].numpy()
    r = f.radius[0, :n].numpy().astype(np.float64)
    pk, k = f.pkappa[0, :n].numpy(), f.kappa[0, :n].numpy()
    has = parent >= 0
    child_sum = np.bincount(parent[has], weights=r[has] ** pk[has],
                            minlength=n)
    internal = (f.n_children[0, :n].numpy() >= 1) & ~f.is_root[0, :n].numpy()
    want = child_sum[internal] ** (1.0 / k[internal])
    np.testing.assert_allclose(r[internal], want, rtol=1e-5)


def test_faz_clearing(grown):
    _, state, _ = grown
    n = int(state.art.n_nodes[0])
    pos = state.art.pos[0, :n].numpy()
    d = np.linalg.norm(pos[:, :2] - 0.5, axis=-1)
    assert (d < float(state.faz_radius[0]) * 0.4).mean() < 0.05


def test_same_seed_same_forest_and_stage_log(grown):
    g, state, _ = grown
    again = g.develop_forest(FOREST, batch=BATCH)
    assert torch.equal(again.art.pos, state.art.pos)
    assert torch.equal(again.ven.n_nodes, state.ven.n_nodes)
    assert [e["seg_len"] for e in g.stage_log if e["accepted"]] == [12, 6]
    assert g.host_syncs == 1 + len(g.stage_log)


def test_csv_export_and_device_edges(grown, tmp_path):
    _, state, _ = grown
    art, ven = tg.forest_to_edges(state.art, 0), tg.forest_to_edges(state.ven, 0)
    path = str(tmp_path / "sample.csv")
    tg.save_edges_csv([art, ven], path)
    arrays = jraster.parse_graph_csv(path)
    n_edges = len(art["radius"]) + len(ven["radius"])
    assert len(arrays["radius"]) == n_edges
    # the device-side edges of the pipeline entry hold the same edge set
    a, b, w, v = tp.forest_edges(state)
    assert a.shape == (BATCH, 2 * state.art.pos.shape[1], 2)
    assert int(v[0].sum()) == n_edges
    np.testing.assert_allclose(np.sort(w[0][v[0]].numpy()),
                               np.sort(arrays["radius"]), rtol=1e-6)
    px = tp.edges_from_unit(a, b, w, v, 64, 256)
    np.testing.assert_allclose(px["lab"][0].numpy(), a.numpy() * 256)
    np.testing.assert_allclose(px["in"][2].numpy(),
                               w.numpy() * 1.3 * (100 / 72) * 64, rtol=1e-6)
    assert px["in"][3] is v


def test_capacity_ceiling_warns():
    g = tg.Greenhouse(CONFIG, node_capacity=2048, sink_capacity=256, seed=1,
                      device="cpu")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        g.develop_forest(FOREST, batch=1)
    assert [x for x in w if x.category is RuntimeWarning
            and "capacity ceiling" in str(x.message)]


def test_segment_replay_from_saved_generator_state():
    """What a capacity redo relies on: a segment run again from its entry
    state and the generator state saved there gives the same forest."""
    g = tg.Greenhouse(CONFIG, node_capacity=1024, sink_capacity=1024, seed=2,
                      device="cpu")
    state = tg._tree_map(lambda *xs: torch.stack(xs),
                         *[g.init_state(FOREST, 2 + i) for i in range(2)])
    g.generator.manual_seed(2)
    saved = g.generator.get_state()
    first = g._run_segment(state, 0, 0, 0, 3, 4, False, 1024)
    other = g._run_segment(state, 0, 0, 0, 3, 4, False, 1024)
    g.generator.set_state(saved)
    again = g._run_segment(state, 0, 0, 0, 3, 4, False, 1024)
    assert torch.equal(first.art.pos, again.art.pos)
    assert torch.equal(first.oxy.alive, again.oxy.alive)
    assert not torch.equal(first.oxy.pos, other.oxy.pos)
    # padding the arrays changes no decision of the forests already there
    wide = tg._resize_sinks(tg._resize_forests(first, 2048), 2048)
    assert wide.art.pos.shape[1] == 2048 and wide.co2.alive.shape[1] == 2048
    assert torch.equal(wide.art.pos[:, :1024], first.art.pos)
    assert int(wide.art.parent[:, 1024:].max()) == -1
    assert not bool(wide.oxy.alive[:, 1024:].any())
    assert tg._resize_forests(wide, 512) is wide


def test_nerve_forest_and_geometry_asset_grow():
    cfg = dict(CONFIG, nerve_center=[2.7, 2.7], nerve_radius=0.3)
    g = tg.Greenhouse(cfg, node_capacity=2048, sink_capacity=1024, seed=3,
                      device="cpu")
    out = g.develop_forest({"type": "nerve", "N_trees": 6}, batch=1)
    assert int(out.art.n_nodes[0]) > 12
    path = os.path.join(ROOT, "octa_tpu", "sim", "geometries",
                        "slab_oxy_sample_3mm.npy")
    cfg = dict(CONFIG, SimulationSpace=dict(
        CONFIG["SimulationSpace"], oxygen_sample_geometry_path=path))
    g = tg.Greenhouse(cfg, node_capacity=2048, sink_capacity=1024, seed=5,
                      device="cpu")
    assert g.geometry.shape == (76, 76) and g.sizes[0] == 1.0
    out = g.develop_forest(FOREST, batch=1)
    assert int(out.art.n_nodes[0]) > 30
    with pytest.raises(ValueError, match="nerve_center"):
        tg.Greenhouse({k: v for k, v in CONFIG.items()
                       if k not in ("nerve_center", "nerve_radius")},
                      device="cpu").init_state({"type": "nerve",
                                                "N_trees": 2}, rng_seed=0)
