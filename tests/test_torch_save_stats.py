"""Port parity: ``Greenhouse.save_stats`` and the generator's
``output.save_stats``.

One mid-growth state of the port on the CPU (14 iterations of the small
config of ``tests/test_torch_greenhouse.py``, batch 2), then two iterations
with draws made by ``draw_iteration`` and handed to ``run_mode``, which
collect the per-iteration counters. The state and the counters go into the
JAX package's ``save_stats`` and the port's: ``stats.yml`` is byte for
byte the JAX package's (``yaml.safe_dump``; the port writes it without
PyYAML), and both write ``stats.png`` where matplotlib imports. The
generator CLI writes ``stats/stats.yml`` into each sample's directory.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from octa_tpu.sim import greenhouse as jg
from octa_tpu_torch import generate_vessel_graph as gen
from octa_tpu_torch.sim import configs
from octa_tpu_torch.sim import greenhouse as tg
from octa_tpu_torch.utils.config import dump_flat_yaml

# the config of tests/test_torch_greenhouse.py (tests/test_sim.py:7-30)
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
         "kappa": 2.55, "delta_sigma": 0.02}],
}
FOREST = {"type": "stumps", "N_trees": 4,
          "source_walls": {"x0": True, "x1": True, "y0": True, "y1": True,
                           "z0": False, "z1": False}}
BATCH, NC, SC, WARM = 2, 512, 1024, 14


@pytest.fixture(scope="module")
def grown():
    """(greenhouse, state, stats [BATCH, 2, 5]) of the port on the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    g = tg.Greenhouse(CONFIG, node_capacity=NC, sink_capacity=SC, seed=3,
                      device="cpu")
    state = tg._tree_map(lambda *xs: torch.stack(xs),
                         *[g.init_state(FOREST, 3 + i) for i in range(BATCH)])
    g.generator.manual_seed(3)
    state = g._run_segment(state, 0, 0, 0, WARM, 4, False, 256)
    mp = g.modes[0]
    gen_ = torch.Generator().manual_seed(1)
    draws = [tg.draw_iteration(gen_, BATCH, mp.N, NC, tg.GEOMETRY_SIZE, "cpu")
             for _ in range(2)]
    state, stats = tg.run_mode(
        state, mp, WARM, i0=0, seg_len=2, draws=draws, collect_stats=True,
        param_scale=g.param_scale, r0=g.r, rotation_radius=g.rotation_radius,
        faz_center=torch.tensor(g.faz_center), size_z=g.sizes[2],
        murray_sweeps=4, new_cap=256)
    torch.set_num_threads(n)
    return g, state, stats


def _jax_state(state):
    ns = tg.state_to_numpy(state)

    def forest(f):
        return jg.ForestState(*(jnp.asarray(x) for x in f))

    def sinks(s):
        return jg.SinkState(*(jnp.asarray(x) for x in s))

    keys = jnp.stack([jax.random.PRNGKey(b) for b in range(BATCH)])
    return jg.GrowthState(
        forest(ns.art), forest(ns.ven), sinks(ns.oxy), sinks(ns.co2),
        jnp.asarray(ns.sigma_t), jnp.asarray(ns.d_cur),
        jnp.asarray(ns.d_start), jnp.asarray(ns.faz_radius), keys,
        jnp.asarray(ns.sat))


@pytest.mark.parametrize("sim_index", [0, 1])
def test_stats_yml_equals_the_jax_package(grown, tmp_path, sim_index):
    g, state, stats = grown
    assert stats.shape == (BATCH, 2, 5)
    ref_dir, ours_dir = tmp_path / "ref", tmp_path / "ours"
    jg.Greenhouse(CONFIG, node_capacity=NC, sink_capacity=SC, seed=3).save_stats(
        _jax_state(state), stats.numpy(), str(ref_dir), sim_index=sim_index)
    g.save_stats(state, stats, str(ours_dir), sim_index=sim_index)
    ours = (ours_dir / "stats.yml").read_text()
    assert ours == (ref_dir / "stats.yml").read_text()
    loaded = yaml.safe_load(ours)
    assert loaded["iterations"] == 2 and loaded["radius_max"] > 0
    assert loaded["final_art_nodes"] == int(state.art.n_nodes[sim_index])
    assert (ours_dir / "stats.png").stat().st_size > 1000
    assert (ref_dir / "stats.png").exists()


@pytest.mark.parametrize("mapping", [
    {"a": 1, "b": 0.1, "c": 1e-05, "d": 12345678.9, "e": -2.5e-12,
     "f": float("inf"), "g": 3.0, "h": True, "i": 1e16, "j": -0.0},
    {"radius_max": np.float32(0.00731).item(), "iterations": 0}])
def test_flat_yaml_writer_is_safe_dump(tmp_path, mapping):
    path = tmp_path / "x.yml"
    dump_flat_yaml(mapping, str(path))
    assert path.read_text() == yaml.safe_dump(mapping)
    assert yaml.safe_load(path.read_text()) == mapping


def test_generator_writes_the_stats(tmp_path):
    cfg = configs.vessel_graph_gen()
    cfg["Greenhouse"]["modes"] = yaml.safe_load(
        "[{name: SVC, I: 3, N: 300, eps_n: 0.18, eps_s: 0.135, eps_k: 0.135, "
        "delta_art: 0.2925, delta_ven: 0.2925, gamma_art: 50, gamma_ven: 50, "
        "phi: 15, omega: 0.3, kappa: 2.55, delta_sigma: 0.02}]")
    cfg["output"].update(directory=str(tmp_path), image_scale_factor=76,
                         save_2D_image=False, save_trees=False,
                         save_stats=True)
    dirs = gen.generate(cfg, 2, seed=1, device="cpu", log=lambda line: None)
    for d in dirs:
        assert sorted(os.listdir(d)) == ["config.yml", "stats"]
        stats = yaml.safe_load(open(os.path.join(d, "stats", "stats.yml")))
        assert stats["iterations"] == 3 and stats["final_art_nodes"] > 0
        assert os.path.exists(os.path.join(d, "stats", "stats.png"))
