"""Sharded growth in the port (``Greenhouse.develop_forest(mesh=)``) and
the generator CLI over several CPU processes (gloo): the tiny schedule of
``__graft_entry__.py:181-205`` grown at batch 4 over two and over four
ranks, and at batch 3 over two (padded to 4 with an extra seed), against
the unsharded port grown at the padded batch. Each rank's rows equal the
unsharded run's bit for bit (JAX's own bar, ``__graft_entry__.py:
205-215``, is equal node counts and positions within 1e-5), and every rank
staged the unsharded run's capacities. ``python -m
octa_tpu_torch.generate_vessel_graph`` over two processes writes the files
of a one-process run (2 samples at batch 2, one a rank; three iterations
of the schedule). One generator
draws each iteration's numbers for the whole batch, so a padded batch's
samples are those of the unsharded run at the padded batch (the growth
test's batch 3), not at the batch asked for. Every rank runs one torch
thread, every collective fails after 60 s and every launch after its join
timeout.
"""
import os

import numpy as np
import pytest
import torch
import yaml

from octa_tpu_torch.parallel import mesh as mesh_lib
from tests import torch_mesh_workers as W

MODES = ("[{name: SVC, I: 3, N: 300, eps_n: 0.18, eps_s: 0.135, eps_k: 0.135, "
         "delta_art: 0.2925, delta_ven: 0.2925, gamma_art: 50, gamma_ven: 50, "
         "phi: 15, omega: 0.3, kappa: 2.55, delta_sigma: 0.02}]")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.sqrt(torch.rand(1 << 20))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def unsharded():
    """The tiny schedule grown at batch 4 in one process."""
    rows, state, log = W.grow(4, sharded=False)
    assert rows == [0, 1, 2, 3]
    assert int(state.art.n_nodes.min()) > 2 * W.GROW_FOREST["N_trees"]
    return state, log


@pytest.mark.parametrize("batch,ranks", [(4, 2), (4, 4), (3, 2)])
def test_sharded_growth_equals_unsharded(unsharded, tmp_path, batch, ranks):
    ref, ref_log = unsharded
    outs = mesh_lib.launch(W.grow, ranks, batch, True, tmp_dir=str(tmp_path),
                           join_timeout=120)
    per = 4 // ranks
    for rank, (rows, state, log) in enumerate(outs):
        assert rows == list(range(rank * per, (rank + 1) * per))
        assert log == ref_log
        for part in ("art", "ven", "oxy", "co2"):
            for field, ours in getattr(state, part)._asdict().items():
                theirs = getattr(getattr(ref, part), field)[rows]
                assert ours.shape == theirs.shape, (part, field)
                assert np.array_equal(ours, theirs), (part, field)
        for field in ("sigma_t", "d_cur", "d_start", "faz_radius"):
            assert np.array_equal(getattr(state, field),
                                  getattr(ref, field)[rows]), field


def _files(dirs):
    """Each sample's files (name -> bytes), the tree CSV under ``csv``
    (its name is the directory's) and the config without its output
    directory, sorted by the CSV."""
    out = []
    for d in dirs:
        sample = {}
        for name in os.listdir(d):
            with open(os.path.join(d, name), "rb") as f:
                sample["csv" if name.endswith(".csv") else name] = f.read()
        cfg = yaml.safe_load(sample["config.yml"])
        del cfg["output"]["directory"]
        sample["config.yml"] = cfg
        out.append(sample)
    return sorted(out, key=lambda s: s["csv"])


def test_generator_cli_over_two_processes_writes_the_one_process_files(
        tmp_path):
    def argv(out):
        return ["--config_file", "builtin", "--num_samples", "2",
                "--batch_size", "2", "--seed", "4", "--device", "cpu",
                "--output.directory", str(out),
                "--output.image_scale_factor", "76",
                "--output.save_3D_volumes", "npy", "--Greenhouse.modes", MODES]

    outs = mesh_lib.launch(W.generate_cli, 2, argv(tmp_path / "dp"),
                           str(tmp_path), tmp_dir=str(tmp_path),
                           join_timeout=180)
    assert [len(o) for o in outs] == [1, 1]
    alone = W.generate_cli(argv(tmp_path / "one"), str(tmp_path))
    assert len(os.listdir(tmp_path / "dp")) == 2
    ours, theirs = _files(outs[0] + outs[1]), _files(alone)
    assert [sorted(s) for s in ours] == [sorted(s) for s in theirs]
    assert {"csv", "config.yml", "art_ven_img_gray.png",
            "art_ven_img_gray.npy"} <= set(ours[0])
    for a, b in zip(ours, theirs):
        assert a == b
