"""K6, the blocked greedy spacing: its dispatch, checks and launch plan on the
CPU, and the kernel's algorithm (rounds that test later candidates against
each round's new acceptances only) written out in numpy against the plain
version. The kernel itself runs on the card only (``chip_smoke.py k6``)."""
import numpy as np
import pytest
import torch

from octa_tpu_torch.ops import spacing
from octa_tpu_torch.sim import greenhouse as tg

# a growth small enough for the CPU: one mode of four iterations
CONFIG = {
    "SimulationSpace": {"no_voxel_x": 1, "no_voxel_y": 1,
                        "no_voxel_z": 0.0131},
    "d": 0.1, "r": 0.0025, "FAZ_radius_bound": [0.44, 0.04],
    "rotation_radius": 1.05, "FAZ_center": [0.5, 0.5], "param_scale": 3,
    "modes": [
        {"name": "SVC", "I": 4, "N": 200, "eps_n": 0.18, "eps_s": 0.135,
         "eps_k": 0.135, "delta_art": 0.2925, "delta_ven": 0.2925,
         "gamma_art": 50, "gamma_ven": 50, "phi": 15, "omega": 0.3,
         "kappa": 2.55, "delta_sigma": 0.02},
    ],
}
FOREST = {"type": "stumps", "N_trees": 4,
          "source_walls": {"x0": True, "x1": True, "y0": True, "y1": True,
                           "z0": False, "z1": False}}


def _inputs(r, n, seed, eps=(0.02, 0.06)):
    rng = np.random.default_rng(seed)
    pos = (rng.random((r, n, 3)) * [1, 1, 0.01]).astype(np.float32)
    valid = rng.random((r, n)) < 0.8
    dup = rng.permutation(n)[: n // 10]
    pos[:, dup] = pos[:, rng.permutation(n)[: len(dup)]]  # exact duplicates
    return pos, valid, rng.uniform(*eps, r).astype(np.float32)


def _close(a, b, eps):
    d = (a - b).astype(np.float32)
    return np.sqrt((d * d).sum(-1)) <= eps


def _rounds(pos, valid, eps, n_blocks=64):
    """The kernel's algorithm for one row, in numpy float32 (its sums over
    the three axes in numpy's order, as the plain version's on the CPU; on
    the card both take the card's order, ``chip_smoke.py k6``)."""
    n = len(valid)
    bs = -(-n // n_blocks)
    ok = valid.copy()
    for k in range(n):  # phase 1: earlier valid candidates of k's block
        j = np.arange((k // bs) * bs, k)
        j = j[valid[j]]
        if ok[k] and _close(pos[k], pos[j], eps).any():
            ok[k] = False
    out = np.zeros(n, bool)
    for i in range(n_blocks):
        b0, b1 = i * bs, min((i + 1) * bs, n)
        if b0 >= n:
            break
        out[b0:b1] = ok[b0:b1]
        new = pos[b0:b1][ok[b0:b1]]
        for k in range(b1, n):  # later candidates against the new entries
            if ok[k] and len(new) and _close(pos[k], new, eps).any():
                ok[k] = False
    return out


@pytest.mark.parametrize("n", [1, 63, 64, 65, 300, 2000])
def test_kernel_algorithm_matches_plain(n):
    pos, valid, eps = _inputs(3, n, seed=n)
    valid[1] = False  # a row with no valid candidate
    got = np.stack([_rounds(pos[r], valid[r], eps[r]) for r in range(3)])
    want = spacing.spacing_plain(torch.from_numpy(pos), torch.from_numpy(valid),
                                 torch.from_numpy(eps)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[1].any()
    if n >= 300:  # the spacing rejects valid candidates
        assert 0 < got.sum() < valid.sum()


def test_cpu_tensors_take_the_plain_path():
    pos, valid, eps = _inputs(2, 500, seed=1)
    args = (torch.from_numpy(pos), torch.from_numpy(valid),
            torch.from_numpy(eps))
    before = spacing.SPACING.launches
    out = tg._blocked_greedy_spacing(*args)
    assert tg._blocked_greedy_spacing is spacing.blocked_greedy_spacing
    assert torch.equal(out, spacing.spacing_plain(*args))
    # one row without the batch axis, and a scalar eps
    one = spacing.blocked_greedy_spacing(args[0][0], args[1][0], 0.04)
    assert torch.equal(one, spacing.spacing_plain(args[0][:1], args[1][:1],
                                                  0.04)[0])
    assert spacing.SPACING.launches == before  # the CPU never counts a launch


@pytest.mark.parametrize("pos,valid,match", [
    (torch.zeros(2, 5, 2), torch.zeros(2, 5, dtype=torch.bool), "expected pos"),
    (torch.zeros(2, 5, 3), torch.zeros(2, 4, dtype=torch.bool), "expected pos"),
    (torch.zeros(5), torch.zeros(5, dtype=torch.bool), "expected pos"),
    (torch.zeros(2, 5, 3, dtype=torch.float64),
     torch.zeros(2, 5, dtype=torch.bool), "float32"),
    (torch.zeros(2, 5, 3), torch.zeros(2, 5, dtype=torch.uint8), "float32"),
])
def test_wrapper_rejects_bad_inputs(pos, valid, match):
    with pytest.raises(ValueError, match=match):
        spacing.blocked_greedy_spacing(pos, valid, 0.1)


@pytest.mark.parametrize("n,threads,smem,staged", [
    (1, 32, 8 + 24 * 4 + 1 + 12, True),
    (63, 64, 8 + 24 * 4 + 63 * 13, True),
    (65, 96, 8 + 24 * 4 + 65 * 13, True),
    (2000, 1024, 8 + 24 * 32 + 2000 * 13, True),     # the growth's rows
    (2048, 1024, 8 + 24 * 32 + 2048 * 13, True),
    (17000, 1024, 8 + 24 * 268 + 17000 * 13, True),
    (17500, 1024, 8 + 24 * 276 + 17500, False),     # through L1 / L2
    (20000, 1024, 8 + 24 * 316 + 20000, False),
])
def test_launch_plan_by_n(n, threads, smem, staged):
    assert spacing.spacing_plan(n) == (threads, smem, staged)
    assert smem <= spacing.MAX_SHARED and threads % 32 == 0


def test_launch_plan_refuses_rows_beyond_shared_memory():
    assert spacing.spacing_plan(160_000)[1] <= spacing.MAX_SHARED
    with pytest.raises(ValueError, match="shared memory"):
        spacing.spacing_plan(200_000)


def test_stage_counts_carry_spacing_launches():
    g = tg.Greenhouse(CONFIG, node_capacity=512, sink_capacity=1024, seed=2,
                      device="cpu")
    g.develop_forest(FOREST, batch=2, final_murray_sweeps=2)
    counts = g.stage_counts()
    assert counts["iterations"] == 4
    assert counts["spacing_launches"] == g.spacing_launches == 0
