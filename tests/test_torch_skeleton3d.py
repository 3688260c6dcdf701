"""Port parity for the volumetric skeleton: ``skeletonize_3d``, the 3D branch
of ``cl_dice`` and ``MetricsManager(volumetric=True)``.

The port's ``skeletonize_3d`` is held bit for bit to the JAX package's and to
the independent numpy oracle of ``tests/test_skeleton3d.py``, at several
slab sizes, on seeded volumes: boxes and tubes, random blobs, random noise,
and labels voxelized from the fixture graphs by K4's plain path (the port's
``voxelize_forest`` on the CPU) thresholded at 0.1 as the 3D-reconstruction
loader does, with their one-voxel dilations. The volumetric clDice and the
metrics manager's ClDice agree with the JAX package's within 1e-6. The JAX
function compiles once per shape and slab (about 20 s each on a CPU), so it
runs at two shapes and its default slab.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.ndimage import binary_dilation

from octa_tpu.ops import skeleton as jsk
from octa_tpu.utils import metrics as jm
from octa_tpu.utils.enums import Phase as JPhase
from octa_tpu_torch.ops import raster
from octa_tpu_torch.ops import skeleton as tsk
from octa_tpu_torch.utils import metrics as tm
from octa_tpu_torch.utils.enums import Phase
from tests.test_skeleton3d import skeletonize_3d_oracle

LABEL_SHAPE = (48, 48, 12)  # (x, y, z) of the voxelizer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this file: under the test run's several worker
    processes, torch's parallel regions wait on threads that are not
    running."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _boxes():
    rng = np.random.default_rng(0)
    tube = np.zeros((7, 9, 24), bool)
    tube[2:5, 3:6, 2:22] = True
    bent = np.zeros((7, 20, 20), bool)
    bent[2:5, 3:6, 2:17] = True
    bent[2:5, 3:17, 14:17] = True
    blob = np.zeros((10, 16, 16), bool)
    for _ in range(6):  # union of random small boxes (cavities, branches)
        z, y, x = rng.integers(0, 6), rng.integers(0, 10), rng.integers(0, 10)
        blob[z:z + rng.integers(2, 5), y:y + rng.integers(2, 7),
             x:x + rng.integers(2, 7)] = True
    noise = np.random.default_rng(1).random((6, 12, 13)) < 0.5
    return {"tube": tube, "bent": bent, "blob": blob, "noise": noise}


@pytest.fixture(scope="module")
def labels():
    """[Z, H, W] labels from the first two fixture graphs at (48, 48, 12),
    and their one-voxel dilations."""
    out = {}
    for i, path in enumerate(raster.fixture_graph_paths()[:2]):
        vol, _ = raster.voxelize_forest(raster.parse_graph_csv(path),
                                        list(LABEL_SHAPE), device="cpu")
        lab = np.transpose(vol, (2, 0, 1)) > 0.1 * 255
        out[f"graph{i}"] = lab
        out[f"graph{i}_dilated"] = binary_dilation(lab, iterations=1)
    return out


def _ours(v, slab=None) -> np.ndarray:
    out = tsk.skeletonize_3d(torch.from_numpy(np.ascontiguousarray(v)),
                             slab=slab)
    assert out.dtype == torch.uint8 and tuple(out.shape) == v.shape
    return out.numpy()


@pytest.mark.parametrize("name", ["tube", "bent", "blob", "noise"])
def test_skeleton3d_matches_oracle_at_every_slab(name):
    v = _boxes()[name]
    ref = skeletonize_3d_oracle(v)
    for slab in (None, 1, 2, 3, v.shape[0]):
        np.testing.assert_array_equal(_ours(v, slab), ref, err_msg=str(slab))
    assert 0 < ref.sum() < v.sum()


@pytest.mark.parametrize("name", ["graph0", "graph0_dilated", "graph1",
                                  "graph1_dilated"])
def test_skeleton3d_of_labels_matches_oracle(labels, name):
    v = labels[name]
    ref = skeletonize_3d_oracle(v)
    assert 0 < ref.sum() < v.sum()
    for slab in (None, 1, 5):
        np.testing.assert_array_equal(_ours(v, slab), ref, err_msg=str(slab))


@pytest.mark.parametrize("name", ["blob", "graph0", "graph0_dilated"])
def test_skeleton3d_matches_jax(labels, name):
    """The JAX function at two shapes ([10, 16, 16] and [12, 48, 48]), on
    float32 volumes as ``cl_dice`` passes them (one compile a shape)."""
    v = {**_boxes(), **labels}[name]
    ref = np.asarray(jsk.skeletonize_3d(jnp.asarray(v, jnp.float32)))
    np.testing.assert_array_equal(_ours(v), ref)
    np.testing.assert_array_equal(_ours(v, 2), ref)


def test_deletable_codes_are_the_simple_point_test():
    """The code test (the card reads it from a table of every code) against
    the JAX package's per-voxel test (``_deletable``) on the centres of
    random 3x3x3 blocks of every density."""
    rng = np.random.default_rng(3)
    blocks = rng.random((4096, 3, 3, 3)) < rng.random((4096, 1, 1, 1))
    blocks[:, 1, 1, 1] = True
    # one [3, 3, 3 * 4096] volume of the blocks side by side: each block's
    # centre sees only its own block (x-stride 3 keeps them apart)
    vol = np.concatenate(list(blocks), axis=2)
    ref = np.asarray(jsk._deletable(jnp.asarray(vol)))[1, 1, 1::3]
    flat = blocks.reshape(4096, 27)
    code = np.delete(flat, 13, axis=1).astype(np.int64) @ (1 << np.arange(26))
    got = tsk.deletable_codes(torch.from_numpy(code)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0.1 < got.mean() < 0.9


def test_volumetric_cl_dice_and_metrics_match_jax(labels):
    lab = labels["graph0"].astype(np.float32)
    pred = labels["graph0_dilated"].astype(np.float32)
    ours = float(tsk.cl_dice(torch.from_numpy(pred), torch.from_numpy(lab)))
    ref = float(jsk.cl_dice(jnp.asarray(pred), jnp.asarray(lab)))
    assert abs(ours - ref) <= 1e-6 and 0 < ref < 1
    assert float(tsk.cl_dice(torch.from_numpy(lab), torch.from_numpy(lab))) == 1.0
    # host arrays, as the post-processing hands them over, thinned on the
    # manager's device
    got = tm.MetricsManager(phase=Phase.VALIDATION, volumetric=True,
                            device="cpu")
    want = jm.MetricsManager(phase=JPhase.VALIDATION, volumetric=True)
    got([pred], [lab])
    want([pred], [lab])
    a = got.aggregate_and_reset("Validation")
    b = want.aggregate_and_reset("Validation")
    assert a.keys() == b.keys()
    for k in b:
        assert abs(a[k] - b[k]) <= 1e-6, k
    assert a["Validation_ClDice"] == pytest.approx(ours, abs=1e-7)
    # a z-stack is scored whole, not per channel
    assert len(got.metrics["ClDice"].scores) == 0
    got([torch.from_numpy(pred)], [torch.from_numpy(lab)])
    assert len(got.metrics["ClDice"].scores) == 1
    assert len(got.metrics["DSC"].scores) == lab.shape[0]
