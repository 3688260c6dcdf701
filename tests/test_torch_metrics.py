"""Port parity: skeletonization, clDice, the scores, the metrics manager and
binary morphology.

The JAX functions of ``octa_tpu.ops.skeleton``, ``octa_tpu.utils.metrics``
and ``octa_tpu.ops.morphology`` and their ports in ``octa_tpu_torch`` run on
the same seeded numpy inputs on the CPU. Discrete results (skeletons,
labels, masks) must be equal; scores agree within 1e-6.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy import ndimage as ndi

from octa_tpu.ops import morphology as jm
from octa_tpu.ops import skeleton as jsk
from octa_tpu.utils import metrics as jmet
from octa_tpu.utils.enums import Phase as JPhase
from octa_tpu_torch import pipeline as tp
from octa_tpu_torch.ops import morphology as tm
from octa_tpu_torch.ops import raster
from octa_tpu_torch.ops import skeleton as tsk
from octa_tpu_torch.utils import metrics as tmet
from octa_tpu_torch.utils.enums import Phase, Task


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this file: where test processes share the
    cores (pytest-xdist), torch's parallel regions wait on threads that are
    not running, and the plain K1 splat of a fixture graph at 128² took 123
    s instead of 2.5 s on eight threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _warm_sqrt():
    torch.sqrt(torch.rand(1 << 20))


def _blobs(rng, shape=(64, 64), p=0.45, sigma=2.0):
    return ndi.gaussian_filter(rng.random(shape), sigma) > np.quantile(
        ndi.gaussian_filter(rng.random(shape), sigma), p)


@pytest.fixture(scope="module")
def fixture_splat(tmp_path_factory):
    """A fixture graph's first 4,000 edges splatted at 128² (parents come
    first, so they form trees)."""
    path = tmp_path_factory.mktemp("graph") / "g.csv"
    with open(raster.fixture_graph_paths()[0]) as f:
        path.write_text("".join(f.readlines()[:4001]))
    graph = raster.parse_graph_csv(str(path))
    img, _ = raster.rasterize_forest(graph, [128, 128], device="cpu")
    return img / 255.0


def test_enums_index_yaml_sections():
    cfg = {"Train": 1, "Validation": 2}
    assert cfg[Phase.TRAIN] == 1 and Phase.VALIDATION in cfg
    assert Phase.TEST == "Test" and str(Task.VESSEL_SEGMENTATION) == "ves-seg"
    assert [p.value for p in Phase] == [p.value for p in JPhase]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_skeletonize_bit_equal_on_blobs(seed):
    mask = _blobs(np.random.default_rng(seed), (72, 64))
    ref = np.asarray(jsk.skeletonize(jnp.asarray(mask)))
    out = tsk.skeletonize(torch.from_numpy(mask)).numpy()
    assert out.dtype == np.uint8 and ref.sum() > 0
    np.testing.assert_array_equal(out, ref)


def test_skeletonize_bit_equal_on_a_vessel_splat(fixture_splat):
    mask = fixture_splat > 0.1
    ref = np.asarray(jsk.skeletonize(jnp.asarray(mask)))
    np.testing.assert_array_equal(tsk.skeletonize(torch.from_numpy(mask)).numpy(),
                                  ref)


def test_cl_dice_and_soft_skeleton_match(rng, fixture_splat):
    lab = fixture_splat > 0.1
    pred = lab ^ (rng.random(lab.shape) < 0.05)
    ref = float(jsk.cl_dice(jnp.asarray(pred), jnp.asarray(lab)))
    out = float(tsk.cl_dice(torch.from_numpy(pred), torch.from_numpy(lab)))
    assert abs(out - ref) <= 1e-6 and 0.3 < ref < 1
    soft = rng.random((2, 40, 48)).astype(np.float32)
    np.testing.assert_allclose(
        tsk.soft_skeletonize(torch.from_numpy(soft), 5).numpy(),
        np.asarray(jsk.soft_skeletonize(jnp.asarray(soft), 5)), atol=1e-6)
    for fn in ("soft_erode", "soft_dilate", "soft_open"):
        np.testing.assert_array_equal(
            getattr(tsk, fn)(torch.from_numpy(soft)).numpy(),
            np.asarray(getattr(jsk, fn)(jnp.asarray(soft))))
    # a volume goes through skeletonize_3d (held to JAX in
    # test_torch_skeleton3d.py)
    assert float(tsk.cl_dice(torch.ones(2, 4, 4), torch.ones(2, 4, 4))) == 1.0


@pytest.mark.parametrize("name", ["dice_score", "iou_score", "accuracy_score",
                                  "recall_score", "precision_score",
                                  "roc_auc_score"])
def test_scores_match(rng, name):
    lab = _blobs(rng, (50, 60))
    prob = np.clip(lab * 0.6 + rng.random(lab.shape) * 0.5, 0, 1).astype(np.float32)
    prob[:5, :5] = 0.25  # ties for the ranks
    pred = prob > 0.5
    arg = prob if name == "roc_auc_score" else pred
    ref = getattr(jmet, name)(arg, lab)
    for x in (arg, torch.from_numpy(arg)):
        assert abs(getattr(tmet, name)(x, lab) - ref) <= 1e-6
    empty = np.zeros_like(lab)
    if name != "accuracy_score":
        assert np.isnan(getattr(tmet, name)(empty, empty)) == \
            np.isnan(getattr(jmet, name)(empty, empty))


def test_pipeline_dice_equals_dice_score(rng):
    lab = torch.from_numpy(np.stack([_blobs(rng) for _ in range(3)]))
    pred = lab ^ torch.from_numpy(rng.random(lab.shape) < 0.1)
    per = tp.dice(pred, lab)
    for i in range(3):
        assert float(per[i]) == pytest.approx(tmet.dice_score(pred[i], lab[i]),
                                              abs=1e-7)


@pytest.mark.parametrize("phase", ["Train", "Validation"])
def test_metrics_manager_matches(rng, fixture_splat, phase):
    jmgr = jmet.MetricsManager(phase=JPhase(phase))
    tmgr = tmet.MetricsManager(phase=Phase(phase))
    lab = (fixture_splat > 0.1).astype(np.float32)[None]
    for _ in range(2):
        pred = (lab.astype(bool) ^ (rng.random(lab.shape) < 0.03)).astype(np.float32)
        jmgr([pred], [lab])
        tmgr([torch.from_numpy(pred)], [lab])
    ref, out = jmgr.aggregate_and_reset(phase), tmgr.aggregate_and_reset(phase)
    assert list(out) == list(ref)
    for k in ref:
        assert out[k] == pytest.approx(ref[k], abs=1e-6), k
    assert tmgr.get_comp_metric(Phase(phase)) == jmgr.get_comp_metric(JPhase(phase))
    assert tmgr.aggregate_and_reset(phase)[f"{phase}_DSC"] == 0.0


def test_is_zstack():
    for out_ch, task in ((1, "ves-seg"), (44, "ves-seg"), (44, "gan-ves-seg")):
        cfg = {"General": {"task": task, "model": {"out_channels": out_ch}}}
        assert tmet._is_zstack(cfg) == jmet._is_zstack(cfg)


@pytest.mark.parametrize("connectivity", [1, 2])
def test_morphology_matches(rng, connectivity):
    mask = _blobs(rng, (48, 56), p=0.6, sigma=1.5)
    t = torch.from_numpy(mask)
    np.testing.assert_array_equal(
        tm.binary_dilation(t[None], 2, connectivity).numpy(),
        np.asarray(jm.binary_dilation(jnp.asarray(mask)[None], 2, connectivity)))
    for fn, args in (("remove_small_objects", (20, connectivity)),
                     ("keep_largest_connected_component", (connectivity,))):
        np.testing.assert_array_equal(getattr(tm, fn)(mask.astype(np.uint8), *args),
                                      getattr(jm, fn)(mask.astype(np.uint8), *args))
    lab_t = tm.connected_components_device(t, connectivity).numpy()
    lab_j = np.asarray(jm.connected_components_device(jnp.asarray(mask),
                                                      connectivity))
    np.testing.assert_array_equal(lab_t, lab_j)
    # the same partition as scipy's labels
    lab_h, n = tm.label_host(mask, connectivity)
    pairs = {(a, b) for a, b in zip(lab_t.ravel(), lab_h.ravel())}
    assert len(pairs) == n + 1 and len({a for a, _ in pairs}) == n + 1
    np.testing.assert_array_equal(
        tm.remove_small_objects_device(t.float(), 20, connectivity).numpy(),
        np.asarray(jm.remove_small_objects_device(jnp.asarray(mask, jnp.float32),
                                                  20, connectivity)))
