"""Data-parallel training in the port: the trainers over two CPU processes
(gloo, spawned by ``parallel.mesh.launch``) against the JAX package's
sharded step and against the port's own step in one process.

- The segmentation trainer (S) with ``DiceBCELoss`` and with
  ``ClDiceLoss`` (its soft clDice's sums over the global batch), two
  float64 steps at batch 2 over two ranks, against the JAX package's
  ``SegAlgorithm`` under its own mesh (conftest's eight virtual CPU
  devices: JAX's divisor rule takes two of them for batch 2) from the same
  parameters: every parameter within 1e-6 relative L2 and the losses
  within 1e-9 relative.
- One float64 step of GAN-seg, S_AA (ANT's draws for the global batch, its
  ascent scaled by B_local / B_global), CycleGAN and DCLGAN with pools of
  one image (one step of a batch of two replays one), CUT, NEGCUT (noise
  drawn for the global batch), NICE-GAN, and of S with ``WeightedMSELoss``,
  S_AA with ``ClDiceLoss`` and GAN-seg with ``loss_s: ClDiceLoss`` (losses
  that are ratios of sums over the batch) over two ranks against the same
  step in one process: losses within 1e-10 relative, every gradient a step
  took within 1e-10 of its tensor's norm (floored at 1e-6 of the network's
  gradient norm: a conv bias that an instance norm follows has none in
  exact arithmetic), every parameter and buffer within 1e-10 (such a bias
  moves by Adam's ``lr g / (|g| + eps)`` of a rounding-noise ``g``: 3e-11
  at most), and the two ranks' parameters and buffers (NEGCUT's EMA
  mirror, NICE-GAN's spectral-norm ``u``) equal bit for bit.
- The weighted ``CrossEntropyLoss``, ``CosineEmbeddingLoss`` and
  ``QWKLoss`` (class scores last, which the JAX package's trainers cannot
  train with: ``tests/test_torch_train.py``) on two ranks' rows of [N, C]
  scores against one process: the value, and the gradient (a rank's is the
  mesh's size times its share of the global one) within 1e-10. A batch of
  three rows on a mesh of two and a mesh of one run no loss collective.
- ``python -m octa_tpu_torch.train`` over two ranks: one run directory,
  written by the first rank, whose checkpoint after two float32 steps is
  the one-process run's within 1e-4 (read 2.7e-5: the two sum a batch's
  gradient in different orders, and Adam's second step carries that to a
  few small-gradient elements).

The batches are float64 where the steps are (a spectral-norm layer computes
in its input's dtype). Every rank runs one torch thread, every collective
fails after 60 s and every launch after its join timeout.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octa_tpu.io import checkpoints as jck
from octa_tpu.train import algorithms as jalg
from octa_tpu.utils.enums import Phase as JPhase
from octa_tpu_torch.parallel import mesh as mesh_lib
from octa_tpu_torch.tools.seg_data import make_seg_dataset, point_config_at
from octa_tpu_torch.utils.config import load_config
from tests import torch_mesh_workers as W

CONFIG = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs",
                      "config_ves_seg-S.yml")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.sqrt(torch.rand(1 << 20))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v, np.float64)
    return out


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _jax_seg_float64(cfg, batches, start):
    """The JAX package's segmentation trainer in float64 from ``start``,
    stepped on ``batches``: its jitted step traced with 64-bit types and
    ``jnp.float32`` standing for float64
    (``tests/test_torch_gan_seg.py::_jax_step_float64``), its parameters
    replicated and each batch sharded over its mesh."""
    j = jalg.define_model(cfg, JPhase.TRAIN)
    j.initialize_model_and_optimizer(batches[0], cfg, W.Args(),
                                     phase=JPhase.TRAIN)
    to64 = lambda tree: jax.tree.map(
        lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype.kind == "f"
        else a, tree)
    losses = []
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "float32", jnp.float64)
        j.dtype = jnp.float64
        j.net = j.net.clone(dtype=jnp.float64)
        j.params = {"model": to64(start)}
        j.mutables = to64(j.mutables)
        j._init_optimizers(cfg)
        assert j.mesh is not None and j.mesh.size == 2
        j._build_steps()
        for b in batches:
            _, lj = j.perform_training_step(to64(dict(b)), {})
            losses.append(float(lj[j.loss_name]))
        params = jax.tree.map(np.asarray, j.params["model"])
    return params, losses


@pytest.mark.parametrize("loss", ["DiceBCELoss", "ClDiceLoss"])
def test_s_over_two_ranks_matches_the_jax_mesh_step(tmp_path, loss):
    cfg = W.seg_config()
    cfg["Train"]["loss"] = loss
    rng = np.random.default_rng(5)
    batches = [{"image": rng.random((2, 1, 32, 32)).astype(np.float32),
                "label": (rng.random((2, 1, 32, 32)) < 0.3).astype(np.float32)}
               for _ in range(2)]
    j = jalg.define_model(cfg, JPhase.TRAIN)
    j.initialize_model_and_optimizer(batches[0], cfg, W.Args(),
                                     phase=JPhase.TRAIN)
    start = jax.tree.map(np.asarray, j.params["model"])
    ref, ref_losses = _jax_seg_float64(cfg, batches, start)
    outs = mesh_lib.launch(W.dp_seg_steps, 2, cfg, start, batches,
                           tmp_dir=str(tmp_path), join_timeout=120)
    (p0, l0), (p1, l1) = outs
    assert l0 == l1
    for ours, theirs in zip(l0, ref_losses):
        assert ours == pytest.approx(theirs, rel=1e-9)
    assert all(np.array_equal(p0[k], p1[k]) for k in p0)
    from octa_tpu_torch.io import checkpoints as tck
    from octa_tpu_torch.models.dynunet import DynUNet

    net = DynUNet(**{k: v for k, v in cfg["General"]["model"].items()
                     if k != "name"}).double()
    net.load_state_dict({k: torch.from_numpy(v) for k, v in p0.items()})
    ours = _flat(tck.state_dict_to_flax(net, {k: torch.from_numpy(v)
                                              for k, v in p0.items()}))
    theirs = _flat(ref)
    assert ours.keys() == theirs.keys()
    for k in theirs:
        assert _rel_l2(ours[k], theirs[k]) <= 1e-6, k


@pytest.fixture(scope="module")
def dp_steps(tmp_path_factory):
    """One float64 step of every trainer of ``W.TRAINERS`` over two ranks,
    each rank's state after it."""
    return mesh_lib.launch(W.dp_trainer_steps, 2, W.TRAINERS,
                           tmp_dir=str(tmp_path_factory.mktemp("dp")),
                           join_timeout=240)


@pytest.mark.parametrize("name", W.TRAINERS)
def test_trainer_over_two_ranks_matches_one_process(dp_steps, name):
    a, b = dp_steps[0][name], dp_steps[1][name]
    for kind in ("params", "buffers"):
        assert a[kind].keys() == b[kind].keys()
        for k in a[kind]:
            assert np.array_equal(a[kind][k], b[kind][k]), (kind, k)
    ref = W.trainer_step(name)
    assert a["losses"].keys() == ref["losses"].keys()
    for k, v in ref["losses"].items():
        assert a["losses"][k] == pytest.approx(v, rel=1e-10, abs=1e-300), k
    assert a["grads"].keys() == ref["grads"].keys() and ref["grads"]
    nets = {k.split(".")[0] for k in ref["grads"]}
    net_norm = {n: np.sqrt(sum(float(np.sum(g ** 2)) for k, g in
                               ref["grads"].items() if k.split(".")[0] == n))
                for n in nets}
    for k, g in ref["grads"].items():
        scale = max(np.linalg.norm(g), 1e-6 * net_norm[k.split(".")[0]])
        assert np.linalg.norm(a["grads"][k] - g) <= 1e-10 * scale, k
    for kind in ("params", "buffers"):
        assert a[kind].keys() == ref[kind].keys()
        for k, v in ref[kind].items():
            np.testing.assert_allclose(a[kind][k], v, rtol=0, atol=1e-10,
                                       err_msg=f"{kind} {k}")


def _cli_config(root):
    globs = make_seg_dataset(str(root / "data"), n_graphs=4, n_backgrounds=2,
                             n_val=2, background_res=40, val_res=64,
                             device="cpu", max_edges=120)
    cfg = point_config_at(load_config(CONFIG), globs, str(root / "runs"))
    aug = cfg["Train"]["data_augmentation"]
    aug[1]["image_resolutions"] = [[32, 32], [64, 64]]
    aug[4]["spatial_size"] = [32, 32]
    aug[6]["spatial_size"] = [64, 64]
    cfg["Validation"]["data_augmentation"][4]["spatial_size"] = [64, 64]
    cfg["General"]["model"]["filters"] = [8, 16, 16, 16, 16]
    for post in (cfg["Train"]["post_processing"],
                 cfg["Validation"]["post_processing"]):
        post["prediction"][-1]["min_size"] = 10
    cfg["Train"].update(epochs=1, epochs_decay=0, batch_size=2, lr=1e-3)
    cfg["General"]["amp"] = False  # float32: bf16 rounds at 4e-3
    return cfg


def test_cli_trains_over_two_ranks(tmp_path):
    cfg = _cli_config(tmp_path)
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    argv = ["--config_file", str(path), "--device", "cpu"]
    run0, run1 = mesh_lib.launch(W.train_cli, 2, argv, tmp_dir=str(tmp_path),
                                 join_timeout=180)
    # the other rank wrote nothing: one run directory
    assert os.listdir(tmp_path / "runs") == [os.path.basename(run0)]
    alone = W.train_cli(argv)
    ck = lambda run: _flat(jck.load_checkpoint(os.path.join(
        run, "checkpoints", "latest_model_model.ckpt"))["model"])
    ours, theirs = ck(run0), ck(alone)
    assert ours.keys() == theirs.keys()
    for k in theirs:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=0, atol=1e-4,
                                   err_msg=str(k))
    with open(os.path.join(run0, "metrics.csv")) as f0, \
            open(os.path.join(alone, "metrics.csv")) as f1:
        assert f0.readline() == f1.readline()


#: (registry name, Data.class_balance): two losses that are per-sample means
PER_SAMPLE = [("CrossEntropyLoss", None), ("DiceBCELoss", None)]


@pytest.fixture(scope="module")
def agreement(tmp_path_factory):
    """``W.loss_agreement`` over two ranks (one launch)."""
    return mesh_lib.launch(W.loss_agreement, 2, PER_SAMPLE,
                           tmp_dir=str(tmp_path_factory.mktemp("agree")))


@pytest.mark.parametrize("name,balance", W.CLASS_LOSSES)
def test_class_losses_over_two_ranks_match_one_process(agreement, name,
                                                       balance):
    """Each rank computes the global loss from its rows (one all-reduce of
    its sums), and its rows' gradient is the mesh's size times their share
    of the global gradient, which the mean of the ranks' gradients turns
    back into the global one."""
    ref, gref = W.class_loss(name, balance)
    (v0, g0), (v1, g1) = (a["class"][name] for a in agreement)
    assert v0 == v1
    assert v0 == pytest.approx(ref, rel=1e-10)
    g = np.concatenate([g0, g1]) / 2
    assert np.linalg.norm(g - gref) <= 1e-10 * np.linalg.norm(gref)


@pytest.mark.parametrize("loss,balance", PER_SAMPLE)
def test_per_sample_losses_train_over_two_ranks(agreement, loss, balance):
    assert all(a["per_sample"][loss, balance is not None] is None
               for a in agreement)


@pytest.mark.parametrize("case,calls", [("sharded", 1), ("undivided", 0),
                                        ("mesh-1", 0)])
def test_loss_collectives(agreement, case, calls):
    """A step on rows of the batch runs one loss collective; a batch of
    three rows on a mesh of two (it runs whole on each rank) and a mesh of
    one run none. Every rank's loss is the one-process step's."""
    ref = W.cldice_step_alone(case)
    for a in agreement:
        loss, n = a["collectives"][case]
        assert n == calls
        assert loss == pytest.approx(ref, rel=1e-10)
