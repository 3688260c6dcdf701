"""Port parity for DCLGAN: one step (the fakes with the background
composite, the two ``ImagePool``\\ s, the D step, then the G+F step with the
PatchNCE in both directions and the identity losses) against the JAX
package's, the checkpoints across the two packages, ``define_model``'s
dispatch, validation's ``L1_cycle``, and the engine and the ``test`` CLI
on ``configs/config_dclgan.yml``.

The small networks of ``test_torch_cut.py`` (two generators, two
discriminators, two projectors) at 32², batch 2, 128 patches, with the JAX
package's initial parameters carried into the port and the background,
``u`` and patch ids injected into both (the pools make the same choices
from the same seeds). Tolerances as there: against the JAX package's
float64 step, losses 1e-12, gradients and parameters 1e-6 in float64, and
1e-5 / 1e-4 / 1e-5 in float32 (zero-start tensors at the gradients' 1e-4),
but for a gradient tensor that float32 cannot give within 1e-4: the JAX
package's own float32 step is the yardstick there: where it is half that
tolerance off its float64 step or more, the port's float32 is held to 5
times its distance. (The generators'
``conv_out`` biases, one sum over every pixel of six passes each, read
1.03e-4 and 9.4e-5 in JAX's float32 and 2.8e-4 and 1.4e-4 in the port's;
every other tensor is within 2e-5 in both.)
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octa_tpu_torch.train import algorithms as talg
from octa_tpu_torch.train import gan_algorithms as tgal
from octa_tpu_torch.utils import losses as tl
from octa_tpu_torch.utils.config import load_config
from octa_tpu_torch.utils.enums import Phase
from tests.test_torch_cut import (
    BATCH,
    RES,
    ROOT,
    SMALL_D,
    SMALL_F,
    SMALL_G,
    Args,
    assert_step_matches,
    checkpoints_cross_packages,
    engine_round_trip,
    gradients,
    jax_float64,
    jax_param_counts,
    jax_trainer,
    nchw,
    nhwc,
    patch_ids,
    port_trainer,
    rel_l2,
    small_config,
    small_engine_config,
    zero_gradient,
)

DCL_LOSSES = ("G", "G_A", "G_B", "NCE1", "NCE2", "idt_A", "idt_B", "D_A",
              "D_B")
NETS = ("netG_A", "netG_B", "netD_A", "netD_B", "netF1", "netF2")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this file (see ``test_torch_cut.py``)."""
    torch.sqrt(torch.rand(1 << 20))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dcl_config():
    cfg = small_config("DCLGAN", netG_A_config=dict(SMALL_G),
                       netG_B_config=dict(SMALL_G), netD_A_config=dict(SMALL_D),
                       netD_B_config=dict(SMALL_D), netF1_config=dict(SMALL_F),
                       netF2_config=dict(SMALL_F), lambda_A=10, lambda_B=10,
                       lambda_idt=0.5, lambda_NCE=2.0, lambda_GAN=1.0,
                       pool_size=50)
    cfg["General"]["inference"] = "netG_A"
    return cfg


def jax_dclgan_step(j, real_A, real_B, background, u, ids1, ids2):
    """The JAX package's ``perform_training_step`` with the draws given:
    the fakes (jitted here), its pools, its D step, its G+F step. Returns
    the losses and the images ``fake_B``, ``fake_A``, ``rec_A``,
    ``idt_A``."""
    real_A, real_B, background, u = (nhwc(x) for x in (real_A, real_B,
                                                         background, u))
    fakes = jax.jit(lambda p, a, b, bg, u: (
        j._apply("netG_A", p["netG_A"], jnp.maximum(a, bg * u)),
        j._apply("netG_B", p["netG_B"], b)))
    fake_B, fake_A = fakes(j.params, real_A, real_B, background, u)
    pooled_B = jnp.asarray(j.fake_B_pool.query(np.asarray(fake_B)))
    pooled_A = jnp.asarray(j.fake_A_pool.query(np.asarray(fake_A)))
    pd, j.opt_state["optimizer_D"], dA, dB = j._d_step(
        j.params, j.opt_state["optimizer_D"], real_A, real_B, pooled_A,
        pooled_B)
    j.params.update(pd)
    pg, pf, j.opt_state["optimizer_G"], j.opt_state["optimizer_F"], aux = \
        j._g_step(j.params, j.opt_state["optimizer_G"],
                  j.opt_state["optimizer_F"], real_A, real_B, background, u,
                  [jnp.asarray(i) for i in ids1],
                  [jnp.asarray(i) for i in ids2])
    j.params.update(pg)
    j.params.update(pf)
    *images, losses = aux
    out = {k: float(v) for k, v in losses.items()}
    out.update(D_A=float(dA), D_B=float(dB))
    return out, [nchw(x) for x in images]


@pytest.fixture(scope="module")
def dcl_stepped():
    """The JAX DCLGAN trainer in float64 and the port's in float64 and
    float32, from the same parameters and draws, each after one step."""
    rng = np.random.default_rng(41)
    cfg = dcl_config()
    inputs = [rng.random((BATCH, 1, RES, RES)).astype(np.float32)
              for _ in range(4)]
    init_batch = {"real_A": inputs[0]}
    j32 = jax_trainer(cfg, init_batch)
    start = jax.tree.map(np.asarray, j32.params)
    ids1, ids2 = (patch_ids(rng, j32.feat_sizes) for _ in range(2))
    # the JAX package's own float32 step, on a copy of its state and pools
    j_f32 = copy.copy(j32)
    j_f32.params, j_f32.opt_state = dict(j32.params), dict(j32.opt_state)
    j_f32.fake_A_pool, j_f32.fake_B_pool = (
        copy.deepcopy(p) for p in (j32.fake_A_pool, j32.fake_B_pool))
    jax_dclgan_step(j_f32, *inputs, ids1, ids2)
    ports = {}
    for dtype in (torch.float64, torch.float32):
        t = port_trainer(cfg, start, dtype, init_batch,
                         heads=("netF1", "netF2"))
        assert list(t.networks) == list(NETS)
        images, losses = t.train_step(
            *(torch.from_numpy(x).to(dtype) for x in inputs),
            [torch.from_numpy(i) for i in ids1],
            [torch.from_numpy(i) for i in ids2])
        ports[dtype] = (t, images, {k: float(v) for k, v in losses.items()})
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "float32", jnp.float64)
        j = jax_float64(j32, cfg, start)
        lj, images = jax_dclgan_step(
            j, *(x.astype(np.float64) for x in inputs), ids1, ids2)
        j.params = jax.tree.map(np.asarray, j.params)
        j.opt_state = jax.tree.map(np.asarray, j.opt_state)
    # the JAX float32 step's own distance from its float64 step, per
    # gradient tensor that has a gradient
    own = {}
    for opt_name in j.optimizer_mapping:
        g32, g64 = (gradients(x, opt_name, start) for x in (j_f32, j))
        own.update({(n, k): rel_l2(g32[n][k], g64[n][k])
                    for n in g64 for k in g64[n]
                    if zero_gradient(n, k) is None})
    return j, lj, images, ports, start, own


@pytest.mark.parametrize("dtype,grad_tol,param_tol,loss_tol", [
    (torch.float64, 1e-6, 1e-6, 1e-12), (torch.float32, 1e-4, 1e-5, 1e-5)])
def test_dclgan_step_matches_jax_float64(dcl_stepped, dtype, grad_tol,
                                         param_tol, loss_tol):
    """The port's step in float64 and float32 against the JAX package's
    float64 step: the nine losses, the four images, and every gradient and
    updated parameter of the three optimizers (each over two networks)."""
    j, lj, images, ports, start, own = dcl_stepped
    t, got_images, lt = ports[dtype]
    assert list(lt) == list(DCL_LOSSES) and set(lj) == set(DCL_LOSSES)
    for k in DCL_LOSSES:
        assert lt[k] == pytest.approx(lj[k], rel=loss_tol), k
    assert min(lt["NCE1"], lt["NCE2"], lt["idt_A"], lt["idt_B"]) > 0
    assert len(got_images) == len(images) == 4
    for a, b in zip(got_images, images):
        np.testing.assert_allclose(a.double().numpy(), b, atol=1e-5)
    # where JAX's own float32 is half the tolerance off or more
    tols = ({k: 5 * v for k, v in own.items() if v >= grad_tol / 2}
            if dtype == torch.float32 else None)
    assert set(tols or {}) <= {(n, ("conv_out", "bias"))
                               for n in ("netG_A", "netG_B")}
    assert_step_matches(t, j, start, dtype, grad_tol, param_tol,
                        grad_tols=tols)
    # the pools hold the same fakes
    for pool in ("fake_A_pool", "fake_B_pool"):
        ours, ref = getattr(t, pool), getattr(j, pool)
        assert len(ours.images) == len(ref.images) == BATCH


def test_dclgan_checkpoints_cross_packages(dcl_stepped, tmp_path):
    """The six networks and the three optimizers, both ways."""
    j, _, _, ports, _, _ = dcl_stepped
    checkpoints_cross_packages(copy.deepcopy(ports[torch.float32][0]), j,
                               tmp_path)


def test_define_model_dispatches_dclgan():
    """``configs/config_dclgan.yml`` builds ``DCLGAN`` with its settings;
    after the initialisation at 64² the six networks have JAX's parameter
    counts; ``test`` builds ``netG_A`` alone."""
    cfg = load_config(os.path.join(ROOT, "configs", "config_dclgan.yml"))
    t = talg.define_model(cfg, Phase.TRAIN, "cpu")
    assert isinstance(t, tgal.DCLGANAlgorithm)
    assert (t.lambda_A, t.lambda_B, t.lambda_idt, t.lambda_NCE) == (10, 10,
                                                                  0.5, 2)
    assert t.fake_A_pool.pool_size == t.fake_B_pool.pool_size == 50
    t.initialize_model_and_optimizer({"real_A": torch.zeros(1, 1, 64, 64)},
                                     cfg, Args())
    assert list(t.networks) == list(NETS)
    assert isinstance(t.criterionNCE, tl.PatchNCELoss)
    assert t.num_parameters() == jax_param_counts(
        cfg, 64, {"netF1": "taps", "netF2": "taps"}, "netG_A")
    assert list(talg.define_model(cfg, Phase.TEST, "cpu").networks) == [
        "netG_A"]


def test_engine_trains_dclgan_resumes_and_translates(tmp_path):
    """One epoch through the engine, a resume and ``test`` with
    ``netG_A``; validation's cycle loss is ``L1_cycle``."""
    cfg = small_engine_config(
        tmp_path, "config_dclgan.yml",
        {"netG_A_config": dict(SMALL_G), "netG_B_config": dict(SMALL_G),
         "netD_A_config": dict(SMALL_D), "netD_B_config": dict(SMALL_D),
         "netF1_config": dict(SMALL_F), "netF2_config": dict(SMALL_F),
         "num_patches": 32})
    engine_round_trip(tmp_path, cfg, DCL_LOSSES, NETS[:4] + ("netF1", "netF2"),
                      ("optimizer_G", "optimizer_D", "optimizer_F"), "netG_A")
    snap_dir = os.path.join(str(tmp_path / "runs"))
    run = os.path.join(snap_dir, sorted(os.listdir(snap_dir))[0])
    snap = load_config(os.path.join(run, "config.yml"))
    val = talg.define_model(snap, Phase.VALIDATION, "cpu")
    val.initialize_model_and_optimizer(None, snap, Args(),
                                       phase=Phase.VALIDATION)
    x = torch.rand(1, 1, RES, RES, generator=torch.Generator().manual_seed(0))
    outputs, losses = val.inference({"image": x, "label": x}, {},
                                    phase=Phase.VALIDATION)
    assert list(losses) == ["L1_cycle"] and float(losses["L1_cycle"]) > 0
    assert outputs["prediction"][0].shape == (1, RES, RES)
