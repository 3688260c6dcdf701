"""Port parity for NEGCUT: ``NegativeGenerator`` and one NEGCUT step (D
step, N step, G+F step, the EMA mirror ``netF_``) against the JAX
package's, the G step's gradient through the negatives, the checkpoints
across the two packages, ``define_model``'s dispatch, and the engine and
the ``test`` CLI on ``configs/config_negcut.yml``.

The small networks of ``test_torch_cut.py`` (negative generator width 16,
``z_dim`` 8) at 32², batch 2, 128 patches, with the JAX package's initial
parameters carried into the port and its patch ids and its four noise
draws (``r1``-``r4``, replayed with ``jax.random``) injected. Tolerances as
there: ``NegativeGenerator`` within 1e-5 in float32; the step against the
JAX package's float64 step, losses 1e-12, gradients and parameters 1e-6 in
float64, and 1e-5 / 1e-4 / 1e-5 in float32 (zero-start tensors at the
gradients' 1e-4); ``netF_`` as a parameter.
"""
import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octa_tpu.models import resnet_gan as jgan
from octa_tpu_torch.io import checkpoints as tck
from octa_tpu_torch.models import resnet_gan as tgan
from octa_tpu_torch.train import algorithms as talg
from octa_tpu_torch.train import gan_algorithms as tgal
from octa_tpu_torch.utils import losses as tl
from octa_tpu_torch.utils.config import load_config
from octa_tpu_torch.utils.enums import Phase
from tests.test_torch_cut import (
    BATCH,
    LAYERS,
    PATCHES,
    RES,
    ROOT,
    SMALL_D,
    SMALL_F,
    SMALL_G,
    Args,
    assert_step_matches,
    checkpoints_cross_packages,
    engine_round_trip,
    flat,
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
)

SMALL_N = {"name": "Negative_Generator", "nc": 16, "z_dim": 8}
NEGCUT_LOSSES = ("G", "loss_NCE", "loss_NCE_Y", "D_fake", "D_real", "N")
HEADS = ("netF", "netF_", "netN")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this file (see ``test_torch_cut.py``)."""
    torch.sqrt(torch.rand(1 << 20))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_noise(key, batch, levels, num_patches=PATCHES, z_dim=8):
    """The four noise draws of the JAX NEGCUT step for ``key``: its
    ``r1``-``r4`` split, and per call one ``normal`` a level from a split
    of the running key (``NegativeGenerator``)."""
    out = []
    for r in jax.random.split(key, 4):
        draws = []
        for _ in range(levels):
            r, sub = jax.random.split(r)
            draws.append(np.array(jax.random.normal(
                sub, (batch, num_patches, z_dim))))
        out.append(draws)
    return out


def test_negative_generator_matches_jax():
    """With the JAX package's parameters and its noise injected, the
    negatives equal JAX's within 1e-5, for each level; without ``noise``
    the draws come from the given generator."""
    rng = np.random.default_rng(4)
    shapes = [(BATCH, 38, 38, 16), (BATCH, 32, 32, 16), (BATCH, 8, 8, 16)]
    pools = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jn = jgan.NegativeGenerator(nc=16, z_dim=8)
    key = jax.random.PRNGKey(6)
    params = jn.init(jax.random.PRNGKey(2), [jnp.asarray(p) for p in pools],
                     PATCHES, key)["params"]
    ref = jn.apply({"params": params}, [jnp.asarray(p) for p in pools],
                   PATCHES, key)
    noise = []
    for _ in pools:
        key, sub = jax.random.split(key)
        noise.append(np.array(jax.random.normal(sub, (BATCH, PATCHES, 8))))
    tn = tgan.NegativeGenerator([16] * 3, nc=16, z_dim=8)
    tck.load_flax_params(tn, jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = tn([torch.from_numpy(p) for p in pools], PATCHES,
                 noise=[torch.from_numpy(z) for z in noise])
    for a, b in zip(got, ref):
        assert a.shape == (BATCH * PATCHES, 16)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    with torch.no_grad():
        g1, g2 = (tn([torch.from_numpy(p) for p in pools], PATCHES,
                     generator=torch.Generator().manual_seed(1))
                  for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))
    assert not torch.allclose(g1[0], got[0])


def negcut_config():
    return small_config("NEGCUTModel", "LearnedPatchNCELoss",
                        netG_config=dict(SMALL_G), netD_config=dict(SMALL_D),
                        netF_config=dict(SMALL_F), netN_config=dict(SMALL_N),
                        nce_idt=True, lambda_NCE=1.0, lambda_GAN=1.0,
                        lambda_MS_neg=1.0)


@pytest.fixture(scope="module")
def negcut_stepped():
    """The JAX NEGCUT trainer in float64 and the port's in float64 and
    float32 from the same parameters, patch ids and noise, each after one
    step; and the port's float64 step with the negatives' pools detached."""
    rng = np.random.default_rng(31)
    cfg = negcut_config()
    real_A, real_B = (rng.random((BATCH, 1, RES, RES)).astype(np.float32)
                      for _ in range(2))
    init_batch = {"real_A": real_A}
    j32 = jax_trainer(cfg, init_batch)
    start = jax.tree.map(np.asarray, j32.params)
    assert set(start) == {"netG", "netD", "netF", "netF_", "netN"}
    ids_a, ids_b = (patch_ids(rng, j32.feat_sizes) for _ in range(2))
    key = jax.random.PRNGKey(17)
    with jax.enable_x64(True):
        noise = jax_noise(key, BATCH, len(LAYERS))

    def port_step(dtype, detach_pools=False):
        t = port_trainer(cfg, start, dtype, init_batch, heads=HEADS)
        orig = tgan.NegativeGenerator.forward
        with pytest.MonkeyPatch.context() as mp:
            if detach_pools:
                mp.setattr(tgan.NegativeGenerator, "forward",
                           lambda self, pools, *a, **k: orig(
                               self, [p.detach() for p in pools], *a, **k))
            (fake_B, idt_B), losses = t.train_step(
                *(torch.from_numpy(x).to(dtype) for x in (real_A, real_B)),
                [torch.from_numpy(i) for i in ids_a],
                [torch.from_numpy(i) for i in ids_b],
                [[torch.from_numpy(z) for z in n] for n in noise])
        return t, (fake_B, idt_B), {k: float(v) for k, v in losses.items()}

    ports = {dtype: port_step(dtype) for dtype in (torch.float64,
                                                   torch.float32)}
    detached = port_step(torch.float64, detach_pools=True)[0]
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "float32", jnp.float64)
        j = jax_float64(j32, cfg, start)
        j.params, j.opt_state, (fake_B, idt_B), losses = j._step(
            j.params, j.opt_state, nhwc(real_A.astype(np.float64)),
            nhwc(real_B.astype(np.float64)),
            [jnp.asarray(i) for i in ids_a], [jnp.asarray(i) for i in ids_b],
            key)
        lj = {k: float(v) for k, v in losses.items()}
        images = (nchw(fake_B), nchw(idt_B))
        j.params = jax.tree.map(np.asarray, j.params)
        j.opt_state = jax.tree.map(np.asarray, j.opt_state)
    return j, lj, images, ports, start, detached


@pytest.mark.parametrize("dtype,grad_tol,param_tol,loss_tol", [
    (torch.float64, 1e-6, 1e-6, 1e-12), (torch.float32, 1e-4, 1e-5, 1e-5)])
def test_negcut_step_matches_jax_float64(negcut_stepped, dtype, grad_tol,
                                         param_tol, loss_tol):
    """The port's step in float64 and float32 against the JAX package's
    float64 step: the six losses, the images, every gradient and updated
    parameter of the four optimizers, and the EMA mirror ``netF_ = 0.9
    netF_ + 0.1 netF`` after the F update."""
    j, lj, images, ports, start, _ = negcut_stepped
    t, got_images, lt = ports[dtype]
    assert list(lt) == list(NEGCUT_LOSSES) and set(lj) == set(NEGCUT_LOSSES)
    for k in NEGCUT_LOSSES:
        assert lt[k] == pytest.approx(lj[k], rel=loss_tol), k
    assert lt["N"] < 0 < lt["loss_NCE"]
    for a, b in zip(got_images, images):
        np.testing.assert_allclose(a.double().numpy(), b, atol=1e-5)
    # the negatives give the projector's level 0 a gradient
    assert_step_matches(t, j, start, dtype, grad_tol, param_tol,
                        flat_level0=False)
    ema = flat(tck.state_dict_to_flax(t.networks["netF_"]), dtype=np.float64)
    want = flat(j.params["netF_"], dtype=np.float64)
    assert ema.keys() == want.keys()
    for k in want:
        assert rel_l2(ema[k], want[k]) <= param_tol, k
    moved = flat(start["netF"], dtype=np.float64)
    assert any(rel_l2(ema[k], moved[k]) > 0 for k in want)


def test_negcut_g_gradient_flows_through_the_negatives(negcut_stepped):
    """``netG``'s gradient includes the negative-pool path (``netF_`` and
    ``netN`` at their new parameters pass it on; they take none): with the
    pools detached, the port's float64 gradient leaves JAX's by far more
    than the step's 1e-6, and ``netF_``, ``netN`` keep no gradient from the
    G step."""
    j, _, _, ports, start, detached = negcut_stepped
    ref = gradients(j, "optimizer_G", start)["netG"]
    got = gradients(ports[torch.float64][0], "optimizer_G", start)["netG"]
    cut = gradients(detached, "optimizer_G", start)["netG"]
    whole = lambda g: np.concatenate([g[k].ravel() for k in sorted(ref)])
    assert rel_l2(whole(got), whole(ref)) <= 1e-6
    assert rel_l2(whole(cut), whole(ref)) > 1e-3
    t = ports[torch.float64][0]
    for name in ("netF_", "netN"):
        assert all(p.requires_grad for p in t.networks[name].parameters())
    # netN's gradient is the N step's alone: its moment is one step's
    assert int(t.optimizer_state("optimizer_N")["count"]) == 1


def test_negcut_draws_its_noise_and_ids_from_its_generator():
    """Without injected noise and ids the step draws both from the
    algorithm's ``torch.Generator`` (seeded by ``General.seed``): two
    trainers of one seed take the same step; another seed another."""
    cfg = negcut_config()
    rng = np.random.default_rng(8)
    x = [torch.from_numpy(rng.random((BATCH, 1, RES, RES)).astype(np.float32))
         for _ in range(2)]

    def step(seed):
        c = json.loads(json.dumps(cfg))
        c["General"]["seed"] = seed
        t = talg.define_model(c, Phase.TRAIN, "cpu")
        t.initialize_model_and_optimizer({"real_A": x[0]}, c, Args())
        _, losses = t.train_step(*x, t._patch_ids(), t._patch_ids())
        return {k: float(v) for k, v in losses.items()}

    a, b, c = step(3), step(3), step(4)
    assert a == b and a != c
    assert all(np.isfinite(list(a.values())))


def test_negcut_checkpoints_cross_packages(negcut_stepped, tmp_path):
    """``netG``, ``netD``, ``netF``, ``netN`` and their four optimizers,
    both ways; ``netF_`` is written by neither package."""
    j, _, _, ports, _, _ = negcut_stepped
    t = copy.deepcopy(ports[torch.float32][0])
    assert "netF_" not in {n for ns in t.optimizer_mapping.values()
                           for n in ns}
    assert set(j.optimizer_mapping) == set(t.optimizer_mapping)
    checkpoints_cross_packages(t, j, tmp_path)


def test_define_model_dispatches_negcut():
    """``configs/config_negcut.yml`` builds ``NEGCUTModel``; after the
    initialisation at 64² its networks have JAX's parameter counts, ``netN``
    takes ``netF``'s width plus ``z_dim``; ``test`` builds ``netG`` alone."""
    cfg = load_config(os.path.join(ROOT, "configs", "config_negcut.yml"))
    t = talg.define_model(cfg, Phase.TRAIN, "cpu")
    assert isinstance(t, tgal.NEGCUTAlgorithm) and t.lambda_MS_neg == 1
    t.initialize_model_and_optimizer({"real_A": torch.zeros(1, 1, 64, 64)},
                                     cfg, Args())
    assert list(t.networks) == ["netG", "netD", "netF", "netF_", "netN"]
    assert set(t.opt) == {"optimizer_G", "optimizer_D", "optimizer_F",
                          "optimizer_N"}
    assert isinstance(t.criterionNCE, tl.LearnedPatchNCELoss)
    assert t.networks["netN"].mlp_0_0.in_features == 256 + 64
    assert t.num_parameters() == jax_param_counts(
        cfg, 64, {"netF": "taps", "netF_": "taps", "netN": "netF"}, "netG")
    assert list(talg.define_model(cfg, Phase.TEST, "cpu").networks) == ["netG"]


def test_engine_trains_negcut_resumes_and_translates(tmp_path):
    """One epoch through the engine, a resume and ``test``; the resumed
    ``netF_`` is the fresh trainer's initial ``netF`` (as in the JAX
    package, :547), not the checkpoint's."""
    cfg = small_engine_config(
        tmp_path, "config_negcut.yml",
        {"netG_config": dict(SMALL_G), "netD_config": dict(SMALL_D),
         "netF_config": dict(SMALL_F), "netN_config": dict(SMALL_N),
         "num_patches": 32})
    model = engine_round_trip(
        tmp_path, cfg, NEGCUT_LOSSES, ("netG", "netD", "netF", "netN"),
        ("optimizer_G", "optimizer_D", "optimizer_F", "optimizer_N"), "netG")
    fresh = talg.define_model(cfg, Phase.TRAIN, "cpu")
    fresh.initialize_model_and_optimizer(
        {"real_A": torch.zeros(1, 1, RES, RES)}, cfg, Args())
    for p, q, r in zip(model.networks["netF_"].parameters(),
                       fresh.networks["netF"].parameters(),
                       model.networks["netF"].parameters()):
        assert torch.equal(p, q) and not torch.equal(p, r)
