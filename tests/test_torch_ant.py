"""Port parity for adversarial noise training (``ANTLoss``, the ``AT`` option
of ``configs/config_ves_seg-S_AA.yml``) and for resuming the segmentation
trainer from a JAX checkpoint.

Small shapes on the CPU: image and background 16², label 32², batch 2, a
DynUNet with filters 4-8, the JAX package's parameters carried into the
port. The JAX package's decisions, control points, Gamma draws and the
draws' derivative dx/da are handed to the port (``ANTLoss``'s three draw
methods overridden, the draws through ``noise_model.injected_draw``), and
the control-point gradients of each ascent step are recorded on both sides.
Tolerances, each with its reading on a CPU (torch 2.13, JAX 0.9) beside
it: in float64 (the JAX functions traced with 64-bit types and
``jnp.float32`` standing for float64, as ``tests/test_torch_gan_seg.py``
does) sample and every control-point gradient within 1e-9 relative L2; in
float32 the sample within 1e-6 and the gradients within 1e-4 (the
network's sums in float32).
"""
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from octa_tpu.io import checkpoints as jck
from octa_tpu.models import noise_model as jnm
from octa_tpu.models.registry import build_network as jbuild
from octa_tpu.train import algorithms as jalg
from octa_tpu.utils import losses as jl
from octa_tpu.utils.enums import Phase as JPhase
from octa_tpu_torch.io import checkpoints as tck
from octa_tpu_torch.models import noise_model as tnm
from octa_tpu_torch.models.registry import build_network as tbuild
from octa_tpu_torch.tools.seg_data import (
    keep_image_at_background_size,
    make_seg_dataset,
    point_config_at,
)
from octa_tpu_torch.train import algorithms as talg
from octa_tpu_torch.train.engine import train
from octa_tpu_torch.utils import losses as tl
from octa_tpu_torch.utils.config import load_config
from octa_tpu_torch.utils.enums import Phase

S_AA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "configs", "config_ves_seg-S_AA.yml")

NET = {"name": "DynUNet", "spatial_dims": 2, "in_channels": 1,
       "out_channels": 1, "kernel_size": [3, 3, 3], "strides": [1, 2, 1],
       "upsample_kernel_size": [1, 2, 1], "filters": [4, 8, 8]}
FIELDS = tnm.NoiseParams._fields


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this file: under the test run's several worker
    processes, torch's parallel regions wait on threads that are not
    running."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _warm_sqrt():
    torch.sqrt(torch.rand(1 << 20))


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


# ---------------------------------------------------------------------------
# the Gamma draw's derivative and JAX's clip
# ---------------------------------------------------------------------------

def test_gamma_gradient_matches_jax():
    """torch's implicit derivative of a Gamma draw against JAX's on the same
    draws, float64, 41 concentrations from 1e-3 to 10, 16 draws each: both
    approximate the same implicit derivative with different series. Within
    1e-3 relative: reads 4.7e-4 at most (at 0.079; 1.0e-4 at 0.316,
    1.5e-4 at 10, below 1e-7 under 0.07). Draws that underflow to 0 (at
    concentrations under 0.006) have derivative 0 in both."""
    a = np.logspace(-3, 1, 41)
    worst = 0.0
    with jax.enable_x64(True):
        for key in jax.random.split(jax.random.PRNGKey(0), 16):
            x, dx = jax.jvp(lambda c: jax.random.gamma(key, c),
                            (jnp.asarray(a),), (jnp.ones_like(jnp.asarray(a)),))
            x, dx = np.array(x), np.array(dx)
            ours = torch._standard_gamma_grad(torch.from_numpy(a),
                                              torch.from_numpy(x)).numpy()
            assert np.all(np.isfinite(ours)) and np.all(ours[x == 0] == 0)
            rel = np.abs(ours - dx) / np.maximum(np.abs(dx), 1e-300)
            worst = max(worst, float(rel.max()))
    assert worst <= 1e-3, worst


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (1e-3, None)])
def test_clip_takes_jax_gradient_at_ties(lo, hi):
    """At a bound JAX's clip passes half the gradient, ``torch.clamp`` all
    of it; ``noise_model.clip`` passes JAX's."""
    pts = np.array([-0.5, 0.0, 1e-3, 0.5, 1.0, 1.5], np.float32)
    ref = jax.vmap(jax.grad(lambda v: jnp.clip(v, lo, hi)))(jnp.asarray(pts))
    x = torch.from_numpy(pts).requires_grad_(True)
    tnm.clip(x, lo, hi).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(ref))
    assert 0.5 in set(x.grad.tolist())
    x.grad = None
    x.clamp(lo, hi).sum().backward()
    assert 0.5 not in set(x.grad.tolist())  # what clamp would have given


def test_noise_model_gradient_with_jax_draws(rng):
    """The noise model's gradient with respect to its five control grids,
    float64, with JAX's draws and derivative injected and ``gamma_cp``
    pinned on its bounds 0 and 1 in places (the tie rule): within 1e-10
    relative L2 of ``jax.grad`` (reads 4.8e-15)."""
    b, hw = 2, (24, 24)
    with jax.enable_x64(True):
        params = jnm.sample_noise_params(jax.random.PRNGKey(3), b)
        gcp = np.asarray(params.gamma_cp).copy()
        gcp[:, 0, :] = 0.0
        gcp[:, -1, :] = 1.0
        params = params._replace(gamma_cp=jnp.asarray(gcp))
        img = jnp.asarray(rng.random((b, *hw)))
        bg = jnp.asarray(rng.random((b, *hw)))
        wgt = jnp.asarray(rng.random((b, *hw)))
        key = jax.random.PRNGKey(4)

        def loss(p):
            return jnp.sum(jnm.apply_noise_model(p, key, img, bg) * wgt)

        ref = jax.grad(loss)(params)
        hook = _jax_gamma_hook(key)
        tp = tnm.NoiseParams(*(torch.from_numpy(np.asarray(v)).requires_grad_(True)
                               for v in params))
        out = tnm.apply_noise_model(
            tp, torch.from_numpy(np.asarray(img)), torch.from_numpy(np.asarray(bg)),
            draw=tnm.injected_draw(hook))
        (out * torch.from_numpy(np.asarray(wgt))).sum().backward()
    for name, r in zip(FIELDS, ref):
        assert _rel_l2(getattr(tp, name).grad, r) <= 1e-10, name


def test_fixed_state_draw_repeats_and_differentiates():
    """Every call of one fixed-state draw gives the same fields for the same
    concentrations, other fields for others, and a reparameterised gradient
    (torch's ``_standard_gamma_grad``)."""
    g = torch.Generator().manual_seed(0)
    draw = tnm.fixed_state_draw(g)
    a = torch.full((2, 8, 8), 2.0, dtype=torch.float64, requires_grad=True)
    first = draw((a,) * 4)
    again = draw((a.detach(),) * 4)
    for x, y in zip(first, again):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    other = draw((a.detach() * 1.5,) * 4)
    assert not torch.equal(other[0], first[0])
    first[0].sum().backward()
    torch.testing.assert_close(
        a.grad, torch._standard_gamma_grad(a.detach(), first[0].detach()))


def test_resize_weights_made_in_inference_mode_take_gradients():
    """The resize weights are cached per shape; made first under inference
    mode (as the adapt-and-segment pipeline makes them), they still serve
    a later call under autograd (the ANT loop)."""
    cp = torch.rand(1, 9, 9, dtype=torch.float64)
    tnm._device_weights.cache_clear()
    with torch.inference_mode():
        tnm.resize(cp, (37, 37), "cubic")
    cp.requires_grad_(True)
    tnm.resize(cp, (37, 37), "cubic").sum().backward()
    assert cp.grad is not None and torch.isfinite(cp.grad).all()


# ---------------------------------------------------------------------------
# ANTLoss against the JAX package's
# ---------------------------------------------------------------------------

def _jax_gamma_keys(noise_rng):
    """The keys of the four Gamma fields of ``jnm.apply_noise_model`` with
    ``noise_rng``, in the port's draw order."""
    k1, k2 = jax.random.split(noise_rng)
    kd1, kd2 = jax.random.split(k1)
    ks1, ks2 = jax.random.split(k2)
    return kd1, kd2, ks1, ks2


def _jax_gamma_hook(noise_rng):
    """JAX's draws at the port's concentrations and their derivative
    dx/da, for ``noise_model.injected_draw``."""
    keys = _jax_gamma_keys(noise_rng)

    def hook(concentrations):
        with jax.enable_x64(concentrations[0].dtype == torch.float64):
            out = _gamma_jvp(jnp.stack(keys),
                             jnp.stack([jnp.asarray(c.numpy())
                                        for c in concentrations]))
            return [(torch.from_numpy(np.array(x)), torch.from_numpy(np.array(d)))
                    for x, d in zip(*out)]

    return hook


@jax.jit
def _gamma_jvp(keys, a):
    """Each field's draw ``jax.random.gamma(keys[i], a[i])`` and its
    derivative dx/da (elementwise, so a JVP with ones gives it)."""
    return jax.vmap(lambda k, c: jax.jvp(lambda v: jax.random.gamma(k, v),
                                         (c,), (jnp.ones_like(c),)))(keys, a)


class _Replayed(tl.ANTLoss):
    """The port's ANTLoss with the JAX package's decisions, control points
    and draws for one key."""

    def __init__(self, loss_fun, rng_key, dtype, **kw):
        super().__init__(loss_fun, **kw)
        self.key, self.dtype = rng_key, dtype

    def _jax(self, b, h, w):
        ks = jax.random.split(self.key, 8)
        ch, cw = self.crop_size(h, w)
        return ks, dict(
            rot_k=jax.random.randint(ks[0], (b,), 0, 4),
            angle=jax.random.uniform(ks[1], (b,), minval=-10.0, maxval=10.0),
            factor=jax.random.uniform(ks[2], (b,), minval=self.max_decrease_res,
                                      maxval=1.0),
            crop_off=jnp.stack([jax.random.randint(ks[3], (b,), 0, h - ch + 1),
                                jax.random.randint(ks[4], (b,), 0, w - cw + 1)],
                               axis=-1))

    def decisions(self, b, h, w, device):
        with jax.enable_x64(self.dtype == torch.float64):
            _, d = self._jax(b, h, w)
            return tl.ANTDecisions(**{k: torch.from_numpy(np.asarray(v))
                                      for k, v in d.items()})

    def noise_params(self, b, device):
        with jax.enable_x64(self.dtype == torch.float64):
            ks, _ = self._jax(b, 8, 8)
            p = jnm.sample_noise_params(ks[5], b, self.grid_size)
            return tnm.NoiseParams(*(torch.from_numpy(np.asarray(v)) for v in p))

    def gamma_draw(self):
        with jax.enable_x64(self.dtype == torch.float64):
            ks = jax.random.split(self.key, 8)
        return tnm.injected_draw(_jax_gamma_hook(ks[6]))


def _jax_ant(ant, params, x, bg, y, key, float64: bool, monkeypatch):
    """The JAX package's ANTLoss on the inputs; returns its sample, label
    and the control-point gradients of each ascent step (recorded at
    ``pga_update``). In float64: 64-bit types on and ``jnp.float32``
    standing for float64 while it runs."""
    pga = jnm.pga_update
    net = jbuild(dict(NET))
    with jax.enable_x64(float64), monkeypatch.context() as mp:
        dt = np.float64 if float64 else np.float32
        if float64:
            mp.setattr(jnp, "float32", jnp.float64)
            net = net.clone(dtype=jnp.float64)
            params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)

        def run(x, bg, y):  # traced once: the recorder sees the gradients
            grads = []

            def record(p, g, alpha, mode="PGA"):
                grads.append(g)
                return pga(p, g, alpha, mode)

            mp.setattr(jnm, "pga_update", record)
            seg = lambda img: net.apply({"params": params}, img)
            return (*ant(seg, x, bg, y, key), grads)

        adv, y_crop, grads = jax.jit(run)(
            jnp.asarray(x, dt), jnp.asarray(bg, dt), jnp.asarray(y, dt))
        return (np.asarray(adv), np.asarray(y_crop),
                jax.tree.map(np.asarray, grads))


@pytest.fixture(scope="module")
def net_params():
    net = jbuild(dict(NET))
    params = net.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 1)))["params"]
    return jax.tree.map(np.asarray, params)


def _port_net(params, dtype):
    net = tbuild(dict(NET))
    tck.restore_like(net, params)
    return net.to(dtype)


# tolerances (relative L2) of sample and control-point gradients, and their
# readings on a CPU: float64 1.5e-16 and 1.6e-14, float32 1.0e-7 and
# 9.2e-6 (the network's float32 sums)
TOL = {torch.float64: (1e-9, 1e-9), torch.float32: (1e-6, 1e-4)}


@pytest.mark.parametrize("dtype,crop", [(torch.float64, (0.5, 0.5)),
                                        (torch.float32, (1, 1))],
                         ids=["float64-crop", "float32-nocrop"])
def test_ant_matches_jax(rng, net_params, monkeypatch, dtype, crop):
    b = 2
    x = rng.random((b, 16, 16))
    bg = rng.random((b, 16, 16))
    y = (rng.random((b, 32, 32)) < 0.3).astype(np.float64) * rng.random((b, 32, 32))
    key = jax.random.PRNGKey(7)
    kw = dict(crop=crop, alpha=0.05)
    ref_adv, ref_y, ref_grads = _jax_ant(
        jl.ANTLoss(jl.DiceBCELoss(True), **kw), net_params, x, bg, y, key,
        dtype == torch.float64, monkeypatch)
    ant = _Replayed(tl.DiceBCELoss(True), key, dtype, **kw)
    net = _port_net(net_params, dtype)
    adv, y_crop = ant(net, *(torch.from_numpy(a).to(dtype) for a in (x, bg, y)))
    assert adv.dtype == dtype and tuple(adv.shape) == ref_adv.shape
    assert not adv.requires_grad
    assert all(p.grad is None for p in net.parameters())
    sample_tol, grad_tol = TOL[dtype]
    np.testing.assert_array_equal(y_crop.numpy(), ref_y)
    assert _rel_l2(adv, ref_adv) <= sample_tol
    assert len(ant.param_grads) == len(ref_grads) == 2
    for ours, ref in zip(ant.param_grads, ref_grads):
        for name, r in zip(FIELDS, ref):
            assert _rel_l2(getattr(ours, name), r) <= grad_tol, name
    assert all(np.isfinite(float(v)) for v in ant.seg_losses)


def test_ant_refuses_mismatched_shapes():
    """The JAX function fails where image and background differ in size (the
    shipped S_AA config resizes the image to 1216² and the background to
    304²); the port says so."""
    ant = tl.ANTLoss(tl.DiceBCELoss(True), generator=torch.Generator())
    with pytest.raises(ValueError, match=r"\(2, 64, 64\).*\(2, 16, 16\)"):
        ant(lambda img: img, torch.rand(2, 64, 64), torch.rand(2, 16, 16),
            torch.rand(2, 64, 64))
    with jax.enable_x64(False), pytest.raises(TypeError):
        jl.ANTLoss(jl.DiceBCELoss(True))(
            lambda img: img, jnp.ones((2, 64, 64)), jnp.ones((2, 16, 16)),
            jnp.ones((2, 64, 64)), jax.random.PRNGKey(0))


def test_ant_draws_from_the_generator():
    """With no overrides the loss draws everything from its generator: the
    same seed gives the same sample, another seed another one."""
    net = _port_net(jax.tree.map(np.asarray, jbuild(dict(NET)).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 1)))["params"]),
        torch.float32)
    x, bg = torch.rand(2, 16, 16), torch.rand(2, 16, 16)
    y = (torch.rand(2, 32, 32) > 0.7).float()
    runs = [tl.ANTLoss(tl.DiceBCELoss(True), crop=(0.5, 0.5),
                       generator=torch.Generator().manual_seed(s))(net, x, bg, y)
            for s in (0, 0, 1)]
    torch.testing.assert_close(runs[0][0], runs[1][0], rtol=0, atol=0)
    assert not torch.equal(runs[0][0], runs[2][0])
    assert runs[0][0].shape == (2, 16, 16) and runs[0][1].shape == (2, 16, 16)


# ---------------------------------------------------------------------------
# SegAlgorithm: an AT step, and resuming a JAX run
# ---------------------------------------------------------------------------

def _seg_config(at=None):
    model = dict(NET, remat=False)
    cfg = {"General": {"task": "ves-seg", "seed": 3, "amp": False,
                       "model": model},
           "Train": {"lr": 1e-3, "weight_decay": 1e-3, "loss": "DiceBCELoss",
                     "epochs": 4, "epochs_decay": 2, "batch_size": 2},
           "Output": {"save_dir": "unused"}}
    if at is not None:
        cfg["Train"]["AT"] = at
    return cfg


class _Args:
    start_epoch = 0
    epoch = "latest"


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v, np.float64)
    return out


def test_seg_algorithm_at_step_matches_jax(rng):
    """One training step with ``Train.AT`` in both packages, the port's ANT
    draws replayed from the key JAX's step uses: the hardened batch written
    back into the mini-batch within 1e-5, the loss within 1e-5 relative and
    the updated parameters within 5e-5 relative L2 per tensor (reads 6.4e-6
    at most: the two float32 ANT passes differ by ~1e-7, and Adam's first
    step moves each parameter by about the learning rate whatever the size
    of its gradient)."""
    at = {"grid_size": [9, 9], "alpha": 0.001, "crop": [1, 1],
          "label_threshold": 0.1}
    cfg = _seg_config(at)
    batch = {"image": rng.random((2, 1, 16, 16)).astype(np.float32),
             "background": rng.random((2, 1, 16, 16)).astype(np.float32),
             "label": rng.random((2, 1, 32, 32)).astype(np.float32)}
    j = jalg.define_model(cfg, JPhase.TRAIN)
    j.initialize_model_and_optimizer(batch, cfg, _Args(), phase=JPhase.TRAIN)
    t = talg.define_model(cfg, Phase.TRAIN, "cpu")
    t.initialize_model_and_optimizer(batch, cfg, _Args(), phase=Phase.TRAIN)
    tck.restore_like(t.net, jax.tree.map(np.asarray, j.params["model"]))
    key = jax.random.fold_in(j.rngs, j._step_count + 1)  # JAX's next_rng
    replay = _Replayed(t.loss_function, key, torch.float32, **at)
    assert isinstance(t.at, tl.ANTLoss)
    t.at = replay
    jb, tb = dict(batch), {k: torch.from_numpy(v) for k, v in batch.items()}
    _, lj = j.perform_training_step(jb, {})
    _, lt = t.perform_training_step(tb, {})
    assert tb["image"].shape == (2, 1, 32, 32)
    np.testing.assert_allclose(tb["image"].numpy(), jb["image"], atol=1e-5)
    assert lt["DiceBCELoss"] == pytest.approx(float(lj["DiceBCELoss"]), rel=1e-5)
    ours = _flat(tck.state_dict_to_flax(t.net))
    ref = _flat(j.params["model"])
    for k in ref:
        assert _rel_l2(ours[k], ref[k]) <= 5e-5, k


def test_jax_checkpoint_resumes_in_the_port(rng, tmp_path):
    """A SegAlgorithm checkpoint pair written by the JAX package (model and
    optax's Adam state after two steps and a schedule change) resumed in the
    port through ``--start_epoch``'s loader: the next step equals JAX's
    resumed step within 1e-5 relative L2 per tensor (reads 8.0e-7)."""
    cfg = _seg_config()
    cfg["Output"]["save_dir"] = str(tmp_path)
    batches = [{"image": rng.random((2, 1, 32, 32)).astype(np.float32),
                "label": (rng.random((2, 1, 32, 32)) < 0.3).astype(np.float32)}
               for _ in range(3)]
    j = jalg.define_model(cfg, JPhase.TRAIN)
    j.initialize_model_and_optimizer(batches[0], cfg, _Args(), phase=JPhase.TRAIN)
    for b in batches[:2]:
        j.perform_training_step(dict(b), {})
    j.scheduler_step(2)  # epoch 3 of 4 with 2 decay epochs: lr halves
    ckdir = tmp_path / "checkpoints"
    jck.save_checkpoint(str(ckdir / "latest_model_model.ckpt"),
                        {"epoch": 2, "model": j.network_state("model")["params"]})
    jck.save_checkpoint(str(ckdir / "latest_optimizer.ckpt"),
                        {"epoch": 2, "optimizer": j.optimizer_state("optimizer")})

    class Resume(_Args):
        start_epoch = 2

    t = talg.define_model(cfg, Phase.TRAIN, "cpu")
    t.initialize_model_and_optimizer(batches[0], cfg, Resume(), phase=Phase.TRAIN)
    state = t.opt["optimizer"].state[next(t.net.parameters())]
    assert int(state["step"]) == 2
    assert t.opt["optimizer"].param_groups[0]["lr"] == pytest.approx(5e-4)
    j.perform_training_step(dict(batches[2]), {})
    t.perform_training_step({k: torch.from_numpy(v) for k, v in batches[2].items()},
                            {})
    ours = _flat(tck.state_dict_to_flax(t.net))
    ref = _flat(j.params["model"])
    for k in ref:
        assert _rel_l2(ours[k], ref[k]) <= 1e-5, k


def _small_s_aa(globs, save_dir, override: bool):
    """``config_ves_seg-S_AA.yml`` on the stand-in data, its sizes cut to
    32² / 64² and a DynUNet 8-16 wide, one epoch of 2 steps; with
    ``override``, the image kept at the background's size."""
    cfg = point_config_at(load_config(S_AA), globs, save_dir)
    if override:
        keep_image_at_background_size(cfg)
    for a in cfg["Train"]["data_augmentation"]:
        if a["name"] == "LoadGraphAndFilterByRandomRadiusd":
            a["image_resolutions"] = [[32, 32], [64, 64]]
        elif a["name"] == "Resized":
            a["spatial_size"] = [32, 32] if "background" in a["keys"] else [64, 64]
    cfg["Validation"]["data_augmentation"][4]["spatial_size"] = [64, 64]
    cfg["General"]["model"]["filters"] = [8, 16, 16, 16, 16]
    for post in (cfg["Train"]["post_processing"],
                 cfg["Validation"]["post_processing"]):
        post["prediction"][-1]["min_size"] = 10
    cfg["Train"].update(epochs=1, epochs_decay=0, batch_size=2, lr=1e-3)
    return cfg


def test_s_aa_config_trains(tmp_path):
    """``config_ves_seg-S_AA.yml`` with the image kept at the background's
    size (``keep_image_at_background_size``): one epoch of 2 steps through
    the engine at a small size, finite losses. As shipped (image resized
    with the label) the step raises the ``ValueError`` naming both shapes."""
    globs = make_seg_dataset(str(tmp_path / "data"), n_graphs=4,
                             n_backgrounds=2, n_val=2, background_res=40,
                             val_res=64, device="cpu", max_edges=120)
    cfg = _small_s_aa(globs, str(tmp_path / "runs"), override=True)
    assert [a["keys"] for a in cfg["Train"]["data_augmentation"]
            if a["name"] == "Resized"] == [["background"], ["label"]]
    steps = []

    class Args(_Args):
        split = ""
        save_latest = False

    train(Args(), cfg, device="cpu", on_step=lambda *a: steps.append(a))
    assert len(steps) == 2
    assert all(np.isfinite(s[2]["DiceBCELoss"]) for s in steps)
    with pytest.raises(ValueError, match=r"\(2, 64, 64\).*\(2, 32, 32\)"):
        train(Args(), _small_s_aa(globs, str(tmp_path / "r2"), override=False),
              device="cpu")
