"""Port parity for the GAN-seg slice: the LSGAN loss, the PatchGAN
discriminator, ``UnalignedZipDataset``, ``ImageToImageTranslationd``, one
joint G/D/S training step, the six checkpoints across the two packages, and
the engine on the ``gan-ves-seg`` task.

Small networks on the CPU in float32 (a ``ResnetGenerator`` with ``ngf`` 8
and 2 blocks, a PatchGAN with ``ndf`` 8, a DynUNet with filters 8-16,
``upshape`` 64²), with the JAX package's initial parameters carried into
the port. Tolerances: the loss 1e-6 relative, network outputs 1e-5
absolute; the joint step in float32 against the JAX package's float32 step
(losses 1e-5 relative, updated parameters 1e-4 relative L2 over each
network, the segmentor's 2e-4) and against its float64 step (every gradient
tensor 1e-4, every parameter tensor 1e-5), and in float64 against its
float64 step (every gradient and parameter tensor 1e-6).
"""
import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octa_tpu.data import dataset as jds
from octa_tpu.data import transforms as jt
from octa_tpu.io import checkpoints as jck
from octa_tpu.models import resnet_gan as jgan
from octa_tpu.train import algorithms as jalg
from octa_tpu.utils import losses as jl
from octa_tpu.utils.enums import Phase as JPhase
from octa_tpu_torch.data import dataset as tds
from octa_tpu_torch.data import transforms as tt
from octa_tpu_torch.io import checkpoints as tck
from octa_tpu_torch.models import registry as treg
from octa_tpu_torch.models import resnet_gan as tgan
from octa_tpu_torch.tools.seg_data import make_seg_dataset, point_config_at
from octa_tpu_torch.train import algorithms as talg
from octa_tpu_torch.train.engine import train
from octa_tpu_torch.utils import losses as tl
from octa_tpu_torch.utils.config import load_config
from octa_tpu_torch.utils.enums import Phase

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "config_gan_ves_seg.yml")
SMALL_G = {"name": "ResnetGenerator", "ngf": 8, "n_blocks": 2}
SMALL_D = {"name": "NLayerDiscriminator", "ndf": 8}


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


def _flat(tree, prefix=(), dtype=np.float32):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,), dtype))
        else:
            out[prefix + (k,)] = np.asarray(v, dtype)
    return out


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _nhwc(x):
    return jnp.asarray(x).transpose(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# the loss and the discriminator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("real", [True, False])
def test_lsgan_matches_jax(rng, real):
    pred = rng.normal(size=(2, 1, 6, 6)).astype(np.float32)
    ours = tl.get_loss_function_by_name("LSGANLoss", {})(torch.from_numpy(pred),
                                                         real)
    ref = jl.LSGANLoss()(jnp.asarray(pred), real)
    assert float(ours) == pytest.approx(float(ref), rel=1e-6)
    assert float(ours) == pytest.approx(float(np.mean((pred - float(real)) ** 2)),
                                        rel=1e-6)


@pytest.mark.parametrize("size", [32, 41])
def test_discriminator_matches_jax(rng, size):
    jnet = jgan.NLayerDiscriminator(ndf=8)
    x = rng.random((2, 1, size, size)).astype(np.float32)
    params = jnet.init(jax.random.PRNGKey(1), _nhwc(x))["params"]
    assert set(params) == {"conv0", "conv1", "conv2", "conv3", "conv_out"}
    net = treg.build_network(dict(SMALL_D))
    tck.restore_like(net, jax.tree.map(np.asarray, params))
    ours = net(torch.from_numpy(x)).detach().numpy()
    ref = np.asarray(jnet.apply({"params": params}, _nhwc(x))).transpose(0, 3, 1, 2)
    assert ours.shape == ref.shape and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    # the flax names, both ways
    back = _flat(tck.state_dict_to_flax(net))
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(back[k], v)
    full = jax.eval_shape(lambda: jgan.patchGAN70x70().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 70, 70, 1))))["params"]
    assert {k: tuple(p.shape) for k, p in tgan.patchGAN70x70().state_dict().items()} \
        == {k: tuple(v.shape) for k, v in tck.flax_to_state_dict(
            jax.tree.map(lambda v: np.zeros(v.shape, np.float32), full),
            tgan.patchGAN70x70()).items()}


def test_registry_has_the_gan_seg_networks():
    assert isinstance(treg.build_network({"name": "patchGAN70x70"}),
                      tgan.NLayerDiscriminator)
    # the contrastive heads build from their levels' channel counts, NICE-GAN's
    # generator from its encoding's; an unknown network raises
    assert isinstance(treg.build_network({"name": "PatchSampleF"},
                                         in_channels=[1, 8]),
                      tgan.PatchSampleF)
    assert isinstance(treg.build_network({"name": "Negative_Generator"},
                                         in_channels=[256]),
                      tgan.NegativeGenerator)
    assert type(treg.build_network({"name": "NiceDiscriminator", "ndf": 8})
                ).__name__ == "NiceDiscriminator"
    assert type(treg.build_network({"name": "NiceResnetGenerator", "ngf": 8},
                                   in_channels=16)
                ).__name__ == "NiceResnetGenerator"
    with pytest.raises(KeyError, match="unknown network"):
        treg.build_network({"name": "NoSuchNetwork"})


# ---------------------------------------------------------------------------
# the data path
# ---------------------------------------------------------------------------

def test_unaligned_zip_draws_match_jax():
    data = {"real_A": [f"a{i}.csv" for i in range(5)],
            "real_A_seg": [f"a{i}.csv" for i in range(5)],
            "real_B": [f"b{i}.png" for i in range(3)],
            "background": [f"bg{i}.png" for i in range(4)]}
    ours = tds.UnalignedZipDataset(data, tt.Compose([]), Phase.TRAIN,
                                   np.random.default_rng(7))
    ref = jds.UnalignedZipDataset(data, jt.Compose([]), JPhase.TRAIN,
                                  np.random.default_rng(7))
    assert len(ours) == len(ref) == 5
    for i in (0, 3, 4, 1, 2, 0):
        assert ours[i] == ref[i]
    # without real_A, real_B is read in order
    b_only = {"real_B": data["real_B"]}
    assert [tds.UnalignedZipDataset(b_only, tt.Compose([]), Phase.TEST,
                                    np.random.default_rng(0))[i]["real_B"]
            for i in range(3)] == data["real_B"]


def test_image_to_image_translation_matches_jax(rng, tmp_path):
    jnet = jgan.ResnetGenerator(ngf=8, n_blocks=2)
    x = rng.random((1, 1, 32, 32)).astype(np.float32)
    params = jnet.init(jax.random.PRNGKey(3), _nhwc(x))["params"]
    path = jck.save_checkpoint(str(tmp_path / "g.ckpt"),
                               {"epoch": 5, "model": params})
    cfg = {"name": "ResnetGenerator", "ngf": 8, "n_blocks": 2}
    entry = [{"name": "ImageToImageTranslationd", "keys": ["image"],
              "model_path": path, "model_config": cfg}]
    ours = tt.get_data_augmentations(entry, 0, device="cpu")[0]
    ref = jt.get_data_augmentations(entry, 0)[0]
    with torch.autocast("cpu", dtype=torch.bfloat16):  # not inherited
        out = ours({"image": torch.from_numpy(x[0])})["image"]
    want = np.asarray(ref({"image": x[0]})["image"])
    assert out.dtype == torch.float32 and not out.requires_grad
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5)
    assert "ImageToImageTranslationd" in tt.TRANSFORM_REGISTRY


# ---------------------------------------------------------------------------
# one joint step against the JAX package's
# ---------------------------------------------------------------------------

def _gan_config(compute_identity=True):
    s = {"name": "DynUNet", "spatial_dims": 2, "in_channels": 1,
         "out_channels": 1, "kernel_size": [3, 3, 3, 3], "strides": [1, 2, 2, 1],
         "upsample_kernel_size": [1, 2, 2, 1], "filters": [8, 16, 16, 16]}
    return {"General": {"task": "gan-ves-seg", "seed": 5, "amp": False,
                        "inference": "G",
                        "model": {"name": "GanSegModel", "model_g": dict(SMALL_G),
                                  "model_d": dict(SMALL_D), "model_s": s,
                                  "compute_identity": compute_identity,
                                  "compute_identity_seg": True,
                                  "upshape": [64, 64]}},
            "Train": {"lr": 2e-4, "weight_decay": 1e-3, "loss_dg": "LSGANLoss",
                      "loss_s": "DiceBCELoss", "epochs": 3, "epochs_decay": 1,
                      "batch_size": 2},
            "Output": {"save_dir": "unused"}}


class _Args:
    start_epoch = 0
    epoch = "latest"
    split = ""
    save_latest = True


def _gan_batch(rng):
    return {"real_A": rng.random((2, 1, 32, 32)).astype(np.float32),
            "real_B": rng.random((2, 1, 32, 32)).astype(np.float32),
            "real_A_seg": (rng.random((2, 1, 64, 64)) < 0.3).astype(np.float32)}


# conv biases that an instance norm follows: their gradient is zero in exact
# arithmetic, so one Adam step moves them by about the learning rate in the
# sign of the rounding noise, in each package its own
ZERO_GRADIENT = {("generator", m) for m in (
    "conv_in", "down_conv_0", "down_conv_1", "up_conv_0", "up_conv_1",
    "resblock_0/conv1", "resblock_0/conv2", "resblock_1/conv1",
    "resblock_1/conv2")} | {("discriminator", f"conv{n}") for n in (1, 2, 3)}


def _zero_gradient(net, key):
    return (net, "/".join(key[:-1])) in ZERO_GRADIENT and key[-1] == "bias"


@pytest.fixture(scope="module")
def stepped():
    """The JAX trainer and the port's from the same parameters, each after
    the same joint step, the port's also in float64; the losses of both and
    the port's outputs."""
    rng = np.random.default_rng(11)
    cfg = _gan_config()
    b = _gan_batch(rng)
    j = jalg.define_model(cfg, JPhase.TRAIN)
    j.initialize_model_and_optimizer(b, cfg, _Args())
    ports = []
    for dtype in (torch.float32, torch.float64):
        t = talg.define_model(cfg, Phase.TRAIN, "cpu")
        assert list(t.networks) == ["segmentor", "generator", "discriminator"]
        for name, net in t.networks.items():
            tck.restore_like(net, jax.tree.map(np.asarray, j.params[name]))
            net.to(dtype)
        t.initialize_model_and_optimizer(b, cfg, _Args())
        ports.append(t)
    t, t64 = ports
    init = {n: _flat(j.params[n]) for n in j.params}
    start = jax.tree.map(np.asarray, j.params)
    _, lj = j.perform_training_step(dict(b), {})
    out, lt = t.perform_training_step(
        {k: torch.from_numpy(v) for k, v in b.items()}, {})
    _, lt64 = t64.train_step(*(torch.from_numpy(b[k]).double()
                               for k in ("real_A", "real_B", "real_A_seg")))
    j64, lj64 = _jax_step_float64(cfg, b, start)
    return j, t, t64, init, (lt, lj, out), (j64, lj64, lt64)


def _jax_step_float64(cfg, b, start):
    """The JAX package's jitted step in float64 from the parameters
    ``start``: its networks, losses and Adam as they are, traced with 64-bit
    types enabled and ``jnp.float32`` standing for float64. The package
    names its float type through ``jnp.float32`` where the trace reads it
    (the algorithm's and the networks' dtype, the norms' statistics, the
    networks' outputs), so nothing of it stays in float32. Returns the
    trainer after the step and its losses."""
    j = jalg.define_model(cfg, JPhase.TRAIN)
    j.initialize_model_and_optimizer(b, cfg, _Args())
    to64 = lambda tree: jax.tree.map(
        lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype.kind == "f"
        else a, tree)
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "float32", jnp.float64)
        j.dtype = jnp.float64
        j.networks = {n: m.clone(dtype=jnp.float64) for n, m in j.networks.items()}
        j.params, j.mutables = to64(start), to64(j.mutables)
        j._init_optimizers(cfg)
        j._build_steps()
        _, losses = j.perform_training_step(to64(dict(b)), {})
        losses = {k: float(v) for k, v in losses.items()}
        j.params = jax.tree.map(np.asarray, j.params)
        j.opt_state = jax.tree.map(np.asarray, j.opt_state)
    return j, losses


def _gradients(alg, opt_name, init, dtype=np.float32):
    """A network's gradient from Adam's first moment after one step,
    ``(1 - b1) (g + wd p)`` in both packages (the port's moments as its
    checkpoints hold them, in float32)."""
    (name,) = alg.optimizer_mapping[opt_name]
    if isinstance(alg, talg.BaseAlgorithm):
        group = alg.opt[opt_name].param_groups[0]
        b1, wd = group["betas"][0], group["weight_decay"]
        mu = _flat(alg.optimizer_state(opt_name)["inner_state"]["1"]["0"]["mu"][name],
                   dtype=dtype)
    else:
        cfg = alg.config["Train"]
        b1 = alg.optimizer_configs.get(opt_name, {}).get("betas", (0.5,))[0]
        wd = cfg["weight_decay"]
        mu = _flat(alg.opt_state[opt_name].inner_state[1][0].mu[name], dtype=dtype)
    return {k: mu[k] / (1 - b1) - wd * init[k] for k in mu}


def test_gan_seg_step_matches_jax(stepped):
    """One joint step against the JAX step, both in float32: the six losses
    within 1e-5 relative; the discriminator's gradient tensors within 1e-4
    relative L2; the generator's and the segmentor's gradients within 1e-2
    relative L2 over each network; the updated parameters within 1e-4
    relative L2 over each network, the segmentor's within 2e-4. And the
    port's float32 step against its float64 step: every gradient tensor
    within 1e-4.

    The looser bounds for generator and segmentor measure the JAX
    package's float32 step, not the port: against the float64 step of
    either package (``test_gan_seg_step_matches_jax_float64``) the JAX
    float32 step's segmentor gradients are up to 1.45e-2 off per tensor
    (3.4e-3 over the network) and its updated segmentor 1.04e-4, while
    the port's float32 step is 1.2e-5 and 1.4e-7 off (held per tensor in
    ``test_gan_seg_float32_step_matches_jax_float64``)."""
    j, t, t64, init, (lt, lj, out), _ = stepped
    assert list(lt) == list(lj)
    for k in lj:
        assert lt[k] == pytest.approx(lj[k], rel=1e-5), k
    assert lt["G_idt"] > 0 and lt["S_idt"] > 0
    assert out["fake_B"].shape == (1, 1, 32, 32)
    assert out["real_B_seg"].shape == (2, 1, 64, 64)
    for opt_name, (name,) in t.optimizer_mapping.items():
        grad = _gradients(t, opt_name, init[name])
        grad64 = _gradients(t64, opt_name, init[name])
        ref = _gradients(j, opt_name, init[name])
        ours = _flat(tck.state_dict_to_flax(t.networks[name]))
        want = _flat(j.params[name])
        assert ours.keys() == want.keys() == grad.keys() == ref.keys()
        kept = [k for k in ref if not _zero_gradient(name, k)]
        for k in ref:
            if k not in kept:  # no gradient to speak of, in either package
                w = k[:-1] + ("kernel",)
                for g in (grad, ref):
                    assert np.linalg.norm(g[k]) <= 1e-5 * np.linalg.norm(g[w]), k
                continue
            assert _rel_l2(grad[k], grad64[k]) <= 1e-4, (name, k)
            if name == "discriminator":
                assert _rel_l2(grad[k], ref[k]) <= 1e-4, (name, k)
        flat = lambda d: np.concatenate([d[k].ravel() for k in kept])
        assert _rel_l2(flat(grad), flat(ref)) <= 1e-2, name
        assert _rel_l2(flat(ours), flat(want)) <= (
            2e-4 if name == "segmentor" else 1e-4), name
    assert t.opt["optimizer_S"].param_groups[0]["betas"] == (0.9, 0.999)
    assert t.opt["optimizer_G"].param_groups[0]["betas"] == (0.5, 0.999)


def _norm(x):
    return float(np.linalg.norm(x))


def test_gan_seg_step_matches_jax_float64(stepped):
    """The port's float64 step against the JAX package's float64 step,
    tensor by tensor: the six losses within 1e-12 relative; every gradient
    tensor and every updated parameter tensor of the three networks within
    1e-6 relative L2 (read through the port's checkpoint form, which rounds
    to float32: about 5e-8); a conv bias that an instance norm follows, with
    no gradient in exact arithmetic, within 1e-12 of its weight's gradient
    norm in both packages."""
    _, _, t64, init, _, (j64, lj64, lt64) = stepped
    assert list(lt64) == list(lj64)
    for k in lj64:
        assert float(lt64[k]) == pytest.approx(lj64[k], rel=1e-12), k
    for opt_name, (name,) in t64.optimizer_mapping.items():
        start = {k: v.astype(np.float64) for k, v in init[name].items()}
        grad = _gradients(t64, opt_name, start, np.float64)
        ref = _gradients(j64, opt_name, start, np.float64)
        ours = _flat(tck.state_dict_to_flax(t64.networks[name]), dtype=np.float64)
        want = _flat(j64.params[name], dtype=np.float64)
        assert ours.keys() == want.keys() == grad.keys() == ref.keys()
        for k in ref:
            if _zero_gradient(name, k):
                w = k[:-1] + ("kernel",)
                for g in (grad, ref):
                    assert _norm(g[k]) <= 1e-12 * _norm(g[w]), (name, k)
                continue
            assert _rel_l2(grad[k], ref[k]) <= 1e-6, (name, k)
            assert _rel_l2(ours[k], want[k]) <= 1e-6, (name, k)


def test_gan_seg_float32_step_matches_jax_float64(stepped):
    """The port's float32 step against the JAX package's float64 step,
    tensor by tensor: every gradient tensor within 1e-4 relative L2 and
    every updated parameter tensor within 1e-5, but the conv biases with no
    gradient in exact arithmetic, which one Adam step moves by the learning
    rate in the sign of the rounding noise."""
    _, t, _, init, _, (j64, _, _) = stepped
    for opt_name, (name,) in t.optimizer_mapping.items():
        start = {k: v.astype(np.float64) for k, v in init[name].items()}
        grad = _gradients(t, opt_name, init[name], np.float64)
        ref = _gradients(j64, opt_name, start, np.float64)
        ours = _flat(tck.state_dict_to_flax(t.networks[name]), dtype=np.float64)
        want = _flat(j64.params[name], dtype=np.float64)
        for k in ref:
            if not _zero_gradient(name, k):
                assert _rel_l2(grad[k], ref[k]) <= 1e-4, (name, k)
                assert _rel_l2(ours[k], want[k]) <= 1e-5, (name, k)


def test_gan_seg_step_without_identity_loss(rng):
    """``compute_identity: false`` (the shipped config): ``loss_G_idt`` is 0
    and the identity image still trains through ``loss_S_idt``; the
    discriminator takes no gradient from the joint half."""
    cfg = _gan_config(compute_identity=False)
    t = talg.define_model(cfg, Phase.TRAIN, "cpu")
    b = {k: torch.from_numpy(v) for k, v in _gan_batch(rng).items()}
    t.initialize_model_and_optimizer(b, cfg, _Args())
    d_before = [p.detach().clone() for p in t.networks["discriminator"].parameters()]
    stages = []
    outs, losses = t.train_step(b["real_A"], b["real_B"], b["real_A_seg"],
                                on_stage=stages.append)
    assert stages == ["D", "adam_D", "GS", "adam_G", "adam_S"]
    assert float(losses["G_idt"]) == 0.0 and float(losses["S_idt"]) > 0
    disc = t.networks["discriminator"]
    assert all(p.requires_grad for p in disc.parameters())
    # D's gradients are those of its own loss: one more step with the
    # joint half's gradient added would move it differently
    g_d = [p.grad.clone() for p in disc.parameters()]
    t2 = talg.define_model(cfg, Phase.TRAIN, "cpu")
    t2.initialize_model_and_optimizer(b, cfg, _Args())
    for p, q in zip(t2.networks["discriminator"].parameters(), d_before):
        p.data.copy_(q)
    fake = t2.generate(b["real_A"]).detach()
    loss_d = 0.5 * (t2.dg_loss(t2.discriminate(fake), False)
                    + t2.dg_loss(t2.discriminate(b["real_B"]), True))
    loss_d.backward()
    for g, p in zip(g_d, t2.networks["discriminator"].parameters()):
        torch.testing.assert_close(g, p.grad, rtol=1e-5, atol=1e-8)


def test_checkpoints_cross_packages(stepped, rng, tmp_path):
    """The six files: the port's read by the JAX package, and the JAX
    package's read by the port, for the three networks and the three
    optimizers, bit for bit; each network the JAX package restores from
    the port's file computes what the port's computes."""
    j, t, *_ = stepped
    x = rng.random((1, 1, 64, 64)).astype(np.float32)
    for opt_name, (net,) in t.optimizer_mapping.items():
        # port -> JAX
        p = tck.save_checkpoint(str(tmp_path / f"t_{net}_model.ckpt"),
                                {"epoch": 1, "model": t.network_state(net)["params"]})
        params = jck.restore_like(j.params[net], jck.load_checkpoint(p)["model"])
        ours = _flat(tck.state_dict_to_flax(t.networks[net]))
        for k, v in _flat(params).items():
            np.testing.assert_array_equal(v, ours[k])
        with torch.no_grad():
            want = t.networks[net](torch.from_numpy(x)).numpy()
        got = np.asarray(j.networks[net].apply({"params": params}, _nhwc(x)))
        np.testing.assert_allclose(got.transpose(0, 3, 1, 2), want, rtol=1e-5,
                                   atol=1e-5)
        p = tck.save_checkpoint(str(tmp_path / f"t_{opt_name}.ckpt"),
                                {"epoch": 1, "optimizer": t.optimizer_state(opt_name)})
        restored = jck.restore_like(j.opt_state[opt_name],
                                    jck.load_checkpoint(p)["optimizer"])
        assert int(restored.count) == 1
        assert float(restored.hyperparams["learning_rate"]) == pytest.approx(2e-4)
        state = t.optimizer_state(opt_name)["inner_state"]["1"]["0"]
        for moment in ("mu", "nu"):
            got = _flat(getattr(restored.inner_state[1][0], moment)[net])
            for k, v in _flat(state[moment][net]).items():
                np.testing.assert_array_equal(got[k], v)
        # JAX -> port
        jp = jck.save_checkpoint(str(tmp_path / f"j_{net}_model.ckpt"),
                                 {"epoch": 1, "model": j.params[net]})
        jo = jck.save_checkpoint(str(tmp_path / f"j_{opt_name}.ckpt"),
                                 {"epoch": 1, "optimizer": j.opt_state[opt_name]})
        fresh = talg.define_model(_gan_config(), Phase.TRAIN, "cpu")
        fresh.initialize_model_and_optimizer(None, _gan_config(), _Args())
        fresh.load_network_state(net, {"params": tck.load_checkpoint(jp)["model"]})
        fresh.load_optimizer_state(opt_name, tck.load_checkpoint(jo)["optimizer"])
        ours = _flat(tck.state_dict_to_flax(fresh.networks[net]))
        for k, v in _flat(j.params[net]).items():
            np.testing.assert_array_equal(ours[k], v)
        st = fresh.optimizer_state(opt_name)
        assert int(st["count"]) == 1
        for moment in ("mu", "nu"):
            ref = _flat(getattr(j.opt_state[opt_name].inner_state[1][0], moment)[net])
            for k, v in _flat(st["inner_state"]["1"]["0"][moment][net]).items():
                np.testing.assert_array_equal(v, ref[k])


# ---------------------------------------------------------------------------
# the engine on the gan-ves-seg task
# ---------------------------------------------------------------------------

def small_gan_config(root, n_real_b=2):
    """``configs/config_gan_ves_seg.yml`` with small networks at 32² ->
    64² on data made under ``root``."""
    globs = make_seg_dataset(str(root / "data"), n_graphs=4, n_backgrounds=2,
                             n_val=2, background_res=32, val_res=64,
                             device="cpu", max_edges=120, n_real_b=n_real_b,
                             real_b_res=32)
    cfg = point_config_at(load_config(CONFIG), globs, str(root / "runs"))
    for a in cfg["Train"]["data_augmentation"]:
        if a["name"] == "LoadGraphAndFilterByRandomRadiusd":
            a["image_resolutions"] = [[32, 32], [64, 64]]
        if a["name"] == "Resized":
            a["spatial_size"] = [32, 32]
    for a in cfg["Validation"]["data_augmentation"]:
        if a["name"] == "Resized":
            a["spatial_size"] = [64, 64]
    for key in ("image", "label"):
        cfg["Validation"]["data"][key].pop("split")
    model = cfg["General"]["model"]
    model.update(model_g=dict(SMALL_G), model_d=dict(SMALL_D), upshape=[64, 64])
    model["model_s"]["filters"] = [8, 16, 16, 16, 16]
    for post in (cfg["Train"]["post_processing"],
                 cfg["Validation"]["post_processing"]):
        post["prediction"][-1]["min_size"] = 10
    cfg["Train"].update(epochs=2, batch_size=2, save_interval=2)
    return cfg


def test_engine_trains_gan_seg_and_resumes(tmp_path):
    cfg = small_gan_config(tmp_path)
    steps = []
    run = train(_Args(), json.loads(json.dumps(cfg)), device="cpu",
                on_step=lambda *a: steps.append(a))
    assert [s[:2] for s in steps] == [(0, 1), (0, 2), (1, 1), (1, 2)]
    assert all(np.isfinite(list(s[2].values())).all() for s in steps)
    with open(os.path.join(run, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [r["epoch"] for r in rows] == ["0", "1"]
    assert {"train_S", "train_D_fake", "train_D_real", "train_G", "train_G_idt",
            "train_S_idt", "val_DiceBCELoss", "Validation_DSC"} <= set(rows[0])
    cks = set(os.listdir(os.path.join(run, "checkpoints")))
    six = {f"latest_{n}_model.ckpt" for n in ("generator", "discriminator",
                                              "segmentor")} \
        | {f"latest_optimizer_{o}.ckpt" for o in "GDS"}
    assert six <= cks
    assert {s.replace("latest", "2") for s in six} <= cks
    assert os.path.exists(os.path.join(run, "sample_train_latest.png"))
    # the JAX package reads the segmentor the port wrote
    seg = jck.load_checkpoint(os.path.join(run, "checkpoints",
                                           "latest_segmentor_model.ckpt"))
    assert seg["epoch"] == 2 and "input_block" in seg["model"]
    # resume from the written checkpoints (the engine's fork of the run
    # directory is tests/test_torch_train.py's)
    snap = load_config(os.path.join(run, "config.yml"))

    class Resume(_Args):
        start_epoch = 2

    model = talg.define_model(snap, Phase.TRAIN, "cpu")
    model.initialize_model_and_optimizer(None, snap, Resume())
    want = tck.load_checkpoint(os.path.join(run, "checkpoints",
                                            "latest_generator_model.ckpt"))
    got = _flat(tck.state_dict_to_flax(model.networks["generator"]))
    for k, v in _flat(want["model"]).items():
        np.testing.assert_array_equal(got[k], v)
    opt = tck.load_checkpoint(os.path.join(run, "checkpoints",
                                           "latest_optimizer_S.ckpt"))["optimizer"]
    st = model.optimizer_state("optimizer_S")
    assert int(st["count"]) == int(opt["count"]) == 4
    for k, v in _flat(opt["inner_state"]["1"]["0"]["mu"]).items():
        np.testing.assert_array_equal(
            _flat(st["inner_state"]["1"]["0"]["mu"])[k], v)
