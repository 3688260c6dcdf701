"""Port parity for NICE-GAN: the layer-instance norm, the spectral-norm
layers and their initial ``u``, the JAX channel order of the pixel
shuffle, the adaILN block, both networks, two consecutive training steps
against the JAX package's, the checkpoints across the two packages, ``test``
on a JAX checkpoint, ``define_model``'s dispatch, and the engine and the
``test`` CLI on ``configs/config_nice_gan.yml``.

Small networks on the CPU (``ngf`` and ``ndf`` 8, two adaILN blocks) at
128² (below it the global head ``out1`` is empty and its MSE NaN), batch 2,
with the JAX package's parameters carried into the port and the draws
(background, ``u``) and the spectral norms' ``u`` injected where a
comparison needs the same state. Tolerances: each layer and network within
1e-12 of JAX's largest value in float64 (with parameters moved off their
initial values); the initial ``u`` within 3 float32 ulps of JAX's at every
width the shipped config uses; two steps in float64 against the JAX
package's float64 step, losses within 1e-12 relative, every gradient,
updated parameter and ``u`` within 1e-6 relative L2; checkpoints bit for
bit; ``test`` on a JAX checkpoint within 1e-5 of JAX's ``inference``.
"""
import contextlib
import copy
import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octa_tpu.io import checkpoints as jck
from octa_tpu.models import layers as jlayers
from octa_tpu.models import nice_gan_nets as jnice
from octa_tpu.train import algorithms as jalg
from octa_tpu.utils.enums import Phase as JPhase
from octa_tpu_torch.io import checkpoints as tck
from octa_tpu_torch.models import layers as tlayers
from octa_tpu_torch.models import nice_gan_nets as tnice
from octa_tpu_torch.models import registry as treg
from octa_tpu_torch.train import algorithms as talg
from octa_tpu_torch.train import gan_algorithms as tgal
from octa_tpu_torch.utils.config import load_config
from octa_tpu_torch.utils.enums import Phase
from tests.test_torch_cut import (
    ROOT,
    Args,
    checkpoints_cross_packages,
    engine_round_trip,
    flat,
    jax_float64,
    jax_trainer,
    nchw,
    nhwc,
    port_trainer,
    rel_l2,
    small_engine_config,
    to64,
)

RES, BATCH, NGF, NDF, BLOCKS = 128, 2, 8, 8, 2
SMALL_GEN = {"name": "NiceResnetGenerator", "input_nc": 1, "output_nc": 1,
             "ngf": NGF, "n_blocks": BLOCKS, "img_size": RES, "light": True}
SMALL_DIS = {"name": "NiceDiscriminator", "input_nc": 1, "ndf": NDF,
             "n_layers": 7}
NICE_LOSSES = ("G", "G_A", "G_B", "cycle_A", "cycle_B", "idt_A", "idt_B",
               "D_A", "D_B")
NETS = ("gen2A", "disB", "gen2B", "disA")
U_WIDTHS = (1, 64, 128, 256, 512, 1024, 2048)  # out-features in the config


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this file (see ``test_torch_cut.py``)."""
    torch.sqrt(torch.rand(1 << 20))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def x64():
    """JAX in float64, with ``jnp.float32`` standing for float64 (the
    norms cast to it)."""
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "float32", jnp.float64)
        yield


_JITTED: dict = {}


@contextlib.contextmanager
def jitted_flax():
    """flax's ``init`` and ``apply`` jitted for the block, one program for
    each module (equal modules share it) and keyword set: op by op, the JAX
    trainers' dry pass and inference compile one program an operation and
    shape."""
    init, apply = flax.linen.Module.init, flax.linen.Module.apply

    def jitted(fn, self, kwargs):
        key = (fn.__name__, self, repr(sorted(kwargs.items())),
               jax.config.jax_enable_x64)
        if key not in _JITTED:
            _JITTED[key] = jax.jit(lambda v, *a: fn(self, v, *a, **kwargs))
        return _JITTED[key]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Module, "init", lambda self, r, *a, **kw:
                   jitted(init, self, kw)(r, *a))
        mp.setattr(flax.linen.Module, "apply", lambda self, v, *a, **kw:
                   jitted(apply, self, kw)(v, *a))
        yield


def port_params(tm, seed=0):
    """Parameters for a layer in both packages: the port's initialisation
    of ``tm`` as a flax tree (float32), moved off its constants."""
    tlayers.kaiming_normal_(tm, torch.Generator().manual_seed(seed))
    return moved(tck.state_dict_to_flax(tm), seed)


def moved(params, seed=0):
    """``params`` with the leaves that start at constants (``rho``, the
    norms' ``gamma`` and ``beta``, ``lamda``) moved off them, in float32."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("rho", "gamma", "beta", "lamda"):
                out[k] = (v + rng.normal(0, 0.5, v.shape)).astype(np.float32)
            else:
                out[k] = v
        return out

    return walk(params)


def set_u(module, spectral: dict):
    """The ``u`` of the JAX ``spectral`` collection into the port's
    buffers."""
    with torch.no_grad():
        for path, u in flat(spectral, dtype=np.float64).items():
            buf = module.get_submodule(".".join(path[:-1])).u
            buf.copy_(torch.from_numpy(u))


def assert_close(a, b, tol=1e-12):
    """``max |a - b| <= tol * max |b|``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-30), \
        np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def assert_u_equal(module, spectral, tol):
    for path, u in flat(spectral, dtype=np.float64).items():
        got = module.get_submodule(".".join(path[:-1])).u.double().numpy()
        assert rel_l2(got, u) <= tol, (path, rel_l2(got, u))


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", U_WIDTHS)
def test_initial_u_matches_jax(width):
    """The initial ``u`` without JAX against ``jax.random.normal(PRNGKey(0),
    (width,), float32)``: within 3 float32 ulps of each value (XLA's own
    ``log1p`` rounds otherwise), most of them equal."""
    ref = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (width,),
                                       jnp.float32))
    got = tlayers.initial_u(width)
    assert got.dtype == np.float32 and got.shape == (width,)
    err = np.abs(got.astype(np.float64) - ref)
    assert (err <= 3 * np.spacing(np.abs(ref))).all(), err.max()
    assert (err == 0).mean() >= 0.9


@pytest.mark.parametrize("adaptive", [False, True])
def test_layer_instance_norm_matches_jax(adaptive):
    """The ILN with its own affine and adaILN with per-sample ``gamma`` /
    ``beta``, in float64, moved parameters; biased variances."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((BATCH, 6, 5, 7)) * 3 + 1).astype(np.float32)
    g, b = (rng.standard_normal((BATCH, 6)).astype(np.float32)
            for _ in range(2))
    jm = jlayers.LayerInstanceNorm(rho_init=(3.2, 1.0) if adaptive
                                   else (1.0, 3.2), affine=not adaptive)
    tm = tlayers.LayerInstanceNorm(6, rho_init=jm.rho_init,
                                   affine=not adaptive)
    assert tm.raw_leaves == ("rho", "gamma", "beta")
    params = port_params(tm)
    tck.load_flax_params(tm, params)
    tm.double()
    extra = (g, b) if adaptive else ()
    with x64(), jitted_flax():
        ref = jm.apply({"params": to64(params)},
                       nhwc(x.astype(np.float64)),
                       *(jnp.asarray(v, jnp.float64) for v in extra))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).double(),
                 *(torch.from_numpy(v).double() for v in extra))
    assert_close(got.numpy(), nchw(ref))


@pytest.mark.parametrize("update_stats", [True, False])
@pytest.mark.parametrize("kind", ["conv", "dense"])
def test_spectral_norm_layers_match_jax(kind, update_stats):
    """``SpectralNormConv`` (4x4, stride 2) and ``SpectralNormDense`` in
    float64 from the same ``u``: the output, and the new ``u`` (kept with
    ``update_stats``, else the old one); sigma takes no gradient."""
    rng = np.random.default_rng(4)
    if kind == "conv":
        x = rng.standard_normal((BATCH, 5, 12, 12)).astype(np.float32)
        jm = jlayers.SpectralNormConv(7, (4, 4), (2, 2))
        tm = tlayers.SpectralNormConv(5, 7, 4, 2)
        jx = nhwc(x)
    else:
        x = rng.standard_normal((BATCH, 9)).astype(np.float32)
        jm, tm = jlayers.SpectralNormDense(7), tlayers.SpectralNormDense(9, 7)
        jx = jnp.asarray(x)
    params = jax.tree.map(lambda a: a + rng.normal(0, 0.1, a.shape).astype(
        np.float32), port_params(tm))
    u0 = rng.standard_normal(7).astype(np.float32)
    tck.load_flax_params(tm, params)
    tm.double()
    assert "u" not in tm.state_dict()
    set_u(tm, {"u": u0})
    with x64():
        ref, new = jm.apply({"params": to64(params),
                             "spectral": {"u": jnp.asarray(u0, jnp.float64)}},
                            jnp.asarray(np.asarray(jx), jnp.float64),
                            update_stats=update_stats, mutable=["spectral"])
    xt = torch.from_numpy(x).double()
    sigma, _ = tlayers._power_iteration(tm.weight.detach().reshape(7, -1),
                                        tm.u.clone())
    got = tm(xt, update_stats=update_stats)
    want = nchw(ref) if kind == "conv" else np.asarray(ref)
    assert_close(got.detach().numpy(), want)
    assert_close(tm.u.numpy(), new["spectral"]["u"])
    assert update_stats == (not np.allclose(tm.u.numpy(), u0))
    # the weight's gradient treats sigma as a constant
    got.sum().backward()
    w = tm.weight.detach().clone().requires_grad_()
    op = (lambda x, w: torch.nn.functional.conv2d(x, w, tm.bias.detach(), 2)) \
        if kind == "conv" else (lambda x, w: torch.nn.functional.linear(
            x, w, tm.bias.detach()))
    op(xt, w / sigma).sum().backward()
    torch.testing.assert_close(tm.weight.grad, w.grad, rtol=1e-12, atol=0)


def test_pixel_shuffle_in_jax_channel_order():
    """The port's pixel shuffle equals JAX's, whose output channel is the
    minor index, and differs from ``torch.nn.functional.pixel_shuffle``."""
    x = np.random.default_rng(5).standard_normal((2, 12, 3, 4)).astype(
        np.float32)
    ref = nchw(jnice.pixel_shuffle(nhwc(x), 2))
    got = tnice.pixel_shuffle(torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(
        torch.nn.functional.pixel_shuffle(torch.from_numpy(x), 2).numpy(), ref)


def test_resnet_adailn_block_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((BATCH, 16, 9, 9)).astype(np.float32)
    g, b = (rng.standard_normal((BATCH, 16)).astype(np.float32)
            for _ in range(2))
    jm = jnice.ResnetAdaILNBlock(16)
    tm = tnice.ResnetAdaILNBlock(16)
    params = port_params(tm)
    tck.load_flax_params(tm, params)
    tm.double()
    with x64(), jitted_flax():
        ref = jm.clone(dtype=jnp.float64).apply(
            {"params": to64(params)}, nhwc(x.astype(np.float64)),
            jnp.asarray(g, jnp.float64), jnp.asarray(b, jnp.float64))
    with torch.no_grad():
        got = tm(*(torch.from_numpy(v).double() for v in (x, g, b)))
    assert_close(got.numpy(), nchw(ref))


@pytest.mark.parametrize("light", [True, False])
def test_generator_matches_jax(light):
    """``NiceResnetGenerator`` on an encoding ``z`` [B, 2 ndf, S, S] with
    and without ``light`` (the dense head on the map flattened
    channels-last, sized by ``img_size``), float64, moved parameters."""
    size = 32
    z = np.random.default_rng(7).standard_normal(
        (BATCH, 2 * NDF, size // 4, size // 4)).astype(np.float32)
    cfg = dict(SMALL_GEN, light=light, img_size=size)
    cfg.pop("name")
    jm = jnice.NiceResnetGenerator(**cfg)
    tm = tnice.NiceResnetGenerator(2 * NDF, **cfg)
    params = port_params(tm)
    tck.load_flax_params(tm, params)
    tm.double()
    assert tm.fc0.in_features == (4 * NGF if light
                                  else (size // 4) ** 2 * 4 * NGF)
    with x64(), jitted_flax():
        ref = jm.clone(dtype=jnp.float64).apply({"params": to64(params)},
                                                nhwc(z.astype(np.float64)))
    with torch.no_grad():
        got = tm(torch.from_numpy(z).double())
    assert got.shape == (BATCH, 1, size, size)
    assert_close(got.numpy(), nchw(ref))


@pytest.fixture(scope="module")
def discriminator():
    rng = np.random.default_rng(8)
    x = rng.random((BATCH, 1, RES, RES)).astype(np.float32)
    jm = jnice.NiceDiscriminator(input_nc=1, ndf=NDF)
    tm = tnice.NiceDiscriminator(input_nc=1, ndf=NDF)
    params = port_params(tm)
    assert set(params) >= {"cam_fc_kernel", "lamda"}
    # JAX's initial u of each layer
    spectral = {n: {"u": np.asarray(jax.random.normal(
        jax.random.PRNGKey(0), (m.out_channels,), jnp.float32))}
        for n, m in tm.named_modules()
        if isinstance(m, tlayers.SpectralNormConv)}
    return jm, params, spectral, x


@pytest.mark.parametrize("update_stats", [True, False])
def test_discriminator_matches_jax(discriminator, update_stats):
    """``NiceDiscriminator``'s five outputs and every new ``u`` in float64
    from JAX's initial ``u``, with ``lamda`` and the norms moved off their
    initial values (so that the CAM branch counts). Without
    ``update_stats`` (the port's inference) the outputs are the same and
    every ``u`` stays (the JAX package's inference discards its new
    collection)."""
    jm, params, spectral, x = discriminator
    tm = tnice.NiceDiscriminator(input_nc=1, ndf=NDF)
    tck.load_flax_params(tm, params)
    tm.double()
    set_u(tm, spectral)
    with x64():
        apply = jax.jit(lambda v, x: jm.clone(dtype=jnp.float64).apply(
            v, x, mutable=["spectral"]))
        ref, new = apply({"params": to64(params), "spectral": to64(spectral)},
                         nhwc(x.astype(np.float64)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).double(), update_stats=update_stats)
    assert [tuple(t.shape) for t in got] == [
        (BATCH, 1, 14, 14), (BATCH, 1, 2, 2), (BATCH, 1),
        (BATCH, 1, RES // 4, RES // 4), (BATCH, 2 * NDF, RES // 4, RES // 4)]
    for a, b in zip(got, ref):
        b = np.asarray(b)
        assert_close(a.numpy(), nchw(b) if b.ndim == 4 else b)
    assert_u_equal(tm, new["spectral"] if update_stats else spectral, 1e-12)


def test_kaiming_init_of_nice_parameters():
    """``kaiming_normal_`` gives NICE-GAN's parameters JAX's initial
    values: ``cam_fc_kernel`` drawn first (the network's own parameter) with
    fan-in ``4 ndf``, ``lamda`` 0, every ``rho`` its ``rho_init``, ILN
    ``gamma`` 1 and ``beta`` 0, every ``u`` :func:`initial_u`; the networks'
    parameter trees have JAX's names and shapes."""
    d = tnice.NiceDiscriminator(ndf=NDF)
    with torch.no_grad():
        d.lamda.fill_(3.0)
        d.enc1.u.fill_(2.0)
    tlayers.kaiming_normal_(d, torch.Generator().manual_seed(5))
    want = torch.randn((4 * NDF, 1), generator=torch.Generator().manual_seed(
        5)) * (2.0 / (4 * NDF)) ** 0.5
    assert torch.equal(d.cam_fc_kernel.detach(), want)
    assert float(d.lamda.detach()) == 0.0
    for m in d.modules():
        if isinstance(m, tlayers.SpectralNormConv):
            np.testing.assert_array_equal(m.u.numpy(), tlayers.initial_u(
                m.out_channels))
    g = tnice.NiceResnetGenerator(2 * NDF, ngf=NGF, n_blocks=BLOCKS)
    with torch.no_grad():
        for p in g.parameters():
            p.fill_(7.0)
    tlayers.kaiming_normal_(g, torch.Generator().manual_seed(6))
    assert torch.equal(g.up0_iln.rho, torch.tensor([[1.0, 3.2]]).expand(
        4 * NGF, 2))
    assert torch.equal(g.upblock1_1.norm2.rho, torch.tensor(
        [[3.2, 1.0]]).expand(4 * NGF, 2))
    assert torch.equal(g.up2_iln_1b.gamma, torch.ones(NGF))
    assert torch.equal(g.up2_iln_0a.beta, torch.zeros(2 * NGF))
    assert torch.equal(g.up2_sub_0.bias, torch.zeros(8 * NGF))
    # the parameter trees have JAX's names and shapes
    for tnet, jnet, x in (
            (d, jnice.NiceDiscriminator(ndf=NDF), jnp.zeros((1, RES, RES, 1))),
            (g, jnice.NiceResnetGenerator(ngf=NGF, n_blocks=BLOCKS),
             jnp.zeros((1, RES // 4, RES // 4, 2 * NDF)))):
        shapes = jax.eval_shape(lambda x, jnet=jnet: jnet.init(
            jax.random.PRNGKey(0), x), x)["params"]
        ours = flat(tck.state_dict_to_flax(tnet))
        assert {k: v.shape for k, v in ours.items()} == {
            k: tuple(v.shape) for k, v in flat_shapes(shapes).items()}


def flat_shapes(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_shapes(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def test_amp_dtypes_follow_jax():
    """Under bf16 autocast: the spectral-norm convs compute in float32 (the
    discriminator's outputs and ``z`` are float32), the generator's convs in
    bf16 with its ``Dense`` head in float32 and a float32 output; the ILN
    returns its input's dtype."""
    d = tnice.NiceDiscriminator(ndf=NDF)
    g = tnice.NiceResnetGenerator(2 * NDF, ngf=NGF, n_blocks=BLOCKS,
                                  img_size=RES)
    x = torch.rand(1, 1, RES, RES)
    seen = {}
    g.fc1.register_forward_hook(lambda m, i, o: seen.update(fc=o.dtype))
    g.upblock1_0.conv1.register_forward_hook(
        lambda m, i, o: seen.update(conv=o.dtype))
    d.enc1.register_forward_hook(lambda m, i, o: seen.update(sn=o.dtype))
    d.conv1x1.register_forward_hook(lambda m, i, o: seen.update(c11=o.dtype))
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        out0, out1, cam, heat, z = d(x)
        y = g(z)
    assert seen == {"fc": torch.float32, "conv": torch.bfloat16,
                    "sn": torch.float32, "c11": torch.bfloat16}
    assert all(t.dtype == torch.float32 for t in (out0, out1, cam, heat, z, y))
    iln = tlayers.LayerInstanceNorm(4)
    assert iln(torch.rand(1, 4, 3, 3).bfloat16()).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# two training steps against the JAX package's
# ---------------------------------------------------------------------------

def nice_config():
    return {"General": {"task": "gan-ves-seg", "seed": 3, "amp": False,
                        "inference": "gen2B",
                        "model": {"name": "NiceGAN",
                                  "gen2A_config": dict(SMALL_GEN),
                                  "gen2B_config": dict(SMALL_GEN),
                                  "disA_config": dict(SMALL_DIS),
                                  "disB_config": dict(SMALL_DIS),
                                  "adv_weight": 1, "cycle_weight": 10,
                                  "recon_weight": 1}},
            "Train": {"lr": 2e-4, "weight_decay": 1e-3, "epochs": 3,
                      "epochs_decay": 1, "batch_size": BATCH,
                      "loss_ad": "MSELoss", "loss_cycle": "L1Loss"},
            "Output": {"save_dir": "unused"}}


def flax64(module, tensors) -> dict:
    """``tensors`` (float64, under ``module``'s parameter names) flat under
    the flax names and layouts, in float64: the checkpoint mapping writes
    float32, so each tensor goes through it as its float32 rounding and
    the remainder, both exact in float32, and the two are summed."""
    hi = {k: v.float() for k, v in tensors.items()}
    lo = {k: (v - hi[k].double()).float() for k, v in tensors.items()}
    a, b = (flat(tck.state_dict_to_flax(module, x), dtype=np.float64)
            for x in (hi, lo))
    return {k: a[k] + b[k] for k in a}


def port_gradients(t):
    """The gradients of the step just taken (each network's last
    backward), flat under the flax names, in float64."""
    return {n: flax64(net, {k: p.grad for k, p in net.named_parameters()})
            for n, net in t.networks.items()}


def jax_gradients(j, before, p0, b1=0.5, wd=1e-3):
    """The gradients of the JAX step just taken, from Adam's first moments
    ``m = b1 m_before + (1 - b1) (g + wd p0)``, ``p0`` the parameters the
    step began from; flat, in float64."""
    out = {}
    for opt_name, nets in j.optimizer_mapping.items():
        for n in nets:
            m = flat(j.opt_state[opt_name].inner_state[1][0].mu[n],
                     dtype=np.float64)
            out[n] = {k: (m[k] - b1 * before.get(n, {}).get(k, 0.0))
                      / (1 - b1) - wd * p0[n][k] for k in m}
    return out


def jax_moments(j):
    return {n: flat(j.opt_state[o].inner_state[1][0].mu[n], dtype=np.float64)
            for o, nets in j.optimizer_mapping.items() for n in nets}


@pytest.fixture(scope="module")
def nice_stepped():
    """The JAX NICE-GAN trainer in float64 and the port's in float64, from
    the same parameters, ``u`` and draws, each after one step and after a
    second one: losses, moments and parameters after each step, and every
    ``u``."""
    rng = np.random.default_rng(51)
    cfg = nice_config()
    steps = [[rng.random((BATCH, 1, RES, RES)).astype(np.float32)
              for _ in range(4)] for _ in range(2)]
    init_batch = {"real_A": steps[0][0]}
    with jitted_flax():
        j32 = jax_trainer(cfg, init_batch)
    start = jax.tree.map(np.asarray, j32.params)
    spectral = {n: jax.tree.map(np.asarray, j32.mutables[n]["spectral"])
                for n in ("disA", "disB")}
    t = port_trainer(cfg, start, torch.float64, init_batch,
                     heads=("gen2A", "gen2B"))
    assert list(t.networks) == list(NETS)
    for n in ("disA", "disB"):
        set_u(t.networks[n], spectral[n])
    port = []
    for inputs in steps:
        images, losses = t.train_step(*(torch.from_numpy(x).double()
                                        for x in inputs))
        port.append(({k: float(v) for k, v in losses.items()},
                     [x.numpy() for x in images], port_gradients(t),
                     {n: flax64(net, dict(net.named_parameters()))
                      for n, net in t.networks.items()}))
    ref = []
    with x64():
        j = jax_float64(j32, cfg, start)
        p0, moments = {n: flat(start[n], dtype=np.float64) for n in start}, {}
        for inputs in steps:
            mut = {n: j.mutables[n] for n in ("disA", "disB")}
            j.params, new_mut, j.opt_state, images, losses = j._step(
                j.params, mut, j.opt_state,
                *(nhwc(x.astype(np.float64)) for x in inputs))
            j.mutables.update(new_mut)
            ref.append(({k: float(v) for k, v in losses.items()},
                        [nchw(x) for x in images],
                        jax_gradients(j, moments, p0),
                        {n: flat(j.params[n], dtype=np.float64)
                         for n in j.params}))
            p0, moments = ref[-1][3], jax_moments(j)
        j.params = jax.tree.map(np.asarray, j.params)
        j.opt_state = jax.tree.map(np.asarray, j.opt_state)
        j.mutables = jax.tree.map(np.asarray, j.mutables)
    return j, t, port, ref, start


@pytest.mark.parametrize("step", [0, 1])
def test_nice_steps_match_jax_float64(nice_stepped, step):
    """Each of two consecutive steps (the D step, then the G step through
    the new discriminators; four power iterations a spectral norm) in
    float64 against the JAX package's: the nine losses within 1e-12
    relative, the four images, every gradient (the port's from the
    parameters, JAX's from Adam's first moments) and updated parameter
    within 1e-6 relative L2, and after the second step every ``u``. A
    gradient tensor that is zero in exact arithmetic (``conv1x1`` while
    ``lamda`` is 0, in the first step) is held to 1e-12 of its network's
    gradient in both."""
    j, t, port, ref, start = nice_stepped
    (lt, imt, gt, pt), (lj, imj, gj, pj) = port[step], ref[step]
    assert list(lt) == list(NICE_LOSSES) and set(lj) == set(NICE_LOSSES)
    for k in NICE_LOSSES:
        assert lt[k] == pytest.approx(lj[k], rel=1e-12), k
    for a, b in zip(imt, imj):
        assert_close(a, b, 1e-9)
    zero = set()
    for net in NETS:
        assert gt[net].keys() == gj[net].keys() == pt[net].keys() \
            == pj[net].keys()
        total = np.sqrt(sum(float(np.sum(v ** 2)) for v in gj[net].values()))
        for k in gj[net]:
            if np.linalg.norm(gj[net][k]) <= 1e-12 * total:
                zero.add((net, k))
                assert np.linalg.norm(gt[net][k]) <= 1e-12 * total, (net, k)
                continue
            assert rel_l2(gt[net][k], gj[net][k]) <= 1e-6, \
                (net, k, rel_l2(gt[net][k], gj[net][k]))
            assert rel_l2(pt[net][k], pj[net][k]) <= 1e-6, (net, k)
    assert zero == ({(d, ("conv1x1", leaf)) for d in ("disA", "disB")
                     for leaf in ("kernel", "bias")} if step == 0 else set())
    if step == 1:
        for n in ("disA", "disB"):
            assert_u_equal(t.networks[n], j.mutables[n]["spectral"], 1e-6)


def test_nice_checkpoints_cross_packages(nice_stepped, tmp_path):
    """The four networks (``rho``, ``gamma``, ``beta``, ``cam_fc_kernel``
    and ``lamda`` among their leaves) and ``G_optim`` / ``D_optim``, both
    ways, bit for bit; no ``u`` is written."""
    j, t, _, _, _ = nice_stepped
    twin = copy.deepcopy(t)
    for net in twin.networks.values():
        net.float()
    checkpoints_cross_packages(twin, j, tmp_path, steps=2)
    leaves = {k[-1] for k in flat(twin.network_state("disA")["params"])}
    assert {"cam_fc_kernel", "lamda", "kernel", "bias"} == leaves
    gen_leaves = {k[-1] for k in flat(twin.network_state("gen2B")["params"])}
    assert {"rho", "gamma", "beta", "kernel", "bias"} == gen_leaves
    # a raw leaf on a module that does not name it still raises
    bad = {"enc0": {"lamda": np.zeros(1, np.float32)}}
    with pytest.raises(KeyError, match="unknown parameter kind"):
        tck.flax_to_state_dict(bad, twin.networks["disA"])


def test_port_test_matches_jax_inference_on_a_jax_checkpoint(nice_stepped,
                                                              tmp_path):
    """The JAX trainer's ``gen2B`` and ``disA`` after its two steps, saved
    by the JAX package: the port's ``test`` model loads both (the paired
    discriminator from the run directory) with ``u`` at its initial value,
    and translates an image within 1e-5 of the JAX package's ``test`` model
    on the same files; inference keeps no ``u``."""
    j = nice_stepped[0]
    ckdir = tmp_path / "run" / "checkpoints"
    for net in ("gen2B", "disA"):
        jck.save_checkpoint(str(ckdir / f"latest_{net}_model.ckpt"), {
            "epoch": 2, "model": jax.tree.map(
                lambda a: np.asarray(a, np.float32), j.params[net])})
    cfg = nice_config()
    cfg["Output"]["save_dir"] = str(tmp_path / "run")

    class Latest(Args):
        epoch = "latest"

    x = np.random.default_rng(9).random((1, 1, RES, RES)).astype(np.float32)
    tm = talg.define_model(cfg, Phase.TEST, "cpu")
    assert list(tm.networks) == ["disA"]
    tm.initialize_model_and_optimizer({"image": torch.from_numpy(x)}, cfg,
                                      Latest(), phase=Phase.TEST)
    assert list(tm.networks) == ["gen2B", "disA"]
    for net in ("gen2B", "disA"):
        ours = flat(tck.state_dict_to_flax(tm.networks[net]))
        for k, v in flat(j.params[net], dtype=np.float32).items():
            np.testing.assert_array_equal(ours[k], v)
    u_before = tm.networks["disA"].enc1.u.clone()
    out, _ = tm.inference({"image": torch.from_numpy(x)}, {})
    assert torch.equal(tm.networks["disA"].enc1.u, u_before)
    np.testing.assert_array_equal(u_before.numpy(), tlayers.initial_u(2 * NDF))

    jm = jalg.define_model(cfg, JPhase.TEST)
    with jitted_flax():
        jm.initialize_model_and_optimizer({"image": x}, cfg, Latest(),
                                          phase=JPhase.TEST)
        ref, _ = jm.inference({"image": x}, {})
    assert out["prediction"][0].shape == (1, RES, RES)
    np.testing.assert_allclose(out["prediction"][0], ref["prediction"][0],
                               atol=1e-5)


# ---------------------------------------------------------------------------
# dispatch, the engine, the test CLI
# ---------------------------------------------------------------------------

def test_define_model_dispatches_nice_gan():
    """``configs/config_nice_gan.yml`` builds ``NiceGAN`` with its weights;
    after the initialisation at 128² (the generators sized by a dry pass of
    a discriminator) the four networks have JAX's parameter counts, in JAX's
    order; ``test`` builds ``gen2B`` and ``disA``; an unknown network
    raises."""
    cfg = load_config(os.path.join(ROOT, "configs", "config_nice_gan.yml"))
    t = talg.define_model(cfg, Phase.TRAIN, "cpu")
    assert isinstance(t, tgal.NiceGANAlgorithm)
    assert (t.adv_weight, t.cycle_weight, t.recon_weight) == (1, 10, 1)
    t.initialize_model_and_optimizer({"real_A": torch.zeros(1, 1, 128, 128)},
                                     cfg, Args())
    assert list(t.networks) == list(NETS)
    assert set(t.opt) == {"G_optim", "D_optim"}
    j = jalg.define_model(cfg, JPhase.TRAIN)
    key = jax.random.PRNGKey(0)
    shapes = {"disA": (1, 128, 128, 1), "disB": (1, 128, 128, 1),
              "gen2A": (1, 32, 32, 128), "gen2B": (1, 32, 32, 128)}
    want = {n: sum(int(np.prod(v.shape)) for v in jax.tree.leaves(
        jax.eval_shape(lambda x, n=n: j.networks[n].init(key, x),
                       jax.ShapeDtypeStruct(shapes[n], jnp.float32))["params"]))
        for n in NETS}
    assert t.num_parameters() == want
    test_model = talg.define_model(cfg, Phase.TEST, "cpu")
    assert list(test_model.networks) == ["disA"]
    with pytest.raises(KeyError, match="unknown network"):
        treg.build_network({"name": "NoSuchNet"})


def test_load_network_for_inference_refuses_a_nice_generator(tmp_path):
    """The generator decodes an encoding, not an image: the single-network
    loader refuses it with a ``ValueError`` (the JAX package fails there
    with a shape error)."""
    with pytest.raises(ValueError, match="encoding, not an image"):
        tck.load_network_for_inference(str(tmp_path / "x.ckpt"),
                                       dict(SMALL_GEN), device="cpu")


def test_engine_trains_nice_gan_resumes_and_translates(tmp_path):
    """One epoch through the engine on a shrunk ``config_nice_gan.yml`` at
    128², a resume and ``test`` with ``gen2B`` and ``disA``."""
    cfg = small_engine_config(
        tmp_path, "config_nice_gan.yml",
        {"gen2A_config": dict(SMALL_GEN), "gen2B_config": dict(SMALL_GEN),
         "disA_config": dict(SMALL_DIS), "disB_config": dict(SMALL_DIS)},
        res=RES)
    model = engine_round_trip(tmp_path, cfg, NICE_LOSSES, NETS,
                              ("G_optim", "D_optim"), "gen2B", res=RES)
    # the resumed trainer starts its u again, as the JAX package's does
    np.testing.assert_array_equal(model.networks["disB"].dis1_1.u.numpy(),
                                  tlayers.initial_u(32 * NDF))
    # validation translates with gen2B on disA's encoding: ``loss_cycle``
    runs = tmp_path / "runs"
    snap = load_config(str(runs / sorted(os.listdir(runs))[0] / "config.yml"))
    val = talg.define_model(snap, Phase.VALIDATION, "cpu")
    x = torch.rand(1, 1, RES, RES, generator=torch.Generator().manual_seed(0))
    val.initialize_model_and_optimizer({"image": x}, snap, Args(),
                                       phase=Phase.VALIDATION)
    outputs, losses = val.inference({"image": x, "label": x}, {},
                                    phase=Phase.VALIDATION)
    assert list(losses) == ["loss_cycle"] and float(losses["loss_cycle"]) > 0
    assert outputs["prediction"][0].shape == (1, RES, RES)
