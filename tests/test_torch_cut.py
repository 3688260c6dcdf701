"""Port parity for CUT and the contrastive parts the GAN zoo's CUT family
shares: the generator's feature taps, ``PatchSampleF``, ``PatchNCELoss``,
``l2_normalize``, the ``Dense`` <-> ``nn.Linear`` checkpoint mapping and
kaiming initialisation of a linear layer; one CUT step against the JAX
package's; the checkpoints across the two packages; ``define_model``'s
dispatch; the engine and the ``test`` CLI on ``configs/config_cut.yml``.

Small networks on the CPU (``ResnetGenerator`` with ``ngf`` 4 and 5 blocks,
so that tap 16 exists; PatchGAN with ``ndf`` 8; projector width 16) at
32², batch 2, 128 patches (the levels of 8 x 8 positions take all 64), with
the JAX package's initial parameters carried into the port and the patch
ids injected into both. Tolerances: taps within 1e-5 of their largest
value and projections within 1e-5 in float32, the loss within 1e-6; in float64 against the JAX package's
float64 step, the losses within 1e-12 relative and every gradient (from
Adam's first moment) and updated parameter tensor within 1e-6 relative L2
(a tensor with no gradient in exact arithmetic, a conv bias that an
instance norm follows, within 1e-12 of its network's gradient norm in
both, and the projector's level 0, flat but for the L2 norm's eps, within
1e-7; in both cases the two packages within 1e-12 of each other); the port's float32 step against the same,
losses 1e-5, gradients 1e-4 and parameters 1e-5 (a tensor that starts at
zero, a bias, is Adam's first update alone, ``lr g / (|g| + eps)`` by
element, which carries the float32 error of a gradient's small elements:
it is held to the gradients' 1e-4). Checkpoints agree bit for bit. The helpers here serve
``test_torch_negcut.py`` and ``test_torch_dclgan.py`` too.
"""
import copy
import csv
import json
import os

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octa_tpu.io import checkpoints as jck
from octa_tpu.models import layers as jlayers
from octa_tpu.models import resnet_gan as jgan
from octa_tpu.train import algorithms as jalg
from octa_tpu.utils import losses as jl
from octa_tpu.utils.enums import Phase as JPhase
from octa_tpu_torch import test as ttest
from octa_tpu_torch.io import checkpoints as tck
from octa_tpu_torch.io.images import load_png_gray8
from octa_tpu_torch.models import layers as tlayers
from octa_tpu_torch.models import registry as treg
from octa_tpu_torch.models import resnet_gan as tgan
from octa_tpu_torch.tools.seg_data import make_seg_dataset, point_config_at
from octa_tpu_torch.train import algorithms as talg
from octa_tpu_torch.train import gan_algorithms as tgal
from octa_tpu_torch.train.engine import train
from octa_tpu_torch.utils import losses as tl
from octa_tpu_torch.utils.config import load_config
from octa_tpu_torch.utils.enums import Phase

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_G = {"name": "ResnetGenerator", "ngf": 4, "n_blocks": 5}
SMALL_D = {"name": "NLayerDiscriminator", "ndf": 8}
SMALL_F = {"name": "PatchSamplerF", "use_mlp": True, "nc": 16}
RES, BATCH, PATCHES = 32, 2, 128
LAYERS = [0, 4, 8, 12, 16]
CUT_LOSSES = ("G", "loss_NCE", "loss_NCE_Y", "D_fake", "D_real")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this file: under the test run's several worker
    processes, torch's parallel regions wait on threads that are not
    running. A throw-away multi-threaded ``torch.sqrt`` first (the first
    one of a process has returned one thread's share a few 1e-4 off on
    some hosts)."""
    torch.sqrt(torch.rand(1 << 20))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# helpers (shared with the NEGCUT and DCLGAN files)
# ---------------------------------------------------------------------------

def flat(tree, prefix=(), dtype=np.float32):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + (k,), dtype))
        else:
            out[prefix + (k,)] = np.asarray(v, dtype)
    return out


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def norm(x):
    return float(np.linalg.norm(x))


def assert_close_to_scale(a, b, tol):
    """``max |a - b| <= tol * max |b|``: float32 convolutions of two
    libraries sum in different orders, a few ulps of the tensor's scale
    apart."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
    assert err <= tol, err


def nhwc(x):
    return jnp.asarray(np.asarray(x)).transpose(0, 2, 3, 1)


def nchw(x):
    return np.asarray(x).transpose(0, 3, 1, 2)


class Args:
    start_epoch = 0
    epoch = "latest"
    split = ""
    save_latest = True


def patch_ids(rng, sizes, num_patches=PATCHES):
    """Per level, the first ``min(num_patches, size)`` of a permutation."""
    return [rng.permutation(s)[:min(num_patches, s)] for s in sizes]


def to64(tree):
    return jax.tree.map(
        lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype.kind == "f"
        else a, tree)


def jax_trainer(cfg, init_batch):
    """The JAX package's trainer of ``cfg`` after its
    ``initialize_model_and_optimizer``, with each flax ``init`` jitted
    (run op by op, flax's init compiles a few hundred small programs, one
    an operation and shape). Python ints among the arguments
    (``num_patches``) are static."""
    orig = flax.linen.Module.init

    def init(self, rngs, *args, **kwargs):
        static = [i + 1 for i, a in enumerate(args) if isinstance(a, int)]
        return jax.jit(lambda r, *a: orig(self, r, *a, **kwargs),
                       static_argnums=static)(rngs, *args)

    j = jalg.define_model(cfg, JPhase.TRAIN)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flax.linen.Module, "init", init)
        j.initialize_model_and_optimizer(init_batch, cfg, Args())
    return j


def jax_float64(j, cfg, start):
    """The JAX trainer ``j`` turned to float64 from the parameters
    ``start``, traced with 64-bit types and ``jnp.float32`` standing for
    float64 (as ``tests/test_torch_gan_seg.py::_jax_step_float64``); call
    under the same context. The networks with a ``dtype`` field are cloned
    in float64; the ``Dense`` heads compute in their parameters' dtype."""
    j.dtype = jnp.float64
    j.networks = {n: (m.clone(dtype=jnp.float64) if hasattr(m, "dtype") else m)
                  for n, m in j.networks.items()}
    j.params, j.mutables = to64(start), to64(j.mutables)
    j._init_optimizers(cfg)
    j._build_steps()
    return j


def port_trainer(cfg, start, dtype, init_batch, heads=("netF",)):
    """The port's trainer with the JAX package's parameters ``start``, its
    networks in ``dtype``; the heads are built by the initialisation from a
    dry encode and then take ``start``'s values too."""
    t = talg.define_model(cfg, Phase.TRAIN, "cpu")
    for name, net in t.networks.items():
        tck.restore_like(net, start[name])
        net.to(dtype)
    t.initialize_model_and_optimizer(
        {k: torch.from_numpy(v) for k, v in init_batch.items()}, cfg, Args())
    for name in heads:
        assert next(t.networks[name].parameters()).dtype == dtype
        tck.restore_like(t.networks[name], start[name])
    return t


def gradients(alg, opt_name, start):
    """Each network's gradient from Adam's first moment after one step,
    ``(1 - b1) (g + wd p)`` in both packages, ``p`` the parameters
    ``start`` (flax trees) the step began from; in float64, and for the
    port in its own layout before the flax mapping (which writes float32),
    so that a gradient near zero keeps its digits."""
    b1, wd = 0.5, alg.config["Train"]["weight_decay"]
    out = {}
    for name in alg.optimizer_mapping[opt_name]:
        if isinstance(alg, talg.BaseAlgorithm):
            module, opt = alg.networks[name], alg.opt[opt_name]
            p0 = tck.flax_to_state_dict(start[name], module)
            g = {k: opt.state[p]["exp_avg"].double() / (1 - b1)
                 - wd * p0[k].double() for k, p in module.named_parameters()}
            out[name] = flat(tck.state_dict_to_flax(module, g),
                             dtype=np.float64)
        else:
            m = flat(alg.opt_state[opt_name].inner_state[1][0].mu[name],
                     dtype=np.float64)
            p0 = flat(start[name], dtype=np.float64)
            out[name] = {k: m[k] / (1 - b1) - wd * p0[k] for k in m}
    return out


def generator_zero_gradient(mod: str, n_blocks: int) -> bool:
    """A generator conv whose bias an instance norm follows with no tap in
    between: no gradient in exact arithmetic. The down-convolutions are
    tapped before their norm (layers 4 and 8), so theirs have one."""
    return mod in ("conv_in", "up_conv_0", "up_conv_1") or any(
        mod == f"resblock_{i}/conv{c}" for i in range(n_blocks)
        for c in (1, 2))


def zero_gradient(net: str, key: tuple, flat_level0: bool = True):
    """The bound, relative to its network's gradient norm, on a tensor with
    no gradient in exact arithmetic (None for the others): 1e-12 for the
    biases above and the PatchGAN's inner conv biases; 1e-7, the scale of
    the L2 norm's eps, for a projector's level-0 MLP without learned
    negatives (``flat_level0``). Level 0 is the padded one-channel input:
    with the first layer's zero bias and non-negative pixels every
    position's projection has one direction, so the loss, which compares
    projections with projections alone, is flat in that MLP's parameters but
    for the eps (its float64 gradients read 1e-15 to 3e-8 of the
    projector's)."""
    mod = "/".join(key[:-1])
    if net.startswith("netF"):
        return 1e-7 if flat_level0 and mod.startswith("mlp_0_") else None
    if key[-1] != "bias":
        return None
    if net.startswith("netG"):
        zero = generator_zero_gradient(mod, SMALL_G["n_blocks"])
    else:
        zero = net.startswith("netD") and mod in ("conv1", "conv2", "conv3")
    return 1e-12 if zero else None


def assert_step_matches(t, j, start, dtype, grad_tol, param_tol,
                        flat_level0=True, grad_tols=None):
    """Every optimizer's gradients and updated parameters of the port's
    trainer ``t`` against the JAX trainer ``j``, tensor by tensor;
    ``grad_tols`` may give a tensor ``(net, key)`` a gradient tolerance of
    its own."""
    for opt_name in t.optimizer_mapping:
        grad = gradients(t, opt_name, start)
        ref = gradients(j, opt_name, start)
        for name in t.optimizer_mapping[opt_name]:
            ours = flat(tck.state_dict_to_flax(t.networks[name]),
                        dtype=np.float64)
            want = flat(j.params[name], dtype=np.float64)
            assert ours.keys() == want.keys() == grad[name].keys() \
                == ref[name].keys()
            total = {id(g): norm(np.concatenate([v.ravel() for v in g.values()]))
                     for g in (grad[name], ref[name])}
            p0 = flat(start[name], dtype=np.float64)
            for k in ref[name]:
                bound = zero_gradient(name, k, flat_level0)
                if bound is not None:  # float32 gives such a tensor no digits
                    if dtype == torch.float64:
                        for g in (grad[name], ref[name]):
                            assert norm(g[k]) <= bound * total[id(g)], (name, k)
                        assert norm(grad[name][k] - ref[name][k]) \
                            <= 1e-12 * total[id(ref[name])], (name, k)
                    continue
                g_tol = (grad_tols or {}).get((name, k), grad_tol)
                assert rel_l2(grad[name][k], ref[name][k]) <= g_tol, \
                    (name, k, rel_l2(grad[name][k], ref[name][k]))
                # a tensor that starts at zero is Adam's first update alone,
                # lr g / (|g| + eps) by element, a function of the gradient
                tol = param_tol if p0[k].any() else g_tol
                assert rel_l2(ours[k], want[k]) <= tol, \
                    (name, k, rel_l2(ours[k], want[k]))


def small_config(name, nce_loss="PatchNCELoss", **model):
    """A ``config_{cut,negcut,dclgan}.yml``-like config with the small
    networks, for one step of ``name``."""
    m = {"name": name, "nce_layers": ",".join(map(str, LAYERS)),
         "num_patches": PATCHES, **model}
    return {"General": {"task": "gan-ves-seg", "seed": 3, "amp": False,
                        "inference": "netG", "model": m},
            "Train": {"lr": 2e-4, "weight_decay": 1e-3, "epochs": 3,
                      "epochs_decay": 1, "batch_size": BATCH,
                      "loss_criterionGAN": "LSGANLoss",
                      "loss_criterionNCE": nce_loss,
                      "loss_criterionCycle": "L1Loss",
                      "loss_criterionIdt": "L1Loss"},
            "Output": {"save_dir": "unused"}}


def small_engine_config(root, config_file, model_update, res=RES):
    """A shipped config with small networks at ``res``² on data made under
    ``root``, one epoch of two steps."""
    globs = make_seg_dataset(str(root / "data"), n_graphs=4, n_backgrounds=2,
                             n_val=0, background_res=res, device="cpu",
                             max_edges=120, n_real_b=2, real_b_res=res)
    cfg = point_config_at(load_config(os.path.join(ROOT, "configs",
                                                   config_file)),
                          globs, str(root / "runs"))
    for phase in ("Train", "Test"):
        for a in cfg[phase]["data_augmentation"]:
            if a["name"] == "LoadGraphAndFilterByRandomRadiusd":
                a["image_resolutions"] = [[res, res]]
            if a["name"] == "Resized":
                a["spatial_size"] = [res, res]
    cfg["General"]["model"].update(model_update)
    cfg["Train"].update(epochs=1, batch_size=BATCH, save_interval=1)
    return cfg


def engine_round_trip(tmp_path, cfg, losses, nets, opts, inference,
                      res=RES):
    """Train ``cfg`` (at ``res``²) for its epoch through the engine, check
    its losses, metrics and checkpoints (the JAX package reads each
    network's), resume from them (each network and optimizer restored as
    written) and translate every graph with ``test``. Returns the resumed
    trainer."""
    steps = []
    run = train(Args(), json.loads(json.dumps(cfg)), device="cpu",
                on_step=lambda *a: steps.append(a))
    assert [s[:2] for s in steps] == [(0, 1), (0, 2)]
    assert all(list(s[2]) == list(losses) for s in steps)
    assert all(np.isfinite(list(s[2].values())).all() for s in steps)
    with open(os.path.join(run, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [r["epoch"] for r in rows] == ["0"]
    assert {f"train_{k}" for k in losses} <= set(rows[0])
    cks = set(os.listdir(os.path.join(run, "checkpoints")))
    want = {f"latest_{n}_model.ckpt" for n in nets} \
        | {f"latest_{o}.ckpt" for o in opts}
    assert want <= cks and {s.replace("latest", "1") for s in want} <= cks
    assert os.path.exists(os.path.join(run, "sample_train_latest.png"))
    for n in nets:
        jm = jck.load_checkpoint(os.path.join(run, "checkpoints",
                                              f"latest_{n}_model.ckpt"))
        assert jm["epoch"] == 1 and jm["model"]
    snap = load_config(os.path.join(run, "config.yml"))

    class Resume(Args):
        start_epoch = 1

    model = talg.define_model(snap, Phase.TRAIN, "cpu")
    init = {"real_A": torch.zeros(1, 1, res, res)}
    model.initialize_model_and_optimizer(init, snap, Resume())
    for net in nets:
        saved = tck.load_checkpoint(os.path.join(
            run, "checkpoints", f"latest_{net}_model.ckpt"))
        got = flat(tck.state_dict_to_flax(model.networks[net]))
        for k, v in flat(saved["model"]).items():
            np.testing.assert_array_equal(got[k], v)
    for o in opts:
        assert int(model.optimizer_state(o)["count"]) == 2
    out = tmp_path / "test"
    written = ttest.main(["--config_file", os.path.join(run, "config.yml"),
                          "--device", "cpu", "--epoch", "latest",
                          "--Test.save_dir", str(out)])
    assert len(written) == 4
    for p in written:
        assert os.path.basename(p).startswith(f"{inference}_graph_")
        img = load_png_gray8(p)
        assert img.shape == (res, res) and img.max() > 0
    return model


# ---------------------------------------------------------------------------
# the generator's feature taps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def generator():
    """The small generator in both packages with the same parameters, and
    an input batch."""
    rng = np.random.default_rng(5)
    x = rng.random((BATCH, 1, RES, RES)).astype(np.float32)
    jnet = jgan.ResnetGenerator(ngf=4, n_blocks=5)
    params = jnet.init(jax.random.PRNGKey(1), nhwc(x))["params"]
    tnet = tgan.ResnetGenerator(ngf=4, n_blocks=5)
    tck.load_flax_params(tnet, jax.tree.map(np.asarray, params))
    return jnet, params, tnet, x


@pytest.mark.parametrize("layers", [[0, 4, 8, 12, 16], [16, 4], [1, 3, 12],
                                    [5, 21, 31], [2, 7, 9, 11, 17, 20, 28]])
@pytest.mark.parametrize("encode_only", [True, False])
def test_generator_taps_match_jax(generator, layers, encode_only):
    """The taps of several ``layers=`` sets, with and without
    ``encode_only``, equal JAX's within 1e-5 of each tap's largest value in
    float32 (the deepest taps read 5e-6, as far as the port's float64 taps
    are from JAX's float32); without ``encode_only`` the image comes with
    them."""
    jnet, params, tnet, x = generator
    ref = jnet.apply({"params": params}, nhwc(x), layers=layers,
                     encode_only=encode_only)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x), layers=layers,
                   encode_only=encode_only)
    # without encode_only, or with a last tap past the network's last
    # stage, the image comes with the taps
    assert isinstance(ref, tuple) == (not encode_only or max(layers) > 27)
    if isinstance(ref, tuple):
        (img, got), (ref_img, ref) = got, ref
        np.testing.assert_allclose(img.numpy(), nchw(ref_img), atol=1e-5)
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert_close_to_scale(a.numpy(), nchw(b), 1e-5)


def test_generator_tap_shapes_at_full_width():
    """At 304², the shipped taps 0, 4, 8, 12 and 16 of ``resnetGenerator9``
    (shapes only, with fake tensors)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        net = tgan.resnetGenerator9()
        feats = net(torch.zeros(4, 1, 304, 304), layers=LAYERS,
                    encode_only=True)
    assert [tuple(f.shape) for f in feats] == [
        (4, 1, 310, 310), (4, 128, 304, 304), (4, 256, 152, 152),
        (4, 256, 76, 76), (4, 256, 76, 76)]
    assert [f.shape[2] * f.shape[3] for f in feats] == [
        96100, 92416, 23104, 5776, 5776]


def test_generator_without_taps_is_unchanged(generator):
    jnet, params, tnet, x = generator
    with torch.no_grad():
        out = tnet(torch.from_numpy(x))
    np.testing.assert_allclose(
        out.numpy(), nchw(jnet.apply({"params": params}, nhwc(x))), atol=1e-5)


# ---------------------------------------------------------------------------
# the patch projector, the loss, the layers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def taps(generator):
    jnet, params, tnet, x = generator
    with torch.no_grad():
        feats = tnet(torch.from_numpy(x), layers=LAYERS, encode_only=True)
    return [f.numpy() for f in feats]


@pytest.mark.parametrize("num_patches", [PATCHES, 0])
def test_patch_sample_f_matches_jax(taps, num_patches):
    """``PatchSampleF`` with the JAX package's parameters, with given ids
    and with every position (``num_patches == 0``), equal to JAX's within
    1e-5."""
    sizes = [f.shape[2] * f.shape[3] for f in taps]
    ids = patch_ids(np.random.default_rng(2), sizes)
    jf = jgan.PatchSampleF(nc=16)
    jfeats = [jnp.asarray(f.transpose(0, 2, 3, 1)) for f in taps]
    params = jf.init(jax.random.PRNGKey(4), jfeats,
                     [jnp.asarray(i) for i in ids], PATCHES)["params"]
    ref, ref_ids = jf.apply({"params": params}, jfeats,
                            [jnp.asarray(i) for i in ids], num_patches)
    tf = treg.build_network(dict(SMALL_F), in_channels=[f.shape[1] for f in taps])
    assert tf.out_channels == [16] * 5
    tck.load_flax_params(tf, jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got, got_ids = tf([torch.from_numpy(f) for f in taps],
                          [torch.from_numpy(i) for i in ids], num_patches)
    for level, (a, b) in enumerate(zip(got, ref)):
        if num_patches:
            assert a.shape == (BATCH * len(ids[level]), 16)
            np.testing.assert_array_equal(got_ids[level].numpy(),
                                          np.asarray(ref_ids[level]))
        else:
            assert a.shape == taps[level].shape[:1] + taps[level].shape[2:] \
                + (16,) and got_ids[level] is None
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_patch_sample_f_runs_in_float32_under_autocast(taps):
    """The projector takes bf16 taps under autocast and computes in
    float32 (flax ``Dense`` with no ``dtype``): the same values as on the
    taps rounded to bf16 and widened."""
    tf = tgan.PatchSampleF([f.shape[1] for f in taps], nc=16)
    tlayers.kaiming_normal_(tf, torch.Generator().manual_seed(0))
    bf = [torch.from_numpy(f).bfloat16() for f in taps]
    ids = [torch.arange(min(PATCHES, f.shape[2] * f.shape[3])) for f in taps]
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        got, _ = tf(bf, ids)
    with torch.no_grad():
        want, _ = tf([f.float() for f in bf], ids)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("negatives", [False, True])
@pytest.mark.parametrize("all_neg", [False, True])
def test_patch_nce_loss_matches_jax(negatives, all_neg):
    """Both branches, with negatives and without (the diagonal at -10),
    per patch and with the minibatch's negatives, equal JAX's within
    1e-6; the key takes no gradient."""
    rng = np.random.default_rng(9)
    unit = lambda x: (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(
        np.float32)  # as the projector gives them
    q, k = (unit(rng.standard_normal((BATCH * 24, 16))) for _ in range(2))
    n = unit(rng.standard_normal((BATCH * 40, 16)))
    kw = dict(batch_size=BATCH, nce_includes_all_negatives_from_minibatch=all_neg)
    ref = jl.PatchNCELoss(**kw)(q, k, n if negatives else None)
    cls = tl.LearnedPatchNCELoss if negatives else tl.PatchNCELoss
    tq, tk = (torch.from_numpy(x).requires_grad_() for x in (q, k))
    got = cls(**kw)(tq, tk, torch.from_numpy(n) if negatives else None)
    assert got.shape == (BATCH * 24,)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)
    got.sum().backward()
    assert tk.grad is None and tq.grad.abs().sum() > 0


def test_l2_normalize_and_linear_init():
    """``l2_normalize`` equals JAX's; ``kaiming_normal_`` draws a linear
    weight with the fan-in ``in_features`` (flax's variance scaling 2.0,
    fan-in, normal, on a ``Dense`` kernel) and a zero bias, and leaves the
    draws of a network without one as they were."""
    x = np.random.default_rng(1).standard_normal((7, 33)).astype(np.float32)
    np.testing.assert_allclose(tlayers.l2_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jlayers.l2_normalize(x)), atol=1e-7)
    lin = torch.nn.Linear(400, 300)
    tlayers.kaiming_normal_(lin, torch.Generator().manual_seed(0))
    assert torch.equal(lin.bias, torch.zeros(300))
    std = float(lin.weight.detach().std())
    assert abs(std / (2 / 400) ** 0.5 - 1) < 0.01
    ref = jax.nn.initializers.variance_scaling(2.0, "fan_in", "normal")(
        jax.random.PRNGKey(0), (400, 300))
    assert abs(float(np.std(ref)) / std - 1) < 0.01
    a, b = tgan.ResnetGenerator(ngf=4, n_blocks=1), tgan.ResnetGenerator(
        ngf=4, n_blocks=1)
    tlayers.kaiming_normal_(a, torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for m in b.modules():
            if isinstance(m, torch.nn.Conv2d):
                cin, kh, kw = m.weight.shape[1:]
                m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                               * (2.0 / (cin * kh * kw)) ** 0.5)
                m.bias.zero_()
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)


# ---------------------------------------------------------------------------
# flax Dense <-> nn.Linear
# ---------------------------------------------------------------------------

def test_dense_checkpoints_both_ways(taps, tmp_path):
    """JAX's ``PatchSampleF`` params through a file into the port (kernel
    [in, out] -> weight [out, in]) and back, bit for bit; the JAX package's
    ``restore_like`` reads the port's tree; the Adam moments over a linear
    layer map the same way; a kernel on a module kind the port does not
    map, or a scale off an instance norm, raises."""
    jf = jgan.PatchSampleF(nc=16)
    jfeats = [jnp.asarray(f.transpose(0, 2, 3, 1)) for f in taps]
    ids = [jnp.arange(8)] * 5
    params = jax.tree.map(np.asarray, jf.init(
        jax.random.PRNGKey(4), jfeats, ids, 8)["params"])
    path = jck.save_checkpoint(str(tmp_path / "netF_model.ckpt"),
                               {"epoch": 1, "model": params})
    tf = tgan.PatchSampleF([f.shape[1] for f in taps], nc=16)
    tck.restore_like(tf, tck.load_checkpoint(path)["model"])
    np.testing.assert_array_equal(tf.mlp_1_0.weight.detach().numpy(),
                                  params["mlp_1_0"]["kernel"].T)
    back = tck.state_dict_to_flax(tf)
    assert back.keys() == params.keys()
    for k, v in flat(params).items():
        np.testing.assert_array_equal(flat(back)[k], v)
    ours = tck.save_checkpoint(str(tmp_path / "t_netF_model.ckpt"),
                               {"epoch": 1, "model": back})
    restored = jck.restore_like(params, jck.load_checkpoint(ours)["model"])
    for k, v in flat(restored).items():
        np.testing.assert_array_equal(v, flat(params)[k])
    # Adam's moments over a linear layer
    opt = torch.optim.Adam(tf.parameters(), lr=1e-3)
    for p in tf.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    st = tck.adam_state_to_flax(opt, {"netF": tf})
    mu = st["inner_state"]["1"]["0"]["mu"]["netF"]
    assert mu["mlp_0_0"]["kernel"].shape == params["mlp_0_0"]["kernel"].shape
    fresh = torch.optim.Adam(tf.parameters(), lr=1e-3)
    tck.load_adam_state(fresh, {"netF": tf}, st)
    for p in tf.parameters():
        torch.testing.assert_close(fresh.state[p]["exp_avg"],
                                   opt.state[p]["exp_avg"], rtol=0, atol=0)
    # other kinds raise instead of guessing
    bad = {"mlp_0_0": {"scale": params["mlp_0_0"]["bias"],
                       "bias": params["mlp_0_0"]["bias"]}}
    with pytest.raises(KeyError, match="scale"):
        tck.flax_to_state_dict(bad, tf)
    odd = torch.nn.Sequential()
    odd.add_module("emb", torch.nn.Embedding(3, 4))
    with pytest.raises(KeyError, match="Embedding"):
        tck.state_dict_to_flax(odd)
    with pytest.raises(KeyError, match="Embedding"):
        tck.flax_to_state_dict({"emb": {"kernel": np.zeros((3, 4))}}, odd)


# ---------------------------------------------------------------------------
# one CUT step against the JAX package's
# ---------------------------------------------------------------------------

def cut_config():
    return small_config("CUTModel", netG_config=dict(SMALL_G),
                        netD_config=dict(SMALL_D), netF_config=dict(SMALL_F),
                        nce_idt=True, lambda_NCE=1.0, lambda_GAN=1.0)


@pytest.fixture(scope="module")
def cut_stepped():
    """The JAX CUT trainer in float64 and the port's in float64 and
    float32, from the same parameters and patch ids, each after one step."""
    rng = np.random.default_rng(21)
    cfg = cut_config()
    real_A, real_B = (rng.random((BATCH, 1, RES, RES)).astype(np.float32)
                      for _ in range(2))
    init_batch = {"real_A": real_A}
    j32 = jax_trainer(cfg, init_batch)
    start = jax.tree.map(np.asarray, j32.params)
    ids_a, ids_b = (patch_ids(rng, j32.feat_sizes) for _ in range(2))
    ports = {}
    for dtype in (torch.float64, torch.float32):
        t = port_trainer(cfg, start, dtype, init_batch)
        assert list(t.networks) == ["netG", "netD", "netF"]
        assert t.feat_sizes == j32.feat_sizes
        (fake_B, idt_B), losses = t.train_step(
            *(torch.from_numpy(x).to(dtype) for x in (real_A, real_B)),
            [torch.from_numpy(i) for i in ids_a],
            [torch.from_numpy(i) for i in ids_b])
        ports[dtype] = (t, (fake_B, idt_B),
                        {k: float(v) for k, v in losses.items()})
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "float32", jnp.float64)
        j = jax_float64(j32, cfg, start)
        j.params, j.opt_state, (fake_B, idt_B), losses = j._step(
            j.params, j.opt_state, nhwc(real_A.astype(np.float64)),
            nhwc(real_B.astype(np.float64)),
            [jnp.asarray(i) for i in ids_a], [jnp.asarray(i) for i in ids_b])
        lj = {k: float(v) for k, v in losses.items()}
        images = (nchw(fake_B), nchw(idt_B))
        j.params = jax.tree.map(np.asarray, j.params)
        j.opt_state = jax.tree.map(np.asarray, j.opt_state)
    return j, lj, images, ports, start


@pytest.mark.parametrize("dtype,grad_tol,param_tol,loss_tol", [
    (torch.float64, 1e-6, 1e-6, 1e-12), (torch.float32, 1e-4, 1e-5, 1e-5)])
def test_cut_step_matches_jax_float64(cut_stepped, dtype, grad_tol,
                                      param_tol, loss_tol):
    """The port's step (D step, then G+F through the new D) in float64 and
    float32 against the JAX package's float64 step: the five losses, the
    images, and every gradient and updated parameter of the three
    optimizers."""
    j, lj, images, ports, start = cut_stepped
    t, got_images, lt = ports[dtype]
    assert list(lt) == list(CUT_LOSSES) and set(lj) == set(CUT_LOSSES)
    for k in CUT_LOSSES:
        assert lt[k] == pytest.approx(lj[k], rel=loss_tol), k
    assert lt["loss_NCE"] > 0 and lt["loss_NCE_Y"] > 0
    for a, b in zip(got_images, images):
        np.testing.assert_allclose(a.double().numpy(), b, atol=1e-5)
    assert_step_matches(t, j, start, dtype, grad_tol, param_tol)


def test_cut_g_step_leaves_the_discriminator_alone(cut_stepped):
    """After the step ``netD`` has its gradient from the D step alone
    (none from the G+F step) and takes gradients again."""
    t = talg.define_model(cut_config(), Phase.TRAIN, "cpu")
    t.initialize_model_and_optimizer(
        {"real_A": torch.zeros(1, 1, RES, RES)}, cut_config(), Args())
    rng = np.random.default_rng(3)
    real_A, real_B = (torch.from_numpy(rng.random((BATCH, 1, RES, RES))
                                       .astype(np.float32)) for _ in range(2))
    ids = t._patch_ids()
    fake_B, idt_B = t.translate(real_A, real_B)
    t.d_step(fake_B, real_B)
    d_grads = [p.grad.clone() for p in t.networks["netD"].parameters()]
    t.g_step(real_A, real_B, fake_B, idt_B, ids, ids)
    for g, p in zip(d_grads, t.networks["netD"].parameters()):
        assert torch.equal(g, p.grad) and p.requires_grad
    assert all(p.grad is not None for p in t.networks["netF"].parameters())


# ---------------------------------------------------------------------------
# checkpoints and dispatch
# ---------------------------------------------------------------------------

def checkpoints_cross_packages(t, j, tmp_path, steps=1):
    """Every network and optimizer of the port's trainer ``t`` read by the
    JAX package, and the JAX trainer ``j``'s (float64 after its ``steps``
    steps, as float32 files) read by the port, bit for bit."""
    to32 = lambda tree: jax.tree.map(
        lambda a: np.asarray(a, np.float32) if np.asarray(a).dtype.kind == "f"
        else np.asarray(a), tree)
    params, opt_state = to32(j.params), to32(j.opt_state)
    for opt_name, nets in t.optimizer_mapping.items():
        # port -> JAX
        for net in nets:
            p = tck.save_checkpoint(
                str(tmp_path / f"t_{net}_model.ckpt"),
                {"epoch": 1, "model": t.network_state(net)["params"]})
            got = jck.restore_like(params[net], jck.load_checkpoint(p)["model"])
            ours = flat(tck.state_dict_to_flax(t.networks[net]))
            for k, v in flat(got).items():
                np.testing.assert_array_equal(v, ours[k])
        p = tck.save_checkpoint(str(tmp_path / f"t_{opt_name}.ckpt"),
                                {"epoch": 1,
                                 "optimizer": t.optimizer_state(opt_name)})
        restored = jck.restore_like(opt_state[opt_name],
                                    jck.load_checkpoint(p)["optimizer"])
        assert int(restored.count) == steps
        state = t.optimizer_state(opt_name)["inner_state"]["1"]["0"]
        for moment in ("mu", "nu"):
            got = getattr(restored.inner_state[1][0], moment)
            assert set(got) == set(nets)
            for net in nets:
                for k, v in flat(state[moment][net]).items():
                    np.testing.assert_array_equal(flat(got[net])[k], v)
        # JAX -> port
        for net in nets:
            jp = jck.save_checkpoint(str(tmp_path / f"j_{net}_model.ckpt"),
                                     {"epoch": 1, "model": params[net]})
            t.load_network_state(net, {"params": tck.load_checkpoint(jp)["model"]})
            ours = flat(tck.state_dict_to_flax(t.networks[net]))
            for k, v in flat(params[net]).items():
                np.testing.assert_array_equal(ours[k], v)
        jo = jck.save_checkpoint(str(tmp_path / f"j_{opt_name}.ckpt"),
                                 {"epoch": 1, "optimizer": opt_state[opt_name]})
        t.load_optimizer_state(opt_name, tck.load_checkpoint(jo)["optimizer"])
        st = t.optimizer_state(opt_name)
        assert int(st["count"]) == steps
        for moment in ("mu", "nu"):
            ref = getattr(opt_state[opt_name].inner_state[1][0], moment)
            for net in nets:
                want = flat(ref[net])
                for k, v in flat(st["inner_state"]["1"]["0"][moment][net]).items():
                    np.testing.assert_array_equal(v, want[k])


def test_cut_checkpoints_cross_packages(cut_stepped, tmp_path):
    """``netG``, ``netD``, ``netF`` and their three optimizers, both ways."""
    j, _, _, ports, _ = cut_stepped
    checkpoints_cross_packages(copy.deepcopy(ports[torch.float32][0]), j,
                               tmp_path)


def jax_param_counts(cfg, res, heads, encoder):
    """The parameter count of each network of the JAX trainer of ``cfg`` at
    ``res``², from shapes alone (``jax.eval_shape``): the generators and
    discriminators from an image, the heads ``{name: input}`` from the
    shapes of ``encoder``'s taps or of another head's pools."""
    j = jalg.define_model(cfg, JPhase.TRAIN)
    key = jax.random.PRNGKey(0)
    x = jax.ShapeDtypeStruct((1, res, res, 1), jnp.float32)
    shapes = {n: jax.eval_shape(lambda x, n=n: j.networks[n].init(key, x), x)
              for n in j.networks if n not in heads}
    feats = jax.eval_shape(lambda p, x: j.networks[encoder].apply(
        p, x, layers=j.nce_layers, encode_only=True), shapes[encoder], x)
    for n, source in heads.items():
        net = j.networks[n.rstrip("_")]  # NEGCUT's mirror netF_ is a netF
        if source == "taps":
            shapes[n] = jax.eval_shape(lambda f, net=net: net.init(
                key, f, [jnp.arange(1)] * len(f), 1), feats)
        else:
            pools = jax.eval_shape(lambda p, f: j.networks[source].apply(
                p, f, None, 0)[0], shapes[source], feats)
            shapes[n] = jax.eval_shape(lambda p, net=net: net.init(
                key, p, 2, key), pools)
    return {n: sum(int(np.prod(v.shape)) for v in jax.tree.leaves(
        s["params"])) for n, s in shapes.items()}


def test_define_model_dispatches_cut():
    """``configs/config_cut.yml`` builds ``CUTModel`` with its settings;
    after the initialisation at 64² the three networks have JAX's
    parameter counts, ``netF`` its levels' channels; ``test`` builds
    ``netG`` alone."""
    cfg = load_config(os.path.join(ROOT, "configs", "config_cut.yml"))
    t = talg.define_model(cfg, Phase.TRAIN, "cpu")
    assert isinstance(t, tgal.CUTAlgorithm)
    assert list(t.networks) == ["netG", "netD"]
    assert t.nce_layers == LAYERS and t.nce_idt is True
    assert t.num_patches == 256 and t.lambda_NCE == t.lambda_GAN == 1
    t.initialize_model_and_optimizer({"real_A": torch.zeros(1, 1, 64, 64)},
                                     cfg, Args())
    assert list(t.networks) == ["netG", "netD", "netF"]
    assert set(t.opt) == {"optimizer_G", "optimizer_D", "optimizer_F"}
    assert isinstance(t.criterionNCE, tl.PatchNCELoss)
    assert t.criterionNCE.batch_size == 4
    assert t.feat_sizes == [70 * 70, 64 * 64, 32 * 32, 16 * 16, 16 * 16]
    assert t.num_parameters() == jax_param_counts(cfg, 64, {"netF": "taps"},
                                                  "netG")
    test_model = talg.define_model(cfg, Phase.TEST, "cpu")
    assert list(test_model.networks) == ["netG"]


# ---------------------------------------------------------------------------
# the engine and the test CLI
# ---------------------------------------------------------------------------

def test_engine_trains_cut_resumes_and_translates(tmp_path):
    cfg = small_engine_config(
        tmp_path, "config_cut.yml",
        {"netG_config": dict(SMALL_G), "netD_config": dict(SMALL_D),
         "netF_config": dict(SMALL_F), "num_patches": 32})
    engine_round_trip(tmp_path, cfg, CUT_LOSSES, ("netG", "netD", "netF"),
                      ("optimizer_G", "optimizer_D", "optimizer_F"), "netG")
