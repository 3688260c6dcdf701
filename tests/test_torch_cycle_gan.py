"""Port parity for CycleGAN, the first algorithm of the GAN zoo: the
``ImagePool``, one G step and one D step against the JAX package's, the
checkpoints across the two packages, ``define_model``'s dispatch, and the
engine and the ``test`` CLI on ``configs/config_cycle_gan.yml``.

Small networks on the CPU (``ResnetGenerator`` with ``ngf`` 8 and 2 blocks,
PatchGAN with ``ndf`` 8) at 32², batch 2, with the JAX package's initial
parameters carried into the port and the background and ``u`` draws
injected into both. Tolerances: in float64 against the JAX package's
float64 step, the nine losses within 1e-12 relative and every gradient and
updated parameter tensor within 1e-6 relative L2 (a conv bias that an
instance norm follows, with no gradient in exact arithmetic, within 1e-12
of its weight's gradient norm); the port's float32 step against the same,
every gradient within 1e-4 and every updated parameter within 1e-5 relative
L2 but those biases. Checkpoints agree bit for bit.
"""
import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from octa_tpu.io import checkpoints as jck
from octa_tpu.train import algorithms as jalg
from octa_tpu.train import gan_algorithms as jgal
from octa_tpu.utils.enums import Phase as JPhase
from octa_tpu_torch import test as ttest
from octa_tpu_torch.io import checkpoints as tck
from octa_tpu_torch.io.images import load_png_gray8
from octa_tpu_torch.tools.seg_data import make_seg_dataset, point_config_at
from octa_tpu_torch.train import algorithms as talg
from octa_tpu_torch.train import gan_algorithms as tgal
from octa_tpu_torch.train.engine import train
from octa_tpu_torch.utils.config import load_config
from octa_tpu_torch.utils.enums import Phase

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "config_cycle_gan.yml")
SMALL_G = {"name": "ResnetGenerator", "ngf": 8, "n_blocks": 2}
SMALL_D = {"name": "NLayerDiscriminator", "ndf": 8}
RES, BATCH = 32, 2
NETS = ("netG_A", "netG_B", "netD_A", "netD_B")
LOSSES = ("G", "G_A", "G_B", "cycle_A", "cycle_B", "idt_A", "idt_B", "D_A",
          "D_B")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this file: under the test run's several worker
    processes, torch's parallel regions wait on threads that are not
    running."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _norm(x):
    return float(np.linalg.norm(x))


def _nhwc(x):
    return jnp.asarray(x).transpose(0, 2, 3, 1)


class _Args:
    start_epoch = 0
    epoch = "latest"
    split = ""
    save_latest = True


# ---------------------------------------------------------------------------
# the replay buffer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pool_size", [0, 1, 3])
def test_image_pool_makes_jax_choices(rng, pool_size):
    """Eight batches of 2 through pools of the same seed: the same images
    come back, choice for choice."""
    ours, ref = tgal.ImagePool(pool_size, 7), jgal.ImagePool(pool_size, 7)
    for _ in range(8):
        batch = rng.random((2, 1, 4, 4)).astype(np.float32)
        got = ours.query(torch.from_numpy(batch))
        want = ref.query(batch)
        np.testing.assert_array_equal(got.numpy(), want)
    assert len(ours.images) == len(ref.images) == pool_size
    for a, b in zip(ours.images, ref.images):
        np.testing.assert_array_equal(a.numpy(), b)


# ---------------------------------------------------------------------------
# one step against the JAX package's
# ---------------------------------------------------------------------------

def _config(lambda_idt=0.5):
    return {"General": {"task": "gan-ves-seg", "seed": 3, "amp": False,
                        "inference": "netG_A",
                        "model": {"name": "CycleGAN",
                                  "netG_A_config": dict(SMALL_G),
                                  "netG_B_config": dict(SMALL_G),
                                  "netD_A_config": dict(SMALL_D),
                                  "netD_B_config": dict(SMALL_D),
                                  "lambda_A": 10, "lambda_B": 10,
                                  "lambda_idt": lambda_idt, "pool_size": 50}},
            "Train": {"lr": 2e-4, "weight_decay": 1e-3, "epochs": 3,
                      "epochs_decay": 1, "batch_size": BATCH,
                      "loss_criterionGAN": "LSGANLoss",
                      "loss_criterionCycle": "L1Loss",
                      "loss_criterionIdt": "L1Loss"},
            "Output": {"save_dir": "unused"}}


def _inputs(rng):
    """real_A, real_B, background and u, NCHW float32."""
    return [rng.random((BATCH, 1, RES, RES)).astype(np.float32)
            for _ in range(4)]


def _jax_step(j, inputs):
    """The JAX package's ``perform_training_step`` with the background and
    ``u`` draws given: its jitted G step, its pools, its jitted D step.
    Returns the losses as floats."""
    real_A, real_B, bg, u = (_nhwc(x) for x in inputs)
    pg, j.opt_state["optimizer_G"], aux = j._g_step(
        j.params, j.opt_state["optimizer_G"], real_A, real_B, bg, u)
    j.params.update(pg)
    fake_B, fake_A, _, _, losses = aux
    pooled_B = jnp.asarray(j.fake_B_pool.query(np.asarray(fake_B)))
    pooled_A = jnp.asarray(j.fake_A_pool.query(np.asarray(fake_A)))
    pd, j.opt_state["optimizer_D"], dA, dB = j._d_step(
        j.params, j.opt_state["optimizer_D"], real_A, real_B, pooled_A,
        pooled_B)
    j.params.update(pd)
    out = {k: float(v) for k, v in losses.items()}
    out.update(D_A=float(dA), D_B=float(dB))
    return out


def _jax_float64(cfg, start):
    """The JAX trainer in float64 from the parameters ``start``, traced with
    64-bit types and ``jnp.float32`` standing for float64 (as
    ``tests/test_torch_gan_seg.py::_jax_step_float64``); call under the
    same context."""
    j = jalg.define_model(cfg, JPhase.TRAIN)
    j.initialize_model_and_optimizer(
        {"real_A": np.zeros((1, 1, RES, RES), np.float32)}, cfg, _Args())
    to64 = lambda tree: jax.tree.map(
        lambda a: np.asarray(a, np.float64) if np.asarray(a).dtype.kind == "f"
        else a, tree)
    j.dtype = jnp.float64
    j.networks = {n: m.clone(dtype=jnp.float64) for n, m in j.networks.items()}
    j.params, j.mutables = to64(start), to64(j.mutables)
    j._init_optimizers(cfg)
    j._build_steps()
    return j, to64


@pytest.fixture(scope="module")
def stepped():
    """The JAX trainer in float64 and the port's in float64 and float32,
    from the same parameters, each after the same step."""
    rng = np.random.default_rng(21)
    cfg = _config()
    inputs = _inputs(rng)
    j32 = jalg.define_model(cfg, JPhase.TRAIN)
    j32.initialize_model_and_optimizer(
        {"real_A": inputs[0]}, cfg, _Args())
    start = jax.tree.map(np.asarray, j32.params)
    ports = {}
    for dtype in (torch.float64, torch.float32):
        t = talg.define_model(cfg, Phase.TRAIN, "cpu")
        assert list(t.networks) == list(NETS)
        for name, net in t.networks.items():
            tck.restore_like(net, start[name])
            net.to(dtype)
        t.initialize_model_and_optimizer(None, cfg, _Args())
        images, losses = t.train_step(
            *(torch.from_numpy(x).to(dtype) for x in inputs))
        ports[dtype] = (t, images, {k: float(v) for k, v in losses.items()})
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "float32", jnp.float64)
        j, to64 = _jax_float64(cfg, start)
        lj = _jax_step(j, [np.asarray(x, np.float64) for x in inputs])
        j.params = jax.tree.map(np.asarray, j.params)
        j.opt_state = jax.tree.map(np.asarray, j.opt_state)
    init = {n: _flat(start[n], dtype=np.float64) for n in NETS}
    return j, lj, ports, init, inputs


# conv biases that an instance norm follows: no gradient in exact arithmetic
ZERO_GRADIENT = {(g, m) for g in ("netG_A", "netG_B") for m in (
    "conv_in", "down_conv_0", "down_conv_1", "up_conv_0", "up_conv_1",
    "resblock_0/conv1", "resblock_0/conv2", "resblock_1/conv1",
    "resblock_1/conv2")} | {(d, f"conv{n}") for d in ("netD_A", "netD_B")
                            for n in (1, 2, 3)}


def _zero_gradient(net, key):
    return (net, "/".join(key[:-1])) in ZERO_GRADIENT and key[-1] == "bias"


def _gradients(alg, opt_name, init):
    """Each network's gradient from Adam's first moment after one step,
    ``(1 - b1) (g + wd p)`` in both packages (the port's moments as its
    checkpoints hold them)."""
    b1, wd = 0.5, alg.config["Train"]["weight_decay"]
    if isinstance(alg, talg.BaseAlgorithm):
        mu = alg.optimizer_state(opt_name)["inner_state"]["1"]["0"]["mu"]
    else:
        mu = alg.opt_state[opt_name].inner_state[1][0].mu
    out = {}
    for name in alg.optimizer_mapping[opt_name]:
        m = _flat(mu[name], dtype=np.float64)
        out[name] = {k: m[k] / (1 - b1) - wd * init[name][k] for k in m}
    return out


@pytest.mark.parametrize("dtype,grad_tol,param_tol,loss_tol", [
    (torch.float64, 1e-6, 1e-6, 1e-12), (torch.float32, 1e-4, 1e-5, 1e-5)])
def test_cycle_gan_step_matches_jax_float64(stepped, dtype, grad_tol,
                                            param_tol, loss_tol):
    """The port's step (G step, pools, D step) in float64 and in float32
    against the JAX package's float64 step, tensor by tensor, for both
    optimizers."""
    j, lj, ports, init, _ = stepped
    t, images, lt = ports[dtype]
    assert list(lt) == list(LOSSES) and set(lj) == set(LOSSES)
    for k in LOSSES:
        assert lt[k] == pytest.approx(lj[k], rel=loss_tol), k
    assert lt["idt_A"] > 0 and lt["cycle_B"] > 0
    assert [tuple(x.shape) for x in images] == [(BATCH, 1, RES, RES)] * 4
    for opt_name in t.optimizer_mapping:
        grad = _gradients(t, opt_name, init)
        ref = _gradients(j, opt_name, init)
        for name in t.optimizer_mapping[opt_name]:
            ours = _flat(tck.state_dict_to_flax(t.networks[name]),
                         dtype=np.float64)
            want = _flat(j.params[name], dtype=np.float64)
            assert ours.keys() == want.keys() == grad[name].keys() \
                == ref[name].keys()
            for k in ref[name]:
                if _zero_gradient(name, k):
                    if dtype == torch.float64:
                        w = k[:-1] + ("kernel",)
                        for g in (grad[name], ref[name]):
                            assert _norm(g[k]) <= 1e-12 * _norm(g[w]), (name, k)
                    continue
                assert _rel_l2(grad[name][k], ref[name][k]) <= grad_tol, \
                    (name, k)
                assert _rel_l2(ours[k], want[k]) <= param_tol, (name, k)


def test_g_step_leaves_the_discriminators_alone(rng):
    """The G step leaves no gradient on either discriminator and restores
    their ``requires_grad``; the D step's gradients are those of its own
    losses alone, with no generator gradient."""
    cfg = _config(lambda_idt=0)
    t = talg.define_model(cfg, Phase.TRAIN, "cpu")
    t.initialize_model_and_optimizer(None, cfg, _Args())
    real_A, real_B, bg, u = (torch.from_numpy(x) for x in _inputs(rng))
    d_before = {n: [p.detach().clone() for p in t.networks[n].parameters()]
                for n in ("netD_A", "netD_B")}
    (fake_B, fake_A, _, idt_A), losses = t.g_step(real_A, real_B, bg, u)
    assert float(losses["idt_A"]) == float(losses["idt_B"]) == 0.0
    assert torch.equal(idt_A, fake_B)
    for n in ("netD_A", "netD_B"):
        for p, q in zip(t.networks[n].parameters(), d_before[n]):
            assert p.grad is None and p.requires_grad and torch.equal(p, q)
    g_grads = [p.grad.clone() for n in ("netG_A", "netG_B")
               for p in t.networks[n].parameters()]
    t.d_step(real_A, real_B, fake_A, fake_B)
    # the D step set the generators' gradients to nothing new
    for g, p in zip(g_grads, [p for n in ("netG_A", "netG_B")
                              for p in t.networks[n].parameters()]):
        assert torch.equal(g, p.grad)
    disc = t.networks["netD_A"]
    got = [p.grad.clone() for p in disc.parameters()]
    for p, q in zip(disc.parameters(), d_before["netD_A"]):
        p.data.copy_(q)
        p.grad = None
    with torch.enable_grad():
        loss = 0.5 * (t.criterionGAN(disc(real_B), True)
                      + t.criterionGAN(disc(fake_B), False))
        loss.backward()
    for g, p in zip(got, disc.parameters()):
        torch.testing.assert_close(g, p.grad, rtol=1e-5, atol=1e-8)


# ---------------------------------------------------------------------------
# checkpoints and dispatch
# ---------------------------------------------------------------------------

def test_checkpoints_cross_packages(stepped, tmp_path):
    """The four networks and the two optimizers (each over two networks):
    the port's files read by the JAX package and the JAX package's read by
    the port, bit for bit."""
    _, _, ports, init, inputs = stepped
    t = ports[torch.float32][0]
    cfg = _config()
    j = jalg.define_model(cfg, JPhase.TRAIN)
    j.initialize_model_and_optimizer({"real_A": inputs[0]}, cfg, _Args())
    _jax_step(j, inputs)
    for opt_name, nets in t.optimizer_mapping.items():
        # port -> JAX
        for net in nets:
            p = tck.save_checkpoint(
                str(tmp_path / f"t_{net}_model.ckpt"),
                {"epoch": 1, "model": t.network_state(net)["params"]})
            params = jck.restore_like(j.params[net],
                                      jck.load_checkpoint(p)["model"])
            ours = _flat(tck.state_dict_to_flax(t.networks[net]))
            for k, v in _flat(params).items():
                np.testing.assert_array_equal(v, ours[k])
        p = tck.save_checkpoint(str(tmp_path / f"t_{opt_name}.ckpt"),
                                {"epoch": 1,
                                 "optimizer": t.optimizer_state(opt_name)})
        restored = jck.restore_like(j.opt_state[opt_name],
                                    jck.load_checkpoint(p)["optimizer"])
        assert int(restored.count) == 1
        state = t.optimizer_state(opt_name)["inner_state"]["1"]["0"]
        for moment in ("mu", "nu"):
            got = getattr(restored.inner_state[1][0], moment)
            assert set(got) == set(nets)
            for net in nets:
                for k, v in _flat(state[moment][net]).items():
                    np.testing.assert_array_equal(_flat(got[net])[k], v)
        # JAX -> port
        fresh = talg.define_model(cfg, Phase.TRAIN, "cpu")
        fresh.initialize_model_and_optimizer(None, cfg, _Args())
        for net in nets:
            jp = jck.save_checkpoint(str(tmp_path / f"j_{net}_model.ckpt"),
                                     {"epoch": 1, "model": j.params[net]})
            fresh.load_network_state(
                net, {"params": tck.load_checkpoint(jp)["model"]})
            ours = _flat(tck.state_dict_to_flax(fresh.networks[net]))
            for k, v in _flat(j.params[net]).items():
                np.testing.assert_array_equal(ours[k], v)
        jo = jck.save_checkpoint(str(tmp_path / f"j_{opt_name}.ckpt"),
                                 {"epoch": 1,
                                  "optimizer": j.opt_state[opt_name]})
        fresh.load_optimizer_state(opt_name,
                                   tck.load_checkpoint(jo)["optimizer"])
        st = fresh.optimizer_state(opt_name)
        assert int(st["count"]) == 1
        for moment in ("mu", "nu"):
            ref = getattr(j.opt_state[opt_name].inner_state[1][0], moment)
            for net in nets:
                want = _flat(ref[net])
                for k, v in _flat(st["inner_state"]["1"]["0"][moment][net]).items():
                    np.testing.assert_array_equal(v, want[k])


def test_define_model_dispatches_cycle_gan():
    cfg = load_config(CONFIG)
    t = talg.define_model(cfg, Phase.TRAIN, "cpu")
    assert isinstance(t, tgal.CycleGANAlgorithm) and list(t.networks) == list(NETS)
    assert t.lambda_A == t.lambda_B == 10 and t.lambda_idt == 0.5
    assert t.fake_A_pool.pool_size == t.fake_B_pool.pool_size == 50
    assert {n: sum(p.numel() for p in net.parameters())
            for n, net in t.networks.items()} == {
        n: sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
            jax.eval_shape(lambda n=n: jalg.define_model(cfg, JPhase.TRAIN)
                           .networks[n].init(jax.random.PRNGKey(0),
                                             jnp.zeros((1, 64, 64, 1))))))
        for n in NETS}
    test_model = talg.define_model(cfg, Phase.TEST, "cpu")
    assert list(test_model.networks) == ["netG_A"]
    for name in ("CUTModel", "NEGCUTModel", "DCLGAN", "NiceGAN"):
        c = json.loads(json.dumps(cfg))
        c["General"]["model"]["name"] = name
        with pytest.raises(NotImplementedError, match=name):
            talg.define_model(c, Phase.TRAIN, "cpu")


# ---------------------------------------------------------------------------
# the engine and the test CLI
# ---------------------------------------------------------------------------

def small_cycle_config(root):
    """``configs/config_cycle_gan.yml`` with small networks at 32² on data
    made under ``root``."""
    globs = make_seg_dataset(str(root / "data"), n_graphs=4, n_backgrounds=2,
                             n_val=0, background_res=RES, device="cpu",
                             max_edges=120, n_real_b=2, real_b_res=RES)
    cfg = point_config_at(load_config(CONFIG), globs, str(root / "runs"))
    for phase in ("Train", "Test"):
        for a in cfg[phase]["data_augmentation"]:
            if a["name"] == "LoadGraphAndFilterByRandomRadiusd":
                a["image_resolutions"] = [[RES, RES]]
            if a["name"] == "Resized":
                a["spatial_size"] = [RES, RES]
    model = cfg["General"]["model"]
    model.update(netG_A_config=dict(SMALL_G), netG_B_config=dict(SMALL_G),
                 netD_A_config=dict(SMALL_D), netD_B_config=dict(SMALL_D))
    cfg["Train"].update(epochs=2, batch_size=BATCH, save_interval=2)
    return cfg


def test_engine_trains_cycle_gan_resumes_and_translates(tmp_path):
    cfg = small_cycle_config(tmp_path)
    steps = []
    run = train(_Args(), json.loads(json.dumps(cfg)), device="cpu",
                on_step=lambda *a: steps.append(a))
    assert [s[:2] for s in steps] == [(0, 1), (0, 2), (1, 1), (1, 2)]
    assert all(list(s[2]) == list(LOSSES) for s in steps)
    assert all(np.isfinite(list(s[2].values())).all() for s in steps)
    with open(os.path.join(run, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    assert [r["epoch"] for r in rows] == ["0", "1"]
    assert {f"train_{k}" for k in LOSSES} <= set(rows[0])
    cks = set(os.listdir(os.path.join(run, "checkpoints")))
    six = {f"latest_{n}_model.ckpt" for n in NETS} \
        | {"latest_optimizer_G.ckpt", "latest_optimizer_D.ckpt"}
    assert six <= cks and {s.replace("latest", "2") for s in six} <= cks
    assert os.path.exists(os.path.join(run, "sample_train_latest.png"))
    # resume: the restored networks and optimizers are the written ones
    snap = load_config(os.path.join(run, "config.yml"))

    class Resume(_Args):
        start_epoch = 2

    model = talg.define_model(snap, Phase.TRAIN, "cpu")
    model.initialize_model_and_optimizer(None, snap, Resume())
    for net in NETS:
        want = tck.load_checkpoint(os.path.join(
            run, "checkpoints", f"latest_{net}_model.ckpt"))
        got = _flat(tck.state_dict_to_flax(model.networks[net]))
        for k, v in _flat(want["model"]).items():
            np.testing.assert_array_equal(got[k], v)
    st = model.optimizer_state("optimizer_G")
    assert int(st["count"]) == 4
    # the JAX package reads generator A as the port wrote it
    jg = jck.load_checkpoint(os.path.join(run, "checkpoints",
                                          "latest_netG_A_model.ckpt"))
    assert jg["epoch"] == 2 and "conv_in" in jg["model"]
    # test: netG_A translates every graph
    out = tmp_path / "test"
    written = ttest.main(["--config_file", os.path.join(run, "config.yml"),
                          "--device", "cpu", "--epoch", "latest",
                          "--Test.save_dir", str(out)])
    assert len(written) == 4
    for p in written:
        assert os.path.basename(p).startswith("netG_A_graph_")
        img = load_png_gray8(p)
        assert img.shape == (RES, RES) and img.max() > 0
