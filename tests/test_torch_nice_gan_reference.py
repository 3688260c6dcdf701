"""The benchmark's plain NICE-GAN reference (``octa_bench/reference/
nice_gan.py``) against the port: each network's forward, the D and the G
half steps (losses, gradients, parameters after Adam, every ``u`` after
the steps), the FLOP count of ``octa_bench/flops_nice_gan.py`` against
``torch.utils.flop_counter.FlopCounterMode``, and the GAN-seg dispatch of
the ``train_gan`` driver against ``reference/train.py::gan_seg_steps``.

Small networks on the CPU: two adaILN blocks, ``ngf`` and ``ndf`` 8,
``n_layers`` 3 (accepted and unused by the discriminator), batch 2, at 96²
(the discriminator's global head halves five times and then takes a 4x4
conv: below 96² it is empty), weights and ``u`` drawn by the reference's
own seeding. Tolerances:

- float64: 1e-10 everywhere (relative L2 for tensors, relative for
  losses). The two compute the same equations in the same order of
  operations up to summation order, a few ulps of float64 apart;
- float32: losses within 1e-4 relative and ``u`` within 1e-5 relative L2
  after two steps, each network's first gradient (all leaves as one
  vector) within 1e-4 relative L2; the parameters after two steps within
  ``3 lr`` elementwise: Adam's first steps move each weight by about ``lr``
  whatever the gradient's size, so a gradient a few ulps from zero whose
  sign differs between two summation orders moves its weight the other
  way.
"""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from octa_bench import flops_nice_gan
from octa_bench.reference import nice_gan as R
from octa_tpu_torch.models import nice_gan_nets as tnice
from octa_tpu_torch.train import algorithms as talg
from octa_tpu_torch.utils.enums import Phase

RES, BATCH, LR = 96, 2, 2e-4
DIS = {"name": "NiceDiscriminator", "input_nc": 1, "ndf": 8, "n_layers": 3}
GEN = {"name": "NiceResnetGenerator", "input_nc": 1, "output_nc": 1,
       "ngf": 8, "n_blocks": 2, "img_size": RES, "light": True}
NETWORKS = {"gen2A": GEN, "gen2B": GEN, "disA": DIS, "disB": DIS}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread (see ``test_torch_cut.py``), after a throw-away
    multi-threaded square root (the CPU's first-call quirk)."""
    torch.sqrt(torch.rand(1 << 20))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_config():
    return {"General": {"task": "gan-ves-seg", "seed": 3, "amp": False,
                        "inference": "gen2B",
                        "model": {"name": "NiceGAN",
                                  "gen2A_config": dict(GEN),
                                  "gen2B_config": dict(GEN),
                                  "disA_config": dict(DIS),
                                  "disB_config": dict(DIS),
                                  "adv_weight": 1, "cycle_weight": 10,
                                  "recon_weight": 1}},
            "Train": {"lr": LR, "epochs": 3, "batch_size": BATCH,
                      "loss_ad": "MSELoss", "loss_cycle": "L1Loss"},
            "Output": {"save_dir": "unused"}}


class _Args:
    start_epoch = 0


def seeded(dtype, seed=5):
    gen = torch.Generator().manual_seed(seed)
    shapes = R.shapes(NETWORKS)
    w = {n: R.seeded_weights(shapes[n], gen, dtype) for n in NETWORKS}
    u = {n: R.seeded_u(DIS, gen, dtype) for n in ("disA", "disB")}
    return w, u


def load(net, weights, u=None):
    net.load_state_dict(weights, strict=True)
    with torch.no_grad():
        for layer, v in (u or {}).items():
            net.get_submodule(layer).u.copy_(v)
    return net


def rel(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float((a - b).norm() / b.norm().clamp(min=1e-300))


def batches(dtype, n=2, seed=9):
    gen = torch.Generator().manual_seed(seed)
    return [tuple(torch.rand(BATCH, 1, RES, RES, generator=gen, dtype=dtype)
                  for _ in range(4)) for _ in range(n)]


def test_shapes_are_the_ports():
    """The reference's parameter names and shapes are the port's modules'."""
    d = tnice.NiceDiscriminator(1, DIS["ndf"], DIS["n_layers"])
    g = tnice.NiceResnetGenerator(R.z_channels(DIS), 1, 1, GEN["ngf"],
                                  GEN["n_blocks"], RES, GEN["light"])
    for net, want in ((d, R.discriminator_shapes(DIS)),
                      (g, R.generator_shapes(GEN, R.z_channels(DIS)))):
        got = {k: tuple(v.shape) for k, v in net.named_parameters()}
        assert got == want
    us = {k: tuple(v.shape) for k, v in d.named_buffers()}
    assert us == {f"{k}.u": (n,) for k, n in R.u_shapes(DIS).items()}
    assert tuple(R.u_shapes(DIS)) == R.SN_LAYERS


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-5)])
def test_discriminator_forward(dtype, tol):
    """The four outputs the trainer uses and every ``u`` after one call."""
    w, u = seeded(dtype)
    net = load(tnice.NiceDiscriminator(1, DIS["ndf"]).to(dtype), w["disA"],
               u["disA"])
    x = batches(dtype)[0][0]
    with torch.no_grad():
        out0, out1, cam, _, z = net(x)
    sn = R.SpectralState(u["disA"])
    ref = R.discriminator(w["disA"], sn, DIS, x)
    for a, b in zip((out0, out1, cam, z), ref):
        assert a.shape == b.shape
        assert rel(a, b) <= tol
    assert out1.numel() == BATCH
    for layer in R.SN_LAYERS:
        assert rel(net.get_submodule(layer).u, sn.u[layer]) <= tol
    assert sn.iterations == len(R.SN_LAYERS)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-5)])
def test_generator_forward(dtype, tol):
    w, _ = seeded(dtype)
    net = load(tnice.NiceResnetGenerator(R.z_channels(DIS), 1, 1,
                                         GEN["ngf"], GEN["n_blocks"], RES,
                                         True).to(dtype), w["gen2B"])
    z = torch.randn(BATCH, R.z_channels(DIS), RES // 4, RES // 4,
                    generator=torch.Generator().manual_seed(2), dtype=dtype)
    with torch.no_grad():
        got = net(z)
    ref = R.generator(w["gen2B"], GEN, z)
    assert got.shape == ref.shape == (BATCH, 1, RES, RES)
    assert rel(got, ref) <= tol


def port_steps(dtype, inputs):
    """The port's trainer from the reference's seeded weights and ``u``,
    stepped on ``inputs``: per step the losses, and the first step's
    gradients (each network's last backward), the parameters and ``u``
    after the last step."""
    cfg = run_config()
    t = talg.define_model(cfg, Phase.TRAIN, "cpu")
    t.initialize_model_and_optimizer(
        {"real_A": torch.zeros(BATCH, 1, RES, RES)}, cfg, _Args())
    w, u = seeded(dtype)
    for name, net in t.networks.items():
        load(net.to(dtype), w[name], u.get(name))
    out = {"losses": [], "grads": None}
    for b in inputs:
        _, losses = t.train_step(*b)
        out["losses"].append({k: float(v) for k, v in losses.items()})
        if out["grads"] is None:
            out["grads"] = {n: {k: p.grad.clone()
                                for k, p in net.named_parameters()}
                            for n, net in t.networks.items()}
    out["params"] = {n: {k: p.detach().clone()
                         for k, p in net.named_parameters()}
                     for n, net in t.networks.items()}
    out["u"] = {n: {k: t.networks[n].get_submodule(k).u.clone()
                    for k in R.SN_LAYERS} for n in ("disA", "disB")}
    return out, w, u


@pytest.fixture(scope="module", params=[torch.float64, torch.float32],
                ids=["float64", "float32"])
def stepped(request):
    dtype = request.param
    inputs = batches(dtype)
    prog, w, u = port_steps(dtype, inputs)
    ref = R.steps({"run": run_config(), "networks": NETWORKS}, w, u, inputs)
    return dtype, prog, ref, w


def test_losses(stepped):
    dtype, prog, ref, _ = stepped
    tol = 1e-10 if dtype == torch.float64 else 1e-4
    assert len(prog["losses"]) == len(ref["losses"]) == 2
    for p, r in zip(prog["losses"], ref["losses"]):
        assert set(p) == set(R.LOSSES) == set(r)
        for k in R.LOSSES:
            assert p[k] == pytest.approx(r[k], rel=tol), k


def test_first_gradients(stepped):
    """The D half's gradients of the discriminators, the G half's of the
    generators, in the first step."""
    dtype, prog, ref, _ = stepped
    for net, g_ref in ref["grads"].items():
        g = prog["grads"][net]
        assert set(g) == set(g_ref)
        if dtype == torch.float64:
            for k in g_ref:
                assert rel(g[k], g_ref[k]) <= 1e-10, (net, k)
        else:
            keys = list(g_ref)
            flat = lambda d: torch.cat([d[k].flatten() for k in keys])  # noqa: E731
            assert rel(flat(g), flat(g_ref)) <= 1e-4, net


def test_parameters_after_adam(stepped):
    dtype, prog, ref, w = stepped
    for net, p_ref in ref["params"].items():
        for k, v in p_ref.items():
            got = prog["params"][net][k]
            if dtype == torch.float64:
                assert rel(got - w[net][k], v - w[net][k]) <= 1e-10, (net, k)
            else:
                assert float((got - v).abs().max()) <= 3 * LR, (net, k)


def test_u_after_the_steps(stepped):
    """Every ``u`` after two steps: sixteen discriminator calls, each one
    power iteration of each spectral-norm conv, threaded in the JAX step's
    order."""
    dtype, prog, ref, _ = stepped
    tol = 1e-10 if dtype == torch.float64 else 1e-5
    assert ref["power_iterations"] == [8 * len(R.SN_LAYERS)] * 2
    for net in ("disA", "disB"):
        for layer in R.SN_LAYERS:
            assert rel(prog["u"][net][layer], ref["u"][net][layer]) <= tol


@pytest.mark.parametrize("net", ["disA", "gen2B"])
def test_flop_count_matches_the_flop_counter(net):
    """Convolutions, dense layers and the CAM product, as
    ``FlopCounterMode`` counts them on one image through the port."""
    if net == "disA":
        module = tnice.NiceDiscriminator(1, DIS["ndf"], DIS["n_layers"])
        x = torch.rand(1, 1, RES, RES)
    else:
        module = tnice.NiceResnetGenerator(R.z_channels(DIS), 1, 1,
                                           GEN["ngf"], GEN["n_blocks"], RES,
                                           True)
        x = torch.rand(1, R.z_channels(DIS), RES // 4, RES // 4)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        module(x)
    assert flops_nice_gan.network_flops(NETWORKS, net, (RES, RES)) \
        == fc.get_total_flops()


def test_train_gan_gan_seg_is_the_shipped_reference():
    """The ``train_gan`` driver's reference for the GAN-seg cell is
    ``reference/train.py::gan_seg_steps`` as it stands, on the kept
    weights and batches: one step at a small size gives the same losses,
    gradients and parameters, bit for bit."""
    import copy
    import json

    from octa_bench.drivers import train_gan
    from octa_bench.reference import nets
    from octa_bench.reference import train as ref_train
    from octa_bench.tests.test_bench_train_gan import GAN_SEG_SIZES, resized

    root = __import__("pathlib").Path(__file__).resolve().parents[1]
    config = json.loads((root / "octa_bench/configs/gan_ves_seg.json")
                        .read_text())
    config["run"] = resized(config["run"], GAN_SEG_SIZES)
    config["run"]["General"]["model"]["upshape"] = [64, 64]
    nw = copy.deepcopy(config["networks"])
    nw["generator"]["n_blocks"] = 2
    config["networks"] = nw
    gen = torch.Generator().manual_seed(4)
    weights = {k: nets.seeded_weights(nets.SHAPES[v["name"]](v), gen)
               for k, v in nw.items()}
    x = torch.rand(2, BATCH, 1, 32, 32, generator=gen)
    label = (torch.rand(BATCH, 1, 64, 64, generator=gen) > 0.5).float()
    batches = [(x[0], x[1], label)]

    class Run:
        pass

    class Cap:
        nice = False

    run, cap = Run(), Cap()
    run.config = config
    cap.weights, cap.batches = weights, batches
    got = train_gan.reference(run, cap)
    want = ref_train.gan_seg_steps(config, weights, batches)
    assert got["losses"] == want["losses"]
    for part in ("grads", "params"):
        for net, d in want[part].items():
            for k, v in d.items():
                assert torch.equal(got[part][net][k], v), (part, net, k)
