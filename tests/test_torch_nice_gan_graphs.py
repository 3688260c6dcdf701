"""NICE-GAN's generator passes replayed from CUDA graphs
(``octa_tpu_torch.train.graphed``). Off CUDA every pass runs eagerly and
nothing is recorded: the step is the eager one. On a card (marker
``card``; ``python -m pytest tests -m card``) a small trainer's graphed
step gives the eager step's losses, gradients and spectral norms' ``u``,
the step that records the sixteen call sites (each network four times a
step) and a step that only replays them. Small
networks, as ``test_torch_nice_gan_reference.py``."""
import copy

import pytest
import torch

from octa_bench.reference import nice_gan as R
from octa_tpu_torch.train import algorithms as talg
from octa_tpu_torch.train.graphed import GraphedPasses
from octa_tpu_torch.utils.enums import Phase
from test_torch_nice_gan_reference import (  # tests/, as pytest runs it
    BATCH,
    RES,
    _Args,
    batches,
    load,
    rel,
    run_config,
    seeded,
)

#: relative gaps of the graphed step from the eager one, with TF32 off and
#: cuDNN deterministic: the losses, every parameter's gradient and the
#: spectral norms' ``u`` after the step. cuDNN may take another algorithm
#: inside a capture than outside (its workspace then comes from the
#: graph's pool), which rounds otherwise (a float32 gradient read 6.9e-4
#: apart on the card, a loss 1e-5); the graphs add each call site's
#: gradients into ``.grad`` in autograd's order; ``u`` after the step
#: follows the D step's Adam update, which moves by a whole step wherever
#: a gradient is near 0 and its sign changes with the rounding; bf16
#: autocast rounds each pass's products. A call site's gradient left out or
#: added twice moves a gradient by a third or more, a stale input a loss.
#: (Parameters after Adam are not compared, for the same reason as ``u``.)
TOL = {False: {"loss": 1e-4, "grad": 1e-2, "u": 1e-3},
       True: {"loss": 1e-2, "grad": 5e-2, "u": 1e-2}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.sqrt(torch.rand(1 << 20))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def trainer(device="cpu", amp=False):
    """A small NICE-GAN trainer from the reference's seeded weights and
    ``u``, before its first step."""
    cfg = run_config()
    cfg["General"]["amp"] = amp
    t = talg.define_model(cfg, Phase.TRAIN, device)
    t.initialize_model_and_optimizer(
        {"real_A": torch.zeros(BATCH, 1, RES, RES, device=device)}, cfg,
        _Args())
    w, u = seeded(torch.float32)
    for name, net in t.networks.items():
        load(net, {k: v.to(device) for k, v in w[name].items()},
             {k: v.to(device) for k, v in u.get(name, {}).items()})
    return t


def state(t) -> dict:
    out = {f"{n}.{k}": v.detach().clone()
           for n, net in t.networks.items()
           for k, v in net.state_dict(keep_vars=True).items()}
    out.update({f"{n}.{k}.u": t.networks[n].get_submodule(k).u.clone()
                for n in ("disA", "disB") for k in R.SN_LAYERS})
    return out


def test_a_cpu_step_records_nothing():
    t = trainer()
    t.train_step(*batches(torch.float32, n=1)[0])
    assert (t.passes.recorded, t.passes.replays) == (0, 0)
    assert t._calls is None


def test_off_cuda_a_pass_is_the_network():
    t = trainer()
    net = t.networks["gen2B"]
    z = torch.rand(BATCH, R.z_channels(t.config["General"]["model"][
        "disA_config"]), RES // 4, RES // 4)
    passes = GraphedPasses(t.autocast)
    assert torch.equal(passes("site", net, net, z), net(z))
    assert torch.equal(t._net("gen2B", z), net(z))
    assert (passes.recorded, passes.replays) == (0, 0)


def grads(t) -> dict:
    return {f"{n}.{k}": p.grad.clone() for n, net in t.networks.items()
            for k, p in net.named_parameters()}


def same_state(t, ref):
    """``t`` given ``ref``'s parameters, ``u`` and Adam states, in place (the
    graphs keep reading the same memory)."""
    with torch.no_grad():
        for n, net in t.networks.items():
            net.load_state_dict(ref.networks[n].state_dict())
            for k, b in net.named_buffers():
                b.copy_(ref.networks[n].get_buffer(k))
        for k, opt in t.opt.items():
            params = [p for g in opt.param_groups for p in g["params"]]
            ref_params = [p for g in ref.opt[k].param_groups
                          for p in g["params"]]
            for p, q in zip(params, ref_params):
                for key, v in opt.state[p].items():
                    v.copy_(ref.opt[k].state[q][key])


@pytest.mark.card
@pytest.mark.parametrize("amp", [False, True], ids=["fp32", "amp"])
def test_graphed_steps_are_the_eager_steps_on_the_card(amp):
    """The first step records the call sites and replays them; the second,
    from the eager trainer's state, replays them alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b = torch.backends
    flags = (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32,
             b.cudnn.deterministic, b.cudnn.benchmark)
    b.cudnn.allow_tf32 = b.cuda.matmul.allow_tf32 = False
    b.cudnn.deterministic, b.cudnn.benchmark = True, False
    try:
        graphed, eager = trainer("cuda", amp), trainer("cuda", amp)
        eager.passes = None
        for step, inputs in enumerate(batches(torch.float32, n=2)):
            if step:
                same_state(graphed, eager)
            inputs = tuple(x.cuda() for x in inputs)
            _, got = graphed.train_step(*inputs)
            _, want = eager.train_step(*inputs)
            for k in want:
                assert rel(got[k], want[k]) <= TOL[amp]["loss"], (step, k)
            got, want = grads(graphed), grads(eager)
            for k in want:
                assert rel(got[k], want[k]) <= TOL[amp]["grad"], (step, k)
            got, want = state(graphed), state(eager)
            for k in want:
                if k.endswith(".u"):
                    assert rel(got[k], want[k]) <= TOL[amp]["u"], (step, k)
    finally:
        (b.cudnn.allow_tf32, b.cuda.matmul.allow_tf32, b.cudnn.deterministic,
         b.cudnn.benchmark) = flags
    assert graphed.passes.recorded == 16
    assert graphed.passes.replays == 16 * 2


def test_a_copy_of_a_trainer_records_its_own_sites():
    t = trainer()
    t.passes.sites["site"] = object()
    twin = copy.deepcopy(t)
    assert twin.passes.sites == {} and twin.passes is not t.passes
    assert twin.passes.amp.__self__ is twin
