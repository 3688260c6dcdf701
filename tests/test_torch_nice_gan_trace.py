"""NICE-GAN's spans and counter (``octa_tpu_torch.utils.trace``): under a
profiler one training step records the ranges ``octa.train.D`` and
``octa.train.G`` and one ``octa.nice.spectral_norm`` range for each power
iteration, the two halves are noted with their ``power_iterations`` (four
discriminator calls each, one iteration of each spectral-norm conv a
call), and ``SpectralNormConv.power_iterations`` counts them traced or
not; without a profiler no span is kept and the step's outputs are bit for
bit the traced step's. Small networks on the CPU, as
``test_torch_nice_gan_reference.py``."""
import copy

import pytest
import torch

from octa_bench.reference import nice_gan as R
from octa_tpu_torch.models.layers import SpectralNormConv
from octa_tpu_torch.train import algorithms as talg
from octa_tpu_torch.utils import trace
from octa_tpu_torch.utils.enums import Phase
from tests.test_torch_nice_gan_reference import (
    BATCH,
    RES,
    _Args,
    batches,
    load,
    run_config,
    seeded,
)

PER_HALF = 4 * len(R.SN_LAYERS)
SPANS = ("octa.train.D", "octa.train.G", "octa.nice.spectral_norm")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    torch.sqrt(torch.rand(1 << 20))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trainer():
    """A small NICE-GAN trainer on the CPU from the reference's seeded
    weights and ``u``, before its first step."""
    cfg = run_config()
    t = talg.define_model(cfg, Phase.TRAIN, "cpu")
    t.initialize_model_and_optimizer(
        {"real_A": torch.zeros(BATCH, 1, RES, RES)}, cfg, _Args())
    w, u = seeded(torch.float32)
    for name, net in t.networks.items():
        load(net, w[name], u.get(name))
    return t


def step(t, inputs):
    """One step of a copy of ``t``: the images, losses, parameters and
    ``u`` after it, and the counter's advance."""
    t = copy.deepcopy(t)
    first = SpectralNormConv.power_iterations
    images, losses = t.train_step(*inputs)
    state = {f"{n}.{k}": v.detach().clone()
             for n, net in t.networks.items()
             for k, v in net.state_dict(keep_vars=True).items()}
    state.update({f"{n}.{k}.u": t.networks[n].get_submodule(k).u.clone()
                  for n in ("disA", "disB") for k in R.SN_LAYERS})
    return images, losses, state, SpectralNormConv.power_iterations - first


@pytest.fixture(scope="module")
def traced(trainer):
    inputs = batches(torch.float32, n=1)[0]
    trace.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = step(trainer, inputs)
    log = trace.log()
    trace.clear()
    events = [e.name for e in prof.events()]
    return inputs, out, log, events


def test_the_profiler_records_each_half_and_each_power_iteration(traced):
    _, _, _, events = traced
    assert events.count("octa.train.D") == events.count("octa.train.G") == 1
    assert events.count("octa.nice.spectral_norm") == 2 * PER_HALF


def test_the_log_holds_the_spans_nested_in_order(traced):
    _, _, log, _ = traced
    by = {n: [e for e in log if e[0] == n] for n in SPANS}
    (_, d0, d1, _, _), = by["octa.train.D"]
    (_, g0, g1, _, _), = by["octa.train.G"]
    assert d1 <= g0
    sn = by["octa.nice.spectral_norm"]
    assert len(sn) == 2 * PER_HALF
    assert sum(d0 <= e[1] and e[2] <= d1 for e in sn) == PER_HALF
    assert sum(g0 <= e[1] and e[2] <= g1 for e in sn) == PER_HALF


def test_power_iterations_noted_and_counted(traced):
    _, out, log, _ = traced
    notes = {e[0]: e[4] for e in log if e[0] in SPANS[:2]}
    assert notes == {"octa.train.D": {"power_iterations": PER_HALF},
                     "octa.train.G": {"power_iterations": PER_HALF}}
    assert out[3] == 8 * len(R.SN_LAYERS) == 72
    totals = trace.totals(log)
    assert totals["octa.train.D"]["notes"]["power_iterations"] \
        + totals["octa.train.G"]["notes"]["power_iterations"] == 72


def test_no_profiler_keeps_no_span_and_changes_nothing(trainer, traced):
    inputs, (images, losses, state, count), _, _ = traced
    trace.clear()
    images_off, losses_off, state_off, count_off = step(trainer, inputs)
    assert trace.log() == []
    assert count_off == count == 72
    for a, b in zip(images_off, images):
        assert torch.equal(a, b)
    assert losses_off.keys() == losses.keys()
    for k in losses:
        assert torch.equal(losses_off[k], losses[k]), k
    assert state_off.keys() == state.keys()
    for k in state:
        assert torch.equal(state_off[k], state[k]), k
