"""Training with discriminators through the engine's loop
(``octa_tpu_torch.train.engine.train``), closed, as ``engine_train.py``
runs it: NICE-GAN (``NiceGANAlgorithm``) and GAN-seg
(``GanSegAlgorithm``). The loader thread renders every batch's ``real_A``
on the fly (K1, the flips and rotations the config lists) beside the
steps; the window runs from the end of the last warm step to the first
step boundary after ``--seconds``, and the epoch is longer than that.

Set-up is the engine's start and its first ``warm_steps`` steps. The
weights are the benchmark's, drawn from the seed on the card into the
networks the engine builds; NICE-GAN's generators, which the trainer
builds only once a dry pass of a discriminator has sized them, are
seeded after ``initialize_model_and_optimizer``, and so are the spectral
norms' initial ``u``. The first ``check_steps`` steps' inputs (for
NICE-GAN the step's own: ``real_A``, ``real_B``, the background and the
uniform ``u`` of its composite), losses, first gradients and the
parameters after them are kept, NICE-GAN's ``u`` after them too.

Once the window has closed the reference (``reference/nice_gan.py``;
``reference/train.py::gan_seg_steps``) follows those steps from the same
weights on the program's inputs, and the loader's renders of the first
samples are checked by themselves. The numbers:

- ``render_max_abs``, ``grad_cos`` and ``change_gap``: as
  ``engine_train.py``;
- ``loss_rel``: the largest relative gap of any named loss of the
  reference over the check steps;
- NICE-GAN: ``u_rel``, the largest relative L2 gap of a spectral norm's
  ``u`` after the check steps: a power iteration left out or taken twice
  moves it.
"""
from __future__ import annotations

import contextlib
import math
import sys

import torch

from octa_bench import flops, flops_nice_gan
from octa_bench.drivers import engine_train as et
from octa_bench.reference import nets
from octa_bench.reference import nice_gan as ref_nice

NICE = "NiceGANAlgorithm"
#: the fault of calibration: each discriminator's first call of a step
#: leaves out ``dis1_1``'s power iteration
SKIP = (0, "dis1_1")


class Capture(et.Capture):
    """``engine_train.Capture`` with NICE-GAN's weights, inputs and ``u``."""

    def __init__(self, run, tracer):
        super().__init__(run, tracer)
        self.nice = run.config["algorithm"] == NICE
        self.u = {}
        self.u_after = None

    def define_model(self, orig):
        if not self.nice:
            return super().define_model(orig)

        def wrapped(config, phase, device="cuda", mesh=None):
            model = orig(config, phase, device, mesh=mesh)
            init = model.initialize_model_and_optimizer

            def initialize(*args, **kw):
                init(*args, **kw)
                self._seed(model)

            model.initialize_model_and_optimizer = initialize
            train_step = model.train_step

            def kept_train_step(*inputs):
                if len(self.batches) < self.check_steps:
                    self.batches.append(tuple(t.detach().clone()
                                              for t in inputs))
                return train_step(*inputs)

            model.train_step = kept_train_step
            step = model.perform_training_step

            def perform_training_step(mini_batch, post):
                with self.tracer.span("step"):
                    return step(mini_batch, post)

            model.perform_training_step = perform_training_step
            self.model = model
            return model

        return wrapped

    def _seed(self, model):
        """The benchmark's weights and initial ``u`` in every network, one
        draw from the seed on the model's device."""
        gen = torch.Generator(model.device).manual_seed(self.run.seed32(3))
        spec = self.run.config["networks"]
        shapes = ref_nice.shapes(spec)
        by_key = {v: k for k, v in self.run.config["program_networks"].items()}
        for key in spec:
            net = model.networks[by_key[key]]
            w = ref_nice.seeded_weights(shapes[key], gen)
            net.load_state_dict(w, strict=True)
            self.weights[key] = {k: v.clone() for k, v in w.items()}
        for key in spec:
            if key in ref_nice.ENCODER:
                continue
            net = model.networks[by_key[key]]
            self.u[key] = ref_nice.seeded_u(spec[key], gen)
            with torch.no_grad():
                for layer, u in self.u[key].items():
                    net.get_submodule(layer).u.copy_(u)

    def on_step(self, epoch, step, losses, wait_s, step_s):
        if self.nice and self.steps + 1 == self.check_steps:
            by_key = {v: k for k, v in
                      self.run.config["program_networks"].items()}
            self.u_after = {
                key: {layer: self.model.networks[by_key[key]]
                      .get_submodule(layer).u.detach().clone()
                      for layer in ref_nice.SN_LAYERS}
                for key in self.u}
        super().on_step(epoch, step, losses, wait_s, step_s)

    def program(self) -> dict:
        out = super().program()
        if self.nice:
            out["u"] = self.u_after
        return out


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------

def loss_rel(prog: list, ref: list) -> float:
    """The largest relative gap of any loss the reference names, over its
    steps; +inf where the program lacks one."""
    worst = 0.0
    for k, losses in enumerate(ref):
        if k >= len(prog):
            return math.inf
        for name, r in losses.items():
            if name not in prog[k]:
                return math.inf
            worst = max(worst, abs(prog[k][name] - r) / max(abs(r), 1e-30))
    return worst


def u_rel(prog: dict | None, ref: dict) -> float:
    """The largest relative L2 gap of a spectral norm's ``u``."""
    if not prog:
        return math.inf
    worst = 0.0
    for net, us in ref.items():
        for layer, r in us.items():
            got = prog[net][layer].double().flatten()
            r = r.double().flatten()
            worst = max(worst, float((got - r).norm()
                                     / r.norm().clamp(min=1e-30)))
    return worst


def reference(run, cap, prec="fp32", half=False, skip=None) -> dict:
    """The reference's check steps from the captured weights and inputs."""
    if cap.nice:
        return ref_nice.steps(run.config, cap.weights, cap.u, cap.batches,
                              prec, half, skip)
    return et.reference_steps(run, cap.weights, cap.batches, prec, half)


def numbers(run, prog: dict, ref: dict, init: dict) -> list:
    out = list(et.step_numbers(prog, ref, init).items())
    out.append(("loss_rel", loss_rel(prog["losses"], ref["losses"])))
    if run.config["algorithm"] == NICE:
        out.append(("u_rel", u_rel(prog.get("u"), ref["u"])))
    return out


def check(run, cap, prec="fp32", ref=None) -> list[tuple[str, float]]:
    """The numbers that decide ``correct``; ``prec`` ``low`` puts the
    lower-precision reference in the program's place (the loader's K1 in
    bfloat16, the networks in fp8)."""
    dev = torch.device(run.device)
    low = prec != "fp32"
    r_gap = 0.0
    for e in cap.renders:
        refs = et.render_refs(e, dev)
        got = et.render_refs(e, dev, torch.bfloat16) if low else e["out"]
        r_gap = max([r_gap] + [et._gap(g, r, 255.0)
                               for g, r in zip(got, refs)])
    if ref is None:
        ref = reference(run, cap)
    prog = reference(run, cap, prec) if low else cap.program()
    return [("render_max_abs", r_gap)] + numbers(run, prog, ref, cap.weights)


# ---------------------------------------------------------------------------

def train_window(run) -> Capture:
    """``engine_train.train_window`` with this driver's :class:`Capture`,
    the engine's prints (a config without validation says so) on standard
    error: standard output is the result line's."""
    base, et.Capture = et.Capture, Capture
    try:
        with contextlib.redirect_stdout(sys.stderr):
            return et.train_window(run)
    finally:
        et.Capture = base


def _tf32_flags():
    b = torch.backends
    return (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())


def _set_tf32_flags(flags):
    b = torch.backends
    b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = flags[:2]
    torch.set_float32_matmul_precision(flags[2])


def run(run):
    cap = train_window(run)
    run.window_closed(torch)
    cap.model = None
    run.free(torch)
    flags = _tf32_flags()
    nets.no_tf32()
    try:
        ref = reference(run, cap)
        run.checks = check(run, cap, ref=ref)
        if run.calibrate:
            run.control = check(run, cap, "low", ref=ref)
            faults = {"half_batch": {"half": True}}
            if cap.nice:
                faults["skipped_power_iteration"] = {"skip": SKIP}
            for name, kw in faults.items():
                got = reference(run, cap, **kw)
                run.faults[name] = numbers(run, got, ref, cap.weights)
    finally:
        _set_tf32_flags(flags)  # the program's own, for a next run
    n = len(cap.step_s)
    window_s = cap.t_end - run.t_first
    count = flops_nice_gan if cap.nice else flops
    per_step = count.passes_flops(run.config, "train_step")
    images = n * run.config["images_per_step"]
    run.attempted, run.failed = n, 0
    run.e2e = {"train_img_per_s": images / window_s}
    run.record = {"cell": run.cell.name, "window_s": window_s, "units": n,
                  "images": images, "flops": per_step * n,
                  "wait_s": cap.wait_s, "step_s": cap.step_s}
