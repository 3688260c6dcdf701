"""Training through the engine's loop (``octa_tpu_torch.train.engine.train``),
closed: the loader thread renders every batch on the fly (K1, the noise
model, the flips and rotations the config lists) beside the steps, and the
loop post-processes each step's prediction.

Set-up is the engine's own start and its first ``warm_steps`` steps: the
weights are the benchmark's, drawn from the seed into the networks the
engine builds; the first ``check_steps`` steps' batches, losses, the
optimizers' state after step 1 and the parameters after the last of them
are kept. The window runs from the end of the last warm step to the first
step boundary after ``--seconds``, where the run leaves the engine. The
epoch is longer than that, so no validation or checkpoint falls inside it.

Once the window has closed the reference follows those steps from the same
weights on the program's batches (it cannot draw the loader's random
augmentations itself), and the loader's K1 renders and noise draws of the
first samples are checked by themselves, replayed from the random states
they started from.
"""
from __future__ import annotations

import copy
import math
import random
import statistics
import time
from argparse import Namespace

import torch

from octa_bench import datasets, flops, measure
from octa_bench.adapt import read_graph
from octa_bench.reference import nets, noise, splat
from octa_bench.reference import train as ref_train


class StopWindow(Exception):
    """Raised from ``on_step`` at the window's end: leaves the engine."""


def prepare(run) -> dict:
    """The configuration as run: the shipped one with its data in the run's
    scratch directory and the seed of the run."""
    cfg = copy.deepcopy(run.config["run"])
    data = datasets.make(f"{run.tmp}/datasets", run.seed32(7),
                         run.traffic["data"])
    for phase in ("Train", "Validation"):
        for entry in cfg.get(phase, {}).get("data", {}).values():
            kind = entry["files"].split("/")[1]
            entry["files"] = data[kind]
            if entry.get("split"):
                entry["split"] = data["split"]
    cfg["Output"]["save_dir"] = f"{run.tmp}/results"
    cfg["General"]["seed"] = run.seed32()
    return cfg


class Capture:
    """Everything the run keeps of the program's first steps and loader."""

    def __init__(self, run, tracer):
        self.run = run
        self.tracer = tracer
        tr = run.traffic
        self.warm = int(tr["warm_steps"])
        self.check_steps = int(tr["check_steps"])
        self.loader_samples = int(tr["loader_samples"])
        self.model = None
        self.weights = {}
        self.batches = []
        self.preds = []
        self.losses = []
        self.grads = None
        self.params = None
        self.renders = []
        self.noises = []
        self.steps = 0
        self.wait_s, self.step_s = [], []
        self.t_end = None

    # -- the engine's model --------------------------------------------------
    def define_model(self, orig):
        def wrapped(config, phase, device="cuda", mesh=None):
            model = orig(config, phase, device, mesh=mesh)
            gen = torch.Generator(device).manual_seed(self.run.seed32(3))
            names = self.run.config["program_networks"]
            for prog_name, net in model.networks.items():
                key = names[prog_name]
                spec = self.run.config["networks"][key]
                w = nets.seeded_weights(nets.SHAPES[spec["name"]](spec), gen)
                net.load_state_dict(w, strict=True)
                self.weights[key] = {k: v.clone() for k, v in w.items()}
            step = model.perform_training_step

            def perform_training_step(mini_batch, post):
                if len(self.batches) < self.check_steps:
                    self.batches.append(tuple(
                        mini_batch[k].detach().clone()
                        for k in self.run.config["batch_keys"]))
                with self.tracer.span("step"):
                    return step(mini_batch, post)

            model.perform_training_step = perform_training_step
            train_step = getattr(model, "train_step", None)
            if train_step is not None:
                def kept_train_step(*args, **kw):
                    out = train_step(*args, **kw)
                    if (len(self.preds) < self.check_steps
                            and isinstance(out, tuple)
                            and torch.is_tensor(out[0])):
                        self.preds.append(out[0].detach().float().clone())
                    return out

                model.train_step = kept_train_step
            if self.run.trace:
                metric = model.compute_metric

                def compute_metric(outputs, metrics):
                    with self.tracer.span("post_processing"):
                        return metric(outputs, metrics)

                model.compute_metric = compute_metric
            self.model = model
            return model

        return wrapped

    def _named_state(self, what: str) -> dict:
        """Per network (by the config's names): ``grad`` as Adam's first
        moment after one step gives it, or the parameters."""
        names = self.run.config["program_networks"]
        out = {}
        for opt_name, net_names in self.model.optimizer_mapping.items():
            opt = self.model.opt[opt_name]
            beta1 = opt.param_groups[0]["betas"][0]
            for prog_name in net_names:
                net = self.model.networks[prog_name]
                d = {}
                for k, p in net.named_parameters():
                    if what == "grad":  # no moment: no gradient reached it
                        m = opt.state[p].get("exp_avg", torch.zeros_like(p))
                        d[k] = (m / (1 - beta1)).clone()
                    else:
                        d[k] = p.detach().clone()
                out[names[prog_name]] = d
        return out

    def program(self) -> dict:
        """What the program's first steps gave, as the reference gives it."""
        return {"losses": self.losses, "grads": self.grads,
                "params": self.params,
                "logits": self.preds if self.preds else None}

    # -- the engine's step hook ---------------------------------------------
    def on_step(self, epoch, step, losses, wait_s, step_s):
        self.steps += 1
        now = time.perf_counter()
        if self.steps <= self.check_steps:
            self.losses.append(dict(losses))
        if self.steps == 1:
            self.grads = self._named_state("grad")
        if self.steps == self.check_steps:
            self.params = self._named_state("param")
        if self.steps == self.warm:
            self.tracer.start()
            self.run.t_first = time.perf_counter()
            return
        if self.steps < self.warm:
            return
        self.wait_s.append(wait_s)
        self.step_s.append(step_s)
        t0 = self.run.t_first
        if self.tracer.prof is not None and (
                now - t0 >= min(self.run.traffic["trace_seconds"],
                                self.run.seconds)):
            self.run.device_trace = self.tracer.stop()
        if now - t0 >= self.run.seconds:
            self.t_end = now
            raise StopWindow

    # -- the loader's renders and noise --------------------------------------
    def loader_hooks(self, T):
        cap = self

        load_call = T.LoadGraphAndFilterByRandomRadiusd.__call__
        noise_call = T.NoiseModeld.__call__

        def load(tf, data):
            keep = len(cap.renders) < cap.loader_samples
            if keep:
                entry = {"paths": [data[k] for k in tf.keys if k in data],
                         "keys": [k for k in tf.keys if k in data],
                         "py_state": tf.rng.py.getstate(),
                         "res": tf.image_resolutions,
                         "min_radius": tf.min_radius,
                         "dropout": tf.max_dropout_prob}
            out = load_call(tf, data)
            if keep:
                entry["out"] = [out[k].detach().clone() for k in entry["keys"]]
                cap.renders.append(entry)
            return out

        def noised(tf, data):
            keep = len(cap.noises) < cap.loader_samples
            if keep:
                k = tf.keys[0]
                entry = {"key": k, "image": tf._tensor(data[k]).float().clone(),
                         "background": tf._tensor(data["background"]).float().clone(),
                         "gen_state": tf.rng.generator.get_state(),
                         "grid": tf.grid_size,
                         "lambdas": (tf.lambda_delta, tf.lambda_speckle,
                                     tf.lambda_gamma),
                         "downsample": tf.downsample_factor}
            out = noise_call(tf, data)
            if keep:
                entry["out"] = out[k].detach().float().clone()
                cap.noises.append(entry)
            return out

        T.LoadGraphAndFilterByRandomRadiusd.__call__ = load
        T.NoiseModeld.__call__ = noised
        return lambda: (setattr(T.LoadGraphAndFilterByRandomRadiusd,
                                "__call__", load_call),
                        setattr(T.NoiseModeld, "__call__", noise_call))


def loader_spans(D, tracer):
    """``bench.loader_wait`` around every batch the engine takes."""
    orig = D.DataLoader.__iter__

    def spanned(self):
        it = orig(self)
        try:
            while True:
                with tracer.span("loader_wait"):
                    try:
                        batch = next(it)
                    except StopIteration:
                        return
                yield batch
        finally:
            it.close()

    D.DataLoader.__iter__ = spanned
    return lambda: setattr(D.DataLoader, "__iter__", orig)


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------

def _kept_edges(arr, min_radius, dropout, blackdict, rng):
    """The radius filter and the hierarchical edge dropout of the renderer,
    replayed from ``rng`` (``random.Random``): ``p = U**10 * dropout`` once
    an image, drawn only for its first render; an edge whose second node is
    blacklisted, or whose draw falls below ``p``, is dropped and blacklists
    its first node, in the file's order."""
    radius = arr[:, 6]
    rkeep = (radius >= min_radius) & (radius <= 1)
    if blackdict is None:
        blackdict = {}
        p = rng.random() ** 10 * dropout
    else:
        p = 0.0
    if p == 0 and not blackdict:
        return rkeep, blackdict
    keep = rkeep.copy()
    for i in range(len(arr)):
        if not rkeep[i]:
            continue
        if tuple(arr[i, 3:6]) in blackdict or rng.random() < p:
            blackdict[tuple(arr[i, 0:3])] = True
            keep[i] = False
    return keep, blackdict


def render_refs(entry, device, dtype=torch.float32) -> list:
    """The reference's renders (0-255) of one sample's loader call."""
    rng = random.Random()
    rng.setstate(entry["py_state"])
    blackdict, out = None, []
    arrays = {}
    for i, path in enumerate(entry["paths"]):
        arr = arrays.setdefault(path, read_graph(path))
        keep, blackdict = _kept_edges(arr, entry["min_radius"][i],
                                      entry["dropout"], blackdict, rng)
        nx, ny = entry["res"][i]
        t = torch.from_numpy(arr).to(device, torch.float32)
        a, b = t[None, :, 0:2] * ny, t[None, :, 3:5] * ny
        w = t[None, :, 6] * 1.3 * max(nx, ny) * (100.0 / 72.0)
        v = torch.from_numpy(keep).to(device)[None]
        out.append(splat.splat(a, b, w, v, ny, nx, 16384, dtype=dtype)[0]
                   * 255.0)
    return out


def noise_ref(entry, dtype=torch.float32):
    """The reference's noised image of one loader call, its draws replayed
    from the generator state the call started from."""
    img, bg = entry["image"], entry["background"]
    if entry["downsample"] != 1:
        raise ValueError("the noise check replays downsample_factor 1 only")
    gen = torch.Generator(img.device)
    gen.set_state(entry["gen_state"])
    p = noise.draw_params(img.shape[0], gen, tuple(entry["grid"]))
    return noise.apply(p, img, bg[:img.shape[0]], gen, *entry["lambdas"],
                       dtype=dtype)


def _gap(got, ref, scale=1.0) -> float:
    return float((got.float().reshape(ref.shape) - ref).abs().max()) / scale


def _p99(got, ref) -> float:
    """The 99th percentile of the pixels' gaps: a Gamma draw replayed from
    concentrations a last bit apart can land elsewhere at a pixel or two
    (a rejection sampler's accept flips), which a largest gap, or a norm of
    the gap, would read as a fault."""
    gap = (got.float().reshape(ref.shape) - ref).abs().flatten()
    return float(torch.quantile(gap, 0.99))


def _norm(t) -> float:
    return float(t.double().norm())


def _flat(grads: dict, keys) -> torch.Tensor:
    return torch.cat([grads[k].double().flatten() for k in keys])


# the fewest elements of a leaf whose fit ``batch_weights`` takes
FIT_MIN_SIZE = 1000


def batch_weights(grads: dict, image_grads: list) -> float:
    """How far the first gradient lies from the mean of the batch's images',
    leaf by leaf: the weights ``w`` that fit a leaf's gradient best as a sum
    of the reference's per-image gradients of that leaf (least squares), by
    the largest ``|n w_i - 1|`` over the ``n`` images; the median over the
    leaves of ``FIT_MIN_SIZE`` elements or more (a fit of ``n`` weights to the
    output's one bias, or to a norm's few scales, is decided by rounding).
    Leaving half of the batch out reads 1 (``w`` a half on the kept
    images, 0 on the others), however parallel the images' gradients are."""
    vals = []
    for k in image_grads[0]:
        g = torch.stack([gi[k].double().flatten() for gi in image_grads])
        if g.shape[1] < FIT_MIN_SIZE:
            continue
        w = torch.linalg.lstsq(g @ g.T, (g @ grads[k].double().flatten())
                               [:, None]).solution[:, 0]
        vals.append(float((len(image_grads) * w - 1).abs().max()))
    return statistics.median(vals) if vals else math.inf


def pred_rel(preds: list, ref_logits: list) -> float:
    """The largest relative L2 gap, image by image, of the logits the
    program's steps returned from the reference's on the same batch and
    weights; +inf where an image is missing."""
    worst = 0.0
    for k, ref in enumerate(ref_logits):
        if k >= len(preds) or preds[k].shape != ref.shape:
            return math.inf
        x, r = preds[k].flatten(1).double(), ref.flatten(1).double()
        worst = max(worst, float(((x - r).norm(dim=1)
                                  / r.norm(dim=1).clamp(min=1e-30)).max()))
    return worst


def step_numbers(prog: dict, ref: dict, init: dict) -> dict[str, float]:
    """The steps' logits image by image, the first gradient's direction and
    its fit to the images' own, and the change of the parameters after the
    steps.

    ``pred_rel`` is :func:`pred_rel`, where the program's logits were kept;
    ``grad_cos`` is 1 - the cosine between the program's first gradient and
    the reference's, all leaves of a network as one vector (the worst
    network); ``batch_weights`` is :func:`batch_weights`, where the
    reference gives the images' own gradients.

    ``change_gap`` is, by the worst leaf, the gap between the norms of the
    program's and the reference's change, over the larger of the
    reference's norm of that leaf and its median leaf's. Leaves whose
    reference gradient is under a thousandth of the median leaf's are left
    out (round-off alone moves them under Adam)."""
    out = {}
    if prog.get("logits") is not None:
        out["pred_rel"] = pred_rel(prog["logits"], ref["logits"])
    grad_cos = change_gap = 0.0
    for net, g_ref in ref["grads"].items():
        keys = list(g_ref)
        g_p, g_r = _flat(prog["grads"][net], keys), _flat(g_ref, keys)
        cos = (g_p @ g_r) / (g_p.norm() * g_r.norm()).clamp(min=1e-300)
        grad_cos = max(grad_cos, float(1 - cos))
        gn = {k: _norm(v) for k, v in g_ref.items()}
        med = statistics.median(gn.values())
        moved = [k for k in gn if gn[k] >= 1e-3 * med]
        dr = {k: _norm(ref["params"][net][k] - init[net][k]) for k in moved}
        dmed = statistics.median(dr.values())
        for k in moved:
            dp = _norm(prog["params"][net][k] - init[net][k])
            change_gap = max(change_gap, abs(dp - dr[k]) / max(dr[k], dmed,
                                                                1e-30))
    out["grad_cos"] = grad_cos
    if ref.get("image_grads"):
        net = next(iter(ref["grads"]))
        out["batch_weights"] = batch_weights(prog["grads"][net],
                                             ref["image_grads"])
    out["change_gap"] = change_gap
    return out


def reference_steps(run, init, batches, prec="fp32", half=False,
                    per_image=False):
    algo = run.config["algorithm"]
    return ref_train.STEPS[algo](run.config, init, batches, prec, half,
                                 per_image)


def check(run, cap, prec="fp32", ref=None) -> list[tuple[str, float]]:
    """The numbers that decide ``correct``. ``prec`` ``low`` puts the
    lower-precision reference in the program's place (the loader's K1 and
    noise in bfloat16, the networks in fp8)."""
    dev = torch.device(run.device)
    nets.no_tf32()
    low = prec != "fp32"
    r_gap = 0.0
    for e in cap.renders:
        refs = render_refs(e, dev)
        got = render_refs(e, dev, torch.bfloat16) if low else e["out"]
        r_gap = max([r_gap] + [_gap(g, r, 255.0) for g, r in zip(got, refs)])
    out = [("render_max_abs", r_gap)]
    if cap.noises:
        out.append(("noise_p99", max(
            _p99(noise_ref(e, torch.bfloat16) if low else e["out"],
                 noise_ref(e)) for e in cap.noises)))
    if ref is None:
        ref = reference_steps(run, cap.weights, cap.batches, per_image=True)
    prog = (reference_steps(run, cap.weights, cap.batches, prec) if low else
            cap.program())
    return out + list(step_numbers(prog, ref, cap.weights).items())


# ---------------------------------------------------------------------------

def train_window(run) -> Capture:
    """The engine from its start to the window's end; returns what was
    kept."""
    from octa_tpu_torch.data import dataset as D
    from octa_tpu_torch.data import transforms as T
    from octa_tpu_torch.train import engine

    cfg = prepare(run)
    tracer = measure.Tracer(torch, run.trace)
    cap = Capture(run, tracer)
    orig_define = engine.define_model
    engine.define_model = cap.define_model(orig_define)
    undo = [lambda: setattr(engine, "define_model", orig_define),
            cap.loader_hooks(T)]
    if run.trace:
        undo.append(loader_spans(D, tracer))
    tracer.warm()
    args = Namespace(split="", start_epoch=0, save_latest=True,
                     epoch="latest", epochs_per_run=0)
    try:
        engine.train(args, cfg, device=run.device, on_step=cap.on_step)
    except StopWindow:
        pass
    finally:
        for u in undo:
            u()
    if cap.t_end is None:
        raise RuntimeError("the epoch ended before the window did: raise the "
                           "traffic's data.graphs")
    if tracer.prof is not None:
        run.device_trace = tracer.stop()
    return cap


def run(run):
    cap = train_window(run)
    run.window_closed(torch)
    cap.model = None
    run.free(torch)
    nets.no_tf32()
    ref = reference_steps(run, cap.weights, cap.batches, per_image=True)
    run.checks = check(run, cap, ref=ref)
    if run.calibrate:
        run.control = check(run, cap, "low", ref=ref)
        half = reference_steps(run, cap.weights, cap.batches, half=True)
        run.faults["half_batch"] = list(step_numbers(half, ref,
                                                     cap.weights).items())
    n = len(cap.step_s)
    window_s = cap.t_end - run.t_first
    per_step = flops.passes_flops(run.config, "train_step")
    images = n * run.config["images_per_step"]
    run.attempted, run.failed = n, 0
    run.e2e = {"train_img_per_s": images / window_s}
    run.record = {"cell": run.cell.name, "window_s": window_s, "units": n,
                  "images": images, "flops": per_step * n,
                  "wait_s": cap.wait_s, "step_s": cap.step_s}
