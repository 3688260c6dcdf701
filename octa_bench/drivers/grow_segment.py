"""Grown data in a closed loop of whole batches: each unit grows a batch of
vessel forests at the configuration's full schedule
(``Greenhouse.develop_forest``), takes their edges on the device
(``pipeline.forest_edges``, ``edges_from_unit``) and adapts and segments
them in batches of the path's size (``AdaptSegment``), masks and Dice to
the host. A unit is one long request; the window ends at the first unit
boundary after ``--seconds``.

Each unit grows from seeds of its own. The first unit of the window keeps
its grown state, one of its segmentation batches and the inputs and
answers of a few of its K2 and K3 calls, all drawn from the seed. Once the
window has closed the reference checks the forests' structure, how far
they grew and their radii under Murray's law, works the kept K2 and K3
calls out again, takes the edges from the forests again and works out
every stage of that batch. A traced run counts K2's work in a second
growth of the first unit's seed after the window, so that the traced loop
launches what an untraced one does.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from octa_bench import adapt, flops, measure
from octa_bench.harness import ROOT
from octa_bench.reference import growth


# K2 and K3 calls of the first unit the check works out again, and the
# queries of each K2 call it takes
KEPT_CALLS, QUERIES = 2, 256


class Recorder:
    """Stands in for a kernel's function in the growth module: passes every
    call on, and keeps the inputs and answers of the calls numbered in
    ``picks``."""

    def __init__(self, fn, picks):
        self.fn, self.picks, self.calls, self.kept = fn, set(picks), 0, {}

    def __call__(self, *args, **kw):
        out = self.fn(*args, **kw)
        if self.calls in self.picks:
            self.kept[self.calls] = (_cloned(args), dict(kw), _cloned(out))
        self.calls += 1
        return out


def _cloned(x):
    if isinstance(x, (tuple, list)):
        return tuple(_cloned(v) for v in x)
    return x.detach().clone() if hasattr(x, "detach") else x


def _patched(mod, **fns):
    """Put ``fns`` in the module's place; returns the undo."""
    old = {k: getattr(mod, k) for k in fns}
    for k, v in fns.items():
        setattr(mod, k, v)
    return lambda: [setattr(mod, k, v) for k, v in old.items()]


def run(run):
    from octa_bench.reference.nets import no_tf32
    from octa_tpu_torch import pipeline
    from octa_tpu_torch.sim import greenhouse as gh_mod

    cfg, tr = run.config, run.traffic
    g, pl = cfg["growth"], cfg["pipeline"]
    dev = torch.device(run.device)
    batch, sub = int(tr["batch"]), int(pl["batch"])
    gh = gh_mod.Greenhouse(g["Greenhouse"], node_capacity=g["node_capacity"],
                           sink_capacity=g["sink_capacity"], device=dev,
                           banded=g["banded"])
    path = adapt.load_path(run, torch)
    gen = torch.Generator(dev).manual_seed(run.seed32(2))
    rng = np.random.default_rng(run.seed32(1))
    checked = int(rng.integers(0, batch // sub))
    # K2 and K3 calls kept of the first unit, drawn among the first 4 an
    # iteration makes of each (K2 makes 4, K3 1 and one a Murray sweep;
    # redone segments add more)
    least = 4 * sum(int(m["I"]) for m in g["Greenhouse"]["modes"])
    picks = {k: rng.choice(least, KEPT_CALLS, replace=False).tolist()
             for k in ("masked_nearest", "segment_sum")}
    # every run grows from the same pool of unit seeds, in its own order
    pool = [tr["pool_seed"] + batch * i for i in range(int(tr["pool_units"]))]
    order = rng.permutation(len(pool))
    tracer = measure.Tracer(torch, run.trace)
    span = tracer.span

    def grow(seed):
        gh.seed = seed
        return gh.develop_forest(g["Forest"], batch=batch,
                                 murray_sweeps=g["murray_sweeps"],
                                 final_murray_sweeps=g["final_murray_sweeps"])

    def unit(k: int, keep: bool):
        seed = pool[order[k % len(pool)]] if k >= 0 else tr["warm_seed"]
        rec = ({n: Recorder(getattr(gh_mod, n), picks[n]) for n in picks}
               if keep else {})
        undo = _patched(gh_mod, **rec)
        t0 = time.perf_counter()
        try:
            with span("grow"):
                state = grow(seed)
                run.sync(torch)
        finally:
            undo()
        grow_s = time.perf_counter() - t0
        kept = None
        with span("adapt"):
            edges = pipeline.forest_edges(state)
            e = pipeline.edges_from_unit(*edges, res_in=pl["res_in"],
                                         res_lab=pl["res_lab"])
            for j in range(batch // sub):
                sl = slice(j * sub, (j + 1) * sub)
                _, _, kj = adapt.adapt_batch(
                    path, tuple(x[sl] for x in e["in"]),
                    tuple(x[sl] for x in e["lab"]), gen, pl["noise"]["grid"],
                    keep and j == checked)
                kept = kj or kept
        out = {"grow_s": grow_s, "host_syncs": gh.host_syncs, "seed": seed}
        if keep:
            out.update(state=state, edges=edges, kept=kept,
                       calls={n: r.kept for n, r in rec.items()})
        return out

    unit(-1, keep=False)  # set-up: every shape and kernel of a unit
    tracer.warm()
    tracer.start()
    run.t_first = t0 = time.perf_counter()
    units, first, traced_units = [], None, 0
    while True:
        u = unit(len(units), keep=not units)
        if first is None:
            first = u
        units.append({"grow_s": u["grow_s"], "host_syncs": u["host_syncs"]})
        now = time.perf_counter()
        if tracer.prof is not None and now - t0 >= min(
                tr["trace_seconds"], run.seconds):
            run.device_trace = tracer.stop()
            traced_units = len(units)
        if now - t0 >= run.seconds:
            break
    if tracer.prof is not None:
        run.device_trace = tracer.stop()
        traced_units = len(units)
    window_s = now - t0
    run.window_closed(torch)
    k2 = _k2_work(gh_mod, grow, first["seed"]) if run.trace else None
    del gh, path
    run.free(torch)
    no_tf32()
    run.checks, run.control = _check(run, first, checked, sub)
    n = len(units)
    images = n * batch
    run.attempted, run.failed = n, 0
    run.e2e = {"synth_img_per_s": images / window_s}
    run.record = {"cell": run.cell.name, "window_s": window_s, "units": n,
                  "images": images,
                  "flops": flops.passes_flops(cfg, "segment_image") * images,
                  "grow_s": [u["grow_s"] for u in units],
                  "host_syncs": [u["host_syncs"] for u in units]}
    if k2 is not None and traced_units == 1:  # the trace holds the first
        run.record.update(
            traced_flops=flops.passes_flops(cfg, "segment_image") * batch,
            k2_flops=k2["flops"], k2_bound_s=k2["bound_s"],
            k2_calls=k2["calls"])


def _k2_work(gh_mod, grow, seed) -> dict:
    """K2's operations, least time and calls in a growth from ``seed``, each
    call's work counted from its inputs (the growth is the same from the
    same seed)."""
    nearest = gh_mod.masked_nearest
    tot = {"flops": 0.0, "bound_s": 0.0, "calls": 0}

    def counted(query, points, masks, *, want_idx=True):
        ops, nbytes = flops.k2_work(torch, query, points, masks, want_idx)
        tot["flops"] = tot["flops"] + ops
        tot["bound_s"] = tot["bound_s"] + torch.clamp(
            ops / flops.PEAK_FP32_FLOPS, min=nbytes / flops.PEAK_HBM_BYTES)
        tot["calls"] += 1
        return nearest(query, points, masks, want_idx=want_idx)

    undo = _patched(gh_mod, masked_nearest=counted)
    try:
        grow(seed)
    finally:
        undo()
    return {k: float(v) for k, v in tot.items()}


def _check(run, first, checked, sub):
    """The numbers that decide ``correct``, and (calibrating) the control's:
    the reference one precision below the configuration's in the program's
    place (bfloat16 for the growth's float32 scans, sums and radii, and for
    K1 and the noise model; fp8 for the networks)."""
    cfg, pl, g = run.config, run.config["pipeline"], run.config["growth"]
    dev = torch.device(run.device)
    state = first["state"]
    forests = (state.art, state.ven)
    # stumps and roots carry 4, grown nodes their mode's exponent
    kappas = {4.0} | {float(np.float32(m["kappa"]))
                      for m in g["Greenhouse"]["modes"]}
    n_trees = int(g["Forest"]["N_trees"])
    gc = g["Greenhouse"]
    r0 = float(np.float32(gc["r"] / gc["param_scale"]))  # leaves keep it
    rng = np.random.default_rng(run.seed32(4))
    calls = first["calls"]
    want = KEPT_CALLS
    k2, k3 = list(calls["masked_nearest"].values()), list(
        calls["segment_sum"].values())
    q_idx = [torch.from_numpy(rng.choice(
        a[0].shape[1], min(a[0].shape[1], QUERIES),
        replace=False)).to(dev) for a, _, _ in k2]

    def k2_call(c):
        (query, points, masks), kw, out = c
        d, i = out if kw.get("want_idx", True) else (out, None)
        return query, points, masks, d, i

    def gaps(low: bool):
        k2_gap = k3_gap = math.inf
        if len(k2) == want:
            k2_gap = 0.0
            for c, q in zip(k2, q_idx):
                call = k2_call(c)
                got = None
                if low:
                    d, i = growth.nearest(*call[:3], q, torch.bfloat16)
                    got = (d, None if call[4] is None else i)
                k2_gap = max(k2_gap, growth.nearest_gap(call, q, got))
        if len(k3) == want:
            k3_gap = 0.0
            for (args, _, out) in k3:
                got = growth.segsum(*args, torch.bfloat16) if low else None
                k3_gap = max(k3_gap, growth.segsum_gap((*args, out), got))
        mg = 0.0
        for f in forests:
            radius = (growth.murray_radii(f, g["final_murray_sweeps"],
                                          torch.bfloat16) if low else None)
            mg = max(mg, growth.murray_gap(f, r0, radius))
        return [("murray_gap", mg), ("k2_gap", k2_gap), ("k3_gap", k3_gap)]

    ref_edges = growth.forest_edges(state)
    checks = [("growth_faults", float(sum(growth.faults(f, kappas)
                                          for f in forests))),
              ("stump_share", growth.stump_share(forests, n_trees)),
              ("edges_mismatch", float(growth.edges_mismatch(first["edges"],
                                                             ref_edges)))]
    checks += gaps(low=False)
    sl = slice(checked * sub, (checked + 1) * sub)
    a, b, r, v = (x[sl] for x in ref_edges)
    sample = dict(first["kept"])
    sample["in"] = _px(a, b, r, v, pl["res_in"])
    sample["lab"] = _px(a, b, r, v, pl["res_lab"])
    weights = adapt.load_reference_nets(cfg, ROOT, dev)
    ref = adapt.reference_outputs(sample, cfg, weights)
    checks += adapt.worst([adapt.compare(first["kept"]["out"], ref)])
    control = []
    if run.calibrate:
        low = adapt.reference_outputs(sample, cfg, weights, "low")
        control = gaps(low=True) + adapt.worst([adapt.compare(low, ref)])
    return checks, control


def _px(a, b, r, v, res):
    """Unit-square edges -> K1's inputs at ``res`` (stroke width ``radius *
    1.3 * res * 100 / 72``)."""
    return a * res, b * res, r * 1.3 * (100.0 / 72.0) * res, v

