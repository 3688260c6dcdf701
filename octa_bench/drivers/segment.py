"""One client in a closed loop of segmentation requests on the adapted path
(``octa_tpu_torch.pipeline.AdaptSegment`` with the shipped weights).

A request is a batch of graphs drawn from the pool (their edges on the
device since set-up) and fresh noise parameters; the program splats them at
both resolutions (K1), adapts the image (noise model, generator), upsamples
and segments it, and the request ends when the masks and the per-image Dice
are on the host. Latency is timed from the request's issue. Requests drawn
from the seed before the window keep their outputs; once the window has
closed the plain reference works every stage of them out again.
"""
from __future__ import annotations

import time

import numpy as np

from octa_bench import adapt, flops, harness, measure


def setup(run, torch):
    """The program's path and the pool, warmed on this cell's shapes."""
    tr = run.traffic
    pl = run.config["pipeline"]
    dev = torch.device(run.device)
    pool = adapt.Pool(dev, (pl["res_in"], pl["res_lab"]))
    rng = np.random.default_rng(run.seed32(1))
    n_max = int(tr["max_requests"])
    picks = rng.integers(0, pool.size, (n_max, pl["batch"]))
    sampled = set(rng.choice(tr["sample_from"], tr["sample_requests"],
                             replace=False).tolist())
    state = {"path": adapt.load_path(run, torch), "pool": pool,
             "picks": torch.from_numpy(picks).to(dev),
             "sampled": sampled, "kept": {},
             "gen": torch.Generator(dev).manual_seed(run.seed32(2))}
    for i in range(int(tr["warm_requests"])):
        request(run, torch, state, n_max - 1 - i, keep=False)
    run.sync(torch)
    return state


def request(run, torch, state, i: int, keep: bool, tracer=None):
    """Request ``i``: returns the host's masks and Dice."""
    pl = run.config["pipeline"]
    span = tracer.span if tracer is not None else (lambda n: measure._NULL)
    pool = state["pool"]
    with span("request"):
        idx = state["picks"][i]
        masks, dice, kept = adapt.adapt_batch(
            state["path"], pool.take(pl["res_in"], idx),
            pool.take(pl["res_lab"], idx), state["gen"],
            pl["noise"]["grid"], keep)
    if keep:
        state["kept"][i] = kept
    return masks, dice


def window(run, torch, state) -> dict:
    """Requests until ``--seconds`` have passed; the window ends when the
    last request's answer is on the host."""
    tr = run.traffic
    tracer = measure.Tracer(torch, run.trace)
    seg = state["path"]
    dyn_ms = []
    if run.trace:
        seg_call = seg.segment

        def timed_segment(fake):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = seg_call(fake)
            e1.record()
            dyn_ms.append((e0, e1))
            return out

        seg.segment = timed_segment
    lat = []
    n = traced = 0
    tracer.warm()
    tracer.start()
    run.t_first = t0 = time.perf_counter()
    while True:
        t_issue = time.perf_counter()
        request(run, torch, state, n, keep=n in state["sampled"],
                tracer=tracer)
        t_done = time.perf_counter()
        lat.append(t_done - t_issue)
        n += 1
        if tracer.prof is not None and (
                t_done - t0 >= min(tr["trace_seconds"], run.seconds)):
            run.device_trace, traced = tracer.stop(), n
        if t_done - t0 >= run.seconds:
            break
    if tracer.prof is not None:
        run.device_trace, traced = tracer.stop(), n
    t_end = t_done
    if run.trace:
        seg.segment = seg_call
    run.sync(torch)
    images = n * run.config["pipeline"]["batch"]
    k1_bound_s = k1_work(run, torch, state, traced) if traced else None
    return {"requests": n, "images": images, "window_s": t_end - t0,
            "latencies": lat, "k1_bound_s": k1_bound_s, "k1_calls": 2 * traced,
            "dynunet_ms": [a.elapsed_time(b) for a, b in dyn_ms]}


def k1_work(run, torch, state, requests: int) -> float:
    """The least time of the K1 calls of the first ``requests`` requests,
    each the larger of its operations over the float32 peak and its bytes
    over the HBM rate, counted from the call's inputs (the pool's edges the
    request took) once the window has closed."""
    pl = run.config["pipeline"]
    pool = state["pool"]
    total = 0.0
    for i in range(requests):
        idx = state["picks"][i]
        for res in (pl["res_in"], pl["res_lab"]):
            ops, nbytes = flops.k1_work(torch, *pool.take(res, idx), res, res)
            total = total + torch.clamp(ops / flops.PEAK_FP32_FLOPS,
                                        min=nbytes / flops.PEAK_HBM_BYTES)
    return float(total)


def check(run, torch, kept: dict, prec: str = "fp32") -> list[dict]:
    """The reference's numbers for every kept request (``prec`` ``low`` puts
    the lower-precision reference in the program's place)."""
    weights = adapt.load_reference_nets(run.config, harness.ROOT,
                                        torch.device(run.device))
    readings = []
    for i in sorted(kept):
        k = kept[i]
        ref = adapt.reference_outputs(k, run.config, weights, "fp32")
        got = (k["out"] if prec == "fp32" else
               adapt.reference_outputs(k, run.config, weights, prec))
        readings.append(adapt.compare(got, ref))
        del ref
    return readings


def run(run):
    import torch

    from octa_bench.reference.nets import no_tf32

    state = setup(run, torch)
    res = window(run, torch, state)
    run.window_closed(torch)
    kept = state["kept"]
    del state
    run.free(torch)
    no_tf32()
    readings = check(run, torch, kept)
    run.checks = adapt.worst(readings) if readings else [("compared", float("nan"))]
    if run.calibrate:
        run.control = adapt.worst(check(run, torch, kept, "low"))
    run.attempted = res["requests"]
    run.failed = 0
    run.e2e = {"segment_img_per_s": res["images"] / res["window_s"],
               "segment_p95_ms": 1e3 * measure.percentile(res["latencies"], 95)}
    per_request = flops.passes_flops(run.config, "segment_image") \
        * run.config["pipeline"]["batch"]
    run.record = {"cell": run.cell.name, "window_s": res["window_s"],
                  "units": res["requests"], "images": res["images"],
                  "flops": per_request * res["requests"],
                  "k1_bound_s": res["k1_bound_s"], "k1_calls": res["k1_calls"],
                  "dynunet_ms": res["dynunet_ms"]}
