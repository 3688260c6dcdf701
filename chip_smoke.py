#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``octa_tpu_torch``) on one GPU.

Usage: ``python3 chip_smoke.py`` from the root of a checkout, on a machine
with one CUDA card, ``nvcc`` and the CUDA toolkit (``sm_90a``: H100). It
builds the hand-written kernels from ``octa_tpu_torch/csrc`` into
``build/kernels/`` and drives the port in phases, printing each phase's
numbers on its own line:

1. device  — the card's name and power limit (``nvidia-smi``);
2. build   — K1 (``csrc/splat2d.cu``) compiled with ``nvcc``;
3. K1      — kernel against its plain PyTorch version on the four fixture
             graphs at batch 4: 304² ``k_max`` 4096, 1216² ``k_max`` 512
             (the main path's two calls) and 1216² ``k_max`` 64 (forced
             overflow drops); max |diff| <= 1e-4; kernel, plain and bound
             times;
4. agree   — the adapted path on the card (float32, TF32 off) against the
             same path on the CPU (the plain versions, which the CPU tests
             hold to the JAX package), at 64² -> 256², batch 2;
5. pipeline — the adapted path at full width with the shipped weights in
             bf16: 32 images, batches of 4, 304² -> 1216²; warm-up, one timed
             rep (img/s), K1 launches == 2 x batches; mean Dice against the
             splatted labels on the fixture graphs with noise seeds 7 and 8;
             one batch's time by stage (CUDA events) and one rep under
             ``torch.profiler`` (device busy share, top kernels).

Then it prints the kernels' JSON line, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises: the script exits non-zero and prints no result line.
Without a CUDA device it exits with code 2 before doing anything.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# per (pixel, edge) pair inside the edge's dilated bbox: projection, clamp,
# sqrt, coverage, product
K1_FLOPS_PER_PAIR = 20
K1_ATOL = 1e-4
N_IMAGES, BATCH = 32, 4


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream (CUDA
    events around ``reps`` calls after ``warmup`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} cards {torch.cuda.device_count()}")


def phase_build():
    from octa_tpu_torch.ops.splat import SPLAT2D

    t0 = time.perf_counter()
    path = SPLAT2D.build()
    SPLAT2D.function()
    ptxas = [ln.strip() for ln in SPLAT2D.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[build] K1 {path.name} in {time.perf_counter() - t0:.2f} s; "
          + " | ".join(ptxas))


def bbox_pixel_edges(a, b, width_px, pair_eid, starts, counts, *,
                     height: int, width: int, tile: int = 128) -> int:
    """Sum over kept (bin, edge) pairs of the bin's pixel centres inside the
    edge's dilated bbox: the (pixel, edge) pairs whose coverage can be
    non-zero, the data-dependent work of K1 (for its bound)."""
    import torch

    from octa_tpu_torch.ops.splat import _cdiv, _dilated_bbox

    nty, ntx = _cdiv(height, tile), _cdiv(width, tile)
    nt = nty * ntx
    dev = a.device
    n = counts.long()
    kept = int(n.sum())
    g = torch.repeat_interleave(torch.arange(n.numel(), device=dev), n,
                                output_size=kept)
    pos = starts.long()[g] + torch.arange(kept, device=dev) - (
        torch.cumsum(n, 0) - n)[g]
    img, eid = g // nt, pair_eid[pos].long()
    lo, hi = _dilated_bbox(a[img, eid], b[img, eid], width_px[img, eid])
    first = torch.stack([(g % nt) // ntx, (g % nt) % ntx], -1) * tile
    last = torch.minimum(first + tile,
                         torch.tensor([height, width], device=dev)) - 1
    # pixel r (centre r + 0.5) is inside iff lo <= r + 0.5 <= hi
    r0 = torch.maximum(first, torch.ceil(lo - 0.5).clamp(-1, 1e7).long())
    r1 = torch.minimum(last, torch.floor(hi - 0.5).clamp(-1, 1e7).long())
    span = (r1 - r0 + 1).clamp(min=0)
    return int((span[:, 0] * span[:, 1]).sum())


def phase_k1(edges):
    """K1 against its plain version at the main path's shapes."""
    import torch

    from octa_tpu_torch.ops import splat

    cases = [("in", 304, 4096, True), ("lab", 1216, 512, True),
             ("lab", 1216, 64, False)]
    rows = []
    for tag, res, k, main in cases:
        a, b, w, v = edges[tag]
        call = lambda: splat.splat_lines_2d(a, b, w, v, height=res, width=res,
                                            k_max=k)
        plain = lambda: splat.splat_lines_2d_plain(a, b, w, v, height=res,
                                                   width=res, k_max=k)
        out, ref = call(), plain()
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not (err <= K1_ATOL):
            raise AssertionError(f"K1 {res}² k={k}: max |diff| {err} > {K1_ATOL}")
        if not bool(torch.isfinite(out).all()) or float(out.max()) <= 0.5:
            raise AssertionError(f"K1 {res}² k={k}: empty or non-finite image")
        pair_eid, starts, counts = splat.bin_edges(
            a, b, w, v, height=res, width=res, k_max=k)
        fn = splat.SPLAT2D.function()
        buf = torch.empty_like(out)
        stream = torch.cuda.current_stream().cuda_stream
        launch = lambda: fn(a.data_ptr(), b.data_ptr(), w.data_ptr(),
                            pair_eid.data_ptr(), starts.data_ptr(),
                            counts.data_ptr(), buf.data_ptr(), a.shape[0],
                            a.shape[1], res, res, 128, stream)
        ms = cuda_ms(call, reps=20)
        kernel_ms = cuda_ms(launch, reps=50)
        plain_ms = cuda_ms(plain, reps=3, warmup=1)
        if not torch.equal(buf, out):
            raise AssertionError(f"K1 {res}² k={k}: bare launch differs")
        pairs = bbox_pixel_edges(a, b, w, pair_eid, starts, counts,
                                 height=res, width=res)
        flops = K1_FLOPS_PER_PAIR * pairs
        nbytes = (a.numel() + b.numel() + w.numel()) * 4 + v.numel() \
            + out.numel() * 4
        ops_ms, bytes_ms = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
        bound_ms = max(ops_ms, bytes_ms)
        bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
        kept = int(counts.sum())
        row = {"res": res, "k_max": k, "main_path": main, "max_abs_err": err,
               "ms": ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bbox_pixel_edges": pairs,
               "kept_bin_edges": kept, "bin_edge_pairs": int(pair_eid.numel()),
               "max_bin_count": int(counts.max())}
        rows.append(row)
        print(f"[k1] {res}² k_max={k}: max|diff|={err:.3g} "
              f"call={ms:.4f} ms kernel={kernel_ms:.4f} ms plain={plain_ms:.3f} ms "
              f"bound={bound_ms:.4f} ms ({bound_by}) bbox_pairs={pairs} "
              f"kept={kept}/{int(pair_eid.numel())} max_bin={int(counts.max())}")
    return rows


def phase_agree(samples):
    """The adapted path on the card (float32) against the CPU plain path."""
    import numpy as np
    import torch

    from octa_tpu_torch import pipeline as tp
    from octa_tpu_torch.models import noise_model as nm

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    bsz, res_in, res_lab = 2, 64, 256
    params = [(10.0 ** (rng.random((bsz, 9, 9)) * 2 - 1)).astype(np.float32)
              for _ in range(4)] + [rng.random((bsz, 9, 9)).astype(np.float32)]
    gammas = [rng.gamma(1.5, size=(bsz, res_in, res_in)).astype(np.float32)
              for _ in range(4)]
    outs = {}
    for dev in ("cpu", "cuda"):
        nets = tp.load_networks(dev, torch.float32)
        pipe = tp.AdaptSegment(dev, torch.float32, nets=nets, res_in=res_in,
                               res_lab=res_lab, max_batch=bsz)
        edges = tp.edges_to_device(samples[:bsz], dev, res_in, res_lab)
        o = pipe.stages(edges["in"], edges["lab"],
                        nm.NoiseParams(*(torch.from_numpy(p).to(dev) for p in params)),
                        gammas=[torch.from_numpy(g).to(dev) for g in gammas])
        outs[dev] = {k: t.cpu() for k, t in o.items()}
    torch.backends.cudnn.allow_tf32 = True
    c, g = outs["cpu"], outs["cuda"]
    img_err = float((c["img"] - g["img"]).abs().max())
    logit_err = float((c["logits"] - g["logits"]).abs().max())
    lab_eq = float((c["lab"] == g["lab"]).float().mean())
    pred_eq = float((c["pred"] == g["pred"]).float().mean())
    print(f"[agree] 64²->256² float32 card vs cpu: splat max|diff|={img_err:.3g} "
          f"logits max|diff|={logit_err:.3g} label equal={lab_eq:.6f} "
          f"mask equal={pred_eq:.6f}")
    if not (img_err <= 1e-4 and logit_err <= 1e-3 and lab_eq >= 0.999
            and pred_eq >= 0.999):
        raise AssertionError("adapted path on the card disagrees with the CPU")


def phase_pipeline(samples):
    import torch

    from octa_tpu_torch import pipeline as tp
    from octa_tpu_torch.models import noise_model as nm
    from octa_tpu_torch.ops.splat import SPLAT2D

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    nets = tp.load_networks(dev, torch.bfloat16)
    pipe = tp.AdaptSegment(dev, torch.bfloat16, nets=nets, max_batch=BATCH)
    reps = (samples * (N_IMAGES // len(samples) + 1))[:N_IMAGES]
    edges = tp.edges_to_device(reps, dev)
    print(f"[pipeline] set-up (weights, edges to device) "
          f"{time.perf_counter() - t0:.2f} s")
    n_batches = N_IMAGES // BATCH

    def run(seed):
        g = torch.Generator(dev).manual_seed(seed)
        preds = []
        for i in range(n_batches):
            s = slice(i * BATCH, (i + 1) * BATCH)
            prm = nm.sample_noise_params(BATCH, g, device=dev)
            pred, lab, _ = pipe(tuple(x[s] for x in edges["in"]),
                                tuple(x[s] for x in edges["lab"]), prm, g)
            preds.append(pred)
        return float(torch.stack(preds).float().sum())

    t0 = time.perf_counter()
    run(0)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    SPLAT2D.launches = 0
    t0 = time.perf_counter()
    total = run(1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = SPLAT2D.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[pipeline] 32 images bf16 304²->1216²: warm-up {warm:.3f} s, "
          f"timed rep {dt:.4f} s = {N_IMAGES / dt:.3f} img/s; "
          f"K1 launches {launches} (batches {n_batches}); peak mem {peak:.2f} GiB")
    if launches != 2 * n_batches:
        raise AssertionError(f"K1 launched {launches} times, expected "
                             f"{2 * n_batches}")
    if not total > 0:
        raise AssertionError("pipeline predicted no vessel pixel")

    e4 = tp.edges_to_device(samples, dev)
    prm = nm.sample_noise_params(len(samples), torch.Generator(dev).manual_seed(7),
                                 device=dev)
    pred, lab, d = pipe(e4["in"], e4["lab"], prm,
                        torch.Generator(dev).manual_seed(8))
    if pred.shape != (len(samples), tp.RES_LAB, tp.RES_LAB) \
            or not bool(torch.isfinite(d).all()):
        raise AssertionError("pipeline output has the wrong shape or NaN Dice")
    print(f"[pipeline] adapted-path Dice vs splatted labels (noise seeds 7/8): "
          f"mean {float(d.mean()):.4f} per image {[round(float(x), 4) for x in d]}")

    # where one batch's time goes, stage by stage (CUDA events, mean of 5)
    g = torch.Generator(dev).manual_seed(8)
    img, _ = pipe.splat(e4["in"], e4["lab"])
    noised = pipe.adapt(img, prm, g)
    fake = pipe.translate(noised)
    stages = {
        "splat x2 (K1)": cuda_ms(lambda: pipe.splat(e4["in"], e4["lab"]), 5),
        "noise model": cuda_ms(lambda: pipe.adapt(img, prm, g), 5),
        "generator 304²": cuda_ms(lambda: pipe.translate(noised), 5),
        "upsample + DynUNet 1216²": cuda_ms(lambda: pipe.segment(fake), 5),
    }
    print("[pipeline] one batch of 4, ms by stage: " + "; ".join(
        f"{k} {v:.3f}" for k, v in stages.items()))

    # device busy share over one rep, and the kernels that take the time
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType

    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    if busy > 0:
        top = sorted(kern, key=lambda e: e.self_device_time_total,
                     reverse=True)[:6]
        print(f"[profile] one rep under torch.profiler: wall {wall:.4f} s, "
              f"device busy {busy:.4f} s ({100 * busy / wall:.1f} %); top: "
              + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.1f} ms"
                          for e in top))
    else:
        print("[profile] device time not measured (profiler saw no kernels)")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from octa_tpu_torch import pipeline as tp
    from octa_tpu_torch.ops import raster

    phase_device()
    phase_build()
    samples = [raster.parse_graph_csv(p) for p in raster.fixture_graph_paths()]
    if len(samples) != 4:
        raise RuntimeError("expected the four fixture graphs")
    edges = tp.edges_to_device(samples, "cuda")
    rows = phase_k1(edges)
    phase_agree(samples)
    launches = phase_pipeline(samples)

    main_rows = [r for r in rows if r["main_path"]]
    kernels = [{
        "name": "splat_lines_2d",
        "route": "cuda",
        "source": "octa_tpu_torch/csrc/splat2d.cu",
        "replaces": "octa_tpu/ops/pallas_splat.py:93",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # per pipeline batch: one 304² (k 4096) and one 1216² (k 512) call
        "ms": sum(r["ms"] for r in main_rows),
        "plain_ms": sum(r["plain_ms"] for r in main_rows),
        "bound_ms": sum(r["bound_ms"] for r in main_rows),
        "bound_by": max(main_rows, key=lambda r: r["bound_ms"])["bound_by"],
        "library_ms": None,
        "cases": rows,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
