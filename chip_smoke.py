#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``octa_tpu_torch``) on one GPU.

Usage: ``python3 chip_smoke.py`` from the root of a checkout, on a machine
with one CUDA card, ``nvcc`` and the CUDA toolkit (``sm_90a``: H100).
``python3 chip_smoke.py k4 k5 gen`` (any of the names k1 k2 k3 k4 k5 iter
iter-banded grow grow-banded gen train cards) runs only the device, build and
named phases and prints no result line; ``cards``, on a host with two cards
or more, launches every kernel on the second card while the first is the
current device and holds it bit-equal to the first card's result. It
builds the hand-written kernels from ``octa_tpu_torch/csrc`` into
``build/kernels/`` and drives the port in phases, printing each phase's
numbers on its own line:

1. device  — the card's name and power limit (``nvidia-smi``);
2. build   — K1 (``csrc/splat2d.cu``), K2 (``csrc/nearest.cu``), K3
             (``csrc/segsum.cu``), K4 (``csrc/splat3d.cu``) and K5
             (``csrc/nearest_banded.cu``) compiled with ``nvcc``, all at once;
3. K1      — kernels against their plain PyTorch versions on the four
             fixture graphs at batch 4: 304² ``k_max`` 4096, 1216² ``k_max``
             512 (the pipeline's two calls) and 1216² ``k_max`` 64 (forced
             overflow drops), on one tree at 1216² ``k_max`` 16384
             (generation's call), and on one graph at batch 1 as training
             renders it, 304² and 1216² (edges of radius >= 0.0033) at
             ``k_max`` 16384: image within 1e-4, the binning kernel's
             lists equal to the plain ordered binning, the bare launch equal
             to the call bit for bit, one binning and one splat kernel a
             call (``torch.profiler``), no host sync in a call (sync debug
             mode "error"); device time of each kernel, call, plain and
             bound times;
4. agree   — the adapted path on the card (float32, TF32 off) against the
             same path on the CPU (the plain versions, which the CPU tests
             hold to the JAX package), at 64² -> 256², batch 2;
5. pipeline — the adapted path at full width with the shipped weights in
             bf16: 32 images, batches of 4, 304² -> 1216²; warm-up, one timed
             rep (img/s), K1 launches == 2 x batches; mean Dice against the
             splatted labels on the fixture graphs with noise seeds 7 and 8;
             one batch's time by stage (CUDA events) and, after phase 9,
             one rep under ``torch.profiler`` (device busy share, top
             kernels);
6. k2      — K2 against its plain version at the growth loop's four call
             shapes at batch 8 and full capacity (16384 nodes, 32768 sinks,
             2000 candidates) with random masks (a row with no valid point,
             a row of duplicated points: ties), the two-mask case, and the
             four shapes of a late iteration with growth-shaped masks (node
             arrays valid on a prefix of ~6,800 of 12,288 slots, ~40 % of
             the sink slots dead, a few new nodes in the 1,024-slot window);
             distances bit-equal and indices equal everywhere; grid, chunks
             skipped, pairs scanned; kernel, plain and bound times;
7. k3      — K3 bit-equal to the sequential scatter-add on the CPU and the
             same from launch to launch, one device kernel per call (under
             ``torch.profiler``), at the loop's two shapes (F=18 and F=1, 16
             rows, ~40 % on the drop sentinel), with one node taking 6,000
             sources, with int64 ids and with a tree's parent ids; tile and
             grid; kernel, plain, ``index_add_`` and bound times;
8. k4      — K4 against its plain version with the two halves of a fixture
             graph (its arterial and its venous tree, about 6,700 edges each)
             at (1216, 1216, 53), the whole graph at (304, 304, 14) and at
             (76, 76, 4) with ``ignore_z``, in both stores: float32 and uint8
             bit-equal to the plain version, the uint8 store bit-equal to the
             quantised float store, two launches identical, the float
             store's digest equal to the parent kernel's; one binning and one
             gather kernel a call (``torch.profiler``), no host sync in a
             call; device time of each kernel, call, plain and bound times
             of each store;
9. k5      — K5 against its plain version (bit-equal at every query) and
             against K2 (equal for alive queries wherever K2's distance is
             within the band) at K2's first three call shapes, on y-sorted
             and on unsorted points, with the bands of a mid-growth DVC
             iteration; its staging kernel against the plain staging, the
             bare launch equal to the call, at most two device kernels a
             call, no host sync in a call; share of chunks skipped; device
             and call times of K5 and of K2 on the same inputs, plain and
             bound times (the bound over the queries of each hit tile and
             the valid points of the chunk);
10. iter   — one growth iteration on the card (kernels) against the same
             iteration on the CPU (plain versions) from one mid-growth state
             (60 iterations grown on the card) and the same random numbers,
             with no host sync on the card; then the same for the banded
             configuration (restaged state, K5 three times and K2 once);
11. grow   — ``Greenhouse.develop_forest`` at the full schedule of
             ``configs/vessel_graph_gen.yml``, batch 8, twice from seed 0:
             tree structure, Murray fixed point, edge counts, K2/K3 launch
             counts against the iterations run, seconds and samples/s, a
             digest of the grown batch (node counts, float64 sum and SHA-256
             of the positions) to compare versions by, K3 on the grown
             forests' parent ids against the CPU, and one late segment
             under ``torch.profiler``;
12. e2e    — the grown batch -> device edges -> K1 splat -> noise model ->
             generator -> DynUNet with no host round trip of the edges; K1
             launches, Dice against the splatted labels, e2e img/s;
13. grow-banded — ``develop_forest`` of ``Greenhouse(banded=True)``, same
             schedule, batch and seed, twice: K5 and K2 launch counts against
             the iterations run (3 and 1 an iteration), tree structure,
             Murray fixed point, node counts against the unbanded run's
             (relative difference of the batch total at most 0.05), the two
             runs identical, a digest of the grown batch, and one late
             segment under ``torch.profiler``;
14. gen    — the dataset generator
             (``octa_tpu_torch.generate_vessel_graph.generate``) at full
             width: 8 samples grown, voxelized at (1216, 1216, 53) (K4,
             arterial and venous, maximum), rasterized at 1216² (K1), written
             into a temporary directory, read back and checked: shapes,
             non-empty, and the Dice of the volume's maximum along z
             against the 2D image, both thresholded at 0.1, at least 0.7;
             seconds per sample by stage;
15. train  — segmentation training (``octa_tpu_torch.train.train``) on
             ``configs/config_ves_seg-S.yml`` at full width (DynUNet, 1216²,
             batch 4, bf16 autocast, remat) for 3 epochs of 2 steps on data
             made in a temporary directory (8 fixture-graph copies, 8
             backgrounds of 8-bit noise at 304², 4 validation pairs at 1216²):
             finite losses, a validation DSC every epoch, the checkpoints, K1
             launched twice per sample loaded (the two renders of
             ``LoadGraphAndFilterByRandomRadiusd``); steps/s and img/s after
             the first step; a step taken apart on a batch loaded on the main
             stream (loading, forward+backward+Adam device time with and
             without remat, post-processing, host syncs a step: 3) and the
             peak memory with and without remat; then one step on the card
             against the same step on the CPU, on the central 608² of one
             loaded sample, from the same weights: float64 on both (loss within 1e-9 relative, every
             gradient within 1e-6 relative L2), and float32 on the card (TF32
             off) against the CPU's float64 (loss within 1e-4, every
             gradient within 1e-3; a gradient that float32 cannot give to
             1e-4 on the CPU either is printed and held to 3 times the CPU
             float32 step's distance). K1's two training shapes (304² and
             1216², batch 1) are cases of phase 3. It also times reading
             one of its Paeth-filtered PNGs at 304² and at 1216².

The main paths are phase 5, phases 11 (second growth) and 12, phase 13
(second growth), phase 14 and phase 15: every kernel's launch count is set
to 0 just before each and read just after. Then it prints the kernels' JSON line, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failure raises: the script exits non-zero and prints no result line.
Without a CUDA device it exits with code 2 before doing anything.
"""
from __future__ import annotations

import csv
import glob
import json
import os
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
# K2: three subtractions, three products, two sums per (query, point, mask)
K2_FLOPS_PER_PAIR = 8
GROW_BATCH, NODE_CAP, SINK_CAP, N_CAND = 8, 16384, 32768, 2000
# K4, per (voxel, edge) pair inside the edge's bbox: the centre, three
# differences each to a and b, four dot products, the projection, three square
# roots, two contributions with a division each, the selects
K4_FLOPS_PER_PAIR = 50
# SHA-256 (first 16 hex digits) of the volumes of K4 before its redesign
# (one block per edge; float32, and the renderer's quantisation of it) at the
# four [k4] shapes: time_kernels.py --only k4 on that package, NVIDIA H100
K4_PARENT_DIGESTS = {
    "art": ("7ccbfac2500e1dd9", "0423a386c7ef33f9"),
    "ven": ("b201fbf328a34292", "c25d2e6ab960e70d"),
    "whole graph": ("fc9d622f34dca7aa", "9a0b4d96af821a37"),
    "whole graph, ignore_z": ("c29b6e60f7b6f5c6", "22b2e4f866de13e9")}
GEN_SCALE, GEN_MIP_DICE = 1216, 0.7
TRAIN_EPOCHS = 3
AGREE_BATCH, AGREE_SIZE = 1, 608  # the card-against-CPU steps: the batch's
# first sample, its central 608² (a CPU step in float64 at 1216² takes ~56 s)
# a gradient tensor that the CPU's float32 step gives no closer than this to
# its float64 step (relative L2) is one float32 cannot give; the card's
# float32 step is held to this factor times the CPU's distance on it (at
# 608² 51 of the 60 tensors are such, 1.5e-4 to 6.4e-3 off on the CPU, and
# the card was at most 1.58 times as far: NVIDIA H100 80GB HBM3, 700 W)
AGREE_ILL_CONDITIONED, AGREE_ILL_FACTOR = 1e-4, 3.0
BANDED_NODE_DELTA = 0.05


def port_kernels() -> dict:
    """Tag -> the kernel object that holds its launch count."""
    from octa_tpu_torch.ops.nearest import NEAREST, NEAREST_BANDED
    from octa_tpu_torch.ops.segsum import SEGSUM
    from octa_tpu_torch.ops.splat import SPLAT2D
    from octa_tpu_torch.ops.splat3d import SPLAT3D

    return {"K1": SPLAT2D, "K2": NEAREST, "K3": SEGSUM, "K4": SPLAT3D,
            "K5": NEAREST_BANDED}


def zero_counts() -> None:
    for k in port_kernels().values():
        k.launches = 0


def read_counts() -> dict:
    return {tag: k.launches for tag, k in port_kernels().items()}


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
    """Compile every kernel, one ``nvcc`` per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    kernels = port_kernels()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        paths = list(pool.map(lambda k: k.build(), kernels.values()))
    dt = time.perf_counter() - t0
    for (tag, k), path in zip(kernels.items(), paths):
        k.function()
        ptxas = [ln.strip() for ln in k.build_log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"[build] {tag} {path.name}: " + " | ".join(ptxas))
    print(f"[build] {len(kernels)} kernels in {dt:.2f} s")


def bbox_pixel_edges(a, b, width_px, ids, counts, *, height: int,
                     width: int, tile: int = 128) -> int:
    """Sum over kept (bin, edge) pairs of the bin's pixel centres inside the
    edge's dilated bbox: the (pixel, edge) pairs whose coverage can be
    non-zero, the data-dependent work of K1 (for its bound). ``ids`` [B,
    nbins, k] and ``counts`` [B, nbins] as ``bin_edges_plain`` gives them."""
    import torch

    from octa_tpu_torch.ops.splat import _cdiv, _dilated_bbox

    ntx = _cdiv(width, tile)
    dev = a.device
    kept = torch.arange(ids.shape[-1], device=dev) < counts[..., None]
    img, t, slot = kept.nonzero(as_tuple=True)
    eid = ids[img, t, slot].long()
    lo, hi = _dilated_bbox(a[img, eid], b[img, eid], width_px[img, eid])
    first = torch.stack([t // ntx, t % ntx], -1) * tile
    last = torch.minimum(first + tile,
                         torch.tensor([height, width], device=dev)) - 1
    # pixel r (centre r + 0.5) is inside iff lo <= r + 0.5 <= hi
    r0 = torch.maximum(first, torch.ceil(lo - 0.5).clamp(-1, 1e7).long())
    r1 = torch.minimum(last, torch.floor(hi - 0.5).clamp(-1, 1e7).long())
    span = (r1 - r0 + 1).clamp(min=0)
    return int((span[:, 0] * span[:, 1]).sum())


def no_host_sync(fn, tag: str):
    """Run ``fn`` once with PyTorch's sync debug mode at "error": a call
    that waits for the card raises."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as exc:
        raise AssertionError(f"{tag}: a call synchronized with the host: "
                             f"{exc}") from exc
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def kernels_of(call, names: tuple, tag: str) -> dict:
    """Device ms a call of ``call`` by kernel (``time_kernels.kernel_ms``,
    which retakes a profiler window that dropped events), asserting that a
    call runs exactly one kernel of each of ``names``."""
    from octa_tpu_torch.tools.time_kernels import kernel_ms

    per = kernel_ms(call)
    if len(per) != len(names) or not all(
            sum(f"::{n}" in k for k in per) == 1 for n in names):
        raise AssertionError(f"{tag}: a call ran {sorted(per)}, expected one "
                             f"kernel of each of {names}")
    return per


def phase_k1():
    """K1 against its plain version at the main paths' shapes; its binning
    against the plain ordered binning; one binning and one splat kernel a
    call, no host sync."""
    import torch

    from octa_tpu_torch.ops import splat
    from octa_tpu_torch.tools.time_kernels import k1_cases

    dev = torch.device("cuda", torch.cuda.current_device())
    rows, calls = [], []
    for tag, (a, b, w, v), res, k, main in k1_cases(dev):
        call = lambda a=a, b=b, w=w, v=v, res=res, k=k: splat.splat_lines_2d(
            a, b, w, v, height=res, width=res, k_max=k)
        plain = lambda: splat.splat_lines_2d_plain(a, b, w, v, height=res,
                                                   width=res, k_max=k)
        out, ref = call(), plain()
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not (err <= K1_ATOL):
            raise AssertionError(f"K1 {res}² k={k}: max |diff| {err} > {K1_ATOL}")
        if not bool(torch.isfinite(out).all()) or float(out.max()) <= 0.5:
            raise AssertionError(f"K1 {res}² k={k}: empty or non-finite image")
        # the bare launch into buffers of its own: the call's image bit for
        # bit, and the plain ordered binning's lists and counts
        ids_ref, counts_ref = splat.bin_edges_plain(a, b, w, v, height=res,
                                                    width=res, k_max=k)
        bsz, nbins, kk = ids_ref.shape
        ids = torch.empty(bsz * nbins * max(kk, 1), dtype=torch.int32,
                          device=dev)
        counts = torch.empty(bsz * nbins, dtype=torch.int32, device=dev)
        buf = torch.empty_like(out)
        fn = splat.SPLAT2D.function()
        stream = torch.cuda.current_stream().cuda_stream
        fn(a.data_ptr(), b.data_ptr(), w.data_ptr(), v.data_ptr(),
           ids.data_ptr(), counts.data_ptr(), buf.data_ptr(), bsz,
           a.shape[1], res, res, 128, kk, stream)
        torch.cuda.synchronize()
        if not torch.equal(buf, out):
            raise AssertionError(f"K1 {res}² k={k}: bare launch differs")
        counts = counts.view(bsz, nbins)
        got = ids[:bsz * nbins * kk].view(bsz, nbins, kk)
        got = torch.where(torch.arange(kk, device=dev) < counts[..., None],
                          got, 0)
        if not (torch.equal(counts, counts_ref) and torch.equal(got, ids_ref)):
            raise AssertionError(f"K1 {res}² k={k}: the binning kernel's lists "
                                 "differ from the plain ordered binning")
        no_host_sync(call, f"K1 {res}² k={k}")
        pairs = bbox_pixel_edges(a, b, w, ids_ref, counts_ref, height=res,
                                 width=res)
        nbytes = (a.numel() + b.numel() + w.numel()) * 4 + v.numel() \
            + out.numel() * 4
        b_ms, bound_by = bound_ms(K1_FLOPS_PER_PAIR * pairs, nbytes)
        rows.append({"case": tag, "res": res, "k_max": k, "B": bsz,
                     "E": int(a.shape[1]), "main_path": main,
                     "max_abs_err": err, "call_ms": cuda_ms(call, reps=20),
                     "plain_ms": cuda_ms(plain, reps=2, warmup=0),
                     "bound_ms": b_ms, "bound_by": bound_by,
                     "bbox_pixel_edges": pairs,
                     "kept_bin_edges": int(counts_ref.sum()),
                     "max_bin_count": int(counts_ref.max()),
                     "bins_full": int((counts_ref == kk).sum())})
        calls.append(call)
    # device times after all CUDA-event timings: a profiled process
    # launches more slowly afterwards
    for row, call in zip(rows, calls):
        per = kernels_of(call, ("bin_kernel", "splat_kernel"),
                         f"K1 {row['case']}")
        row["bin_ms"] = sum(t for n, t in per.items() if "bin_kernel" in n)
        row["splat_ms"] = sum(t for n, t in per.items() if "splat_kernel" in n)
        row["ms"] = row["bin_ms"] + row["splat_ms"]
        print(f"[k1] {row['case']} {row['res']}² k_max={row['k_max']} "
              f"B={row['B']} E={row['E']}: max|diff|={row['max_abs_err']:.3g}, "
              f"bare launch equal, binning equal to plain, two kernels a call, "
              f"no host sync; device {row['ms']:.4f} ms (binning "
              f"{row['bin_ms']:.4f}, splat {row['splat_ms']:.4f}), call "
              f"{row['call_ms']:.4f} ms, plain={row['plain_ms']:.3f} ms "
              f"bound={row['bound_ms']:.4f} ms ({row['bound_by']}) "
              f"bbox_pairs={row['bbox_pixel_edges']} kept="
              f"{row['kept_bin_edges']} max_bin={row['max_bin_count']} "
              f"full bins={row['bins_full']}")
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
    zero_counts()
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
    fixture_dice = float(d.mean())
    print(f"[pipeline] adapted-path Dice vs splatted labels (noise seeds 7/8): "
          f"mean {fixture_dice:.4f} per image {[round(float(x), 4) for x in d]}")

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

    return launches, pipe, fixture_dice, run


def profile_pipeline(run):
    """Device busy share over one rep of the pipeline (``run`` of
    :func:`phase_pipeline`) and the kernels that take the time. It runs
    after every kernel's device times: the short profiler windows of
    ``time_kernels`` that dropped events all came after this long
    session."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
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


def bound_ms(flops: float, nbytes: float):
    """The least time the card could take: the larger of operations over the
    FP32 peak and bytes over the memory rate, and which of the two it is."""
    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def chunk_stats(masks, chunk: int):
    """Of the ``chunk``-point chunks of every row (K2's staging unit): the
    share that no mask admits (skipped whole), and the share of all (query,
    point) pairs that lie between a chunk's first and last admitted point
    (scanned)."""
    import torch

    r, _, n = masks.shape
    adm = torch.nn.functional.pad(masks.any(1), (0, -n % chunk))
    adm = adm.reshape(r, -1, chunk)
    has = adm.any(-1)
    pos = torch.arange(chunk, device=masks.device)
    first = torch.where(adm, pos, chunk).amin(-1)
    last = torch.where(adm, pos, -1).amax(-1)
    scanned = float(torch.where(has, last - first + 1, 0).sum())
    return 1.0 - float(has.float().mean()), scanned / (r * n)


def phase_k2():
    """K2 against its plain version at the growth loop's call shapes, with
    random and with growth-shaped masks: distances and indices equal."""
    import torch

    from octa_tpu_torch.ops import nearest
    from octa_tpu_torch.ops._cuda import multiprocessors
    from octa_tpu_torch.tools.time_kernels import device_ms, k2_cases

    dev = torch.device("cuda", torch.cuda.current_device())
    rows, calls = [], []
    for tag, q, p, masks, want_idx, main in k2_cases(dev):
        r, qn, _ = q.shape
        n, m = p.shape[1], masks.shape[1]
        call = lambda q=q, p=p, masks=masks, want_idx=want_idx: \
            nearest.masked_nearest(q, p, masks, want_idx=want_idx)
        plain = lambda: nearest.masked_nearest_plain(q, p, masks,
                                                     want_idx=want_idx)
        out, ref = call(), plain()
        torch.cuda.synchronize()
        d, dref = (out[0], ref[0]) if want_idx else (out, ref)
        if not torch.equal(d, dref):
            raise AssertionError(f"K2 {tag}: distances differ from plain at "
                                 f"{int((d != dref).sum())} queries")
        empty = ~masks.any(-1)                                   # [R, M]
        if not bool(torch.isinf(d[empty]).all()):
            raise AssertionError(f"K2 {tag}: a mask with no point is not +inf")
        n_ties = 0
        if want_idx:
            i, iref = out[1], ref[1]
            if not torch.equal(i, iref):
                raise AssertionError(f"K2 {tag}: indices differ from plain at "
                                     f"{int((i != iref).sum())} queries")
            if not bool((i[empty] == 0).all()):
                raise AssertionError(f"K2 {tag}: index of a no-point row not 0")
            if not tag.endswith("growth masks"):  # row 1 holds duplicates
                half = n // 2
                twin = (iref[1] + half).clamp(max=n - 1)
                tie = ((iref[1] < half) & torch.gather(masks[1], 1, twin)
                       & torch.isfinite(dref[1]))
                n_ties = int(tie.sum())
                if n_ties == 0:
                    raise AssertionError(f"K2 {tag}: no tie was exercised")
        plan = nearest.nearest_plan(r, qn, n, multiprocessors(dev))
        skipped, scanned = chunk_stats(masks, nearest.NEAREST_CHUNK)
        nbytes = (q.numel() + p.numel() + d.numel()) * 4 + masks.numel() \
            + (d.numel() * 4 if want_idx else 0)
        # the pairs this run's masks admit, and all pairs (the bound as it
        # was counted before chunks were trimmed)
        admitted = float(masks.sum(-1).sum()) * qn
        b_ms, b_by = bound_ms(K2_FLOPS_PER_PAIR * admitted, nbytes)
        all_ms, _ = bound_ms(K2_FLOPS_PER_PAIR * r * qn * n * m, nbytes)
        rows.append({"case": tag, "R": r, "Q": qn, "N": n, "M": m,
                     "want_idx": want_idx, "main_path": main,
                     "max_abs_err": 0.0, "bit_equal": True,
                     "idx_equal": want_idx, "ties": n_ties,
                     "grid": list(plan.grid(r, qn)),
                     "chunks_skipped_share": skipped,
                     "pairs_scanned_share": scanned,
                     "call_ms": cuda_ms(call, reps=10),
                     "plain_ms": cuda_ms(plain, reps=1, warmup=0),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "bound_all_pairs_ms": all_ms})
        calls.append(call)
    # device times after all CUDA-event timings: a profiled process
    # launches more slowly afterwards
    for row, call in zip(rows, calls):
        row["ms"], kernels = device_ms(call)
        if len(kernels) != 1 or "nearest_kernel" not in kernels[0]:
            raise AssertionError(f"K2 {row['case']}: one call ran {kernels}")
        print(f"[k2] {row['case']} R={row['R']} Q={row['Q']} N={row['N']} "
              f"M={row['M']} idx={row['want_idx']}: bit-equal, indices equal, "
              f"ties held={row['ties']}; grid {tuple(row['grid'])}; chunks "
              f"skipped {100 * row['chunks_skipped_share']:.1f} %, pairs scanned "
              f"{100 * row['pairs_scanned_share']:.1f} %; kernel={row['ms']:.4f} "
              f"ms (call {row['call_ms']:.4f} ms) plain={row['plain_ms']:.3f} ms "
              f"bound={row['bound_ms']:.4f} ms ({row['bound_by']}, admitted "
              f"pairs; all pairs {row['bound_all_pairs_ms']:.4f} ms)")
    return rows


def phase_k3():
    """K3 against the sequential scatter-add on the CPU (bit for bit) at the
    loop's two shapes, with random, skewed and tree-shaped ids."""
    import torch

    from octa_tpu_torch.ops import segsum
    from octa_tpu_torch.ops._cuda import multiprocessors
    from octa_tpu_torch.tools.time_kernels import device_ms, k3_cases

    dev = torch.device("cuda", torch.cuda.current_device())
    rows, fns = [], []
    for tag, seg, feats, nc, main in k3_cases(dev):
        r, sq, f = feats.shape
        call = lambda seg=seg, feats=feats, nc=nc: \
            segsum.segment_sum(seg, feats, nc)
        plain = lambda seg=seg, feats=feats, nc=nc: \
            segsum.segment_sum_plain(seg, feats, nc)
        out, ref = call(), plain()
        torch.cuda.synchronize()
        # the kernel adds in source order: equal, bit for bit, to the plain
        # version's sequential scatter-add on the CPU, and the same from
        # launch to launch; the plain version on the card adds with atomics
        cpu = segsum.segment_sum_plain(seg.cpu(), feats.cpu(), nc)
        err = float((out.cpu() - cpu).abs().max())
        if err != 0.0 or not torch.equal(out.cpu(), cpu):
            raise AssertionError(f"K3 {tag}: differs from the CPU scatter-add "
                                 f"by up to {err}")
        card_err = float((out - ref).abs().max())
        if not torch.equal(out, call()):
            raise AssertionError(f"K3 {tag}: two launches gave other bits")
        tile, grid = segsum.segsum_plan(nc, r, f, multiprocessors(dev))
        # the library call: one index_add_ into a zeroed [R*(nc+1), F]
        flat = (seg.long() + torch.arange(r, device=dev)[:, None]
                * (nc + 1)).reshape(-1)
        buf = torch.empty(r * (nc + 1), f, device=dev)
        lib = lambda flat=flat, buf=buf, src=feats.reshape(r * sq, f): \
            buf.zero_().index_add_(0, flat, src)
        nbytes = seg.numel() * seg.element_size() + feats.numel() * 4 \
            + out.numel() * 4
        b_ms, b_by = bound_ms(feats.numel(), nbytes)
        rows.append({"case": tag, "F": f, "Sq": sq, "nc": nc, "R": r,
                     "ids": str(seg.dtype), "main_path": main,
                     "max_abs_err": err, "equal_to_cpu_plain": True,
                     "max_abs_err_to_card_index_add": card_err,
                     "kernels_per_call": 1, "tile": tile, "grid": list(grid),
                     "call_ms": cuda_ms(call, reps=20),
                     "library_call_ms": cuda_ms(lib, reps=20),
                     "bound_ms": b_ms, "bound_by": b_by})
        fns.append((call, plain, lib))
    for row, (call, plain, lib) in zip(rows, fns):
        row["ms"], kernels = device_ms(call)
        if len(kernels) != 1 or "segsum_kernel" not in kernels[0]:
            raise AssertionError(f"K3 {row['case']}: one call ran {kernels}")
        row["plain_ms"], _ = device_ms(plain)
        row["library_ms"], _ = device_ms(lib)
        print(f"[k3] {row['case']} F={row['F']} Sq={row['Sq']} nc={row['nc']} "
              f"R={row['R']} {row['ids']}: bit-equal to the CPU scatter-add, "
              f"repeatable, one kernel a call; tile {row['tile']} nodes, grid "
              f"{tuple(row['grid'])}; max|diff| to index_add_ on the card "
              f"{row['max_abs_err_to_card_index_add']:.3g}; kernel="
              f"{row['ms']:.4f} ms (call "
              f"{row['call_ms']:.4f} ms) plain={row['plain_ms']:.4f} ms "
              f"index_add_={row['library_ms']:.4f} ms (call "
              f"{row['library_call_ms']:.4f} ms) bound={row['bound_ms']:.4f} ms "
              f"({row['bound_by']}); device times from torch.profiler")
    return rows


def phase_k4():
    """K4 against its plain version at the generation path's shapes, in
    both stores: bit for bit, the uint8 store also against the quantised
    float store, and the float store's digest against the parent kernel's;
    two kernels a call, no host sync."""
    import torch

    from octa_tpu_torch.ops import splat3d
    from octa_tpu_torch.tools.time_kernels import digest, k4_cases

    dev = torch.device("cuda", torch.cuda.current_device())
    rows, calls = [], []
    for tag, (a, b, r, v), dims, main in k4_cases(dev):
        f32 = lambda a=a, b=b, r=r, v=v, dims=dims: splat3d.splat_capsules_3d(
            a, b, r, v, dims=dims)
        u8 = lambda a=a, b=b, r=r, v=v, dims=dims: splat3d.splat_capsules_3d(
            a, b, r, v, dims=dims, out_dtype=torch.uint8)
        out, out8 = f32(), u8()
        ref = splat3d.splat_capsules_3d_plain(a, b, r, v, dims=dims)
        ref8 = splat3d.splat_capsules_3d_plain(a, b, r, v, dims=dims,
                                               out_dtype=torch.uint8)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not (torch.equal(out, ref) and torch.equal(out8, ref8)):
            raise AssertionError(f"K4 {tag} {dims}: not bit-equal to the plain "
                                 f"version (float max |diff| {err})")
        if not torch.equal(out8, splat3d.quantise(out)):
            raise AssertionError(f"K4 {tag} {dims}: the uint8 store differs "
                                 "from the quantised float store")
        if (out.shape != dims or not bool(torch.isfinite(out).all())
                or float(out.min()) < 0 or not 0.5 < float(out.max()) <= 1):
            raise AssertionError(f"K4 {tag} {dims}: shape, range or empty volume")
        if not (torch.equal(out, f32()) and torch.equal(out8, u8())):
            raise AssertionError(f"K4 {tag} {dims}: two launches gave other bits")
        dig = (digest(out), digest(out8))
        if dig != K4_PARENT_DIGESTS[tag]:
            raise AssertionError(f"K4 {tag} {dims}: digests {dig}, before the "
                                 f"redesign {K4_PARENT_DIGESTS[tag]}")
        for store, call in (("float32", f32), ("uint8", u8)):
            no_host_sync(call, f"K4 {tag} {store}")
        _, n = splat3d.edge_bboxes(a, b, r, dims)
        pairs = int((n.prod(-1) * v).sum())
        ins = (a.numel() + b.numel() + r.numel()) * 4 + v.numel()
        for store, call, vol in (("float32", f32, out), ("uint8", u8, out8)):
            plain = lambda a=a, b=b, r=r, v=v, dims=dims, vol=vol: \
                splat3d.splat_capsules_3d_plain(a, b, r, v, dims=dims,
                                                out_dtype=vol.dtype)
            b_ms, b_by = bound_ms(K4_FLOPS_PER_PAIR * pairs,
                                  ins + vol.numel() * vol.element_size())
            rows.append({"case": tag, "store": store, "dims": list(dims),
                         "E": int(v.sum()), "E_padded": int(v.numel()),
                         "main_path": main and store == "uint8",
                         "max_abs_err": err if store == "float32" else 0.0,
                         "bit_equal": True, "digests": list(dig),
                         "bbox_voxel_edges": pairs,
                         "filled_share": float((out > 0).float().mean()),
                         "call_ms": cuda_ms(call, reps=20),
                         "plain_ms": cuda_ms(plain, reps=1, warmup=0),
                         "bound_ms": b_ms, "bound_by": b_by})
            calls.append(call)
    # device times after all CUDA-event timings: a profiled process
    # launches more slowly afterwards
    for row, call in zip(rows, calls):
        per = kernels_of(call, ("bin_kernel", "gather_kernel"),
                         f"K4 {row['case']} {row['store']}")
        row["bin_ms"] = sum(t for k, t in per.items() if "bin_kernel" in k)
        row["gather_ms"] = sum(t for k, t in per.items() if "gather_kernel" in k)
        row["ms"] = row["bin_ms"] + row["gather_ms"]
        print(f"[k4] {row['case']} {row['store']} dims={tuple(row['dims'])} "
              f"E={row['E']}: bit-equal to plain, uint8 = quantised float, "
              f"repeatable, two kernels a call, no host sync; digests "
              f"{row['digests']} as before the redesign; device "
              f"{row['ms']:.4f} ms (binning "
              f"{row['bin_ms']:.4f}, gather {row['gather_ms']:.4f}), call "
              f"{row['call_ms']:.4f} ms, plain={row['plain_ms']:.3f} ms "
              f"bound={row['bound_ms']:.4f} ms ({row['bound_by']}); bbox "
              f"pairs={row['bbox_voxel_edges']} filled="
              f"{row['filled_share']:.4f}")
    return rows


def phase_k5():
    """K5 against its plain version and against K2 at the banded growth
    loop's three call shapes, on y-sorted and on unsorted points; its
    staging kernel against the plain staging; at most two device kernels a
    call, no host sync."""
    import torch

    from octa_tpu_torch.ops import nearest
    from octa_tpu_torch.ops._cuda import multiprocessors
    from octa_tpu_torch.tools.time_kernels import device_ms, k5_cases

    dev = torch.device("cuda", torch.cuda.current_device())
    rows, fns = [], []
    for tag, layout, q, p, mask, alive, band, want_idx in k5_cases(dev):
        r, qn, _ = q.shape
        n = p.shape[1]
        call = lambda q=q, p=p, mask=mask, alive=alive, band=band, \
            want_idx=want_idx: nearest.masked_nearest_banded(
                q, p, mask, alive, band, want_idx=want_idx)
        plain = lambda: nearest.masked_nearest_banded_plain(
            q, p, mask, alive, band, want_idx=want_idx)
        full = lambda q=q, p=p, mask=mask, want_idx=want_idx: \
            nearest.masked_nearest(q, p, mask, want_idx=want_idx)
        out, ref, k2 = call(), plain(), full()
        torch.cuda.synchronize()
        if not want_idx:
            out, ref, k2 = (out,), (ref,), (k2,)
        if not all(torch.equal(x, y) for x, y in zip(out, ref)):
            bad = int((out[0] != ref[0]).sum())
            raise AssertionError(f"K5 {tag} {layout}: kernel and plain "
                                 f"version differ at {bad} queries")
        inside = alive[:, None] & (k2[0] <= band[:, None, None])
        n_in = int(inside.sum())
        if n_in == 0 or not all(torch.equal(x[inside], y[inside])
                                for x, y in zip(out, k2)):
            raise AssertionError(f"K5 {tag} {layout}: differs from K2 "
                                 f"inside the band ({n_in} queries there)")
        # the bare launch with scratch of its own: the call's result, and
        # the staging kernel's copy and chunk table against the plain one
        plan = nearest.banded_plan(r, qn, n, multiprocessors(dev))
        n_chunks = -(-n // nearest.BAND_CHUNK)
        staged = torch.empty(r, n, 4, device=dev)
        info = torch.empty(r, n_chunks, 4, device=dev)
        part = (torch.empty(plan.splits * r * qn, device=dev),
                torch.empty(plan.splits * r * qn, dtype=torch.int32, device=dev),
                torch.zeros(r * plan.grid(r, qn)[0], dtype=torch.int32,
                            device=dev))
        d = torch.empty(r, 1, qn, device=dev)
        i = torch.empty(r, 1, qn, dtype=torch.int32, device=dev)
        err = nearest.NEAREST_BANDED.function()(
            q.data_ptr(), q.stride(0), p.data_ptr(), p.stride(0),
            mask.data_ptr(), mask.stride(0), alive.data_ptr(), band.data_ptr(),
            staged.data_ptr(), info.data_ptr(), d.data_ptr(),
            i.data_ptr() if want_idx else None,
            *(t.data_ptr() for t in part), r, qn, n, plan.splits,
            plan.per_split, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        st = nearest.banded_stage_plain(p, mask[:, 0])
        info_i = info.view(torch.int32)
        if err != 0 or not torch.equal(d, out[0]) or (
                want_idx and not torch.equal(i, out[1])):
            raise AssertionError(f"K5 {tag} {layout}: bare launch differs")
        if not (torch.equal(staged[..., :3], st.staged)
                and torch.equal(info[..., 0], st.lo)
                and torch.equal(info[..., 1], st.hi)
                and torch.equal(info_i[..., 2], st.first)
                and torch.equal(info_i[..., 3], st.last)):
            raise AssertionError(f"K5 {tag} {layout}: the staging kernel "
                                 "differs from the plain staging")
        no_host_sync(call, f"K5 {tag} {layout}")
        fin = torch.isfinite(ref[0]) & torch.isfinite(out[0])
        err = float((out[0] - ref[0])[fin].abs().max()) if bool(fin.any()) \
            else 0.0
        # the bound's pairs, as K2's: for each hit (tile, chunk) pair the
        # tile's queries times the chunk's valid points; and the pairs the
        # kernel scans (the chunk from its first to its last valid point)
        hit = nearest.banded_hits(q, p, mask, alive, band).float()
        tq = torch.full((hit.shape[1],), float(nearest.BAND_TILE), device=dev)
        tq[-1] = qn - (hit.shape[1] - 1) * nearest.BAND_TILE
        n_valid = torch.nn.functional.pad(mask[:, 0], (0, -n % nearest.BAND_CHUNK))
        n_valid = n_valid.reshape(r, n_chunks, -1).sum(-1).float()  # [R, nC]
        span = (st.last - st.first + 1).clamp(min=0).float()        # [R, nC]
        admitted = float(torch.einsum("rtc,t,rc->", hit, tq, n_valid))
        scanned = float(torch.einsum("rtc,t,rc->", hit, tq, span))
        skipped = 1.0 - float(hit.mean())
        nbytes = (q.numel() + p.numel() + out[0].numel() + band.numel()) * 4 \
            + mask.numel() + alive.numel() \
            + (out[0].numel() * 4 if want_idx else 0)
        b_ms, b_by = bound_ms(K2_FLOPS_PER_PAIR * admitted, nbytes)
        all_ms, _ = bound_ms(K2_FLOPS_PER_PAIR * r * qn * n, nbytes)
        rows.append({"case": tag, "layout": layout, "R": r, "Q": qn, "N": n,
                     "want_idx": want_idx, "main_path": layout == "y-sorted",
                     "max_abs_err": err, "bit_equal": True,
                     "queries_inside_band": n_in, "splits": plan.splits,
                     "chunks_skipped_share": skipped,
                     "pairs_admitted": admitted, "pairs_scanned": scanned,
                     "call_ms": cuda_ms(call, reps=20),
                     "k2_call_ms": cuda_ms(full, reps=20),
                     "plain_ms": cuda_ms(plain, reps=1, warmup=0),
                     "bound_ms": b_ms, "bound_by": b_by,
                     "bound_all_pairs_ms": all_ms})
        fns.append((call, full))
    # device times after all CUDA-event timings: a profiled process
    # launches more slowly afterwards
    for row, (call, full) in zip(rows, fns):
        per = kernels_of(call, ("stage_kernel", "scan_kernel"),
                         f"K5 {row['case']}")
        row["ms"] = sum(per.values())
        row["stage_ms"] = sum(t for k, t in per.items() if "stage_kernel" in k)
        row["kernels_per_call"] = len(per)
        row["k2_ms"], _ = device_ms(full)
        print(f"[k5] {row['case']} R={row['R']} Q={row['Q']} N={row['N']} "
              f"{row['layout']}: bit-equal to plain, equal to K2 at "
              f"{row['queries_inside_band']} queries inside the band, staging "
              f"equal to plain, {row['kernels_per_call']} kernels a call, no "
              f"host sync; splits {row['splits']}; chunks skipped "
              f"{100 * row['chunks_skipped_share']:.1f} %; K5 device "
              f"{row['ms']:.4f} ms (staging {row['stage_ms']:.4f}), call "
              f"{row['call_ms']:.4f} ms; K2 device {row['k2_ms']:.4f} ms, call "
              f"{row['k2_call_ms']:.4f} ms; plain={row['plain_ms']:.3f} ms "
              f"bound={row['bound_ms']:.4f} ms ({row['bound_by']}, "
              f"{row['pairs_admitted']:.0f} admitted pairs in hit chunks; "
              f"{row['pairs_scanned']:.0f} pairs scanned; over all pairs "
              f"{row['bound_all_pairs_ms']:.4f} ms)")
    return rows


def _new_nodes(forests, n_old):
    """{(sample, forest, parent, rank among that parent's new children):
    position} of the nodes an iteration added."""
    out = {}
    n_new = forests.n_nodes.cpu().numpy()
    pos = forests.pos.cpu().numpy()
    parent = forests.parent.cpu().numpy()
    for s in range(n_new.shape[0]):
        for f in range(2):
            seen = {}
            for k in range(int(n_old[s, f]), int(n_new[s, f])):
                par = int(parent[s, f, k])
                seen[par] = seen.get(par, -1) + 1
                out[(s, f, par, seen[par])] = pos[s, f, k]
    return out


def phase_iter(banded: bool = False):
    """One iteration on the card (kernels) against the CPU (plain), in the
    plain or the banded configuration."""
    import warnings

    import numpy as np
    import torch

    from octa_tpu_torch.sim import greenhouse as gh
    from octa_tpu_torch.sim.configs import vessel_graph_gen

    tag = "iter-banded" if banded else "iter"
    # the mid-growth state: 60 SVC iterations on the card (a later and larger
    # state than the CPU could grow in the same time), then copied to the CPU
    cfg = vessel_graph_gen()
    batch, warm_iters, seed = 2, 60, 5
    g = gh.Greenhouse(cfg["Greenhouse"], seed=seed, banded=banded)
    state_c = gh._tree_map(
        lambda *xs: torch.stack(xs),
        *[g.init_state(cfg["Forest"], seed + i, node_capacity=4096,
                       sink_capacity=8192) for i in range(batch)])
    g.generator.manual_seed(seed)
    state_c = g._run_segment(state_c, 0, 0, 0, warm_iters, 4, False, 1024)
    if int(state_c.sat.max()) != 0 or int(state_c.art.n_nodes.max()) > 4000:
        raise AssertionError("the warm-up growth saturated a capacity")
    if banded:  # as develop_forest does at a segment boundary
        state_c = gh._restage_spatial(state_c)
    state = gh._tree_map(lambda x: x.cpu(), state_c)
    mp = g.modes[0]
    nc = state.art.pos.shape[1]
    draws = gh.draw_iteration(torch.Generator().manual_seed(11), batch,
                              mp.N, nc, gh.GEOMETRY_SIZE, "cpu")
    draws_c = gh.IterationDraws(*(x.cuda() for x in draws))
    faz = {dev: torch.from_numpy(g.faz_center).to(dev)
           for dev in ("cpu", "cuda")}

    def step(st, dr, dev):
        return gh._iteration(
            gh._stack_state(st), mp, warm_iters, warm_iters,
            param_scale=g.param_scale, r0=g.r,
            rotation_radius=g.rotation_radius, faz_center=faz[dev],
            size_z=g.sizes[2], n_cand=mp.N, murray_sweeps=4, new_cap=1024,
            draws=dr, banded=banded)

    t0 = time.perf_counter()
    cpu = step(state, draws, "cpu")
    cpu_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    before = read_counts()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        card = step(state_c, draws_c, "cuda")
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [str(w.message) for w in caught if "ynchroniz" in str(w.message)]
    k2, k3, k5 = (read_counts()[k] - before[k] for k in ("K2", "K3", "K5"))
    if syncs:
        raise AssertionError(f"an iteration on the card synchronized: {syncs}")
    if (k2, k3, k5) != ((1, 5, 3) if banded else (4, 5, 0)):
        raise AssertionError(f"one iteration launched K2 {k2}x, K3 {k3}x, K5 "
                             f"{k5}x; expected 4, 5, 0 (banded: 1, 5, 3)")

    n_old = gh._stack_state(state).forests.n_nodes.numpy()
    differ = []
    for name, a, b in (
            ("n_nodes", cpu.forests.n_nodes, card.forests.n_nodes),
            ("alive sinks", cpu.sinks.alive.sum(-1), card.sinks.alive.sum(-1))):
        a, b = a.numpy().astype(float), b.cpu().numpy().astype(float)
        print(f"[{tag}] {name}: cpu {a.astype(int).tolist()} "
              f"card {b.astype(int).tolist()}")
        if not (np.abs(a - b) <= np.maximum(0.005 * a, 1)).all():
            raise AssertionError(f"{name} differ by more than 0.5 % (or 1)")
    emit_c = (cpu.forests.n_children - gh._stack_state(state).forests.n_children)
    emit_g = (card.forests.n_children.cpu()
              - gh._stack_state(state).forests.n_children)
    for s, f, n in (emit_c != emit_g).nonzero().tolist():
        differ.append(f"sample {s} forest {f} node {n}: emits "
                      f"{int(emit_c[s, f, n])} on the cpu, "
                      f"{int(emit_g[s, f, n])} on the card")
    for s, f, k in (cpu.sinks.alive != card.sinks.alive.cpu()).nonzero().tolist():
        differ.append(f"sample {s} sinks {f} slot {k}: alive "
                      f"{bool(cpu.sinks.alive[s, f, k])} on the cpu")
    for line in differ:
        print(f"[{tag}] decision differs: {line}")
    nodes_c, nodes_g = _new_nodes(cpu.forests, n_old), _new_nodes(card.forests, n_old)
    both = sorted(set(nodes_c) & set(nodes_g))
    if len(set(nodes_c) ^ set(nodes_g)) > max(2, 0.01 * len(nodes_c)) or not both:
        raise AssertionError(f"only {len(both)} of {len(nodes_c)} new nodes "
                             "were made on both devices")
    pos_err = max(float(np.abs(nodes_c[k] - nodes_g[k]).max()) for k in both)
    rad_err = float((cpu.forests.radius - card.forests.radius.cpu()).abs().max()) \
        if not differ else float("nan")
    print(f"[{tag}] iteration {warm_iters} of SVC, batch {batch}, "
          f"{nc} node slots: {len(both)} new nodes on both devices "
          f"({len(nodes_c)} cpu, {len(nodes_g)} card), max |pos diff| "
          f"{pos_err:.3g}, max |radius diff| {rad_err:.3g}, decisions that "
          f"differ {len(differ)}, K2 {k2} K3 {k3} K5 {k5} launches, host syncs "
          f"{len(syncs)}; the iteration on the CPU took {cpu_s:.1f} s")
    if not pos_err <= 1e-4:
        raise AssertionError(f"new node positions differ by {pos_err}")


def _check_forest(f, b: int, tag: str, ordered: bool = True):
    """Structure and Murray fixed point of sample ``b`` of a grown forest.
    ``ordered``: parents lie below their children in the node array (not so
    after the banded configuration's y-sorts, where instead every node must
    reach a root by following parents)."""
    import numpy as np

    n = int(f.n_nodes[b])
    parent = f.parent[b, :n].cpu().numpy()
    n_children = f.n_children[b, :n].cpu().numpy()
    is_root = f.is_root[b, :n].cpu().numpy()
    radius = f.radius[b, :n].cpu().numpy().astype(np.float64)
    kappa = f.kappa[b, :n].cpu().numpy().astype(np.float64)
    pkappa = f.pkappa[b, :n].cpu().numpy().astype(np.float64)
    idx = np.arange(n)
    if not ((parent >= 0) == ~is_root).all():
        raise AssertionError(f"{tag}: a non-root node has no parent")
    if ordered and not (parent[~is_root] < idx[~is_root]).all():
        raise AssertionError(f"{tag}: a parent index is not below its child's")
    top = np.where(parent >= 0, parent, idx)
    for _ in range(max(n, 2).bit_length()):  # pointer jumping: 2^k steps up
        top = top[top]
    if not is_root[top].all():
        raise AssertionError(f"{tag}: a node does not descend from a root")
    counted = np.bincount(parent[parent >= 0], minlength=n)
    if not (counted == n_children).all() or n_children.max() > 2:
        raise AssertionError(f"{tag}: n_children disagrees with the parents")
    if not (np.isfinite(radius).all() and (radius > 0).all()):
        raise AssertionError(f"{tag}: radii not finite and positive")
    child_sum = np.bincount(parent[parent >= 0],
                            weights=radius[parent >= 0] ** pkappa[parent >= 0],
                            minlength=n)
    internal = (n_children >= 1) & ~is_root
    want = child_sum[internal] ** (1.0 / kappa[internal])
    resid = np.abs(radius[internal] - want)
    return n, float(resid.max()), float((resid / want).max())


def profile_late_segment(g, state, ecap: int, tag: str, names: dict):
    """``time_growth.profile_late_segment``, with the launch counts put back
    afterwards: the profiled segment is not a main path."""
    from octa_tpu_torch.tools import time_growth

    keep = read_counts()
    time_growth.profile_late_segment(g, state, ecap, tag, names)
    for k, kern in port_kernels().items():
        kern.launches = keep[k]


def phase_grow():
    """The full growth schedule on the card, twice from the same seed."""
    import warnings

    import torch

    from octa_tpu_torch.sim import greenhouse as gh
    from octa_tpu_torch.sim.configs import vessel_graph_gen
    from octa_tpu_torch.tools.time_growth import forest_digest

    cfg = vessel_graph_gen()
    g = gh.Greenhouse(cfg["Greenhouse"], node_capacity=NODE_CAP,
                      sink_capacity=SINK_CAP, seed=0)
    runs = []
    for rep in range(2):
        # the second growth opens the main path: every count starts at 0
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            state = g.develop_forest(cfg["Forest"], batch=GROW_BATCH)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        ceiling = [str(w.message) for w in caught
                   if "capacity ceiling" in str(w.message)]
        if ceiling:
            raise AssertionError(f"growth hit a capacity ceiling: {ceiling}")
        log = g.stage_log
        iters = sum(e["seg_len"] for e in log)
        redos = sum(not e["accepted"] for e in log)
        k2, k3 = read_counts()["K2"], read_counts()["K3"]
        cap, scap = state.art.pos.shape[1], state.oxy.pos.shape[1]
        print(f"[grow] run {rep}: develop_forest batch {GROW_BATCH}, 100 + 150 "
              f"iterations: {dt:.3f} s = {GROW_BATCH / dt:.3f} samples/s; "
              f"segments {len(log)} (redone {redos}), iterations run {iters}; "
              f"final cap {cap} scap {scap} ecap {log[-1]['ecap']}; "
              f"K2 {k2} K3 {k3} launches; host syncs {g.host_syncs}; peak mem "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        if k2 != 4 * iters or k3 != 5 * iters:
            raise AssertionError(
                f"launch counts K2 {k2} K3 {k3} do not match {iters} iterations "
                "(4 and 1 + 4 murray sweeps per iteration)")
        runs.append((state, dt, iters, redos, log))

    state, dt, iters, redos, log = runs[1]
    counts = [torch.stack([s.art.n_nodes, s.ven.n_nodes]).cpu() for s, *_ in runs]
    same = torch.equal(counts[0], counts[1])
    same_pos = torch.equal(runs[0][0].art.pos, runs[1][0].art.pos)
    print(f"[grow] two runs from seed 0: node counts identical={same}, "
          f"arterial positions identical={same_pos}; art {counts[1][0].tolist()} "
          f"ven {counts[1][1].tolist()}")
    print(f"[grow] digest of the grown batch: {forest_digest(state)}")
    # K3 on the grown forests' parent ids (the Murray sweep's structure)
    # against the sequential scatter-add on the CPU
    from octa_tpu_torch.ops import segsum

    keep = read_counts()
    for name, f in (("art", state.art), ("ven", state.ven)):
        nc = f.pos.shape[1]
        exists = torch.arange(nc, device=f.pos.device) < f.n_nodes[:, None]
        seg = torch.where(exists & (f.parent >= 0), f.parent, nc)
        rk = torch.where(exists, f.radius ** f.pkappa, 0.0)[..., None]
        out = segsum.segment_sum(seg, rk, nc)
        if not torch.equal(out.cpu(), segsum.segment_sum_plain(
                seg.cpu(), rk.cpu(), nc)):
            raise AssertionError(f"K3 on the grown {name} parent ids differs "
                                 "from the CPU scatter-add")
    for k, kern in port_kernels().items():
        kern.launches = keep[k]
    print("[grow] K3 on the grown forests' parent ids: bit-equal to the CPU "
          "scatter-add")
    edges = []
    worst_abs = worst_rel = 0.0
    for b in range(GROW_BATCH):
        n_edges = 0
        for name, f in (("art", state.art), ("ven", state.ven)):
            n, r_abs, r_rel = _check_forest(f, b, f"sample {b} {name}")
            n_edges += n - int(f.is_root[b].sum())
            worst_abs, worst_rel = max(worst_abs, r_abs), max(worst_rel, r_rel)
        edges.append(n_edges)
    print(f"[grow] per sample art+ven edges {edges}; Murray fixed-point "
          f"residual max abs {worst_abs:.3g} rel {worst_rel:.3g}")
    if not all(10_000 <= e <= 18_000 for e in edges):
        raise AssertionError(f"edge counts {edges} outside 10,000-18,000")
    if not (worst_abs < 1e-5 and worst_rel < 1e-5):
        raise AssertionError("radii are not at the Murray fixed point")

    profile_late_segment(g, state, log[-1]["ecap"], "grow-profile",
                         {"K2": "nearest_kernel", "K3": "segsum_kernel"})
    return state, dt, iters


def phase_e2e(state, grow_s: float, pipe, fixture_dice: float):
    """The grown batch through the adapt-and-segment pipeline, edges kept on
    the card."""
    import torch

    from octa_tpu_torch import pipeline as tp
    from octa_tpu_torch.models import noise_model as nm
    from octa_tpu_torch.ops.splat import SPLAT2D

    dev = torch.device("cuda")
    n = state.art.pos.shape[0]

    def run(seed):
        gen = torch.Generator(dev).manual_seed(seed)
        edges = tp.edges_from_unit(*tp.forest_edges(state))
        preds, dices = [], []
        for i in range(0, n, BATCH):
            s = slice(i, i + BATCH)
            prm = nm.sample_noise_params(BATCH, gen, device=dev)
            pred, lab, d = pipe(tuple(x[s] for x in edges["in"]),
                                tuple(x[s] for x in edges["lab"]), prm, gen)
            preds.append(pred)
            dices.append(d)
        return torch.cat(preds), torch.cat(dices)

    keep = SPLAT2D.launches
    run(6)  # warm-up at this edge count (not the main path)
    torch.cuda.synchronize()
    SPLAT2D.launches = keep
    t0 = time.perf_counter()
    pred, d = run(7)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = SPLAT2D.launches
    if launches != 2 * (n // BATCH):
        raise AssertionError(f"K1 launched {launches} times for {n // BATCH} "
                             "batches, expected 2 per batch")
    if pred.shape != (n, tp.RES_LAB, tp.RES_LAB) or not bool(pred.any(-1).any(-1).all()):
        raise AssertionError("e2e: an empty prediction or a wrong shape")
    mean = float(d.mean())
    print(f"[e2e] {n} grown samples -> device edges -> K1 -> noise -> generator "
          f"-> DynUNet: adapt+segment {dt:.4f} s, K1 launches {launches}; Dice vs "
          f"splatted labels mean {mean:.4f} per image "
          f"{[round(float(x), 4) for x in d]} (fixture graphs {fixture_dice:.4f}); "
          f"e2e {n / (grow_s + dt):.4f} img/s = {n} / ({grow_s:.3f} s grow + "
          f"{dt:.3f} s adapt+segment)")
    if not (bool(torch.isfinite(d).all()) and abs(mean - fixture_dice) <= 0.05):
        raise AssertionError(f"e2e Dice {mean} not within 0.05 of the fixture "
                             f"graphs' {fixture_dice}")
    return launches


def phase_grow_banded(ref_state=None):
    """The full growth schedule in the banded configuration, twice from the
    same seed; node counts against ``ref_state``, the unbanded run's."""
    import warnings

    import torch

    from octa_tpu_torch.sim import greenhouse as gh
    from octa_tpu_torch.sim.configs import vessel_graph_gen
    from octa_tpu_torch.tools.time_growth import forest_digest

    cfg = vessel_graph_gen()
    g = gh.Greenhouse(cfg["Greenhouse"], node_capacity=NODE_CAP,
                      sink_capacity=SINK_CAP, seed=0, banded=True)
    runs = []
    for rep in range(2):
        zero_counts()  # the second growth is this main path's run
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            state = g.develop_forest(cfg["Forest"], batch=GROW_BATCH)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        counts = read_counts()
        ceiling = [str(w.message) for w in caught
                   if "capacity ceiling" in str(w.message)]
        if ceiling:
            raise AssertionError(f"growth hit a capacity ceiling: {ceiling}")
        log = g.stage_log
        iters = sum(e["seg_len"] for e in log)
        redos = sum(not e["accepted"] for e in log)
        print(f"[grow-banded] run {rep}: develop_forest(banded) batch "
              f"{GROW_BATCH}: {dt:.3f} s = {GROW_BATCH / dt:.3f} samples/s; "
              f"segments {len(log)} (redone {redos}), iterations run {iters}; "
              f"final cap {state.art.pos.shape[1]} scap {state.oxy.pos.shape[1]}; "
              f"launches {counts}; host syncs {g.host_syncs}")
        if (counts["K5"], counts["K2"], counts["K3"]) != (3 * iters, iters,
                                                          5 * iters):
            raise AssertionError(
                f"launch counts {counts} do not match {iters} iterations "
                "(3 K5, 1 K2, 5 K3 an iteration)")
        runs.append((state, dt, counts))
    state, dt, counts = runs[1]
    same = all(torch.equal(x, y) for x, y in zip(
        runs[0][0].art + runs[0][0].ven + runs[0][0].oxy,
        state.art + state.ven + state.oxy))
    worst_abs = worst_rel = 0.0
    for b in range(GROW_BATCH):
        for name, f in (("art", state.art), ("ven", state.ven)):
            _, r_abs, r_rel = _check_forest(f, b, f"banded sample {b} {name}",
                                            ordered=False)
            worst_abs, worst_rel = max(worst_abs, r_abs), max(worst_rel, r_rel)
    nodes = torch.stack([state.art.n_nodes, state.ven.n_nodes]).cpu()
    # what K5 could skip on the grown state (sorted at the last restage,
    # the last segment's nodes and sinks appended behind): oxygen sinks
    # against arterial nodes, band = delta_art of the last iteration
    from octa_tpu_torch.ops import nearest

    last = g.modes[-1]
    nc = state.art.pos.shape[1]
    exists = torch.arange(nc, device=state.art.pos.device) < state.art.n_nodes[:, None]
    band = last.delta_art / (g.param_scale * (state.sigma_t - last.delta_sigma))
    hit = nearest.banded_hits(state.oxy.pos, state.art.pos, exists[:, None],
                              state.oxy.alive, band)
    print(f"[grow-banded] on the grown state (sinks -> arterial nodes, "
          f"{hit.shape[1]} tiles x {hit.shape[2]} chunks a sample): chunks "
          f"skipped {100 * (1 - float(hit.float().mean())):.1f} %")
    print(f"[grow-banded] digest of the grown batch: {forest_digest(state)}")
    profile_late_segment(g, state, g.stage_log[-1]["ecap"], "grow-banded-profile",
                         {"K5 staging": "::stage_kernel", "K5 scan": "::scan_kernel",
                          "K2": "nearest_kernel", "K3": "segsum_kernel"})
    line = (f"[grow-banded] two runs from seed 0 identical={same}; art "
            f"{nodes[0].tolist()} ven {nodes[1].tolist()}; Murray residual max "
            f"abs {worst_abs:.3g} rel {worst_rel:.3g}")
    delta = None
    if ref_state is not None:
        ref = torch.stack([ref_state.art.n_nodes, ref_state.ven.n_nodes]).cpu()
        delta = abs(int(nodes.sum()) - int(ref.sum())) / int(ref.sum())
        per = ((nodes.sum(0) - ref.sum(0)).abs() / ref.sum(0)).max()
        line += (f"; nodes of the batch {int(nodes.sum())} against the unbanded "
                 f"run's {int(ref.sum())}: relative difference {delta:.4f} "
                 f"(largest per sample {float(per):.4f})")
    print(line)
    if not same:
        raise AssertionError("two banded runs from one seed differ")
    if not (worst_abs < 1e-5 and worst_rel < 1e-5):
        raise AssertionError("banded: radii are not at the Murray fixed point")
    if delta is not None and delta > BANDED_NODE_DELTA:
        raise AssertionError(f"banded node count differs by {delta} from the "
                             f"unbanded run's (limit {BANDED_NODE_DELTA})")
    return counts, dt


def phase_gen():
    """The dataset generator at full width: grow 8, voxelize, rasterize,
    write, read back."""
    import json as _json
    import os
    import tempfile

    import numpy as np
    import torch

    from octa_tpu_torch import generate_vessel_graph as gen
    from octa_tpu_torch.io import images
    from octa_tpu_torch.ops import raster
    from octa_tpu_torch.sim.configs import vessel_graph_gen

    cfg = vessel_graph_gen()
    cfg["output"].update(image_scale_factor=GEN_SCALE, save_3D_volumes="npy")
    n = GROW_BATCH
    with tempfile.TemporaryDirectory() as tmp:
        cfg["output"]["directory"] = tmp
        timings = {}
        zero_counts()
        t0 = time.perf_counter()
        dirs = gen.generate(cfg, n, seed=0, timings=timings,
                            log=lambda line: None)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts()
        if (counts["K4"], counts["K1"], counts["K5"]) != (2 * n, 2 * n, 0) \
                or counts["K2"] == 0 or counts["K3"] != 5 * counts["K2"] // 4:
            raise AssertionError(f"[gen] launch counts {counts}: expected K4 "
                                 f"{2 * n}, K1 {2 * n}, K5 0, K3 = 5/4 K2 > 0")
        dices, flipped, edges, nbytes = [], [], [], 0
        for d in dirs:
            name = os.path.basename(d)
            vol = np.load(os.path.join(d, "art_ven_img_gray.npy"))
            img = images.load_png_gray8(os.path.join(d, "art_ven_img_gray.png"))
            graph = raster.parse_graph_csv(os.path.join(d, name + ".csv"))
            with open(os.path.join(d, "config.json")) as f:
                if _json.load(f) != cfg:
                    raise AssertionError(f"[gen] {d}: config.json differs")
            nbytes += sum(os.path.getsize(os.path.join(d, f))
                          for f in os.listdir(d))
            if vol.shape != (GEN_SCALE, GEN_SCALE, 53) or vol.dtype != np.uint8 \
                    or img.shape != (GEN_SCALE, GEN_SCALE) or img.dtype != np.uint8:
                raise AssertionError(f"[gen] {d}: shapes {vol.shape} {img.shape}")
            if int(vol.max()) < 200 or int(img.max()) < 200:
                raise AssertionError(f"[gen] {d}: an empty volume or image")
            edges.append(len(graph["radius"]))
            # the volume's maximum along z against the 2D image (row = x,
            # column = y in both), thresholded at 0.1 of full scale
            mip, im = vol.max(-1) > 25, img > 25
            dices.append(2 * float((mip & im).sum()) / float(mip.sum() + im.sum()))
            flipped.append(2 * float((mip.T & im).sum()) / float(mip.sum() + im.sum()))
    per = {k: v / n for k, v in timings.items()}
    print(f"[gen] generate() {n} samples at scale {GEN_SCALE}: {dt:.3f} s = "
          f"{dt / n:.3f} s a sample (grow {per['grow']:.3f}, voxelize "
          f"{per['voxelize']:.4f}, rasterize {per['rasterize']:.4f}, write "
          f"{per['write']:.3f}); launches {counts}; {nbytes / 2 ** 20:.1f} MiB "
          f"written; edges per sample {edges}; Dice of the volume's z-maximum "
          f"against the image min {min(dices):.4f} mean "
          f"{sum(dices) / n:.4f} (transposed, as a control: mean "
          f"{sum(flipped) / n:.4f}); limit {GEN_MIP_DICE}")
    if not all(10_000 <= e <= 18_000 for e in edges):
        raise AssertionError(f"[gen] edge counts {edges} outside 10,000-18,000")
    if min(dices) < GEN_MIP_DICE:
        raise AssertionError(f"[gen] the volume's z-maximum overlaps the image "
                             f"with Dice {min(dices)} < {GEN_MIP_DICE}")
    return counts, timings


class TrainArgs:
    """The flags of ``python -m octa_tpu_torch.train`` at their defaults."""

    start_epoch = 0
    epoch = "latest"
    split = ""
    save_latest = True
    epochs_per_run = 0


def _grad_rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def train_step_split(model, batch, post, metrics, reps: int = 3) -> dict:
    """One training step on a loaded batch, taken apart: device ms of the
    forward, backward and Adam update (CUDA events), host ms of the
    post-processing and the metric, and the host syncs of a step (sync debug
    mode "warn", one warning each)."""
    import warnings

    import torch

    from octa_tpu_torch.train.algorithms import _post_first

    x = model._batch_in(batch["image"])
    y = model._batch_in(batch["label"])
    step_ms = cuda_ms(lambda: model.train_step(x, y), reps=reps, warmup=1)
    pred, _ = model.train_step(x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outputs = {"prediction": _post_first(post.get("prediction"), pred),
               "label": _post_first(post.get("label"), y)}
    model.compute_metric(outputs, metrics)
    post_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            outputs, _ = model.perform_training_step(batch, post)
            model.compute_metric(outputs, metrics)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    return {"step_ms": step_ms, "post_ms": post_ms, "syncs": syncs}


def phase_train():
    """Segmentation training (``configs/config_ves_seg-S.yml`` at full width:
    DynUNet, 1216², batch 4, bf16 autocast, remat) through the port's
    ``octa_tpu_torch.train.train`` on data made on the spot; returns the
    main path's kernel counts."""
    import tempfile

    import numpy as np
    import torch

    from octa_tpu_torch.data.dataset import (
        collate,
        get_dataset,
        get_post_transformation,
    )
    from octa_tpu_torch.io.images import load_png
    from octa_tpu_torch.ops.splat import SPLAT2D
    from octa_tpu_torch.tools.seg_data import make_seg_dataset, point_config_at
    from octa_tpu_torch.train import train
    from octa_tpu_torch.train.algorithms import define_model
    from octa_tpu_torch.utils.config import load_config
    from octa_tpu_torch.utils.enums import Phase
    from octa_tpu_torch.utils.metrics import MetricsManager

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        globs = make_seg_dataset(tmp, n_graphs=8, n_backgrounds=8, n_val=4,
                                 device=dev)
        cfg = point_config_at(load_config("configs/config_ves_seg-S.yml"),
                              globs, os.path.join(tmp, "runs"))
        cfg["Train"].update(epochs=TRAIN_EPOCHS, epochs_decay=1, val_interval=1)
        batch = cfg["Train"]["batch_size"]
        print(f"[train] data (8 graphs, 8 backgrounds 304², 4 validation pairs "
              f"1216²) made in {time.perf_counter() - t0:.2f} s")
        png_ms = {}
        for res, pattern in ((304, "backgrounds"), (1216, "val_images")):
            path = sorted(glob.glob(globs[pattern]))[0]
            t0 = time.perf_counter()
            for _ in range(3):
                load_png(path)
            png_ms[res] = (time.perf_counter() - t0) / 3 * 1e3
        print(f"[train] reading a Paeth-filtered 8-bit PNG (io/images.py "
              f"load_png, host): 304² {png_ms[304]:.1f} ms, 1216² "
              f"{png_ms[1216]:.1f} ms")
        steps = []
        # main path: the training run
        zero_counts()
        t0 = time.perf_counter()
        run = train(TrainArgs(), json.loads(json.dumps(cfg)), device=dev,
                    on_step=lambda *a: steps.append(a))
        run_s = time.perf_counter() - t0
        counts = read_counts()
        with open(os.path.join(run, "metrics.csv")) as f:
            rows = list(csv.DictReader(f))
        cks = sorted(os.listdir(os.path.join(run, "checkpoints")))

        losses = [s[2]["DiceBCELoss"] for s in steps]
        if len(steps) != 2 * TRAIN_EPOCHS or not np.all(np.isfinite(losses)):
            raise AssertionError(f"[train] steps {len(steps)}, losses {losses}")
        dsc = [float(r["Validation_DSC"]) for r in rows]
        if len(rows) != TRAIN_EPOCHS or not np.all(np.isfinite(dsc)):
            raise AssertionError(f"[train] metrics.csv rows {rows}")
        if not {"latest_model_model.ckpt", "latest_optimizer.ckpt",
                "best_model_model.ckpt"} <= set(cks):
            raise AssertionError(f"[train] checkpoints {cks}")
        loaded_batches = counts["K1"] / (2 * batch)
        if counts["K1"] % (2 * batch) or loaded_batches < len(steps):
            raise AssertionError(f"[train] K1 launched {counts['K1']} times for "
                                 f"{len(steps)} steps of batch {batch}")
        per = [w + s for _, _, _, w, s in steps[1:]]
        steps_s = len(per) / sum(per)
        print(f"[train] {TRAIN_EPOCHS} epochs, {len(steps)} steps of batch "
              f"{batch} at 1216² in {run_s:.2f} s; losses "
              + " ".join(f"{v:.4f}" for v in losses)
              + "; validation DSC " + " ".join(f"{v:.4f}" for v in dsc)
              + f"; after the first step {steps_s:.3f} steps/s, "
              f"{steps_s * batch:.2f} img/s (loader wait "
              f"{np.mean([s[3] for s in steps[1:]]) * 1e3:.1f} ms, step "
              f"{np.mean([s[4] for s in steps[1:]]) * 1e3:.1f} ms a step)")
        print(f"[train] K1 launches {counts['K1']} = 2 x {batch} x "
              f"{loaded_batches:.0f} loaded batches ({len(steps)} trained, the "
              f"rest prefetched by the engine's first-batch peek); other "
              f"kernels {({k: v for k, v in counts.items() if k != 'K1'})}")

        # a step's split, on batches loaded here on the main stream
        ds = get_dataset(cfg, Phase.TRAIN, device=dev).dataset
        post = get_post_transformation(cfg, Phase.TRAIN, dev)
        torch.cuda.synchronize()
        SPLAT2D.launches = 0
        t0 = time.perf_counter()
        b = collate([ds[i] for i in range(batch)])
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        if SPLAT2D.launches != 2 * batch:
            raise AssertionError(f"[train] a batch launched K1 "
                                 f"{SPLAT2D.launches} times, not {2 * batch}")
        split = {}
        for remat in (True, False):
            c = json.loads(json.dumps(cfg))
            c["General"]["model"]["remat"] = remat
            model = define_model(c, Phase.TRAIN, dev)
            model.initialize_model_and_optimizer(b, c, TrainArgs())
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            split[remat] = train_step_split(model, b, post,
                                            MetricsManager(Phase.TRAIN))
            split[remat]["peak_gib"] = (torch.cuda.max_memory_allocated()
                                        - base) / 2 ** 30
            del model
            torch.cuda.empty_cache()
        on, off = split[True], split[False]
        print(f"[train] a step at batch {batch}, 1216², bf16: loading a batch "
              f"{load_ms:.1f} ms host (in the loader thread, {2 * batch} K1 "
              f"launches); forward+backward+Adam {on['step_ms']:.2f} ms device "
              f"with remat, {off['step_ms']:.2f} ms without; post-processing "
              f"and metric {on['post_ms']:.1f} ms host; host syncs a step "
              f"{on['syncs']}; peak memory above the weights "
              f"{on['peak_gib']:.2f} GiB with remat, {off['peak_gib']:.2f} GiB "
              f"without")
        if on["syncs"] != 3:
            raise AssertionError(f"[train] {on['syncs']} host syncs a step, "
                                 "expected 3 (loss, prediction, label)")
        phase_train_agree(cfg, b)
    return counts


def _central(x, size: int):
    """The central ``size``² crop of an NCHW batch."""
    h, w = x.shape[-2:]
    return x[..., (h - size) // 2:(h + size) // 2, (w - size) // 2:(w + size) // 2]


def phase_train_agree(cfg, batch):
    """One training step on the card against the same step on the CPU, from
    the same weights and the central 608² of the loaded batch's first
    sample (the full network; the crop keeps the CPU's share short): in
    float64 on both (the port's path with no rounding to speak of: loss
    within 1e-9 relative, every gradient tensor within 1e-6 relative L2),
    and in float32 with TF32 off on the card against the CPU's float64
    (loss within 1e-4 relative; every gradient tensor within 1e-3 relative
    L2). A gradient tensor that float32 itself cannot give to 1e-4, the
    CPU's float32 step being further than that from its float64 step (most
    of them at 608²: sums over 370,000 pixels through instance norms), is
    printed, and held instead to ``AGREE_ILL_FACTOR`` times the CPU's own
    float32 distance from float64."""
    import numpy as np
    import torch

    from octa_tpu_torch.train.algorithms import define_model
    from octa_tpu_torch.utils.enums import Phase

    c = json.loads(json.dumps(cfg))
    c["General"]["amp"] = False
    c["General"]["model"]["remat"] = False
    runs = {}
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev, dtype in (("cpu", torch.float64), ("cpu", torch.float32),
                           ("cuda", torch.float64), ("cuda", torch.float32)):
            model = define_model(c, Phase.TRAIN, dev)
            model.initialize_model_and_optimizer(batch, c, TrainArgs())
            model.net.to(dtype)
            x, y = (_central(batch[k][:AGREE_BATCH], AGREE_SIZE).to(dev, dtype)
                    for k in ("image", "label"))
            t0 = time.perf_counter()
            _, loss = model.train_step(x, y)
            grads = {n: p.grad.cpu().double()
                     for n, p in model.net.named_parameters()}
            runs[dev, dtype] = (float(loss), grads, time.perf_counter() - t0)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    ref_loss, ref_grads, ref_s = runs["cpu", torch.float64]
    cpu32 = {n: _grad_rel_l2(g, ref_grads[n])
             for n, g in runs["cpu", torch.float32][1].items()}
    ill = sorted(n for n, e in cpu32.items() if e > AGREE_ILL_CONDITIONED)
    for dtype, (loss_tol, grad_tol) in ((torch.float64, (1e-9, 1e-6)),
                                        (torch.float32, (1e-4, 1e-3))):
        loss, grads, _ = runs["cuda", dtype]
        rel_loss = abs(loss - ref_loss) / abs(ref_loss)
        err = {n: _grad_rel_l2(grads[n], ref_grads[n]) for n in ref_grads}
        held = ill if dtype == torch.float32 else []
        worst = max((e, n) for n, e in err.items() if n not in held)
        print(f"[train-agree] card {str(dtype)[6:]} step against the CPU's "
              f"float64, {AGREE_BATCH} sample at {AGREE_SIZE}²: loss "
              f"{loss:.9f} vs {ref_loss:.9f} (rel {rel_loss:.2e}, bound "
              f"{loss_tol:g}), worst gradient rel L2 {worst[0]:.2e} "
              f"({worst[1]}, of {len(ref_grads) - len(held)} tensors; bound "
              f"{grad_tol:g}); the median {np.median(list(err.values())):.2e}")
        bad = [n for n in held if err[n] > AGREE_ILL_FACTOR * cpu32[n]]
        if held:
            ratio = max((err[n] / cpu32[n], n) for n in held)
            print(f"[train-agree] card float32, the {len(held)} tensors that "
                  f"float32 gives no closer than {AGREE_ILL_CONDITIONED:g} on "
                  f"the CPU either: the card's distance at most "
                  f"{ratio[0]:.2f} x the CPU's ({ratio[1]}; bound "
                  f"{AGREE_ILL_FACTOR:g} x); card / CPU float32 rel L2: "
                  + ", ".join(f"{n} {err[n]:.2e}/{cpu32[n]:.2e}" for n in held))
        if not (rel_loss <= loss_tol and worst[0] <= grad_tol) or bad:
            raise AssertionError(f"[train-agree] the card's {dtype} step "
                                 f"disagrees with the CPU's {bad}")
    print(f"[train-agree] cpu steps: float64 {ref_s:.1f} s, float32 "
          f"{runs['cpu', torch.float32][2]:.1f} s; the CPU's float32 "
          f"gradients {min(cpu32.values()):.2e}-{max(cpu32.values()):.2e} "
          f"rel L2 off its float64, {len(ill)} of {len(cpu32)} over "
          f"{AGREE_ILL_CONDITIONED:g}")


def phase_cards():
    """With two cards or more (``python3 chip_smoke.py cards``): every
    kernel, launched on the second card while the first is the current
    device, gives the bits it gives on the first. The wrappers launch a
    tensor on another card under a device guard."""
    import torch

    from octa_tpu_torch.ops import nearest, segsum, splat, splat3d

    if torch.cuda.device_count() < 2:
        raise AssertionError("[cards] needs two cards or more")
    torch.cuda.set_device(0)
    g = torch.Generator().manual_seed(11)
    rand = lambda *shape: torch.rand(shape, generator=g)
    q, p = rand(2, 600, 3), rand(2, 3000, 3)
    mask, alive = rand(2, 1, 3000) < 0.8, rand(2, 600) < 0.8
    band = torch.full((2,), 0.05)
    seg, f3 = (rand(2, 3000) * 500).to(torch.int32), rand(2, 3000, 3)
    a2 = rand(1, 300, 2) * 256
    b2, w2 = a2 + rand(1, 300, 2) * 16 - 8, rand(1, 300) * 3 + 1
    v2 = torch.ones(1, 300, dtype=torch.bool)
    box = torch.tensor([64.0, 64.0, 16.0])
    a3 = rand(200, 3) * box
    b3, r3 = a3 + rand(200, 3) * 8 - 4, rand(200) * 2 + 0.5
    v3 = torch.ones(200, dtype=torch.bool)
    calls = {
        "K1": lambda t: splat.splat_lines_2d(
            *t(a2, b2, w2, v2), height=256, width=256, k_max=64),
        "K2": lambda t: nearest.masked_nearest(*t(q, p, mask)),
        "K3": lambda t: segsum.segment_sum(*t(seg, f3), 500),
        "K4": lambda t: splat3d.splat_capsules_3d(
            *t(a3, b3, r3, v3), dims=(64, 64, 16)),
        "K5": lambda t: nearest.masked_nearest_banded(
            *t(q, p, mask, alive, band))}
    for tag, call in calls.items():
        outs = []
        for i in (0, 1):
            out = call(lambda *xs, i=i: [x.to(f"cuda:{i}") for x in xs])
            outs.append([x.cpu() for x in (out if isinstance(out, tuple)
                                           else (out,))])
        if torch.cuda.current_device() != 0:
            raise AssertionError(f"[cards] {tag} changed the current device")
        if not all(torch.equal(x, y) for x, y in zip(*outs)):
            raise AssertionError(f"[cards] {tag} on cuda:1 differs from cuda:0")
        print(f"[cards] {tag} on cuda:1 (cuda:0 current): bit-equal to "
              f"cuda:0")


def print_windows() -> None:
    """How many ``torch.profiler`` windows the device times took, and how
    many of them were taken again because the profiler had dropped events
    (``time_kernels._launches``, which raises when none of a time's windows
    is whole)."""
    from octa_tpu_torch.tools.time_kernels import WINDOWS

    print(f"[profiler] {WINDOWS['taken']} windows taken for device times, "
          f"{WINDOWS['retaken']} of them again after dropped events")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from octa_tpu_torch.ops import raster

    t0 = time.perf_counter()

    def lap(name):
        print(f"[time] {name} done at {time.perf_counter() - t0:.1f} s")

    phase_device()
    phase_build()
    lap("build")
    only = set(sys.argv[1:])
    if only:  # a partial run for fault finding: the named phases only
        for name, phase in (
                ("k1", phase_k1), ("k2", phase_k2), ("k3", phase_k3),
                ("k4", phase_k4), ("k5", phase_k5),
                ("iter", phase_iter), ("iter-banded", lambda: phase_iter(True)),
                ("grow", phase_grow), ("grow-banded", phase_grow_banded),
                ("gen", phase_gen), ("train", phase_train),
                ("cards", phase_cards)):
            if name in only:
                phase()
        print_windows()
        print(f"partial run ({sorted(only)}): no result line")
        return 0
    samples = [raster.parse_graph_csv(p) for p in raster.fixture_graph_paths()]
    if len(samples) != 4:
        raise RuntimeError("expected the four fixture graphs")
    rows = phase_k1()
    lap("k1")
    phase_agree(samples)
    # main path 1: adapt and segment
    launches, pipe, fixture_dice, run_pipeline = phase_pipeline(samples)
    lap("agree, pipeline")
    k2_rows = phase_k2()
    k3_rows = phase_k3()
    lap("k2, k3")
    k4_rows = phase_k4()
    k5_rows = phase_k5()
    profile_pipeline(run_pipeline)
    lap("k4, k5, pipeline profile")
    phase_iter()
    phase_iter(banded=True)
    lap("iter, iter-banded")
    # main path 2: grow (its second run) -> e2e
    state, grow_s, _ = phase_grow()
    phase_e2e(state, grow_s, pipe, fixture_dice)
    grow_counts = read_counts()
    lap("grow, e2e")
    # main path 3: banded growth (its second run)
    banded_counts, _ = phase_grow_banded(state)
    lap("grow-banded")
    # main path 4: the dataset generator
    gen_counts, _ = phase_gen()
    lap("gen")
    # main path 5: segmentation training
    train_counts = phase_train()
    lap("train")

    def by_path(tag):
        paths = {"adapt_segment": launches if tag == "K1" else 0,
                 "grow_e2e": grow_counts[tag], "grow_banded": banded_counts[tag],
                 "generate": gen_counts[tag], "train": train_counts[tag]}
        return {k: v for k, v in paths.items() if v}

    main_rows = [r for r in rows if r["case"].startswith("pipeline")]
    k2_main = [r for r in k2_rows if r["main_path"]]
    k4_main = [r for r in k4_rows if r["main_path"]]
    k5_main = [r for r in k5_rows if r["main_path"]]
    kernels = [{
        "name": "splat_lines_2d",
        "route": "cuda",
        "source": "octa_tpu_torch/csrc/splat2d.cu",
        "replaces": "octa_tpu/ops/pallas_splat.py:93",
        "launches": sum(by_path("K1").values()),
        "launches_by_path": by_path("K1"),
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        # per pipeline batch: one 304² (k 4096) and one 1216² (k 512) call;
        # device time (binning + splat), and the calls' time
        "ms": sum(r["ms"] for r in main_rows),
        "call_ms": sum(r["call_ms"] for r in main_rows),
        "plain_ms": sum(r["plain_ms"] for r in main_rows),
        "bound_ms": sum(r["bound_ms"] for r in main_rows),
        "bound_by": max(main_rows, key=lambda r: r["bound_ms"])["bound_by"],
        "library_ms": None,
        "cases": rows,
    }, {
        "name": "masked_nearest",
        "route": "cuda",
        "source": "octa_tpu_torch/csrc/nearest.cu",
        "replaces": "octa_tpu/ops/pallas_nearest.py:110",
        "launches": sum(by_path("K2").values()),
        "launches_by_path": by_path("K2"),
        "max_abs_err": max(r["max_abs_err"] for r in k2_rows),
        # per growth iteration at full capacity, batch 8: the four calls
        "ms": sum(r["ms"] for r in k2_main),
        "plain_ms": sum(r["plain_ms"] for r in k2_main),
        "bound_ms": sum(r["bound_ms"] for r in k2_main),
        "bound_by": max(k2_main, key=lambda r: r["bound_ms"])["bound_by"],
        "library_ms": None,
        "cases": k2_rows,
    }, {
        "name": "segment_sum",
        "route": "cuda",
        "source": "octa_tpu_torch/csrc/segsum.cu",
        "replaces": "octa_tpu/ops/pallas_segsum.py:72",
        "launches": sum(by_path("K3").values()),
        "launches_by_path": by_path("K3"),
        "max_abs_err": max(r["max_abs_err"] for r in k3_rows),
        # per growth iteration at full capacity, batch 8: one F=18 call and
        # four F=1 Murray sweeps
        "ms": k3_rows[0]["ms"] + 4 * k3_rows[1]["ms"],
        "plain_ms": k3_rows[0]["plain_ms"] + 4 * k3_rows[1]["plain_ms"],
        "bound_ms": k3_rows[0]["bound_ms"] + 4 * k3_rows[1]["bound_ms"],
        "bound_by": k3_rows[0]["bound_by"],
        "library_ms": k3_rows[0]["library_ms"] + 4 * k3_rows[1]["library_ms"],
        "cases": k3_rows,
    }, {
        "name": "splat_capsules_3d",
        "route": "cuda",
        "source": "octa_tpu_torch/csrc/splat3d.cu",
        "replaces": "octa_tpu/ops/pallas_splat.py:284",
        "launches": sum(by_path("K4").values()),
        "launches_by_path": by_path("K4"),
        "max_abs_err": max(r["max_abs_err"] for r in k4_rows),
        # per generated sample: the arterial and the venous tree at
        # (1216, 1216, 53) in the renderer's uint8 store; device time
        # (binning + gather), and the calls' time
        "ms": sum(r["ms"] for r in k4_main),
        "call_ms": sum(r["call_ms"] for r in k4_main),
        "plain_ms": sum(r["plain_ms"] for r in k4_main),
        "bound_ms": sum(r["bound_ms"] for r in k4_main),
        "bound_by": max(k4_main, key=lambda r: r["bound_ms"])["bound_by"],
        "library_ms": None,
        "cases": k4_rows,
    }, {
        "name": "masked_nearest_banded",
        "route": "cuda",
        "source": "octa_tpu_torch/csrc/nearest_banded.cu",
        "replaces": "octa_tpu/ops/pallas_nearest.py:269",
        "launches": sum(by_path("K5").values()),
        "launches_by_path": by_path("K5"),
        "max_abs_err": max(r["max_abs_err"] for r in k5_rows),
        # per banded growth iteration at full capacity, batch 8: the three
        # calls on y-sorted points; device time, and the calls' time
        "ms": sum(r["ms"] for r in k5_main),
        "call_ms": sum(r["call_ms"] for r in k5_main),
        "plain_ms": sum(r["plain_ms"] for r in k5_main),
        "bound_ms": sum(r["bound_ms"] for r in k5_main),
        "bound_by": max(k5_main, key=lambda r: r["bound_ms"])["bound_by"],
        "library_ms": None,
        "cases": k5_rows,
    }]
    print_windows()
    missing = [k["name"] for k in kernels if k["launches"] < 1]
    if missing:
        raise AssertionError(f"no main path launched {missing}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
