#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``octa_tpu_torch``) on one GPU.

Usage: ``python3 chip_smoke.py`` from the root of a checkout, on a machine
with one CUDA card, ``nvcc`` and the CUDA toolkit (``sm_90a``: H100).
``python3 chip_smoke.py k4 k5 gen`` (any of the names k1 k2 k3 k4 k5 iter
iter-banded grow grow-banded gen train gan-seg eval train-aa aa-agree
aa-spread menten baselines skel3d 3d-recon cycle-gan cards) runs only the
device, build and named phases and prints no result line; ``cards``, on a host with two cards
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
             (relative difference of the batch total at most 0.05), the
             first run (PyTorch's deterministic algorithms, failing on an op
             that has none) and the second (the default, as users run it)
             identical bit for bit, a digest of the grown batch, and one
             late segment under ``torch.profiler``;
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

16. gan-seg — joint G/D/S training (``octa_tpu_torch.train.train``) on
             ``configs/config_gan_ves_seg.yml`` at full width
             (``resnetGenerator9`` at 304², ``patchGAN70x70``, DynUNet at
             1216² with remat; batch 4, bf16 autocast), its first 3 of 100
             epochs (``epochs_per_run``) of 2 steps on stand-in data (noise-
             model renders of the fixture graphs as ``real_B``, no real
             OCTA): finite losses, a validation DSC every epoch, the six
             checkpoints, K1 twice a sample loaded; steps/s and img/s. Then
             resumed from the checkpoints (``--start_epoch``), and from the
             six files of one more step that the engine's writer
             (``save_latest_checkpoints``) wrote: the restored parameters
             and Adam states equal the saved ones bit for bit, and one step
             after the restore is held to the same step of the
             run that went on within max(0.2, 8 x the difference of that
             step taken twice from one state) of the step's update, the
             losses within max(1e-3, 8 x theirs): the joint step's backward
             passes (reflect padding, the bilinear upsampling, cuDNN weight
             gradients) accumulate with atomics on the card. A step taken
             apart (device ms of the D step, the joint G+S step and the
             three Adam steps, CUDA events), host syncs a step, peak memory
             above the weights with remat;
17. gan-seg-agree — one GAN-seg step on the card against the CPU's, full
             widths at 128² -> 256², batch 1: float64 on both (losses and
             gradients within 1e-6), and float32 on the card with TF32 off
             and cuDNN deterministic against the CPU's float64 (losses
             within 1e-4; a gradient the CPU's own float32 step gives within
             1e-4 within 5e-3; the others together within 15 x, each within
             30 x, the CPU float32's distance; the conv biases that an
             instance norm follows, with no gradient in exact arithmetic,
             within 1e-9 / 1e-3 of their weights' gradient norm); a control
             step with TF32 on that the together bound must reject; and
             each convolution alone in float32, card and CPU against
             float64 from the float64 step's own inputs (printed: where the
             card's float32 step loses accuracy);
18. eval   — ``python -m octa_tpu_torch.test`` on
             ``docker/trained_models/GAN/config.yml`` (the shipped generator)
             over 64 samples as a subprocess (the first sample's seconds,
             the rate over the other 63) and in this process (K1
             launches); its
             first sample card against CPU in float32 with TF32 off (1e-4);
             ``python -m octa_tpu_torch.validate`` on
             ``configs/config_ves_seg-S_GAN.yml`` with the shipped
             ``ves_seg-S-GAN/10_model.ckpt`` on stand-in pairs (bf16 as
             shipped), and card against CPU in float32 with TF32 off (each
             metric within 1e-3); one epoch (2 steps) of that config's
             training with ``ImageToImageTranslationd`` (the shipped
             generator) in the loader, and the translation's ms a sample;
19. train-aa — adversarial noise training (``configs/config_ves_seg-S_AA.yml``
             at full width, its ``AT`` block as shipped) for 3 epochs of 2
             steps, with one change written into a copy of the config: its
             second ``Resized`` takes ``label`` only, so that ``image``
             stays at the background's 304² (as shipped ``ANTLoss``'s noise
             model multiplies a 1216² image with a 304² background and
             fails, in the JAX package too); finite losses, the
             segmentation loss of each ascent step, a validation DSC every
             epoch, K1 twice a sample loaded; img/s, the device ms of the
             ANT call and of the training step each step (CUDA events),
             host syncs a step and peak memory; one epoch of ``python -m
             octa_tpu_torch.train`` on the copy;
20. aa-agree — one ANT call and one training step at image 64², label
             256², batch 2, full-width DynUNet, crop (1, 1) and (0.5, 0.5),
             with the decisions, control points and Gamma draws pinned:
             float64 card against CPU within 1e-6 (sample, label, every
             ascent step's control-point gradients, the step's gradients and
             weights); float32 (TF32 off, cuDNN deterministic) twice on
             the card, held to the CPU's float64 within max(6 x the CPU
             float32's distance, 8 x the two card runs' distance) per
             tensor but the updated weights (printed: Adam's first update
             is a gradient's sign); a TF32-on control run must break that
             bound;
21. menten — one epoch (2 steps) of ``configs/config_ves_seg_menten.yml``
             as shipped; each of ``BinomialVesselNoised``,
             ``AddVitreousFloater`` (chance 1) and ``AddMotionArtifact`` on
             one 1216² sample on the card and on the CPU from one seed
             (within 1e-5; the motion artifact bit for bit), host ms a
             sample each;
22. baselines — ``python -m octa_tpu_torch.validate`` on
             ``configs/config_frangi.yml`` and ``config_oof.yml`` (no
             checkpoint) on 4 stand-in pairs at 1216², card against CPU with
             TF32 off (each metric within 1e-4), img/s, each filter's
             device ms on one image, ``test`` on the same images;
             ``skrgan`` once through the registry on a card image, a smoke
             run of its host path (device, shape, finite);
23. skel3d — ``skeletonize_3d`` (``ops/skeleton.py``, plain PyTorch) on a
             label as the 3D-reconstruction loader makes it (a fixture graph
             voxelized by K4 at (1216, 1216, 53), planes 4-47, above 0.1 of
             its maximum): its central 256² crop and that crop's one-voxel
             dilation on the card against the CPU bit for bit, at the
             default slab and at 7 planes; the card's seconds on the whole
             [44, 1216, 1216] label and on its dilation, the slab, the peak
             memory, the seconds of the table of neighbourhood codes;
24. 3d-recon — the 3D reconstruction: ``generate()`` of 10 samples at
             scale 1216 into a temporary directory (growth, K4's volumes),
             8 to train on and 2 to validate; ``configs/
             config_3d_recon_supervised.yml`` (DynUNet 2D, 44 output planes,
             1216², batch 4, bf16, remat) with the data blocks of
             ``tests/test_3d_recon.py`` (``tools/seg_data.py::
             point_recon_config_at``: the graph rendered by K1 as the image,
             the volume's planes 4-47 as the label), its first 3 of 30
             epochs of 2 steps: finite losses, K4 twice a sample generated
             and K1 once a sample loaded; img/s after the first step, loader
             wait, a step taken apart (device ms, host syncs: 3, peak
             memory); ``python -m octa_tpu_torch.validate`` once on the 2
             pairs (volumetric ClDice), and ``skeletonize_3d``'s seconds on
             the first pair's thresholded prediction and label; ``python -m
             octa_tpu_torch.test`` with ``RemoveOuterNoise``: a (44, 1216,
             1216) ``.npy`` and a PNG a pair, every component touching the
             central plane;
25. cycle-gan — CycleGAN (``configs/config_cycle_gan.yml`` as shipped:
             two ``resnetGenerator9``, two ``patchGAN70x70``, 304², batch 4,
             bf16) through ``octa_tpu_torch.train.train``, its first 3 of 100
             epochs of 2 steps on stand-in data (noise-model renders as
             ``real_B``, no real OCTA): finite losses, the six checkpoints, K1
             once a sample loaded; img/s; resumed from the checkpoints,
             written again and read back bit for bit, and one step after
             the restore held to the same step of a copy of the saved state
             within max(0.2, 8 x two copies' difference); the G and D steps'
             device ms, peak memory; an ``ImagePool`` on the card against the
             same pool on the host (the same choices); ``python -m
             octa_tpu_torch.test`` with ``netG_A`` on the 8 graphs; then
             ``[cycle-gan-agree]``: one step on the card against the CPU at
             128², batch 1, float64 (1e-6) and float32 with TF32 off and
             cuDNN deterministic under ``[gan-seg-agree]``'s bounds, and a
             TF32-on control step that the together bound must reject.

The main paths are phase 5, phases 11 (second growth) and 12, phase 13
(second growth), phase 14, phase 15, phase 16's training run, phase 18's
``test`` run in this process and its training, phase 19's training run,
phase 21's, phase 24's generation and training, and phase 25's training and
``test`` runs: every kernel's launch count
is set to 0 just before each and read just after. A count through the
loader thread is held to a range (a multiple of the launches a sample
makes, at least the samples consumed), since the thread loads ahead. Bits
are compared only where the code is deterministic by construction: the
kernels, a restored state, growth (forward only; its scatters write
permutations). Every tolerance check records its value against its bound
(``hold``), and a ``[checks]`` line lists each check's worst ratio before
the kernels' JSON line; last comes ``{"ok": true, "device": {"platform":
"gpu", "kind": ..., "count": ...}}``. A failing phase prints ``[fail]
<phase>: <exception>`` and the script exits non-zero with no result line.
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
GAN_EPOCHS = 3
# the resumed GAN-seg step against the step of the run that went on: the
# difference of the updated parameters, relative to the step's update, and
# of the losses, each held to the larger of its floor and RESUME_FACTOR
# times the difference of the same step taken twice from one state (the
# joint step's backward passes accumulate with atomics on the card)
# (the step taken twice read 0.0407 of the update and 7.6e-5 of the losses
# apart, measured on one NVIDIA H100 80GB HBM3 at 700 W)
RESUME_FLOOR, RESUME_LOSS_FLOOR, RESUME_FACTOR = 0.2, 1e-3, 8.0
GAN_AGREE_IN, GAN_AGREE_UP = 128, 256
# the card's float32 GAN-seg step against the CPU's float64: a gradient
# tensor the CPU's float32 gives within 1e-4 is held to GAN_AGREE_WELL; the
# others together to GAN_AGREE_TOGETHER and each to GAN_AGREE_EACH times
# the CPU float32's own distance. The card's float32 read 5.13 x together,
# 8.36 x at most and 1.37e-3 with cuDNN's deterministic algorithms, and
# 5.75 x, 8.87 x and 1.7e-4 with PyTorch's own GEMM convolutions; with TF32
# on, 102 x together. Each convolution alone, its float32 output and input
# gradient are 3.3-3.8 x the CPU's distance in the generator's 256-channel
# residual blocks (median over all 3.0 x and 2.7 x), its weight gradient
# 1.5 x: the step compounds the forward and input-gradient sums (measured
# on one NVIDIA H100 80GB HBM3 at 700 W)
GAN_AGREE_WELL, GAN_AGREE_TOGETHER, GAN_AGREE_EACH = 5e-3, 15.0, 30.0
# the per-convolution float32 comparison splits weight gradients by the
# pixels they sum: at least this many, or fewer
GAN_AGREE_LONG_SUM = 4096
# the test CLI's samples: the first one's seconds apart (the loader's
# start, the first calls), the steady rate over the others
EVAL_SAMPLES, EVAL_VAL = 64, 2
# [aa-agree]: one ANT call and one step at image 64², label 256², batch 2,
# full-width DynUNet, cuDNN deterministic. The card's float32 run is held
# to the CPU's float64 within the larger of AA_CPU_FACTOR times the CPU's
# own float32 distance and AA_TWICE_FACTOR times the distance of two
# identical card runs (the bilinear sample's gather backward accumulates
# with atomics on the card). Over 852 tensors of 12 cases (aa-spread) the
# card read 0.000175 / 1.01 / 1.47 / 2.39 x the CPU float32's distance
# (min / median / 99th percentile / max), and a TF32-on run at least 109 x
# a bound of 3 x, so at least 54 x this one (measured on one NVIDIA H100
# 80GB HBM3 at 700 W)
AA_IN, AA_LABEL, AA_BATCH, AA_SEED = 64, 256, 2, 11
AA_CPU_FACTOR, AA_TWICE_FACTOR = 6.0, 8.0
# ``chip_smoke.py aa-spread``: [aa-agree] at these input seeds, for the
# spread of the card's float32 distance that the factors above must hold
AA_SPREAD_SEEDS = tuple(range(11, 17))
# [menten]: each transform on one sample at this size, card against CPU
MENTEN_RES = 1216
# [baselines]: stand-in validation pairs for frangi and oof at 1216²
BASELINE_VAL = 4
# [3d-recon]: the generator's volumes at scale 1216 are (1216, 1216, 53);
# the shipped config predicts 44 planes, here planes 4-47; samples to train
# on and to validate, epochs of the config's 30 (its schedule kept)
RECON_RES, RECON_DEPTH, RECON_Z_KEEP = 1216, 53, (4, 48)
RECON_TRAIN, RECON_VAL, RECON_EPOCHS, RECON_SEED = 8, 2, 3, 0
# [skel3d]: the side of the crop held card against CPU bit for bit
SKEL_CROP = 256
# [cycle-gan]: a pool small enough to replay within three batches of 4
CYCLE_POOL = 4


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


#: tolerance check name -> the worst value/bound ratio over the run (a lower
#: bound's ratio is bound/value), printed as the ``[checks]`` line
CHECKS: dict[str, float] = {}


def hold(name: str, value: float, bound: float) -> float:
    """A tolerance check, ``value <= bound``: records the ratio of value to
    bound under ``name`` and raises, naming both, when it fails; returns
    ``value``. A lower limit is held as its deficit (``1 - Dice <= 0.3``
    for ``Dice >= 0.7``), so that the ratio says how close it came."""
    value, bound = float(value), float(bound)
    ratio = value / bound
    if ratio != ratio:  # NaN
        ratio = float("inf")
    CHECKS[name] = max(CHECKS.get(name, 0.0), ratio)
    if not ratio <= 1.0:
        raise AssertionError(f"{name}: {value:.4g} against the bound "
                             f"<= {bound:.4g}")
    return value


def print_checks() -> None:
    print("[checks] worst value/bound over the run: " + "; ".join(
        f"{name} {ratio:.3g}" for name, ratio in CHECKS.items()))


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
        err = hold("k1 max|diff| to plain", (out - ref).abs().max(), K1_ATOL)
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
        p0 = partial_reads()
        per = kernels_of(call, ("bin_kernel", "splat_kernel"),
                         f"K1 {row['case']}")
        row["bin_ms"] = sum(t for n, t in per.items() if "bin_kernel" in n)
        row["splat_ms"] = sum(t for n, t in per.items() if "splat_kernel" in n)
        row["ms"] = row["bin_ms"] + row["splat_ms"]
        row["partial"] = partial_reads() > p0
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
          f"(bound 1e-4) logits max|diff|={logit_err:.3g} (bound 1e-3) label "
          f"equal={lab_eq:.6f} mask equal={pred_eq:.6f} (bounds 0.999)")
    hold("agree splat max|diff|", img_err, 1e-4)
    hold("agree logits max|diff|", logit_err, 1e-3)
    hold("agree label share differing", 1 - lab_eq, 1e-3)
    hold("agree mask share differing", 1 - pred_eq, 1e-3)


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
        p0 = partial_reads()
        row["ms"], kernels = device_ms(call)
        row["partial"] = partial_reads() > p0
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
        p0 = partial_reads()
        row["ms"], kernels = device_ms(call)
        if len(kernels) != 1 or "segsum_kernel" not in kernels[0]:
            raise AssertionError(f"K3 {row['case']}: one call ran {kernels}")
        row["plain_ms"], _ = device_ms(plain)
        row["library_ms"], _ = device_ms(lib)
        row["partial"] = partial_reads() > p0
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
        p0 = partial_reads()
        per = kernels_of(call, ("bin_kernel", "gather_kernel"),
                         f"K4 {row['case']} {row['store']}")
        row["bin_ms"] = sum(t for k, t in per.items() if "bin_kernel" in k)
        row["gather_ms"] = sum(t for k, t in per.items() if "gather_kernel" in k)
        row["ms"] = row["bin_ms"] + row["gather_ms"]
        row["partial"] = partial_reads() > p0
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
        p0 = partial_reads()
        per = kernels_of(call, ("stage_kernel", "scan_kernel"),
                         f"K5 {row['case']}")
        row["ms"] = sum(per.values())
        row["stage_ms"] = sum(t for k, t in per.items() if "stage_kernel" in k)
        row["kernels_per_call"] = len(per)
        row["k2_ms"], _ = device_ms(full)
        row["partial"] = partial_reads() > p0
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
    hold(f"{tag} new-node max|pos diff|", pos_err, 1e-4)


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
    hold("grow Murray residual abs", worst_abs, 1e-5)
    hold("grow Murray residual rel", worst_rel, 1e-5)

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
    if not bool(torch.isfinite(d).all()):
        raise AssertionError("e2e: a Dice is not finite")
    hold("e2e |Dice - fixture graphs' Dice|", abs(mean - fixture_dice), 0.05)
    return launches


def phase_grow_banded(ref_state=None):
    """The full growth schedule in the banded configuration, twice from the
    same seed; node counts against ``ref_state``, the unbanded run's. The
    first run takes PyTorch's deterministic algorithms
    (``torch.use_deterministic_algorithms(True, warn_only=True)``), and an
    op that has none fails the phase; the second, the main path's, runs as
    users run it. The two are compared bit for bit: equal bits show that
    the default path computes what the deterministic one does."""
    import warnings

    import torch

    from octa_tpu_torch.sim import greenhouse as gh
    from octa_tpu_torch.sim.configs import vessel_graph_gen
    from octa_tpu_torch.tools.time_growth import forest_digest

    cfg = vessel_graph_gen()
    g = gh.Greenhouse(cfg["Greenhouse"], node_capacity=NODE_CAP,
                      sink_capacity=SINK_CAP, seed=0, banded=True)
    runs, nondeterministic = [], set()
    for rep in range(2):
        zero_counts()  # the second growth is this main path's run
        torch.use_deterministic_algorithms(rep == 0, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                state = g.develop_forest(cfg["Forest"], batch=GROW_BATCH)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
        finally:
            torch.use_deterministic_algorithms(False)
        nondeterministic |= {str(w.message).splitlines()[0] for w in caught
                             if "deterministic" in str(w.message)}
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
    line = (f"[grow-banded] two runs from seed 0, with deterministic "
            f"algorithms and without, identical={same}; art "
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
    if nondeterministic:
        raise AssertionError("banded growth ran ops with no deterministic "
                             f"implementation: {sorted(nondeterministic)}")
    if not same:
        raise AssertionError("two banded runs from one seed differ, with "
                             "deterministic algorithms and without")
    hold("grow-banded Murray residual abs", worst_abs, 1e-5)
    hold("grow-banded Murray residual rel", worst_rel, 1e-5)
    if delta is not None:
        hold("grow-banded node count against unbanded", delta,
             BANDED_NODE_DELTA)
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
    hold("gen 1 - z-maximum Dice against the image", 1 - min(dices),
         1 - GEN_MIP_DICE)
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
        if held:
            ratio = max((err[n] / cpu32[n], n) for n in held)
            print(f"[train-agree] card float32, the {len(held)} tensors that "
                  f"float32 gives no closer than {AGREE_ILL_CONDITIONED:g} on "
                  f"the CPU either: the card's distance at most "
                  f"{ratio[0]:.2f} x the CPU's ({ratio[1]}; bound "
                  f"{AGREE_ILL_FACTOR:g} x); card / CPU float32 rel L2: "
                  + ", ".join(f"{n} {err[n]:.2e}/{cpu32[n]:.2e}" for n in held))
        tag = f"train-agree {str(dtype)[6:]}"
        hold(f"{tag} loss rel", rel_loss, loss_tol)
        hold(f"{tag} gradient rel L2", worst[0], grad_tol)
        for n in held:
            hold(f"{tag} gradient / CPU float32's", err[n] / cpu32[n],
                 AGREE_ILL_FACTOR)
    print(f"[train-agree] cpu steps: float64 {ref_s:.1f} s, float32 "
          f"{runs['cpu', torch.float32][2]:.1f} s; the CPU's float32 "
          f"gradients {min(cpu32.values()):.2e}-{max(cpu32.values()):.2e} "
          f"rel L2 off its float64, {len(ill)} of {len(cpu32)} over "
          f"{AGREE_ILL_CONDITIONED:g}")


def _gan_batch_in(model, batch):
    return [model._batch_in(batch[k]) for k in ("real_A", "real_B", "real_A_seg")]


def _gan_params(model) -> dict:
    """Each network's parameters as one float32 vector."""
    import torch

    return {n: torch.cat([p.detach().float().reshape(-1)
                          for p in net.parameters()])
            for n, net in model.networks.items()}


def _gan_state_equal(a, b) -> bool:
    """The parameters and the three Adam states (step, moments, learning
    rate) of two GAN-seg trainers, bit for bit."""
    import torch

    for n in a.networks:
        for p, q in zip(a.networks[n].parameters(), b.networks[n].parameters()):
            if not torch.equal(p, q):
                return False
    for o in a.opt:
        ga, gb = a.opt[o].param_groups[0], b.opt[o].param_groups[0]
        if ga["lr"] != gb["lr"]:
            return False
        for p, q in zip(ga["params"], gb["params"]):
            sa, sb = a.opt[o].state[p], b.opt[o].state[q]
            if float(sa["step"]) != float(sb["step"]) or not (
                    torch.equal(sa["exp_avg"], sb["exp_avg"])
                    and torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])):
                return False
    return True


def _resumed(cfg: dict, save_dir: str, epoch: int, dev):
    """A GAN-seg trainer resumed from ``save_dir``'s latest checkpoints, as
    ``--start_epoch`` does."""
    from octa_tpu_torch.train.algorithms import define_model
    from octa_tpu_torch.utils.enums import Phase

    c = json.loads(json.dumps(cfg))
    c["Output"]["save_dir"] = save_dir

    class Resume(TrainArgs):
        start_epoch = epoch

    model = define_model(c, Phase.TRAIN, dev)
    model.initialize_model_and_optimizer(None, c, Resume())
    return model


def phase_gan_seg():
    """Joint G/D/S training (``configs/config_gan_ves_seg.yml`` at full
    width) through the port's ``octa_tpu_torch.train.train`` on stand-in
    data; resumed from its checkpoints; a step taken apart; then
    ``[gan-seg-agree]``. Returns the main path's kernel counts."""
    import copy
    import tempfile
    import warnings

    import numpy as np
    import torch

    from octa_tpu_torch.data.dataset import (
        collate,
        get_dataset,
        get_post_transformation,
    )
    from octa_tpu_torch.io.visualizer import Visualizer
    from octa_tpu_torch.tools.seg_data import make_seg_dataset, point_config_at
    from octa_tpu_torch.train import train
    from octa_tpu_torch.train.algorithms import define_model
    from octa_tpu_torch.train.engine import save_latest_checkpoints
    from octa_tpu_torch.utils.config import load_config
    from octa_tpu_torch.utils.enums import Phase
    from octa_tpu_torch.utils.metrics import MetricsManager

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        globs = make_seg_dataset(tmp, n_graphs=8, n_backgrounds=8, n_val=4,
                                 n_real_b=8, device=dev)
        cfg = point_config_at(load_config("configs/config_gan_ves_seg.yml"),
                              globs, os.path.join(tmp, "runs"))
        for key in ("image", "label"):  # the split names a 50-image set
            cfg["Validation"]["data"][key].pop("split")
        batch = cfg["Train"]["batch_size"]

        class FirstEpochs(TrainArgs):  # of the config's 100: its schedule
            epochs_per_run = GAN_EPOCHS
        print(f"[gan-seg] stand-in data (8 graphs, 8 backgrounds and 8 real_B "
              f"renders at 304², 4 validation pairs at 1216²; no real OCTA) "
              f"made in {time.perf_counter() - t0:.2f} s")
        steps = []
        # main path: the training run
        zero_counts()
        t0 = time.perf_counter()
        run = train(FirstEpochs(), json.loads(json.dumps(cfg)), device=dev,
                    on_step=lambda *a: steps.append(a))
        run_s = time.perf_counter() - t0
        counts = read_counts()
        with open(os.path.join(run, "metrics.csv")) as f:
            rows = list(csv.DictReader(f))
        cks = set(os.listdir(os.path.join(run, "checkpoints")))
        losses = {k: [s[2][k] for s in steps] for k in steps[0][2]}
        if len(steps) != 2 * GAN_EPOCHS or not all(
                np.all(np.isfinite(v)) for v in losses.values()):
            raise AssertionError(f"[gan-seg] steps {len(steps)}, losses {losses}")
        dsc = [float(r["Validation_DSC"]) for r in rows]
        if len(rows) != GAN_EPOCHS or not np.all(np.isfinite(dsc)):
            raise AssertionError(f"[gan-seg] metrics.csv rows {rows}")
        six = {f"latest_{n}_model.ckpt" for n in ("generator", "discriminator",
                                                  "segmentor")} \
            | {f"latest_optimizer_{o}.ckpt" for o in "GDS"}
        if not six <= cks:
            raise AssertionError(f"[gan-seg] checkpoints {sorted(cks)}")
        # K1 renders real_A and real_A_seg of each sample loaded; the loader
        # thread loads ahead, so the count is held to a range
        loaded = counts["K1"] / (2 * batch)
        if counts["K1"] % (2 * batch) or loaded < len(steps):
            raise AssertionError(f"[gan-seg] K1 launched {counts['K1']} times "
                                 f"for {len(steps)} steps of batch {batch}")
        per = [w + s for _, _, _, w, s in steps[1:]]
        steps_s = len(per) / sum(per)
        print(f"[gan-seg] {GAN_EPOCHS} epochs, {len(steps)} steps of batch "
              f"{batch} (304² -> 1216², bf16 autocast, segmentor remat) in "
              f"{run_s:.2f} s; losses " + "; ".join(
                  f"{k} " + " ".join(f"{v:.4f}" for v in vs)
                  for k, vs in losses.items())
              + "; validation DSC (stand-in pairs) "
              + " ".join(f"{v:.4f}" for v in dsc)
              + f"; after the first step {steps_s:.3f} steps/s, "
              f"{steps_s * batch:.2f} img/s (loader wait "
              f"{np.mean([s[3] for s in steps[1:]]) * 1e3:.1f} ms, step "
              f"{np.mean([s[4] for s in steps[1:]]) * 1e3:.1f} ms a step)")
        print(f"[gan-seg] the six checkpoints written; K1 launches "
              f"{counts['K1']} = 2 x {batch} x {loaded:.0f} loaded batches "
              f"({len(steps)} trained, the rest loaded ahead by the loader "
              f"thread); other kernels "
              f"{({k: v for k, v in counts.items() if k != 'K1'})}")

        # resume: a step after restored checkpoints against the same step
        # of the run that went on, and the same step taken twice
        ds = get_dataset(cfg, Phase.TRAIN, device=dev).dataset
        b1 = collate([ds[i] for i in range(batch)])
        b2 = collate([ds[i] for i in range(batch, 2 * batch)])
        fresh = define_model(cfg, Phase.TRAIN, dev)
        run_state = _resumed(cfg, run, GAN_EPOCHS, dev)
        moved = {n: float((_gan_params(run_state)[n] - p).abs().max())
                 for n, p in _gan_params(fresh).items()}
        del fresh
        if not all(v > 0 for v in moved.values()):
            raise AssertionError(f"[gan-seg] a network did not train: {moved}")
        run_state.train_step(*_gan_batch_in(run_state, b1))
        # the six files, written as the engine writes them
        c = json.loads(json.dumps(cfg))
        c["Output"]["save_dir"] = os.path.join(tmp, "resume")
        vis = Visualizer(c)
        save_latest_checkpoints(vis, run_state, GAN_EPOCHS + 1, cfg)
        twin = copy.deepcopy(run_state)
        restored = _resumed(cfg, vis.save_dir, GAN_EPOCHS + 1, dev)
        bits = _gan_state_equal(restored, twin)
        if not bits:
            raise AssertionError("[gan-seg] the restored state differs from "
                                 "the saved one")
        before = _gan_params(twin)
        out = {}
        for tag, model in (("run", run_state), ("twin", twin),
                           ("restored", restored)):
            _, ls = model.train_step(*_gan_batch_in(model, b2))
            out[tag] = ({k: float(v) for k, v in ls.items()}, _gan_params(model))

        def apart(tag):
            (la, pa), (lb, pb) = out[tag], out["run"]
            dp = max(float((pa[n] - pb[n]).norm() / (pb[n] - before[n]).norm())
                     for n in pb)
            dl = max(abs(la[k] - lb[k]) / max(abs(lb[k]), 1e-6) for k in lb)
            return dp, dl

        (dp_twin, dl_twin), (dp_res, dl_res) = apart("twin"), apart("restored")
        bound_p = max(RESUME_FLOOR, RESUME_FACTOR * dp_twin)
        bound_l = max(RESUME_LOSS_FLOOR, RESUME_FACTOR * dl_twin)
        print(f"[gan-seg] resumed from the run's checkpoints (--start_epoch "
              f"{GAN_EPOCHS}), one step, the six files written and read back: "
              f"the restored parameters and Adam states equal the saved ones "
              f"bit for bit; the next step against the run's: parameters "
              f"{dp_res:.3g} apart relative to the step's update (bound "
              f"{bound_p:.3g}), losses {dl_res:.3g} relative (bound "
              f"{bound_l:.3g}); the same step taken twice from one state: "
              f"{dp_twin:.3g} and {dl_twin:.3g} (its backward passes are not "
              f"deterministic on the card)")
        hold("gan-seg resumed step: parameters", dp_res, bound_p)
        hold("gan-seg resumed step: losses", dl_res, bound_l)
        del run_state, twin, out

        # a step taken apart, on a batch loaded on the main stream
        model = restored
        post = get_post_transformation(cfg, Phase.TRAIN, dev)
        names = ("D", "adam_D", "GS", "adam_G", "adam_S")
        reps, ms = 3, {n: 0.0 for n in names}
        x = _gan_batch_in(model, b1)
        for rep in range(reps + 1):
            events = [torch.cuda.Event(enable_timing=True)]
            events[0].record()

            def mark(name, events=events):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)

            model.train_step(*x, on_stage=mark)
            torch.cuda.synchronize()
            if rep:  # the first is a warm-up
                for name, a, b in zip(names, events, events[1:]):
                    ms[name] += a.elapsed_time(b) / reps
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        model.train_step(*x)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        metrics = MetricsManager(Phase.TRAIN)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                outputs, _ = model.perform_training_step(b1, post)
                model.compute_metric(outputs, metrics)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        print(f"[gan-seg] a step at batch {batch}, bf16, segmentor remat: "
              f"device ms (CUDA events, mean of {reps}): generator forward and "
              f"D forward+backward {ms['D']:.2f}, Adam D {ms['adam_D']:.2f}, "
              f"joint G+S forward+backward {ms['GS']:.2f}, Adam G "
              f"{ms['adam_G']:.2f}, Adam S {ms['adam_S']:.2f}, whole step "
              f"{sum(ms.values()):.2f}; host syncs a step {syncs}; peak memory "
              f"above the weights {peak:.2f} GiB")
        del model, restored
        torch.cuda.empty_cache()
        phase_gan_seg_agree(cfg, b1)
    return counts


# analytically zero gradients: the bias of a conv that an instance norm
# follows (every generator conv but the last; the PatchGAN's inner convs)
def _zero_gradient_bias(name: str) -> bool:
    net, *mod, leaf = name.split(".")
    if leaf != "bias":
        return False
    if net == "generator":
        return mod != ["conv_out"]
    return net == "discriminator" and mod[0] in ("conv1", "conv2", "conv3")


def _capture_convs(model) -> tuple[dict, list]:
    """Forward hooks on every convolution of ``model``'s networks: for each,
    the module, its input and its output's gradient, from the first call
    whose output takes a gradient. Returns the dict and the hooks' handles."""
    import torch.nn as nn

    pairs, handles = {}, []
    for n, net in model.networks.items():
        for name, m in net.named_modules():
            if not isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                continue

            def hook(mod, inp, out, key=f"{n}.{name}"):
                if key in pairs or not out.requires_grad:
                    return
                pairs[key] = [mod, inp[0].detach(), None]
                out.register_hook(
                    lambda g: pairs[key].__setitem__(2, g.detach()))
            handles.append(m.register_forward_hook(hook))
    return pairs, handles


def _conv_sums(pairs: dict) -> list:
    """Each convolution's own float32 error: its output, input gradient and
    weight gradient from the captured float64 input and output gradient,
    computed in float32 on the card and on the CPU, each against float64.
    Rows of (layer, pixels its weight gradient sums, card/CPU distance of
    the output, of the input gradient, of the weight gradient, the CPU's
    weight-gradient distance)."""
    import copy

    import torch
    import torch.nn as nn

    rows = []
    for key, (mod, x, dy) in pairs.items():
        if dy is None:
            continue
        out = {}
        for tag, dev, dtype in (("ref", "cpu", torch.float64),
                                ("cpu", "cpu", torch.float32),
                                ("card", "cuda", torch.float32)):
            m = copy.deepcopy(mod).to(dev, dtype)
            xi = x.to(dev, dtype).requires_grad_(True)
            y = m(xi)
            gx, gw = torch.autograd.grad(y, (xi, m.weight), dy.to(dev, dtype))
            out[tag] = [t.detach().cpu().double() for t in (y, gx, gw)]
        cpu = [_grad_rel_l2(a, b) for a, b in zip(out["cpu"], out["ref"])]
        on_card = [_grad_rel_l2(a, b) for a, b in zip(out["card"], out["ref"])]
        summed = dy if isinstance(mod, nn.Conv2d) else x
        pixels = summed.numel() // summed.shape[1]
        rows.append((key, pixels,
                     *(c / max(q, 1e-300) for c, q in zip(on_card, cpu)), cpu[2]))
    return rows


def phase_gan_seg_agree(cfg, batch):
    """One GAN-seg step on the card against the same step on the CPU, from
    the same weights, full-width networks at 128² -> 256², batch 1 (central
    crops of the loaded batch's first sample): in float64 on both (losses
    within 1e-6 relative, every gradient tensor within 1e-6 relative L2),
    and in float32 with TF32 off and cuDNN's deterministic algorithms on
    the card against the CPU's float64 (losses within 1e-4 relative; a
    gradient tensor that the CPU's float32 step gives within 1e-4 of its
    float64 step within ``GAN_AGREE_WELL``; the others, together, within
    ``GAN_AGREE_TOGETHER`` times the CPU float32 step's own distance, each
    within ``GAN_AGREE_EACH`` times its own). A conv bias that an instance
    norm follows has no gradient in exact arithmetic: its gradient norm is
    held to 1e-9 (float64) and 1e-3 (float32) of its weight's. A control
    step in float32 with TF32 on (PyTorch's default for cuDNN) must fail
    the together bound. Then each convolution's own float32 sums, from its
    input and output gradient in the CPU's float64 step, on the card and on
    the CPU: where the card's float32 step loses accuracy (printed, not
    held)."""
    import numpy as np
    import torch

    from octa_tpu_torch.train.algorithms import define_model
    from octa_tpu_torch.utils.enums import Phase

    c = json.loads(json.dumps(cfg))
    c["General"]["amp"] = False
    c["General"]["model"]["upshape"] = [GAN_AGREE_UP, GAN_AGREE_UP]
    c["General"]["model"]["model_s"]["remat"] = False
    x = [_central(batch["real_A"][:1], GAN_AGREE_IN),
         _central(batch["real_B"][:1], GAN_AGREE_IN),
         _central(batch["real_A_seg"][:1], GAN_AGREE_UP)]
    runs = {}
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    try:
        for dev, dtype, tf32 in (
                ("cpu", torch.float64, False), ("cpu", torch.float32, False),
                ("cuda", torch.float64, False), ("cuda", torch.float32, False),
                ("cuda", torch.float32, True)):
            torch.backends.cudnn.allow_tf32 = tf32
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.deterministic = not tf32
            model = define_model(c, Phase.TRAIN, dev)
            for net in model.networks.values():
                net.to(dtype)
            model.initialize_model_and_optimizer(None, c, TrainArgs())
            if (dev, dtype) == ("cpu", torch.float64):
                pairs, handles = _capture_convs(model)
            t0 = time.perf_counter()
            _, ls = model.train_step(*(t.to(dev, dtype) for t in x))
            grads = {f"{n}.{k}": p.grad.detach().cpu().double()
                     for n, net in model.networks.items()
                     for k, p in net.named_parameters()}
            runs[dev, dtype, tf32] = ({k: float(v) for k, v in ls.items()},
                                      grads, time.perf_counter() - t0)
            del model
        for h in handles:
            h.remove()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        sums = _conv_sums(pairs)
        del pairs
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
    ref_loss, ref, ref_s = runs["cpu", torch.float64, False]
    cpu32_grads = runs["cpu", torch.float32, False][1]
    zero = sorted(n for n in ref if _zero_gradient_bias(n))
    rest = [n for n in ref if n not in zero]
    cpu32 = {n: _grad_rel_l2(cpu32_grads[n], ref[n]) for n in rest}
    ill = [n for n in rest if cpu32[n] > AGREE_ILL_CONDITIONED]
    cpu_num = sum(float((cpu32_grads[n] - ref[n]).norm() ** 2)
                  for n in ill) ** 0.5

    def bias_ratio(grads):
        return max(float(grads[n].norm() / grads[n[:-4] + "weight"].norm())
                   for n in zero)

    def together(grads):
        return sum(float((grads[n] - ref[n]).norm() ** 2)
                   for n in ill) ** 0.5 / cpu_num

    each_step = {}
    for dtype in (torch.float64, torch.float32):
        loss, grads, _ = runs["cuda", dtype, False]
        tag = f"gan-seg-agree {str(dtype)[6:]}"
        rel_loss = max(abs(loss[k] - ref_loss[k]) / abs(ref_loss[k])
                       for k in ref_loss if ref_loss[k] != 0)
        err = {n: _grad_rel_l2(grads[n], ref[n]) for n in rest}
        held = ill if dtype == torch.float32 else []
        if dtype == torch.float64:
            tol, b_tol = 1e-6, 1e-9
        else:
            tol, b_tol = GAN_AGREE_WELL, 1e-3
        worst = max((e, n) for n, e in err.items() if n not in held)
        line = (f"[gan-seg-agree] card {str(dtype)[6:]} GAN-seg step against the "
                f"CPU's float64 ({GAN_AGREE_IN}² -> {GAN_AGREE_UP}², batch 1): "
                f"losses worst rel {rel_loss:.3g} (bound "
                f"{1e-6 if dtype == torch.float64 else 1e-4:g}); gradients of "
                f"{len(rest) - len(held)} tensors: worst rel L2 {worst[0]:.3g} "
                f"({worst[1]}, bound {tol:g}), the median "
                f"{np.median(list(err.values())):.3g}; {len(zero)} zero-gradient "
                f"biases at most {bias_ratio(grads):.3g} of their weights' "
                f"gradient norm (bound {b_tol:g}; the CPU float32's "
                f"{bias_ratio(cpu32_grads):.3g})")
        if held:
            each_step = {n: err[n] / cpu32[n] for n in held}
            each = max((v, n) for n, v in each_step.items())
            line += (f"; the {len(held)} tensors the CPU's float32 gives no "
                     f"closer than {AGREE_ILL_CONDITIONED:g}: together "
                     f"{together(grads):.3g} x the CPU float32's distance "
                     f"(bound {GAN_AGREE_TOGETHER:g}), each at most "
                     f"{each[0]:.3g} x ({each[1]}, bound {GAN_AGREE_EACH:g})")
        print(line)
        hold(f"{tag} loss rel", rel_loss, 1e-6 if dtype == torch.float64 else 1e-4)
        hold(f"{tag} gradient rel L2", worst[0], tol)
        hold(f"{tag} zero-gradient bias / weight gradient", bias_ratio(grads),
             b_tol)
        if held:
            hold(f"{tag} gradients together / CPU float32's", together(grads),
                 GAN_AGREE_TOGETHER)
            hold(f"{tag} gradient / CPU float32's", each[0], GAN_AGREE_EACH)
    tf32 = together(runs["cuda", torch.float32, True][1])
    print(f"[gan-seg-agree] control: the card's float32 step with TF32 on "
          f"(cuDNN's default) is {tf32:.3g} x the CPU float32's distance "
          f"together, against {together(runs['cuda', torch.float32, False][1]):.3g} "
          f"x with TF32 off; the together bound {GAN_AGREE_TOGETHER:g} must "
          f"reject it")
    hold("gan-seg-agree TF32 control: together bound / its reading",
         GAN_AGREE_TOGETHER / tf32, 1.0)
    # where the card's float32 step loses accuracy: each convolution alone
    med = lambda col, rows=sums: float(np.median([r[col] for r in rows]))
    long = [r for r in sums if r[1] >= GAN_AGREE_LONG_SUM]
    short = [r for r in sums if r[1] < GAN_AGREE_LONG_SUM]
    top = sorted(sums, key=lambda r: -r[4])[:4]
    worst_step = sorted(each_step, key=lambda n: -each_step[n])[:4]
    by_layer = {r[0]: r for r in sums}
    print(f"[gan-seg-agree] each of {len(sums)} convolutions alone, from its "
          f"input and output gradient in the CPU's float64 step, float32 on "
          f"the card (TF32 off, cuDNN deterministic) and on the CPU against "
          f"float64: card/CPU distance, median, output {med(2):.3g} x, input "
          f"gradient {med(3):.3g} x, weight gradient {med(4):.3g} x; weight "
          f"gradients that sum >= {GAN_AGREE_LONG_SUM} pixels "
          f"({len(long)}) {med(4, long) if long else float('nan'):.3g} x, "
          f"fewer ({len(short)}) {med(4, short) if short else float('nan'):.3g} "
          f"x; largest weight-gradient ratios " + ", ".join(
              f"{r[0]} {r[4]:.3g} x ({r[1]} pixels, CPU {r[5]:.2g})"
              for r in top)
          + "; the step's largest ratios and their layer's own weight "
          "gradient: " + ", ".join(
              f"{n} {each_step[n]:.3g} x / "
              + (f"{by_layer[n.rsplit('.', 1)[0]][4]:.3g} x"
                 if n.rsplit(".", 1)[0] in by_layer else "no conv")
              for n in worst_step))
    print("[gan-seg-agree] each convolution: layer, pixels summed, card/CPU "
          "output, input gradient, weight gradient: " + "; ".join(
              f"{r[0]} {r[1]} {r[2]:.2g} {r[3]:.2g} {r[4]:.2g}" for r in sums))
    print(f"[gan-seg-agree] cpu steps: float64 {ref_s:.1f} s, float32 "
          f"{runs['cpu', torch.float32, False][2]:.1f} s; the CPU's float32 "
          f"gradients {min(cpu32.values()):.2e}-{max(cpu32.values()):.2e} rel L2 "
          f"off its float64, {len(ill)} of {len(cpu32)} over "
          f"{AGREE_ILL_CONDITIONED:g}")


def phase_eval():
    """The evaluation CLIs and translation in the loader: ``python -m
    octa_tpu_torch.test`` on the shipped generator, ``python -m
    octa_tpu_torch.validate`` on the shipped segmentor, and two steps of
    ``configs/config_ves_seg-S_GAN.yml`` with ``ImageToImageTranslationd``.
    Returns the kernel counts of the test CLI's run and of the training."""
    import ast
    import tempfile

    import numpy as np
    import torch

    from octa_tpu_torch import test as ttest
    from octa_tpu_torch import validate as tval
    from octa_tpu_torch.data.dataset import get_dataset
    from octa_tpu_torch.data.transforms import get_data_augmentations
    from octa_tpu_torch.tools.seg_data import make_seg_dataset, point_config_at
    from octa_tpu_torch.train import train
    from octa_tpu_torch.train.algorithms import define_model
    from octa_tpu_torch.utils.config import load_config
    from octa_tpu_torch.utils.enums import Phase

    dev = torch.device("cuda")
    gen_ckpt = "docker/trained_models/GAN/10_G_model.ckpt"
    seg_ckpt = "docker/trained_models/ves_seg-S-GAN/10_model.ckpt"
    with tempfile.TemporaryDirectory() as tmp:
        globs = make_seg_dataset(tmp, n_graphs=8, n_backgrounds=8,
                                 n_val=EVAL_VAL, device=dev)
        test_globs = make_seg_dataset(os.path.join(tmp, "test"),
                                      n_graphs=EVAL_SAMPLES, n_backgrounds=8,
                                      n_val=0, device=dev)
        # test.py on the shipped generator (General.inference: G)
        out = os.path.join(tmp, "generated")
        argv = ["--config_file", "docker/trained_models/GAN/config.yml",
                "--num_samples", str(EVAL_SAMPLES),
                "--Test.data.real_A.files", test_globs["graphs"],
                "--Test.data.background.files", test_globs["backgrounds"],
                "--Test.model_path", gen_ckpt, "--Test.save_dir", out]
        r = subprocess.run([sys.executable, "-m", "octa_tpu_torch.test", *argv],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise AssertionError(f"[eval] python -m octa_tpu_torch.test: rc "
                                 f"{r.returncode}\n{r.stdout}\n{r.stderr}")
        wrote = r.stdout.strip().splitlines()[-1]
        pngs = sorted(os.listdir(out))
        if len(pngs) != EVAL_SAMPLES or not all(p.startswith("G_") for p in pngs):
            raise AssertionError(f"[eval] test.py wrote {pngs}")
        # main path: the same run in this process, for the launch counts
        zero_counts()
        t0 = time.perf_counter()
        written = ttest.main(argv[:-1] + [os.path.join(tmp, "generated2")])
        test_counts = read_counts()
        in_process_s = time.perf_counter() - t0
        if len(written) != EVAL_SAMPLES or test_counts["K1"] < EVAL_SAMPLES:
            raise AssertionError(f"[eval] test.py in process: {written}, K1 "
                                 f"launched {test_counts['K1']} times")
        # the first sample's translation, card against CPU in float32
        cfg = load_config("docker/trained_models/GAN/config.yml")
        cfg["Test"]["data"]["real_A"]["files"] = globs["graphs"]
        cfg["Test"]["data"]["background"]["files"] = globs["backgrounds"]
        cfg["Test"]["model_path"] = gen_ckpt
        cfg["General"]["seed"] = 4958
        x = get_dataset(cfg, Phase.TEST, device=dev).dataset[0]["real_A"][None]
        preds = {}
        flags = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
        for tf32 in (False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            torch.backends.cuda.matmul.allow_tf32 = tf32
            for d in ("cpu", "cuda") if not tf32 else ("cuda",):
                model = define_model(cfg, Phase.TEST, d)
                model.initialize_model_and_optimizer(None, cfg, TrainArgs(),
                                                     phase=Phase.TEST)
                with torch.no_grad():
                    preds[d, tf32] = model.generate(x.to(d, torch.float32)).cpu()
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
        err = float((preds["cuda", False] - preds["cpu", False]).abs().max())
        err_tf32 = float((preds["cuda", True] - preds["cpu", False]).abs().max())
        print(f"[eval] test.py (docker/trained_models/GAN/config.yml, the shipped "
              f"generator, inference G, 304²): {wrote}, as a subprocess "
              f"(loading with K1, translation, PNG writing); in process "
              f"{in_process_s:.2f} s with model loading, K1 launches "
              f"{test_counts['K1']} for {EVAL_SAMPLES} samples (one render a "
              f"sample, with what the loader thread loaded ahead); the first "
              f"sample on the card against the CPU, float32: max abs "
              f"{err:.3g} with TF32 off (bound 1e-4), {err_tf32:.3g} with "
              f"TF32 on")
        hold("eval test.py card vs CPU max|diff|", err, 1e-4)

        # validate.py on the shipped segmentor, on stand-in pairs
        vargv = ["--config_file", "configs/config_ves_seg-S_GAN.yml",
                 "--Test.model_path", seg_ckpt,
                 "--Validation.data.image.files", globs["val_images"],
                 "--Validation.data.label.files", globs["val_labels"]]
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "octa_tpu_torch.validate",
                            *vargv], capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise AssertionError(f"[eval] python -m octa_tpu_torch.validate: "
                                 f"rc {r.returncode}\n{r.stdout}\n{r.stderr}")
        shipped = ast.literal_eval(r.stdout.strip().splitlines()[-1])
        val_s = time.perf_counter() - t0
        res = {}
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            for d in ("cuda", "cpu"):
                t0 = time.perf_counter()
                res[d] = (tval.main(vargv + ["--device", d, "--General.amp",
                                             "false"]),
                          time.perf_counter() - t0)
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = flags
        gap = max((abs(res["cuda"][0][k] - res["cpu"][0][k]), k)
                  for k in res["cpu"][0])
        if not all(np.isfinite(v) for v in shipped.values()):
            raise AssertionError(f"[eval] validate.py: {shipped}")
        print(f"[eval] validate.py (configs/config_ves_seg-S_GAN.yml, the "
              f"shipped ves_seg-S-GAN/10_model.ckpt, {EVAL_VAL} stand-in pairs "
              f"at 1216², not real OCTA and no paper number): bf16 as shipped "
              f"{json.dumps(shipped)} in {val_s:.1f} s (a subprocess); float32 "
              f"card against CPU: worst {gap[1]} {gap[0]:.3g} (bound 1e-3; "
              f"the CPU took {res['cpu'][1]:.1f} s)")
        hold("eval validate.py card vs CPU metric", gap[0], 1e-3)

        # training with the shipped generator translating in the loader
        cfg = point_config_at(load_config("configs/config_ves_seg-S_GAN.yml"),
                              globs, os.path.join(tmp, "s_gan"))
        for aug in cfg["Train"]["data_augmentation"]:
            if aug["name"] == "ImageToImageTranslationd":
                aug["model_path"] = gen_ckpt
                entry = dict(aug)
        cfg["Train"].update(epochs=1, epochs_decay=0)
        batch = cfg["Train"]["batch_size"]
        steps = []
        zero_counts()
        train(TrainArgs(), json.loads(json.dumps(cfg)), device=dev,
              on_step=lambda *a: steps.append(a))
        s_gan_counts = read_counts()
        losses = [s[2]["DiceBCELoss"] for s in steps]
        loaded = s_gan_counts["K1"] / (2 * batch)
        if len(steps) != 8 // batch or not np.all(np.isfinite(losses)) or \
                s_gan_counts["K1"] % 2 or loaded < len(steps):
            raise AssertionError(f"[eval] S_GAN training: {len(steps)} steps, "
                                 f"losses {losses}, K1 {s_gan_counts['K1']}")
        translate = get_data_augmentations([entry], 42, device=dev)[0]
        img = torch.rand(1, 304, 304, device=dev)
        ms = cuda_ms(lambda: translate({"image": img}), reps=10)
        print(f"[eval] config_ves_seg-S_GAN.yml, {len(steps)} steps of batch "
              f"{batch} with ImageToImageTranslationd (the shipped generator) "
              f"in the loader: losses " + " ".join(f"{v:.4f}" for v in losses)
              + f"; loader wait {np.mean([s[3] for s in steps]) * 1e3:.1f} ms, "
              f"step {np.mean([s[4] for s in steps]) * 1e3:.1f} ms a step; "
              f"translation {ms:.2f} ms a 304² sample (CUDA events, float32); "
              f"K1 launches {s_gan_counts['K1']} (2 a sample loaded)")
    return test_counts, s_gan_counts


def _ant_pins(crop, seed: int = 5):
    """Decisions and control points of one ANT call for ``[aa-agree]``, drawn
    once on the CPU by the port's own ``ANTLoss`` (float32 angles and
    factors, float32 control points), and the seed of the Gamma draws."""
    import torch

    from octa_tpu_torch.utils.losses import ANTLoss, DiceBCELoss

    base = ANTLoss(DiceBCELoss(True), crop=crop,
                   generator=torch.Generator().manual_seed(seed))
    return {"d": base.decisions(AA_BATCH, AA_LABEL, AA_LABEL, "cpu"),
            "p": base.noise_params(AA_BATCH, "cpu"), "seed": seed + 1}


def _pinned_ant(at, pins):
    """``at`` (a model's ``ANTLoss``) with its draws replaced by ``pins``:
    the same decisions and control points on every device, and Gamma fields
    that are a smooth function of the concentrations the run computes: the
    inverse CDF at fixed uniforms (``scipy.special.gammaincinv`` on the
    host, float64), with torch's derivative dx/da attached
    (``noise_model.injected_draw``). A sampler's draws would not do: the
    CPU's Gamma sampler draws element after element from one stream, so
    one rejection that float32 rounding flips shifts every later draw."""
    import torch
    from scipy.special import gammaincinv

    from octa_tpu_torch.models import noise_model as nm
    from octa_tpu_torch.utils.losses import ANTDecisions

    at.decisions = lambda b, h, w, device: ANTDecisions(
        *(t.to(device) for t in pins["d"]))
    at.noise_params = lambda b, device: nm.NoiseParams(
        *(t.to(device) for t in pins["p"]))

    def hook(concentrations):
        out = []
        for i, c in enumerate(concentrations):
            g = torch.Generator().manual_seed(pins["seed"] + i)
            u = torch.rand(c.shape, dtype=torch.float64, generator=g)
            a = c.cpu().double()
            x = torch.from_numpy(gammaincinv(a.numpy(), u.numpy()))
            out.append((x.to(c.dtype), torch._standard_gamma_grad(a, x)
                        .to(c.dtype)))
        return out

    at.gamma_draw = lambda: nm.injected_draw(hook)
    return at


def _aa_step(cfg, dev, dtype, inputs, pins, crop):
    """One ANT call and one training step of a fresh S_AA trainer on
    ``dev`` in ``dtype`` with the pinned draws; returns the sample, label,
    each ascent step's control-point gradients, the step's gradients and
    the updated parameters, on the CPU in float64, and the seconds."""
    import torch

    from octa_tpu_torch.train.algorithms import define_model
    from octa_tpu_torch.utils.enums import Phase

    c = json.loads(json.dumps(cfg))
    c["Train"]["AT"]["crop"] = list(crop)
    model = define_model(c, Phase.TRAIN, dev)
    model.initialize_model_and_optimizer(None, c, TrainArgs())
    model.net.to(dtype)
    _pinned_ant(model.at, pins)
    x, bg, y = (t.to(dev, dtype) for t in inputs)
    t0 = time.perf_counter()
    adv, y_crop = model.adversarial_batch(x, bg, y)
    model.train_step(adv, y_crop)
    secs = time.perf_counter() - t0
    f64 = lambda t: t.detach().cpu().double()
    out = {"sample": f64(adv), "label": f64(y_crop)}
    for i, grads in enumerate(model.at.param_grads):
        for name, g in zip(grads._fields, grads):
            out[f"iteration {i + 1} d{name}"] = f64(g)
    for n, p in model.net.named_parameters():
        out[f"grad {n}"] = f64(p.grad)
        out[f"param {n}"] = f64(p)
    return out, secs


def phase_aa_agree(cfg=None, seeds=(AA_SEED,)):
    """``[aa-agree]``: one ANT call and one training step of the S_AA
    trainer (full-width DynUNet, ``remat`` as configured, autocast off) at
    image and background 64², label 256², batch 2, crop (1, 1) and (0.5,
    0.5), with the same decisions, control points and Gamma draws pinned
    (``_pinned_ant``), cuDNN's deterministic algorithms on and its
    benchmark off: float64 on the card against float64 on the CPU (sample,
    label, each ascent step's control-point gradients, the step's gradients
    and the updated weights within 1e-6 relative L2 each), and float32 with
    TF32 off on the card, twice, against the CPU's float64: the sample,
    label and gradients within the larger of ``AA_CPU_FACTOR`` times the
    CPU's own float32 distance and ``AA_TWICE_FACTOR`` times the two card
    runs' distance. A control run in float32 with TF32 on must break that
    bound in some tensor. The float32 updated weights are printed, not
    held: Adam's first update is ``lr g / (|g| + eps)``, the sign of each
    gradient element, which float32 rounding flips where an element is near
    zero (the CPU's own float32 step reads 0.15-0.35 off float64 in the
    instance-norm biases at this size). ``seeds`` are the inputs' seeds
    (the pins' seed is each less 6); with more than one (``aa-spread``) a
    last line gives the spread of the card's float32 distance over the CPU
    float32's. Every case prints before any is held."""
    import numpy as np
    import torch

    from octa_tpu_torch.tools.seg_data import keep_image_at_background_size
    from octa_tpu_torch.utils.config import load_config

    c = json.loads(json.dumps(cfg or keep_image_at_background_size(
        load_config("configs/config_ves_seg-S_AA.yml"))))
    c["General"]["amp"] = False
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    holds, spread = [], {"tensors": [], "controls": []}
    try:
        for seed in seeds:
            rng = np.random.default_rng(seed)
            inputs = [torch.from_numpy(rng.random(shape)) for shape in (
                (AA_BATCH, 1, AA_IN, AA_IN), (AA_BATCH, 1, AA_IN, AA_IN),
                (AA_BATCH, 1, AA_LABEL, AA_LABEL))]
            for crop in ((1, 1), (0.5, 0.5)):
                pins = _ant_pins(crop, seed - 6)
                runs = {}
                for key in (("cpu", torch.float64), ("cuda", torch.float64),
                            ("cpu", torch.float32), ("cuda", torch.float32),
                            ("cuda twice", torch.float32),
                            ("cuda tf32", torch.float32)):
                    tf32 = key[0] == "cuda tf32"
                    torch.backends.cudnn.allow_tf32 = tf32
                    torch.backends.cuda.matmul.allow_tf32 = tf32
                    runs[key] = _aa_step(c, key[0].split()[0], key[1], inputs,
                                         pins, crop)
                holds += _aa_case(seed, crop, runs, spread)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    if len(seeds) > 1:
        q = lambda col: np.quantile([r[col] for r in spread["tensors"]],
                                    [0, 0.5, 0.99, 1])
        print(f"[aa-spread] {len(spread['controls'])} cases (input seeds "
              f"{list(seeds)}, 2 crops), {len(spread['tensors'])} tensor "
              "readings "
              "(sample and gradients; cuDNN deterministic, TF32 off): the "
              "card's float32 distance over the CPU float32's, min / median / "
              "99th percentile / max " + " / ".join(f"{v:.3g}" for v in q(0))
              + "; over the bound " + " / ".join(f"{v:.3g}" for v in q(1))
              + "; TF32-on control over the bound, the worst tensor of a "
              f"case at least {min(spread['controls']):.3g}")
    for args in holds:
        hold(*args)


def _aa_case(seed, crop, runs, spread) -> list:
    """``[aa-agree]``'s readings of one case: prints its line, appends (card
    over CPU float32 distance, card over bound) per held tensor and the TF32
    control's worst reading over its bound to ``spread``, and returns its
    holds."""
    import torch

    ref = runs["cpu", torch.float64][0]
    names = list(ref)
    d64 = {n: _grad_rel_l2(runs["cuda", torch.float64][0][n], ref[n])
           for n in names}
    worst64 = max((v, n) for n, v in d64.items())
    tag = f"aa-agree crop {crop[0]:g}"
    holds = [(f"{tag} float64 rel L2", worst64[0], 1e-6)]
    card, twice, cpu32, tf32 = (runs[k, torch.float32][0]
                                for k in ("cuda", "cuda twice", "cpu",
                                          "cuda tf32"))
    ratios, weights, control = [], [], []
    for n in names:
        if n.startswith("param "):  # printed, not held (docstring)
            weights.append((_grad_rel_l2(card[n], ref[n]),
                            _grad_rel_l2(cpu32[n], ref[n]), n))
            continue
        d_card = _grad_rel_l2(card[n], ref[n])
        d_twice = _grad_rel_l2(card[n], twice[n])
        d_cpu = _grad_rel_l2(cpu32[n], ref[n])
        # the floor, far below float32's resolution, is for tensors that
        # all three runs give exactly (the label)
        bound = max(AA_CPU_FACTOR * d_cpu, AA_TWICE_FACTOR * d_twice, 1e-9)
        ratios.append((d_card / bound, n, d_card, d_cpu, d_twice))
        control.append(_grad_rel_l2(tf32[n], ref[n]) / bound)
        holds.append((f"{tag} float32 / bound", d_card, bound))
        if d_cpu > 0:
            spread["tensors"].append((d_card / d_cpu, d_card / bound))
    worst_control = max(control)
    spread["controls"].append(worst_control)
    holds.append((f"{tag} TF32 control: bound / its worst reading",
                  1.0 / worst_control, 1.0))
    ratios.sort(reverse=True)
    twice_max = max((r[4], r[1]) for r in ratios)
    to_cpu = [r[2] / r[3] for r in ratios if r[3] > 0]
    print(f"[aa-agree] seed {seed}, crop {crop}: image {AA_IN}², label "
          f"{AA_LABEL}², batch {AA_BATCH}, full-width DynUNet, cuDNN "
          f"deterministic; {len(names)} tensors (sample, label, 2 x 5 "
          f"control-point gradients, the step's gradients and updated "
          f"weights). float64 card vs CPU: worst rel L2 {worst64[0]:.2e} "
          f"({worst64[1]}; bound 1e-6). float32 card (TF32 off) vs CPU "
          f"float64: worst {ratios[0][2]:.2e} ({ratios[0][1]}), "
          f"{ratios[0][0]:.3f} of its bound (CPU float32 {ratios[0][3]:.2e}, "
          f"two card runs {ratios[0][4]:.2e} apart); the card's distance "
          f"{min(to_cpu):.2f}-{max(to_cpu):.2f} x the CPU float32's; the two "
          f"float32 card runs at most {twice_max[0]:.2e} apart "
          f"({twice_max[1]}); sample "
          f"{_grad_rel_l2(card['sample'], ref['sample']):.2e}, twice "
          f"{_grad_rel_l2(card['sample'], twice['sample']):.2e}; TF32-on "
          f"control at worst {worst_control:.3g} x its bound (must exceed 1); "
          f"CPU seconds float64 {runs['cpu', torch.float64][1]:.1f}, float32 "
          f"{runs['cpu', torch.float32][1]:.1f}; updated weights in float32 "
          f"(not held): worst card {max(weights)[0]:.3g} ({max(weights)[2]}), "
          f"CPU {max(w[1] for w in weights):.3g}")
    return holds


def phase_train_aa():
    """``[train-aa]``: adversarial noise training
    (``configs/config_ves_seg-S_AA.yml`` at full width: DynUNet, 1216²,
    batch 4, bf16 autocast, remat, the ``AT`` block) through the port's
    ``octa_tpu_torch.train.train``, with one change, written into a copy of
    the config in the run's directory: its second ``Resized`` takes
    ``label`` only, so that ``image`` stays at the background's 304² (as
    shipped the ANT noise model multiplies a 1216² image with a 304²
    background, and both packages fail). 3 epochs of 2 steps on stand-in
    data; per step the device ms of the ANT call and of the training step
    (CUDA events around each), the segmentation loss of each ascent step;
    then a step taken apart (host syncs, peak memory) and ``[aa-agree]``.
    Returns the training run's kernel counts."""
    import tempfile
    import warnings

    import numpy as np
    import torch

    from octa_tpu_torch.data.dataset import (
        collate,
        get_dataset,
        get_post_transformation,
    )
    from octa_tpu_torch.tools.seg_data import (
        keep_image_at_background_size,
        make_seg_dataset,
        point_config_at,
    )
    from octa_tpu_torch.train import train
    from octa_tpu_torch.train.algorithms import SegAlgorithm, define_model
    from octa_tpu_torch.utils.config import load_config
    from octa_tpu_torch.utils.enums import Phase
    from octa_tpu_torch.utils.metrics import MetricsManager

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        globs = make_seg_dataset(tmp, n_graphs=8, n_backgrounds=8, n_val=4,
                                 device=dev)
        cfg = point_config_at(load_config("configs/config_ves_seg-S_AA.yml"),
                              globs, os.path.join(tmp, "runs"))
        keep_image_at_background_size(cfg)
        cfg["Train"].update(epochs=TRAIN_EPOCHS, epochs_decay=1, val_interval=1)
        copy_path = os.path.join(tmp, "config_ves_seg-S_AA.json")
        with open(copy_path, "w") as f:
            json.dump(cfg, f)
        batch = cfg["Train"]["batch_size"]
        print("[train-aa] configs/config_ves_seg-S_AA.yml with one change "
              "(a copy in the run's directory): its second Resized takes "
              "label only, so image stays at the background's 304²; as "
              "shipped ANTLoss's noise model multiplies a 1216² image with a "
              "304² background and fails in both packages")
        events, steps = [], []
        adv_fn, step_fn = SegAlgorithm.adversarial_batch, SegAlgorithm.train_step

        def timed(fn, tag):
            def wrapper(self, *a, **k):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(self, *a, **k)
                end.record()
                events.append((tag, start, end, list(self.at.seg_losses)
                               if tag == "ant" else None))
                return out
            return wrapper

        SegAlgorithm.adversarial_batch = timed(adv_fn, "ant")
        SegAlgorithm.train_step = timed(step_fn, "step")
        # main path: the training run
        zero_counts()
        t0 = time.perf_counter()
        try:
            with open(copy_path) as f:
                run = train(TrainArgs(), json.load(f), device=dev,
                            on_step=lambda *a: steps.append(a))
        finally:
            SegAlgorithm.adversarial_batch = adv_fn
            SegAlgorithm.train_step = step_fn
        run_s = time.perf_counter() - t0
        counts = read_counts()
        torch.cuda.synchronize()
        ant = [(s.elapsed_time(e), [float(v) for v in losses])
               for tag, s, e, losses in events if tag == "ant"]
        step = [s.elapsed_time(e) for tag, s, e, _ in events if tag == "step"]
        with open(os.path.join(run, "metrics.csv")) as f:
            rows = list(csv.DictReader(f))
        losses = [s[2]["DiceBCELoss"] for s in steps]
        pga = [v for _, ls in ant for v in ls]
        if len(steps) != 2 * TRAIN_EPOCHS or len(ant) != len(steps) or \
                not np.all(np.isfinite(losses)) or len(pga) != 2 * len(steps) \
                or not np.all(np.isfinite(pga)):
            raise AssertionError(f"[train-aa] steps {len(steps)}, losses "
                                 f"{losses}, ascent losses {pga}")
        dsc = [float(r["Validation_DSC"]) for r in rows]
        if len(rows) != TRAIN_EPOCHS or not np.all(np.isfinite(dsc)):
            raise AssertionError(f"[train-aa] metrics.csv rows {rows}")
        loaded = counts["K1"] / (2 * batch)
        if counts["K1"] % (2 * batch) or loaded < len(steps):
            raise AssertionError(f"[train-aa] K1 launched {counts['K1']} times "
                                 f"for {len(steps)} steps of batch {batch}")
        per = [w + s for _, _, _, w, s in steps[1:]]
        steps_s = len(per) / sum(per)
        print(f"[train-aa] {TRAIN_EPOCHS} epochs, {len(steps)} steps of batch "
              f"{batch} (image 304² -> ANT sample 1216², bf16 autocast, remat) "
              f"in {run_s:.2f} s; losses " + " ".join(f"{v:.4f}" for v in losses)
              + "; segmentation loss at each ascent step " + " ".join(
                  "/".join(f"{v:.4f}" for v in ls) for _, ls in ant)
              + "; validation DSC " + " ".join(f"{v:.4f}" for v in dsc)
              + f"; after the first step {steps_s:.3f} steps/s, "
              f"{steps_s * batch:.2f} img/s (loader wait "
              f"{np.mean([s[3] for s in steps[1:]]) * 1e3:.1f} ms)")
        print(f"[train-aa] device ms a step after the first (CUDA events): "
              f"ANT call (2 gradient passes through the segmentor and the "
              f"final sample) {np.mean([a for a, _ in ant[1:]]):.2f} (each: "
              + " ".join(f"{a:.1f}" for a, _ in ant) + f"), training step "
              f"{np.mean(step[1:]):.2f} (each: "
              + " ".join(f"{v:.1f}" for v in step) + f"); K1 launches "
              f"{counts['K1']} = 2 x {batch} x {loaded:.0f} loaded batches "
              f"(the loader thread loads ahead); other kernels "
              f"{({k: v for k, v in counts.items() if k != 'K1'})}")

        # a step taken apart on a batch loaded here
        ds = get_dataset(cfg, Phase.TRAIN, device=dev).dataset
        post = get_post_transformation(cfg, Phase.TRAIN, dev)
        b = collate([ds[i] for i in range(batch)])
        model = define_model(cfg, Phase.TRAIN, dev)
        model.initialize_model_and_optimizer(b, cfg, TrainArgs())
        metrics = MetricsManager(Phase.TRAIN)
        outputs, _ = model.perform_training_step(dict(b), post)  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                outputs, _ = model.perform_training_step(dict(b), post)
                model.compute_metric(outputs, metrics)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        print(f"[train-aa] a step on a batch loaded beforehand: host syncs "
              f"{syncs} (the loss, the prediction and the label, as in the "
              f"S recipe, and none in the ANT call if 3); peak memory above "
              f"the weights {peak:.2f} GiB with remat")
        del model
        torch.cuda.empty_cache()
        # the CLI on the copy: one epoch (its first of three, as a user's
        # first run would take it)
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "octa_tpu_torch.train",
                            "--config_file", copy_path, "--epochs_per_run",
                            "1", "--Output.save_dir",
                            os.path.join(tmp, "cli")],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0 or not glob.glob(
                os.path.join(tmp, "cli", "*", "metrics.csv")):
            raise AssertionError(f"[train-aa] python -m octa_tpu_torch.train: "
                                 f"rc {r.returncode}\n{r.stdout}\n{r.stderr}")
        print(f"[train-aa] python -m octa_tpu_torch.train --config_file "
              f"<the copy> --epochs_per_run 1: one epoch in "
              f"{time.perf_counter() - t0:.1f} s (a fresh process)")
        phase_aa_agree(cfg)
    return counts


def _with_fields(pool, fields):
    """``pool`` whose ``uniform`` hands out ``fields`` in order, on the
    pool's device (``[menten]``: the same binomial noise on card and CPU)."""
    it = iter(fields)
    pool.uniform = lambda shape: next(it).to(pool.device)
    return pool


def phase_menten():
    """``[menten]``: one epoch of 2 steps of
    ``configs/config_ves_seg_menten.yml`` as shipped (DynUNet 1216², batch
    4, bf16, remat; ``MentenAugmentationd`` in the loader) on stand-in data;
    then each of the chain's three transforms on one 1216² sample on the
    card and on the CPU from one seed (the binomial noise's uniform fields
    handed to both pools, ``floater_chance`` 1): image within 1e-5, the
    motion artifact bit for bit; host ms a sample of each. Returns the
    training run's kernel counts."""
    import tempfile
    import warnings

    import numpy as np
    import torch

    from octa_tpu_torch.data import transforms as tt
    from octa_tpu_torch.tools.seg_data import make_seg_dataset, point_config_at
    from octa_tpu_torch.train import train
    from octa_tpu_torch.utils.config import load_config

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        globs = make_seg_dataset(tmp, n_graphs=8, n_backgrounds=8, n_val=4,
                                 device=dev)
        cfg = point_config_at(load_config("configs/config_ves_seg_menten.yml"),
                              globs, os.path.join(tmp, "runs"))
        cfg["Train"].update(epochs=1, epochs_decay=0)
        batch = cfg["Train"]["batch_size"]
        steps = []
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always", tt.LabelEditSkipped)
            zero_counts()  # main path: the training run
            t0 = time.perf_counter()
            run = train(TrainArgs(), json.loads(json.dumps(cfg)), device=dev,
                        on_step=lambda *a: steps.append(a))
            run_s = time.perf_counter() - t0
            counts = read_counts()
        skipped = sum(w.category is tt.LabelEditSkipped for w in caught)
        samples = counts["K1"] // 2
        with open(os.path.join(run, "metrics.csv")) as f:
            rows = list(csv.DictReader(f))
        losses = [s[2]["DiceBCELoss"] for s in steps]
        loaded = counts["K1"] / (2 * batch)
        if len(steps) != 8 // batch or not np.all(np.isfinite(losses)) or \
                len(rows) != 1 or not np.isfinite(float(rows[0]["Validation_DSC"])) \
                or counts["K1"] % (2 * batch) or loaded < len(steps):
            raise AssertionError(f"[menten] {len(steps)} steps, losses {losses}, "
                                 f"rows {rows}, K1 {counts['K1']}")
        print(f"[menten] configs/config_ves_seg_menten.yml as shipped, 1 epoch "
              f"of {len(steps)} steps of batch {batch} at 1216² in {run_s:.2f} "
              f"s: losses " + " ".join(f"{v:.4f}" for v in losses)
              + f"; validation DSC {float(rows[0]['Validation_DSC']):.4f}; "
              f"loader wait {np.mean([s[3] for s in steps]) * 1e3:.1f} ms, step "
              f"{np.mean([s[4] for s in steps]) * 1e3:.1f} ms a step; K1 "
              f"launches {counts['K1']} (2 a sample loaded); label edits "
              f"skipped where the JAX package raises: {skipped} "
              f"(LabelEditSkipped, over {samples} samples loaded)")

    rng = np.random.default_rng(21)
    r = MENTEN_RES
    image = rng.random((1, r, r)).astype(np.float32)
    label = (rng.random((1, r, r)) < 0.2).astype(np.float32)
    fields = [torch.rand(r, r, generator=torch.Generator().manual_seed(i))
              for i in (1, 2)]
    cases = (("BinomialVesselNoised",
              lambda: tt.BinomialVesselNoised(["image"]), 1e-5),
             ("AddVitreousFloater",
              lambda: tt.AddVitreousFloater(["image"], floater_chance=1.0), 1e-5),
             ("AddMotionArtifact",
              lambda: tt.AddMotionArtifact("image", "label"), 0.0))
    report = []
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False  # the blurs are convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name, make, tol in cases:
            report.append(_menten_case(name, make, tol, image, label, fields))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags
    print(f"[menten] one {r}² sample, seed 7, floater_chance 1: "
          + "; ".join(report))
    return counts


def _menten_case(name, make, tol, image, label, fields) -> str:
    """One of ``[menten]``'s transforms on the card and on the CPU."""
    import numpy as np
    import torch

    from octa_tpu_torch.data import transforms as tt

    out, ms, skips = {}, {}, {}
    for d in ("cuda", "cpu"):
        t = make()
        t.set_rng(_with_fields(tt.RngPool(7, d), fields))
        data = {"image": torch.from_numpy(image).to(d),
                "label": torch.from_numpy(label).to(d)}
        t(dict(data))  # warm
        t.set_rng(_with_fields(tt.RngPool(7, d), fields))
        if d == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = t(dict(data))
        if d == "cuda":
            torch.cuda.synchronize()
        ms[d] = (time.perf_counter() - t0) * 1e3
        skips[d] = getattr(t, "label_edits_skipped", 0)
        out[d] = {k: v.detach().cpu() if torch.is_tensor(v)
                  else torch.from_numpy(np.asarray(v))
                  for k, v in res.items()}
    err = max(float((out["cuda"][k] - out["cpu"][k]).abs().max())
              for k in out["cpu"])
    if tol == 0:
        if err != 0 or skips["cuda"] != skips["cpu"]:
            raise AssertionError(f"[menten] {name}: card and CPU differ "
                                 f"({err:.3g}, label edits skipped {skips}), "
                                 f"expected bit-equal")
    else:
        changed = float((out["cpu"]["image"]
                         - torch.from_numpy(image)).abs().max())
        if changed == 0:
            raise AssertionError(f"[menten] {name} left the image as it was")
        hold(f"menten {name} card vs CPU", err, tol)
    return (f"{name} max|card - CPU| {err:.3g} (bound "
            f"{tol if tol else 'bit-equal'}), host {ms['cuda']:.1f} ms a "
            f"sample with the card, {ms['cpu']:.1f} ms on the CPU"
            + (f", label edits skipped {skips['cuda']}"
               if hasattr(t, "label_edits_skipped") else ""))


def phase_baselines():
    """``[baselines]``: ``python -m octa_tpu_torch.validate`` on
    ``configs/config_frangi.yml`` and ``configs/config_oof.yml``
    (parameterless models, no checkpoint) on ``BASELINE_VAL`` stand-in pairs
    at 1216² as a subprocess on the card, then in process on the card and
    on the CPU with TF32 off: each metric equal within 1e-4; img/s of the
    in-process card run and the baseline's device ms on one 1216² image;
    ``test`` on the same images. Then ``skrgan`` through the registry on
    one card image: a smoke run of its host path (the result's device,
    shape and finiteness)."""
    import ast
    import tempfile

    import numpy as np
    import torch

    from octa_tpu_torch import test as ttest
    from octa_tpu_torch import validate as tval
    from octa_tpu_torch.models.registry import build_network
    from octa_tpu_torch.tools.seg_data import make_seg_dataset

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    with tempfile.TemporaryDirectory() as tmp:
        globs = make_seg_dataset(tmp, n_graphs=1, n_backgrounds=1,
                                 n_val=BASELINE_VAL, device="cuda")
        for name in ("frangi", "oof"):
            argv = ["--config_file", f"configs/config_{name}.yml",
                    "--Validation.data.image.files", globs["val_images"],
                    "--Validation.data.label.files", globs["val_labels"],
                    "--Output.save_dir", os.path.join(tmp, name)]
            r = subprocess.run([sys.executable, "-m", "octa_tpu_torch.validate",
                                *argv], capture_output=True, text=True,
                               timeout=300)
            if r.returncode != 0:
                raise AssertionError(f"[baselines] validate {name}: rc "
                                     f"{r.returncode}\n{r.stdout}\n{r.stderr}")
            shipped = ast.literal_eval(r.stdout.strip().splitlines()[-1])
            res = {}
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
            try:
                for d in ("cuda", "cpu"):
                    t0 = time.perf_counter()
                    res[d] = (tval.main(argv + ["--device", d]),
                              time.perf_counter() - t0)
            finally:
                (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32) = flags
            gap = max((abs(res["cuda"][0][k] - res["cpu"][0][k]), k)
                      for k in res["cpu"][0])
            if set(res["cuda"][0]) != set(shipped) or not all(
                    np.isfinite(v) for v in shipped.values()):
                raise AssertionError(f"[baselines] {name}: {shipped}")
            hold(f"baselines validate {name} card vs CPU metric", gap[0], 1e-4)
            run = build_network({"name": name})
            x = torch.rand(1, 1, 1216, 1216, device="cuda")
            ms = cuda_ms(lambda: run(x), reps=5)
            written = ttest.main(
                ["--config_file", f"configs/config_{name}.yml",
                 "--Test.data.image.files", globs["val_images"],
                 "--Test.save_dir", os.path.join(tmp, f"{name}_test")])
            if len(written) != BASELINE_VAL:
                raise AssertionError(f"[baselines] test {name}: {written}")
            print(f"[baselines] validate.py configs/config_{name}.yml, "
                  f"{BASELINE_VAL} stand-in pairs at 1216² (no real OCTA, no "
                  f"paper number): {json.dumps(shipped)} (a subprocess); in "
                  f"process card {BASELINE_VAL / res['cuda'][1]:.2f} img/s "
                  f"with loading and metrics, CPU "
                  f"{BASELINE_VAL / res['cpu'][1]:.2f} img/s; card against CPU "
                  f"worst {gap[1]} {gap[0]:.3g} (bound 1e-4); {name} on one "
                  f"1216² image {ms:.2f} ms device; test.py wrote "
                  f"{len(written)} predictions")
    x = torch.rand(1, 1, 304, 304, generator=torch.Generator().manual_seed(3))
    skr = build_network({"name": "skrgan"})
    t0 = time.perf_counter()
    out = skr(x.cuda())
    torch.cuda.synchronize()
    skr_s = time.perf_counter() - t0
    if out.device.type != "cuda" or tuple(out.shape) != (1, 1, 304, 304) \
            or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"[baselines] skrgan: {out.device} "
                             f"{tuple(out.shape)}, finite "
                             f"{bool(torch.isfinite(out).all())}")
    print(f"[baselines] skrgan, a smoke run of its host path (numpy and "
          f"scipy, as in the JAX package; parity with JAX is held on the "
          f"CPU by tests/test_torch_filters.py): one 304² card image in, a "
          f"finite (1, 1, 304, 304) result back on the card in {skr_s:.2f} s")


def _recon_label(dev, res: int = RECON_RES):
    """One 3D-reconstruction label as the loader makes it: a fixture graph
    voxelized by K4 at (res, res, res * 53 / 1216) (the generator's
    geometry), planes ``RECON_Z_KEEP`` as [Z, H, W], above 0.1 of its
    maximum."""
    from octa_tpu_torch.ops import raster

    graph = raster.parse_graph_csv(raster.fixture_graph_paths()[0])
    vol, _ = raster.voxelize_forest_device(
        graph, [res, res, round(res * RECON_DEPTH / RECON_RES)], device=dev)
    vol = vol.permute(2, 0, 1)[RECON_Z_KEEP[0]:RECON_Z_KEEP[1]]
    return vol > 0.1 * float(vol.max())


def _dilate3d(x):
    """The one-voxel (3x3x3) dilation of a bool volume [Z, H, W]."""
    import torch.nn.functional as F

    return F.max_pool3d(x[None, None].float(), 3, stride=1,
                        padding=1)[0, 0] > 0


def phase_skel3d():
    """``skeletonize_3d`` on the card against the CPU bit for bit on a crop
    of a generated label and its one-voxel dilation; the card's seconds on
    one full label and its dilation, with the slab and the peak memory."""
    import torch

    from octa_tpu_torch.ops import skeleton as sk

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    sk.deletable_table(dev)
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    label = _recon_label(dev)
    c = SKEL_CROP
    h0 = (label.shape[1] - c) // 2
    crop = label[:, h0:h0 + c, h0:h0 + c].contiguous()
    for name, vol in (("label", crop), ("dilated label", _dilate3d(crop))):
        t0 = time.perf_counter()
        cpu = sk.skeletonize_3d(vol.cpu())
        cpu_s = time.perf_counter() - t0
        for slab in (None, 7):
            card = sk.skeletonize_3d(vol, slab=slab)
            if not torch.equal(card.cpu(), cpu):
                raise AssertionError(f"[skel3d] {name} crop, slab {slab}: card "
                                     f"and CPU differ at "
                                     f"{int((card.cpu() != cpu).sum())} voxels")
        print(f"[skel3d] {name} crop {tuple(vol.shape)}: {int(vol.sum())} "
              f"object voxels -> {int(cpu.sum())} skeleton voxels; the card "
              f"equals the CPU bit for bit at the default slab and at 7 (the "
              f"CPU took {cpu_s:.2f} s)")
    slab = sk._default_slab(dev, *label.shape[1:])
    for name, vol in (("label", label), ("dilated label", _dilate3d(label))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = sk.skeletonize_3d(vol)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        print(f"[skel3d] full {name} {tuple(vol.shape)}: "
              f"{int(vol.sum())} object voxels "
              f"({float(vol.float().mean()) * 100:.2f} %) -> {int(out.sum())} "
              f"skeleton voxels in {dt:.3f} s on the card; slab {slab} planes; "
              f"peak memory {peak:.2f} GiB above the volume")
    print(f"[skel3d] the table of the 2^26 neighbourhood codes made in "
          f"{table_s:.3f} s (once a process)")


def phase_recon():
    """The 3D reconstruction: the generator at scale 1216 makes 10 samples
    (growth, K4 label volumes); ``configs/config_3d_recon_supervised.yml``
    with their data blocks trains 3 epochs of 2 steps at full width; one
    ``validate`` with the volumetric ClDice on 2 pairs; ``test`` with
    ``RemoveOuterNoise``. Returns the main path's kernel counts."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from octa_tpu_torch import generate_vessel_graph as gen
    from octa_tpu_torch import test as ttest
    from octa_tpu_torch import validate as tval
    from octa_tpu_torch.data.dataset import (
        collate,
        get_dataset,
        get_post_transformation,
    )
    from octa_tpu_torch.data.transforms import RemoveOuterNoise
    from octa_tpu_torch.ops import skeleton as sk
    from octa_tpu_torch.sim.configs import vessel_graph_gen
    from octa_tpu_torch.tools.seg_data import point_recon_config_at
    from octa_tpu_torch.train import train
    from octa_tpu_torch.train.algorithms import define_model
    from octa_tpu_torch.utils.config import load_config
    from octa_tpu_torch.utils.enums import Phase
    from octa_tpu_torch.utils.metrics import MetricsManager

    dev = torch.device("cuda")
    n = RECON_TRAIN + RECON_VAL
    with tempfile.TemporaryDirectory() as tmp:
        gcfg = vessel_graph_gen()
        gcfg["output"].update(directory=os.path.join(tmp, "train"),
                              image_scale_factor=RECON_RES,
                              save_3D_volumes="npy", save_2D_image=False)
        # main path: generation (growth, K4) and training (K1)
        zero_counts()
        t0 = time.perf_counter()
        timings = {}
        dirs = gen.generate(gcfg, n, seed=RECON_SEED, timings=timings,
                            device=dev, log=lambda line: None)
        gen_s = time.perf_counter() - t0
        gen_counts = read_counts()
        os.makedirs(os.path.join(tmp, "val"))
        for d in dirs[RECON_TRAIN:]:
            shutil.move(d, os.path.join(tmp, "val"))
        globs = {k: {"graphs": os.path.join(tmp, k, "*", "*.csv"),
                     "volumes": os.path.join(tmp, k, "*", "art_ven_img_gray.npy")}
                 for k in ("train", "val")}
        cfg = point_recon_config_at(
            load_config("configs/config_3d_recon_supervised.yml"),
            globs["train"], globs["val"], os.path.join(tmp, "runs"),
            res=RECON_RES, z_keep=RECON_Z_KEEP)
        cfg["Train"]["val_interval"] = 1000  # validate.py runs once below
        batch = cfg["Train"]["batch_size"]

        class FirstEpochs(TrainArgs):  # of the config's 30: its schedule
            epochs_per_run = RECON_EPOCHS
        steps = []
        t0 = time.perf_counter()
        run = train(FirstEpochs(), json.loads(json.dumps(cfg)), device=dev,
                    on_step=lambda *a: steps.append(a))
        run_s = time.perf_counter() - t0
        counts = read_counts()
        losses = [s[2]["DiceBCELoss"] for s in steps]
        if len(steps) != 2 * RECON_EPOCHS or not np.all(np.isfinite(losses)):
            raise AssertionError(f"[3d-recon] steps {len(steps)}, losses {losses}")
        k1 = counts["K1"] - gen_counts["K1"]
        if gen_counts["K4"] != 2 * n or k1 % batch or k1 < len(steps) * batch:
            raise AssertionError(f"[3d-recon] launches {counts} (generation "
                                 f"{gen_counts}): expected K4 {2 * n} in "
                                 f"generation, K1 once a sample loaded")
        per = [w + s for _, _, _, w, s in steps[1:]]
        steps_s = len(per) / sum(per)
        shape = np.load(os.path.join(dirs[0], "art_ven_img_gray.npy"),
                        mmap_mode="r").shape
        print(f"[3d-recon] generate() {n} samples at scale {RECON_RES} "
              f"({shape} uint8 volumes, K4) in {gen_s:.2f} s (grow "
              f"{timings['grow']:.2f}, voxelize {timings['voxelize']:.3f}, write "
              f"{timings['write']:.2f}); {RECON_TRAIN} to train, {RECON_VAL} to "
              f"validate")
        print(f"[3d-recon] config_3d_recon_supervised.yml (DynUNet 2D, "
              f"{cfg['General']['model']['out_channels']} output planes, "
              f"{list(RECON_Z_KEEP)} of {shape[2]}, {RECON_RES}², batch "
              f"{batch}, bf16, remat), data blocks of tests/test_3d_recon.py: "
              f"{RECON_EPOCHS} epochs, {len(steps)} steps in {run_s:.2f} s; "
              f"losses " + " ".join(f"{v:.4f}" for v in losses)
              + f"; after the first step {steps_s:.3f} steps/s, "
              f"{steps_s * batch:.2f} img/s (loader wait "
              f"{np.mean([s[3] for s in steps[1:]]) * 1e3:.1f} ms, step "
              f"{np.mean([s[4] for s in steps[1:]]) * 1e3:.1f} ms a step); "
              f"launches: generation {gen_counts}, training K1 {k1} (one a "
              f"sample loaded)")

        # a step taken apart, on a batch loaded on the main stream
        ds = get_dataset(cfg, Phase.TRAIN, device=dev).dataset
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = collate([ds[i] for i in range(batch)])
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        post = get_post_transformation(cfg, Phase.TRAIN, dev)
        model = define_model(cfg, Phase.TRAIN, dev)
        model.initialize_model_and_optimizer(b, cfg, TrainArgs())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        split = train_step_split(model, b, post, MetricsManager(Phase.TRAIN))
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        del model
        torch.cuda.empty_cache()
        print(f"[3d-recon] a step at batch {batch}: loading a batch "
              f"{load_ms:.1f} ms host (a {shape} volume read as float32 and "
              f"K1 once a sample); "
              f"forward+backward+Adam {split['step_ms']:.2f} ms device; "
              f"post-processing and metric {split['post_ms']:.1f} ms host; "
              f"host syncs a step {split['syncs']}; peak memory above the "
              f"weights {peak:.2f} GiB")
        if split["syncs"] != 3:
            raise AssertionError(f"[3d-recon] {split['syncs']} host syncs a "
                                 "step, expected 3 (loss, prediction, label)")

        # validate once: the volumetric ClDice of each pair
        t0 = time.perf_counter()
        metrics = tval.main(["--config_file", os.path.join(run, "config.yml"),
                             "--epoch", "latest", "--device", dev.type])
        val_s = time.perf_counter() - t0
        if not np.isfinite(metrics.get("Validation_ClDice", np.nan)):
            raise AssertionError(f"[3d-recon] validate.py: {metrics}")
        vds = get_dataset(cfg, Phase.VALIDATION, device=dev).dataset
        vpost = get_post_transformation(cfg, Phase.VALIDATION, dev)
        model = define_model(cfg, Phase.VALIDATION, dev)

        class Latest(TrainArgs):
            epoch = "latest"
        c = json.loads(json.dumps(cfg))
        c["Output"]["save_dir"] = run
        vb = collate([vds[0]])
        model.initialize_model_and_optimizer(vb, c, Latest(),
                                             phase=Phase.VALIDATION)
        out, _ = model.inference(vb, vpost, phase=Phase.VALIDATION)
        pred = torch.from_numpy(np.asarray(out["prediction"][0]) > 0).to(dev)
        lab = torch.as_tensor(np.asarray(out["label"][0]) > 0, device=dev)
        skel_s = {}
        for name, vol in (("prediction", pred), ("label", lab)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sk.skeletonize_3d(vol)
            torch.cuda.synchronize()
            skel_s[name] = (time.perf_counter() - t0,
                            float(vol.float().mean()) * 100)
        del model
        print(f"[3d-recon] validate.py --epoch latest ({RECON_VAL} pairs, "
              f"volumetric ClDice): {json.dumps(metrics)} in {val_s:.1f} s; "
              f"skeletonize_3d of the first pair's thresholded prediction "
              f"{skel_s['prediction'][0]:.3f} s ({skel_s['prediction'][1]:.2f} "
              f"% object), of its label {skel_s['label'][0]:.3f} s "
              f"({skel_s['label'][1]:.2f} %)")

        # test: RemoveOuterNoise on each prediction, .npy and PNG written
        out_dir = os.path.join(tmp, "test")
        t0 = time.perf_counter()
        written = ttest.main(["--config_file", os.path.join(run, "config.yml"),
                              "--epoch", "latest", "--device", dev.type,
                              "--Test.save_dir", out_dir])
        test_s = time.perf_counter() - t0
        if len(written) != RECON_VAL:
            raise AssertionError(f"[3d-recon] test.py wrote {written}")
        planes = RECON_Z_KEEP[1] - RECON_Z_KEEP[0]
        for png in written:
            vol = np.load(png + ".npy")
            if vol.shape != (planes, RECON_RES, RECON_RES) or not np.array_equal(
                    RemoveOuterNoise(z_axis=0)(vol), vol > 0):
                raise AssertionError(f"[3d-recon] {png}.npy: shape {vol.shape}"
                                     f" or components off the central plane")
        print(f"[3d-recon] test.py --epoch latest with RemoveOuterNoise: "
              f"{len(written)} volumes {vol.shape} and their PNGs in "
              f"{test_s:.1f} s; each volume's components all touch its "
              f"central plane")
    return counts


def _cycle_state_twin(model, seed: int):
    """A deep copy of a CycleGAN trainer with fresh pools (as a trainer
    resumed from checkpoints has: the pools are not saved)."""
    import copy

    from octa_tpu_torch.train.gan_algorithms import ImagePool

    twin = copy.deepcopy(model)
    twin.fake_A_pool = ImagePool(model.fake_A_pool.pool_size, seed)
    twin.fake_B_pool = ImagePool(model.fake_B_pool.pool_size, seed + 1)
    return twin


def phase_cycle_gan():
    """CycleGAN (``configs/config_cycle_gan.yml`` at full width) through
    the port's ``octa_tpu_torch.train.train`` on stand-in data; the G and D
    steps taken apart; the pool's choices on the card replayed on the host;
    one step after a resume from the written checkpoints; ``test`` with
    ``netG_A``; then ``[cycle-gan-agree]``. Returns the kernel counts of
    the training run and of the test run."""
    import tempfile

    import numpy as np
    import torch

    from octa_tpu_torch import test as ttest
    from octa_tpu_torch.data.dataset import collate, get_dataset
    from octa_tpu_torch.io.visualizer import Visualizer
    from octa_tpu_torch.tools.seg_data import make_seg_dataset, point_config_at
    from octa_tpu_torch.train import train
    from octa_tpu_torch.train.engine import save_latest_checkpoints
    from octa_tpu_torch.train.gan_algorithms import ImagePool
    from octa_tpu_torch.utils.config import load_config
    from octa_tpu_torch.utils.enums import Phase

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        globs = make_seg_dataset(tmp, n_graphs=8, n_backgrounds=8, n_val=0,
                                 n_real_b=8, device=dev)
        cfg = point_config_at(load_config("configs/config_cycle_gan.yml"),
                              globs, os.path.join(tmp, "runs"))
        batch = cfg["Train"]["batch_size"]
        seed = cfg["General"]["seed"]

        class FirstEpochs(TrainArgs):  # of the config's 100: its schedule
            epochs_per_run = GAN_EPOCHS
        steps = []
        # main path: the training run
        zero_counts()
        t0 = time.perf_counter()
        run = train(FirstEpochs(), json.loads(json.dumps(cfg)), device=dev,
                    on_step=lambda *a: steps.append(a))
        run_s = time.perf_counter() - t0
        train_counts = read_counts()
        losses = {k: [s[2][k] for s in steps] for k in steps[0][2]}
        if len(steps) != 2 * GAN_EPOCHS or not all(
                np.all(np.isfinite(v)) for v in losses.values()):
            raise AssertionError(f"[cycle-gan] steps {len(steps)}, losses {losses}")
        cks = set(os.listdir(os.path.join(run, "checkpoints")))
        six = {f"latest_net{n}_model.ckpt" for n in ("G_A", "G_B", "D_A", "D_B")} \
            | {"latest_optimizer_G.ckpt", "latest_optimizer_D.ckpt"}
        if not six <= cks:
            raise AssertionError(f"[cycle-gan] checkpoints {sorted(cks)}")
        k1 = train_counts["K1"]
        if k1 % batch or k1 < len(steps) * batch:
            raise AssertionError(f"[cycle-gan] K1 launched {k1} times for "
                                 f"{len(steps)} steps of batch {batch}")
        per = [w + s for _, _, _, w, s in steps[1:]]
        steps_s = len(per) / sum(per)
        print(f"[cycle-gan] config_cycle_gan.yml (two resnetGenerator9, two "
              f"patchGAN70x70, 304², batch {batch}, bf16), its first "
              f"{GAN_EPOCHS} of 100 epochs, {len(steps)} steps in {run_s:.2f} s "
              f"on stand-in data (8 graphs, 8 backgrounds, 8 noise-model "
              f"renders as real_B; no real OCTA); losses " + "; ".join(
                  f"{k} " + " ".join(f"{v:.4f}" for v in vs)
                  for k, vs in losses.items())
              + f"; after the first step {steps_s:.3f} steps/s, "
              f"{steps_s * batch:.2f} img/s (loader wait "
              f"{np.mean([s[3] for s in steps[1:]]) * 1e3:.1f} ms, step "
              f"{np.mean([s[4] for s in steps[1:]]) * 1e3:.1f} ms a step); K1 "
              f"launches {k1} (one a sample loaded); the six checkpoints "
              f"written")

        # the written checkpoints, restored: equal to the saved state bit
        # for bit; one step after the restore against the same step of a
        # copy of the saved state, within 8 x two copies' difference
        ds = get_dataset(cfg, Phase.TRAIN, device=dev).dataset
        b1 = collate([ds[i] for i in range(batch)])
        x = [b1[k].to(dev, torch.float32)
             for k in ("real_A", "real_B", "background")]
        u = torch.rand(x[0].shape, device=dev,
                       generator=torch.Generator(dev).manual_seed(5))
        model = _resumed(cfg, run, GAN_EPOCHS, dev)
        c = json.loads(json.dumps(cfg))
        c["Output"]["save_dir"] = os.path.join(tmp, "resume")
        vis = Visualizer(c)
        save_latest_checkpoints(vis, model, GAN_EPOCHS, cfg)
        restored = _resumed(cfg, vis.save_dir, GAN_EPOCHS, dev)
        if not _gan_state_equal(restored, model):
            raise AssertionError("[cycle-gan] the restored state differs "
                                 "from the saved one")
        twin, twin2 = (_cycle_state_twin(model, seed) for _ in range(2))
        before = _gan_params(model)
        out = {}
        for tag, m in (("restored", restored), ("twin", twin),
                       ("twin2", twin2)):
            _, ls = m.train_step(*x, u)
            out[tag] = ({k: float(v) for k, v in ls.items()}, _gan_params(m))

        def apart(tag, ref="twin"):
            (la, pa), (lb, pb) = out[tag], out[ref]
            dp = max(float((pa[k] - pb[k]).norm() / (pb[k] - before[k]).norm())
                     for k in pb)
            dl = max(abs(la[k] - lb[k]) / max(abs(lb[k]), 1e-6) for k in lb)
            return dp, dl

        (dp_res, dl_res), (dp_twin, dl_twin) = apart("restored"), apart("twin2")
        bound_p = max(RESUME_FLOOR, RESUME_FACTOR * dp_twin)
        bound_l = max(RESUME_LOSS_FLOOR, RESUME_FACTOR * dl_twin)
        print(f"[cycle-gan] resumed from the run's checkpoints, written again "
              f"and read back: parameters and both Adam states equal the saved "
              f"ones bit for bit; one step after the restore against the same "
              f"step of a copy of the saved state: parameters {dp_res:.3g} "
              f"apart relative to the step's update (bound {bound_p:.3g}), "
              f"losses {dl_res:.3g} (bound {bound_l:.3g}); two copies "
              f"{dp_twin:.3g} and {dl_twin:.3g}")
        hold("cycle-gan resumed step: parameters", dp_res, bound_p)
        hold("cycle-gan resumed step: losses", dl_res, bound_l)
        del restored, twin, twin2, out

        # the G step and the D step taken apart, peak memory
        model.train_step(*x, u)  # warm-up
        reps, g_ms, d_ms = 3, 0.0, 0.0
        for _ in range(reps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            (fake_B, fake_A, _, _), _ = model.g_step(*x, u)
            ev[1].record()
            model.d_step(x[0], x[1], model.fake_A_pool.query(fake_A),
                         model.fake_B_pool.query(fake_B))
            ev[2].record()
            torch.cuda.synchronize()
            g_ms += ev[0].elapsed_time(ev[1]) / reps
            d_ms += ev[1].elapsed_time(ev[2]) / reps
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        model.train_step(*x, u)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        print(f"[cycle-gan] a step at batch {batch}, 304², bf16: G step "
              f"{g_ms:.2f} ms, D step with the pools {d_ms:.2f} ms device "
              f"(CUDA events, mean of {reps}); peak memory above the weights "
              f"{peak:.2f} GiB")

        # the pool's choices on the card, replayed on the host from the same
        # random.Random stream
        fakes = [model.g_step(*x, u)[0][0] for _ in range(3)]
        pools = ImagePool(CYCLE_POOL, seed), ImagePool(CYCLE_POOL, seed)
        replays = 0
        for f in fakes:
            card = pools[0].query(f)
            host = pools[1].query(f.cpu())
            if not torch.equal(card.cpu(), host):
                raise AssertionError("[cycle-gan] the pool's choices on the "
                                     "card differ from the host's")
            replays += sum(not torch.equal(card[i], f[i]) for i in range(batch))
        print(f"[cycle-gan] ImagePool({CYCLE_POOL}, seed {seed}) on the card "
              f"against the same pool on the host, {len(fakes)} batches: the "
              f"same images, {replays} of them replayed from the pool")
        del model, fakes

        # test.py with netG_A: the graphs translated
        zero_counts()
        t0 = time.perf_counter()
        written = ttest.main(["--config_file", os.path.join(run, "config.yml"),
                              "--epoch", "latest", "--device", dev.type,
                              "--Test.save_dir", os.path.join(tmp, "test")])
        test_s = time.perf_counter() - t0
        test_counts = read_counts()
        if len(written) != 8 or not all(
                os.path.basename(p).startswith("netG_A_") for p in written) \
                or test_counts["K1"] < len(written):
            raise AssertionError(f"[cycle-gan] test.py wrote {written}, K1 "
                                 f"{test_counts['K1']}")
        print(f"[cycle-gan] test.py --epoch latest (General.inference "
              f"netG_A): {len(written)} translations in {test_s:.2f} s with "
              f"model loading; K1 launches {test_counts['K1']}")
        phase_cycle_gan_agree(cfg, b1)
    return train_counts, test_counts


def phase_cycle_gan_agree(cfg, batch):
    """One CycleGAN step (G step, pools, D step) on the card against the
    same step on the CPU, from the same weights and draws, full-width
    networks at ``GAN_AGREE_IN``², batch 1 (central crops of the loaded
    batch's first sample): float64 on both (losses within 1e-6 relative,
    every gradient within 1e-6 relative L2), and float32 with TF32 off and
    cuDNN's deterministic algorithms against the CPU's float64, with the
    bounds of ``[gan-seg-agree]``: a gradient tensor that the CPU's float32
    step gives within 1e-4 within ``GAN_AGREE_WELL``, the others together
    within ``GAN_AGREE_TOGETHER`` and each within ``GAN_AGREE_EACH`` times
    the CPU float32's own distance; conv biases that an instance norm
    follows within 1e-9 / 1e-3 of their weights' gradient norm. A control
    step in float32 with TF32 on must fail the together bound (it read
    51.9 x the CPU float32's distance against 3.08 x with TF32 off at
    128², on one NVIDIA H100 80GB HBM3 at 700 W)."""
    import torch

    from octa_tpu_torch.train.algorithms import define_model
    from octa_tpu_torch.utils.enums import Phase

    c = json.loads(json.dumps(cfg))
    c["General"]["amp"] = False
    x = [_central(batch[k][:1].float(), GAN_AGREE_IN)
         for k in ("real_A", "real_B", "background")]
    x.append(torch.rand(x[0].shape, generator=torch.Generator().manual_seed(3)))
    runs = {}
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.deterministic)
    try:
        for dev, dtype, tf32 in (
                ("cpu", torch.float64, False), ("cpu", torch.float32, False),
                ("cuda", torch.float64, False), ("cuda", torch.float32, False),
                ("cuda", torch.float32, True)):
            torch.backends.cudnn.allow_tf32 = tf32
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.deterministic = not tf32
            model = define_model(c, Phase.TRAIN, dev)
            for net in model.networks.values():
                net.to(dtype)
            model.initialize_model_and_optimizer(None, c, TrainArgs())
            t0 = time.perf_counter()
            _, ls = model.train_step(*(t.to(dev, dtype) for t in x))
            grads = {f"{n}.{k}": p.grad.detach().cpu().double()
                     for n, net in model.networks.items()
                     for k, p in net.named_parameters()}
            runs[dev, dtype, tf32] = ({k: float(v) for k, v in ls.items()},
                                      grads, time.perf_counter() - t0)
            del model
    finally:
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = flags
    ref_loss, ref, ref_s = runs["cpu", torch.float64, False]
    cpu32_grads = runs["cpu", torch.float32, False][1]
    zero = sorted(n for n in ref if _zero_gradient_bias(
        ("generator." if n.startswith("netG") else "discriminator.")
        + n.split(".", 1)[1]))
    rest = [n for n in ref if n not in zero]
    cpu32 = {n: _grad_rel_l2(cpu32_grads[n], ref[n]) for n in rest}
    ill = [n for n in rest if cpu32[n] > AGREE_ILL_CONDITIONED]
    cpu_num = sum(float((cpu32_grads[n] - ref[n]).norm() ** 2)
                  for n in ill) ** 0.5

    def bias_ratio(grads):
        return max(float(grads[n].norm() / grads[n[:-4] + "weight"].norm())
                   for n in zero)

    def together(grads):
        return sum(float((grads[n] - ref[n]).norm() ** 2)
                   for n in ill) ** 0.5 / max(cpu_num, 1e-300)

    for dtype in (torch.float64, torch.float32):
        loss, grads, card_s = runs["cuda", dtype, False]
        tag = f"cycle-gan-agree {str(dtype)[6:]}"
        rel_loss = max(abs(loss[k] - ref_loss[k]) / abs(ref_loss[k])
                       for k in ref_loss if ref_loss[k] != 0)
        err = {n: _grad_rel_l2(grads[n], ref[n]) for n in rest}
        held = ill if dtype == torch.float32 else []
        tol, b_tol = ((1e-6, 1e-9) if dtype == torch.float64
                      else (GAN_AGREE_WELL, 1e-3))
        worst = max((e, n) for n, e in err.items() if n not in held)
        line = (f"[cycle-gan-agree] card {str(dtype)[6:]} CycleGAN step against "
                f"the CPU's float64 ({GAN_AGREE_IN}², batch 1): losses worst "
                f"rel {rel_loss:.3g}; gradients of {len(rest) - len(held)} "
                f"tensors: worst rel L2 {worst[0]:.3g} ({worst[1]}, bound "
                f"{tol:g}); {len(zero)} zero-gradient biases at most "
                f"{bias_ratio(grads):.3g} of their weights' gradient norm "
                f"(bound {b_tol:g}; the CPU float32's "
                f"{bias_ratio(cpu32_grads):.3g})")
        hold(f"{tag} loss rel", rel_loss, 1e-6 if dtype == torch.float64 else 1e-4)
        hold(f"{tag} gradient rel L2", worst[0], tol)
        hold(f"{tag} zero-gradient bias / weight gradient", bias_ratio(grads),
             b_tol)
        if held:
            each = max((err[n] / cpu32[n], n) for n in held)
            line += (f"; the {len(held)} tensors the CPU's float32 gives no "
                     f"closer than {AGREE_ILL_CONDITIONED:g}: together "
                     f"{together(grads):.3g} x the CPU float32's distance "
                     f"(bound {GAN_AGREE_TOGETHER:g}), each at most "
                     f"{each[0]:.3g} x ({each[1]}, bound {GAN_AGREE_EACH:g})")
            hold(f"{tag} gradients together / CPU float32's", together(grads),
                 GAN_AGREE_TOGETHER)
            hold(f"{tag} gradient / CPU float32's", each[0], GAN_AGREE_EACH)
        print(line)
    tf32 = runs["cuda", torch.float32, True][1]
    print(f"[cycle-gan-agree] control: the card's float32 step with TF32 on "
          f"(cuDNN's default) is {together(tf32):.3g} x the CPU float32's "
          f"distance together (the together bound {GAN_AGREE_TOGETHER:g} "
          f"must reject it), worst tensor "
          f"{max(_grad_rel_l2(tf32[n], ref[n]) for n in rest):.3g} rel L2; "
          f"the CPU steps took {ref_s:.1f} s (float64) "
          f"and {runs['cpu', torch.float32, False][2]:.1f} s (float32); "
          f"{len(ill)} of {len(rest)} gradient tensors the CPU's float32 gives "
          f"no closer than {AGREE_ILL_CONDITIONED:g}")
    hold("cycle-gan-agree TF32 control: together bound / its reading",
         GAN_AGREE_TOGETHER / together(tf32), 1.0)


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


def partial_reads() -> int:
    """Kernel times read so far from a profiler window that missed some of
    the kernel's launches (``time_kernels._launches``): a case whose count
    grows while it is timed is marked ``"partial"`` in the kernels line."""
    from octa_tpu_torch.tools.time_kernels import WINDOWS

    return WINDOWS["partial"]


def print_windows() -> None:
    """How many ``torch.profiler`` windows the device times took, and how
    many of them were taken again because the profiler had dropped events
    (``time_kernels._launches``, which reads each kernel from a window that
    held whole calls of it, or, for a kernel launched once a call, from the
    launches the fullest window held, and raises otherwise)."""
    from octa_tpu_torch.tools.time_kernels import WINDOWS

    print(f"[profiler] {WINDOWS['taken']} windows taken for device times, "
          f"{WINDOWS['retaken']} of them again after dropped events, "
          f"{WINDOWS['partial']} kernel times read from a window with some "
          f"of the kernel's launches missing")


def run_phase(name: str, phase, *args):
    """Run one phase; a failure prints ``[fail] <phase>: <exception>`` on
    stdout and is raised again, so the run exits 1."""
    try:
        return phase(*args)
    except BaseException as exc:
        print(f"[fail] {name}: {type(exc).__name__}: {exc}", flush=True)
        raise


def main() -> int:
    import gc

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from octa_tpu_torch.ops import raster

    t0 = time.perf_counter()

    def lap(name):
        print(f"[time] {name} done at {time.perf_counter() - t0:.1f} s")

    run_phase("device", phase_device)
    run_phase("build", phase_build)
    lap("build")
    only = set(sys.argv[1:])
    if only:  # a partial run for fault finding: the named phases only
        for name, phase in (
                ("k1", phase_k1), ("k2", phase_k2), ("k3", phase_k3),
                ("k4", phase_k4), ("k5", phase_k5),
                ("iter", phase_iter), ("iter-banded", lambda: phase_iter(True)),
                ("grow", phase_grow), ("grow-banded", phase_grow_banded),
                ("gen", phase_gen), ("train", phase_train),
                ("gan-seg", phase_gan_seg), ("eval", phase_eval),
                ("train-aa", phase_train_aa), ("aa-agree", phase_aa_agree),
                ("aa-spread", lambda: phase_aa_agree(seeds=AA_SPREAD_SEEDS)),
                ("menten", phase_menten), ("baselines", phase_baselines),
                ("skel3d", phase_skel3d), ("3d-recon", phase_recon),
                ("cycle-gan", phase_cycle_gan), ("cards", phase_cards)):
            if name in only:
                run_phase(name, phase)
                lap(name)
        print_windows()
        print_checks()
        print(f"partial run ({sorted(only)}): no result line")
        return 0
    samples = [raster.parse_graph_csv(p) for p in raster.fixture_graph_paths()]
    if len(samples) != 4:
        raise RuntimeError("expected the four fixture graphs")
    rows = run_phase("k1", phase_k1)
    lap("k1")
    run_phase("agree", phase_agree, samples)
    # main path 1: adapt and segment
    launches, pipe, fixture_dice, run_pipeline = run_phase(
        "pipeline", phase_pipeline, samples)
    lap("agree, pipeline")
    k2_rows = run_phase("k2", phase_k2)
    k3_rows = run_phase("k3", phase_k3)
    lap("k2, k3")
    k4_rows = run_phase("k4", phase_k4)
    k5_rows = run_phase("k5", phase_k5)
    run_phase("profile", profile_pipeline, run_pipeline)
    lap("k4, k5, pipeline profile")
    run_phase("iter", phase_iter)
    run_phase("iter-banded", phase_iter, True)
    lap("iter, iter-banded")
    # main path 2: grow (its second run) -> e2e
    state, grow_s, _ = run_phase("grow", phase_grow)
    run_phase("e2e", phase_e2e, state, grow_s, pipe, fixture_dice)
    grow_counts = read_counts()
    lap("grow, e2e")
    # main path 3: banded growth (its second run)
    banded_counts, _ = run_phase("grow-banded", phase_grow_banded, state)
    lap("grow-banded")
    # main path 4: the dataset generator
    gen_counts, _ = run_phase("gen", phase_gen)
    lap("gen")
    # main path 5: segmentation training
    train_counts = run_phase("train", phase_train)
    lap("train")
    # the earlier paths' tensors go before the GAN-seg step takes the card
    del pipe, run_pipeline, state
    gc.collect()
    torch.cuda.empty_cache()
    # main path 6: GAN-seg training
    gan_counts = run_phase("gan-seg", phase_gan_seg)
    lap("gan-seg, gan-seg-agree")
    # main paths 7 and 8: test.py, and training with translation
    test_counts, s_gan_counts = run_phase("eval", phase_eval)
    lap("eval")
    gc.collect()
    torch.cuda.empty_cache()
    # main path 9: adversarial noise training (S_AA)
    aa_counts = run_phase("train-aa", phase_train_aa)
    lap("train-aa, aa-agree")
    # main path 10: the Menten augmentation chain
    menten_counts = run_phase("menten", phase_menten)
    lap("menten")
    run_phase("baselines", phase_baselines)
    lap("baselines")
    gc.collect()
    torch.cuda.empty_cache()
    run_phase("skel3d", phase_skel3d)
    lap("skel3d")
    # main path 11: the 3D reconstruction (generation, training)
    recon_counts = run_phase("3d-recon", phase_recon)
    lap("3d-recon")
    gc.collect()
    torch.cuda.empty_cache()
    # main paths 12 and 13: CycleGAN training, and test.py with netG_A
    cycle_counts, cycle_test_counts = run_phase("cycle-gan", phase_cycle_gan)
    lap("cycle-gan, cycle-gan-agree")

    def by_path(tag):
        paths = {"adapt_segment": launches if tag == "K1" else 0,
                 "grow_e2e": grow_counts[tag], "grow_banded": banded_counts[tag],
                 "generate": gen_counts[tag], "train": train_counts[tag],
                 "gan_seg": gan_counts[tag], "test_cli": test_counts[tag],
                 "s_gan_train": s_gan_counts[tag], "train_aa": aa_counts[tag],
                 "menten": menten_counts[tag], "recon_3d": recon_counts[tag],
                 "cycle_gan": cycle_counts[tag],
                 "cycle_test": cycle_test_counts[tag]}
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
        "partial": any(r["partial"] for r in main_rows),
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
        "partial": any(r["partial"] for r in k2_main),
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
        "partial": k3_rows[0]["partial"] or k3_rows[1]["partial"],
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
        "partial": any(r["partial"] for r in k4_main),
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
        "partial": any(r["partial"] for r in k5_main),
        "cases": k5_rows,
    }]
    print_windows()
    missing = [k["name"] for k in kernels if k["launches"] < 1]
    if missing:
        print(f"[fail] kernels: no main path launched {missing}")
        raise AssertionError(f"no main path launched {missing}")
    print_checks()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
