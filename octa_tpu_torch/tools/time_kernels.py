"""Time K1 (2D line splat), K2 (masked nearest), K3 (segment sum), K4 (3D
capsule voxelizer), K5 (banded nearest) and K6 (candidate spacing) on the
card at their main paths' call shapes.

Usage, from the root of a checkout::

    python3 octa_tpu_torch/tools/time_kernels.py [ROOT]
        [--only k1|k2|k3|k4|k5|k6|launch] [--sass DIR]

``ROOT`` is a directory that holds an ``octa_tpu_torch`` package (default:
this checkout). To compare two versions of the package (a change of a
kernel's design against its undoing: the earlier version from git history),
unpack the other one into a directory of its own and run both in turns in
one go on one card (other, this, this, other).

Prints the card's name and power limit, then one line per case: the device
time of a call's kernels (``torch.profiler``, mean of 10 calls; each kernel's
beside it where a call runs more than one), the time of
a call (CUDA events, mean of 20 calls after 3: the host's share included
where it is the larger) and a digest of the output
(SHA-256 of its bytes, so that two versions can be shown to compute the same
bits). The cases are K1's calls on the four fixture graphs (the pipeline's
304² ``k_max`` 4096 and 1216² ``k_max`` 512 at batch 4, a forced overflow
at 1216² ``k_max`` 64, and generation's one tree at 1216² ``k_max`` 16384),
the four K2 calls of a growth iteration at batch 8 and
full capacity with random masks, the same four with the masks of a late
growth iteration (node arrays valid on a prefix, dead sink slots, a
new-node window that holds a few nodes), K3's two shapes with random,
skewed and tree-shaped ids, K4's four shapes (the arterial and the venous
tree of the first fixture graph at (1216, 1216, 53), generation's calls, and
the whole graph at (304, 304, 14) and, with ``ignore_z``, at (76, 76, 4)) in
the float32 store and in the renderer's uint8 store (for a package whose K4
has only the float store, that store and the renderer's quantising
expression after it), K5's three calls of a banded iteration on
y-sorted and unsorted points (K2's time on the same inputs follows each K5
line), and K6's calls of a growth iteration at batch 32 and 8 and of the
generator (2000 candidates a row; the plain version's time follows each). ``launch`` times, on the host, what every wrapper
does around its launch to find the device and the stream: the device guard
and ``Stream`` object that the wrappers once took, against
``ops/_cuda.py``'s ``on_device`` and ``stream_handle``. ``--sass DIR`` writes ``cuobjdump -sass`` of
the built K2 and K3 libraries into ``DIR``.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import os
import re
import shutil
import subprocess
import sys

GROW_BATCH, NODE_CAP, SINK_CAP, N_CAND = 8, 16384, 32768, 2000
# a late DVC iteration: staged capacities, ~6,800 nodes a tree, sinks with
# dead slots, a few new nodes in the 1,024-slot window
LATE_CAP, LATE_SCAP, LATE_NODES, LATE_SINKS, LATE_NEW = 12288, 20480, 6800, 16000, 64


def k2_cases(dev):
    """[(tag, query, points, masks, want_idx, main)]: the four calls of an
    iteration with random masks (a row with no valid point and a row of
    duplicated points in each), the two-mask case, and the four calls with
    growth-shaped masks."""
    import torch

    b, sq = GROW_BATCH, SINK_CAP + N_CAND
    lsq = LATE_SCAP + N_CAND
    shapes = [("sinks+cand -> nodes", 3 * b, sq, NODE_CAP, 1, True, True),
              ("cand -> art nodes", b, N_CAND, NODE_CAP, 1, True, True),
              ("cand -> oxy sinks", b, N_CAND, SINK_CAP, 1, False, True),
              ("sinks+cand -> new nodes", 2 * b, sq, 1024, 1, False, True),
              ("two masks", 3, 300, 520, 2, True, False)]
    cases = []
    for ci, (tag, r, qn, n, m, want_idx, main) in enumerate(shapes):
        g = torch.Generator(dev).manual_seed(100 + ci)
        q = torch.rand((r, qn, 3), generator=g, device=dev)
        p = torch.rand((r, n, 3), generator=g, device=dev)
        masks = torch.rand((r, m, n), generator=g, device=dev) < 0.6
        masks[0] = False                      # a row with no valid point
        half = n // 2
        p[1, half:2 * half] = p[1, :half]     # a row of duplicates: ties
        cases.append((tag, q, p, masks, want_idx, main))

    def prefix(g, r, n, mean, spread):  # [R, N]: valid on a prefix per row
        lens = mean + torch.randint(-spread, spread + 1, (r, 1), generator=g,
                                    device=dev)
        return torch.arange(n, device=dev) < lens

    late = [("sinks+cand -> nodes, growth masks", 3 * b, lsq, LATE_CAP, True),
            ("cand -> art nodes, growth masks", b, N_CAND, LATE_CAP, True),
            ("cand -> oxy sinks, growth masks", b, N_CAND, LATE_SCAP, False),
            ("sinks+cand -> new nodes, growth masks", 2 * b, lsq, 1024, False)]
    for ci, (tag, r, qn, n, want_idx) in enumerate(late):
        g = torch.Generator(dev).manual_seed(400 + ci)
        q = torch.rand((r, qn, 3), generator=g, device=dev)
        p = torch.rand((r, n, 3), generator=g, device=dev)
        if ci == 0:    # active nodes: existing, fewer than two children
            mask = prefix(g, r, n, LATE_NODES, 800) & (
                torch.rand((r, n), generator=g, device=dev) < 0.75)
        elif ci == 1:  # existing arterial nodes
            mask = prefix(g, r, n, LATE_NODES, 800)
        elif ci == 2:  # alive oxygen sinks: about 40 % of the used slots dead
            mask = prefix(g, r, n, LATE_SINKS, 2000) & (
                torch.rand((r, n), generator=g, device=dev) >= 0.4)
        else:          # this iteration's new nodes at the head of the window
            mask = prefix(g, r, n, LATE_NEW, 48)
        cases.append((tag, q, p, mask[:, None], want_idx, False))
    return cases


def k3_cases(dev):
    """[(tag, seg, feats, nc, main)]: the attraction sums (F = 18) and the
    Murray sweep (F = 1) with random ids, about 40 % on the drop sentinel;
    the attraction sums with one node taking 6,000 of a row's sources and
    with int64 ids; the sweep with a tree's parent ids (at most two
    children a node, the roots and the empty tail on the sentinel)."""
    import torch

    r, sq, nc = 2 * GROW_BATCH, SINK_CAP + N_CAND, NODE_CAP
    cases = []
    for ci, (tag, f, n) in enumerate([("attraction sums", 18, sq),
                                      ("murray sweep", 1, nc)]):
        g = torch.Generator(dev).manual_seed(200 + ci)
        seg = torch.randint(0, nc, (r, n), generator=g, device=dev,
                            dtype=torch.int32)
        drop = torch.rand((r, n), generator=g, device=dev) < 0.4
        seg = torch.where(drop, nc, seg).to(torch.int32)
        feats = torch.randn((r, n, f), generator=g, device=dev)
        cases.append((tag, seg, feats, nc, True))
    seg, feats = cases[0][1].clone(), cases[0][2]
    g = torch.Generator(dev).manual_seed(210)
    hot = torch.rand((r, sq), generator=g, device=dev).argsort(-1)[:, :6000]
    seg.scatter_(1, hot, 123)
    cases.append(("skewed, 6,000 sources on one node", seg, feats, nc, False))
    cases.append(("attraction sums, int64 ids", cases[0][1].long(), feats, nc,
                  False))
    # a binary heap (parent of i is (i - 1) // 2) under a random relabelling
    # of nodes and a random order of sources: at most two children a node
    g = torch.Generator(dev).manual_seed(211)
    lab = torch.rand((r, nc), generator=g, device=dev).argsort(-1)
    i = torch.arange(nc, device=dev)
    n_nodes = torch.randint(nc // 2, nc, (r, 1), generator=g, device=dev)
    par = torch.gather(lab, 1, ((i - 1) // 2).clamp(min=0).expand(r, nc))
    par = torch.where((i >= 1) & (i < n_nodes), par, nc)
    seg = torch.full((r, nc), nc, dtype=torch.int32, device=dev)
    seg.scatter_(1, lab, par.to(torch.int32))
    feats = torch.rand((r, nc, 1), generator=g, device=dev)
    cases.append(("murray sweep, tree parent ids", seg, feats, nc, False))
    return cases


def k6_case(dev, r: int, n: int, seed: int, eps=None):
    """(pos [r, n, 3], valid [r, n], eps [r]) for K6: candidates in the unit
    slab of the growth (z up to 0.0131), about 80 % valid, a tenth of them
    exact copies of others; ``eps`` one a row, by default between 0.4 and 2
    mean spacings (1 / sqrt(n)). Where r > 1, row 0 has no valid candidate;
    where r > 2 and n > 1, row 1's second candidate is moved to about eps
    from its first, both made valid, and its eps set to their float32
    distance; row 2 holds row 1's points with eps one float32 step below
    that distance: a pair at exactly eps and one just beyond it."""
    import torch

    g = torch.Generator(dev).manual_seed(seed)
    slab = torch.tensor([1.0, 1.0, 0.0131], device=dev)
    pos = torch.rand((r, n, 3), generator=g, device=dev) * slab
    valid = torch.rand((r, n), generator=g, device=dev) < 0.8
    dup = torch.randperm(n, generator=g, device=dev)[: n // 10]
    src = torch.randperm(n, generator=g, device=dev)[: n // 10]
    pos[:, dup] = pos[:, src]
    if eps is None:
        eps = (0.4 + 1.6 * torch.rand(r, generator=g, device=dev)) / n ** 0.5
    else:
        eps = torch.as_tensor(eps, dtype=torch.float32, device=dev).expand(r)
    eps = eps.clone()
    if r > 1:
        valid[0] = False
    if r > 2 and n > 1:
        pos[1, 1] = pos[1, 0] + eps[1] * torch.tensor([0.6, 0.8, 0.0],
                                                      device=dev)
        d = pos[1, 1] - pos[1, 0]
        at = (d * d).sum(-1).sqrt()  # the plain version's expression
        pos[2] = pos[1]
        valid[1:3, :2] = True
        eps[1] = at
        eps[2] = torch.nextafter(at, torch.zeros_like(at))
    return pos, valid, eps


def k6_cases(dev):
    """[(tag, pos, valid, eps, main)]: K6's call of a growth iteration at
    batch 32 (the benchmark's) and at batch 8, and the dataset generator's
    (batch 1), 2000 candidates a row, with the spacing distances of the
    schedule (eps_s / (3 sigma): 0.045 at the start of SVC down to 0.009 in
    DVC's iteration 75)."""
    import torch

    cases = []
    for ci, (tag, r) in enumerate((("growth, batch 32", 32),
                                   ("growth, batch 8", GROW_BATCH),
                                   ("generate, one row", 1))):
        g = torch.Generator(dev).manual_seed(600 + ci)
        eps = 0.009 + 0.036 * torch.rand(r, generator=g, device=dev)
        cases.append((tag, *k6_case(dev, r, N_CAND, 600 + ci, eps), True))
    return cases


def k1_cases(dev):
    """[(tag, (a, b, w, v), res, k_max, main)]: the four fixture graphs at
    batch 4 at the pipeline's two shapes and with a forced overflow, the
    first graph's first tree (its arterial one) at generation's shape, and
    the first graph as segmentation training renders it (batch 1: the 304²
    image, and the 1216² label without edges of radius under 0.0033)."""
    import torch

    from octa_tpu_torch import pipeline as tp
    from octa_tpu_torch.ops import raster

    samples = [raster.parse_graph_csv(p) for p in raster.fixture_graph_paths()]
    edges = tp.edges_to_device(samples, dev)
    tree = {k: v[:len(v) // 2] for k, v in samples[0].items()}
    a, b = raster.edges_to_px_2d(tree, (1216, 1216), 2)
    w = tree["radius"] * raster._RADIUS_FUDGE * 1216 * raster._PT_TO_PX
    gen = tuple(torch.from_numpy(x).to(dev)[None]
                for x in raster.pad_edges(a, b, w))
    train = []
    for res, min_radius in ((304, 0.0), (1216, 0.0033)):
        # one sample of segmentation training (config_ves_seg-S.yml):
        # LoadGraphAndFilterByRandomRadiusd's image and label
        g = samples[0]
        a, b = raster.edges_to_px_2d(g, (res, res), 2)
        w = g["radius"] * raster._RADIUS_FUDGE * res * raster._PT_TO_PX
        keep = (g["radius"] >= min_radius) & (g["radius"] <= 1)
        train.append(tuple(torch.from_numpy(x).to(dev)[None]
                           for x in raster.pad_edges(a, b, w, keep)))
    return [("pipeline input", edges["in"], 304, 4096, True),
            ("pipeline label", edges["lab"], 1216, 512, True),
            ("forced overflow", edges["lab"], 1216, 64, False),
            ("generation, one tree", gen, 1216, 16384, True),
            ("train image", train[0], 304, 16384, True),
            ("train label", train[1], 1216, 16384, True)]


def k4_cases(dev):
    """[(tag, (a, b, r, v), dims, main)]: the first fixture graph's two
    trees (the CSV holds the arterial tree, then the venous) at generation's
    (1216, 1216, 53), the whole graph at (304, 304, 14), and at (76, 76, 4)
    with ``ignore_z``; as ``voxel_edges`` prepares them."""
    import numpy as np
    import torch

    from octa_tpu_torch.ops import raster

    graph = raster.parse_graph_csv(raster.fixture_graph_paths()[0])
    half = len(graph["radius"]) // 2
    z = lambda scale: int(0.0131 * scale)  # the slab of vessel_graph_gen
    cases = []
    for tag, part, vdims, ignore_z, main in (
            ("art", slice(0, half), [1216, 1216, z(1216)], False, True),
            ("ven", slice(half, None), [1216, 1216, z(1216)], False, True),
            ("whole graph", slice(None), [304, 304, z(304)], False, False),
            ("whole graph, ignore_z", slice(None), [76, 76, 1], True, False)):
        sub = {k: x[part] for k, x in graph.items()}
        keep = np.ones(len(sub["radius"]), bool)
        *arrs, dims = raster.voxel_edges(sub, keep, vdims, ignore_z)
        cases.append((tag, tuple(torch.from_numpy(x).to(dev) for x in arrs),
                      dims, main))
    return cases


def k5_cases(dev):
    """[(tag, layout, q, p, mask, alive, band, want_idx)]: K5's three calls
    of a banded growth iteration at batch 8 and full capacity (K2's first
    three shapes) with the bands of DVC iteration 75, on y-sorted points
    (as after a restage: the main path) and on unsorted ones."""
    import torch

    from octa_tpu_torch.sim.configs import vessel_graph_gen

    gcfg = vessel_graph_gen()["Greenhouse"]
    mode = gcfg["modes"][1]
    # the distance parameters of DVC iteration 75 (sigma = 1 + 75 * 0.02)
    denom = gcfg["param_scale"] * (1.0 + 75 * mode["delta_sigma"])
    par = {k: mode[k] / denom for k in
           ("eps_n", "eps_s", "eps_k", "delta_art", "delta_ven")}
    b, sq = GROW_BATCH, SINK_CAP + N_CAND
    # tag, R, Q, N, want_idx, one band per row (cycled)
    shapes = [("sinks+cand -> nodes", 3 * b, sq, NODE_CAP, True,
               [par["delta_art"], par["eps_k"], par["delta_ven"]]),
              ("cand -> art nodes", b, N_CAND, NODE_CAP, True,
               [max(par["eps_n"], par["eps_k"])]),
              ("cand -> oxy sinks", b, N_CAND, SINK_CAP, False, [par["eps_s"]])]
    slab = torch.tensor([1.0, 1.0, gcfg["SimulationSpace"]["no_voxel_z"]],
                        device=dev)

    def ysort(x, lo, hi):  # sort rows lo:hi of every [n, 3] block by y
        if hi <= lo:
            return
        order = torch.argsort(x[:, lo:hi, 1], dim=1, stable=True)
        x[:, lo:hi] = torch.gather(x[:, lo:hi], 1,
                                   order[..., None].expand(-1, -1, 3))

    cases = []
    for ci, (tag, r, qn, n, want_idx, bands) in enumerate(shapes):
        for layout in ("y-sorted", "unsorted"):
            g = torch.Generator(dev).manual_seed(300 + ci)
            q = torch.rand((r, qn, 3), generator=g, device=dev) * slab
            p = torch.rand((r, n, 3), generator=g, device=dev) * slab
            n_live = int(0.85 * n)  # the tail of the node array is empty
            mask = ((torch.rand((r, 1, n), generator=g, device=dev) < 0.8)
                    & (torch.arange(n, device=dev) < n_live))
            alive = torch.rand((r, qn), generator=g, device=dev) < 0.8
            band = torch.tensor([bands[i % len(bands)] for i in range(r)],
                                device=dev)
            if layout == "y-sorted":  # as after a restage
                ysort(p, 0, n_live)
                ysort(q, 0, qn - N_CAND)        # the sink prefix (may be empty)
                ysort(q, qn - N_CAND, qn)       # the candidates
            cases.append((tag, layout, q, p, mask, alive, band, want_idx))
    return cases


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
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


# profiler windows taken by ``_launches``, those among them taken again
# because the profiler had dropped some of their events, and the kernel
# times read from a window with some of that kernel's launches missing
WINDOWS = {"taken": 0, "retaken": 0, "partial": 0}


def _launches(fn, reps: int, tries: int = 3) -> dict:
    """{device kernel name: (mean ms a launch, launches a call)} of ``fn``
    under ``torch.profiler`` over ``reps`` calls.

    On the card the profiler has dropped events of a window (all of them,
    or one launch of ten), on some hosts in every window after a while. A
    kernel's time is read from a window that held a whole number of its
    launches a call. While some kernel has no such window, the window is
    taken again, with the allocator's cached blocks released, up to
    ``tries`` windows in all; each retake is printed with what the window
    held. A kernel that no window held whole is read from the window that
    held the most of its launches only where a call launches it once: every
    call launches it at the same shapes, so the mean of the launches held is
    a call's. Each such time counts in ``WINDOWS["partial"]``. A kernel that
    a call launches several times (at several shapes, so that the mean
    depends on which launch was dropped) raises instead: a time is returned
    only where it was measured over whole calls or over launches alike."""
    import math

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    whole: dict = {}  # name -> (ms, launches) of a window with whole calls
    most: dict = {}  # name -> (ms, launches) of the window that held the most
    held: dict = {}
    for attempt in range(tries):
        if attempt:
            WINDOWS["retaken"] += 1
            print(f"[profiler] a window of {reps} calls held "
                  f"{ {name: n for name, (_, n) in held.items()} }: taken "
                  f"again", flush=True)
            torch.cuda.empty_cache()
        WINDOWS["taken"] += 1
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        held = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                t, n = held.get(e.name, (0.0, 0))
                held[e.name] = (t + e.self_device_time_total / 1e3, n + 1)
        for name, (t, n) in held.items():
            if n % reps == 0:
                whole.setdefault(name, (t, n))
            elif n > most.get(name, (0.0, 0))[1]:
                most[name] = (t, n)
        if whole and set(most) <= set(whole):
            return {name: (t / n, n // reps) for name, (t, n) in whole.items()}
    out = {name: (t / n, n // reps) for name, (t, n) in whole.items()}
    for name, (t, n) in most.items():
        if name in whole:
            continue
        if math.ceil(n / reps) != 1:
            raise RuntimeError(
                f"torch.profiler dropped launches of {name} in {tries} "
                f"windows in a row of {reps} calls (at most {n} held); it "
                f"runs several times a call, so their mean is no call's")
        WINDOWS["partial"] += 1
        print(f"[profiler] no whole window of {name} in {tries}: its time "
              f"from the {n} of {reps} launches the fullest one held",
              flush=True)
        out[name] = (t / n, 1)
    if not out:
        raise RuntimeError(f"torch.profiler held no kernel of {tries} windows "
                           f"of {reps} calls")
    return out


def kernel_ms(fn, reps: int = 10) -> dict:
    """Device time per call of ``fn`` in ms, by device kernel name."""
    return {name: ms * k for name, (ms, k) in _launches(fn, reps).items()}


def device_ms(fn, reps: int = 10):
    """Device time per call of ``fn`` in ms, and the names of a call's
    device kernels (a name once for each of its launches)."""
    per = _launches(fn, reps)
    return (sum(ms * k for ms, k in per.values()),
            [name for name, (_, k) in per.items() for _ in range(k)])


def launch_host_us(dev, reps: int = 20000) -> dict:
    """Host microseconds a call of the two ways to find a launch's device
    and stream on ``dev``, the current card: the guard path (the device
    guard and a ``Stream`` object) and ``on_device`` + ``stream_handle``
    (no guard on the current card, the raw handle)."""
    import time

    import torch

    from octa_tpu_torch.ops._cuda import on_device, stream_handle

    def guard():
        with torch.cuda.device(dev):
            return torch.cuda.current_stream(dev).cuda_stream

    def thin():
        with on_device(dev):
            return stream_handle(dev)

    assert guard() == thin()
    out = {}
    for name, fn in (("guard", guard), ("on_device", thin), ("guard", guard),
                     ("on_device", thin)):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out.setdefault(name, []).append((time.perf_counter() - t0) / reps * 1e6)
    return out


def short_name(kernel: str) -> str:
    """A device kernel's name without its namespaces, template arguments and
    parameters: ``void (anonymous namespace)::gather_kernel<unsigned
    char>(...)`` -> ``gather_kernel``."""
    name = kernel.replace("(anonymous namespace)::", "").split("(")[0]
    return name.removeprefix("void ").split("<")[0].split("::")[-1]


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def sass_inner_loops(listing: str) -> dict:
    """Kernel name -> (instructions, float multiplies) of its innermost
    compute loop in a ``cuobjdump -sass`` listing: the longest backward
    branch whose body loads from shared memory and holds no barrier."""
    loops = {}
    for block in re.split(r"\n\s*Function : ", listing)[1:]:
        ins = [(int(a, 16), op.strip()) for a, op in
               re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", block)]
        best = None
        for addr, op in ins:
            m = re.search(r"\bBRA (0x[0-9a-f]+)", op)
            if not m or int(m.group(1), 16) >= addr:
                continue
            body = [o for a, o in ins if int(m.group(1), 16) <= a <= addr]
            if (any("BAR" in o for o in body)
                    or not any(re.search(r"\bLDS", o) for o in body)):
                continue
            if best is None or len(body) > len(best):
                best = body
        if best:
            loops[block.split()[0]] = (
                len(best), sum(bool(re.search(r"\bFMUL\b", o)) for o in best))
    return loops


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root", nargs="?", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--sass", default=None)
    ap.add_argument("--only", choices=("k1", "k2", "k3", "k4", "k5", "k6",
                                       "launch"),
                    default=None,
                    help="time one kernel's cases only")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from octa_tpu_torch.ops import nearest, segsum, splat, splat3d
    try:
        from octa_tpu_torch.ops import spacing
    except ImportError:  # a package before K6: its plain spacing only
        spacing = None

    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: no CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device())
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    print(f"package {os.path.dirname(nearest.__file__)}", flush=True)

    # (label, function, digest of its output or None)
    items = []
    run = lambda k: args.only in (None, k) and (k != "k6" or spacing)
    from octa_tpu_torch.ops import _cuda
    if run("launch") and hasattr(_cuda, "on_device"):  # not in older packages
        us = launch_host_us(dev)
        print("[launch] host us a call to find the device and stream: "
              + "; ".join(f"{k} {', '.join(f'{t:.3f}' for t in v)}"
                          for k, v in us.items()), flush=True)
    for tag, (a, b, w, v), res, k, _ in k1_cases(dev) if run("k1") else []:
        call = lambda a=a, b=b, w=w, v=v, res=res, k=k: splat.splat_lines_2d(
            a, b, w, v, height=res, width=res, k_max=k)
        items.append((f"[k1] {tag} {res}² k_max={k} B={a.shape[0]} "
                      f"E={a.shape[1]}", call, digest(call())))
    for tag, q, p, masks, want_idx, _ in k2_cases(dev) if run("k2") else []:
        call = lambda q=q, p=p, masks=masks, want_idx=want_idx: \
            nearest.masked_nearest(q, p, masks, want_idx=want_idx)
        out = call()
        items.append((f"[k2] {tag} R={q.shape[0]} Q={q.shape[1]} "
                      f"N={p.shape[1]}", call,
                      digest(*(out if want_idx else (out,)))))
    for tag, seg, feats, nc, _ in k3_cases(dev) if run("k3") else []:
        call = lambda seg=seg, feats=feats, nc=nc: \
            segsum.segment_sum(seg, feats, nc)
        r, sq, f = feats.shape
        items.append((f"[k3] {tag} F={f} Sq={sq} nc={nc} R={r}", call,
                      digest(call())))
        flat = (seg.long() + torch.arange(r, device=dev)[:, None]
                * (nc + 1)).reshape(-1)
        buf = torch.empty(r * (nc + 1), f, device=dev)
        lib = lambda flat=flat, buf=buf, src=feats.reshape(r * sq, f): \
            buf.zero_().index_add_(0, flat, src)
        items.append(("    index_add_", lib, None))
    u8_store = "out_dtype" in inspect.signature(
        splat3d.splat_capsules_3d).parameters
    for tag, (a, b, r, v), dims, _ in k4_cases(dev) if run("k4") else []:
        f32 = lambda a=a, b=b, r=r, v=v, dims=dims: \
            splat3d.splat_capsules_3d(a, b, r, v, dims=dims)
        if u8_store:
            u8 = lambda a=a, b=b, r=r, v=v, dims=dims: \
                splat3d.splat_capsules_3d(a, b, r, v, dims=dims,
                                          out_dtype=torch.uint8)
        else:  # the renderer's passes after the float store
            u8 = lambda f32=f32: \
                (f32() * 255.0).clamp(0, 255).to(torch.uint8)
        label = f"[k4] {tag} {tuple(dims)} E={int(v.sum())}"
        items.append((f"{label} float32", f32, digest(f32())))
        items.append((f"{label} uint8", u8, digest(u8())))
    for tag, layout, q, p, mask, alive, band, want_idx in (
            k5_cases(dev) if run("k5") else []):
        call = lambda q=q, p=p, mask=mask, alive=alive, band=band, \
            want_idx=want_idx: nearest.masked_nearest_banded(
                q, p, mask, alive, band, want_idx=want_idx)
        full = lambda q=q, p=p, mask=mask, want_idx=want_idx: \
            nearest.masked_nearest(q, p, mask, want_idx=want_idx)
        out = call()
        items.append((f"[k5] {tag} R={q.shape[0]} Q={q.shape[1]} "
                      f"N={p.shape[1]} {layout}", call,
                      digest(*(out if want_idx else (out,)))))
        items.append(("    K2 on the same inputs", full, None))
    for tag, pos, valid, eps, _ in k6_cases(dev) if run("k6") else []:
        call = lambda pos=pos, valid=valid, eps=eps: \
            spacing.blocked_greedy_spacing(pos, valid, eps)
        plain = lambda pos=pos, valid=valid, eps=eps: \
            spacing.spacing_plain(pos, valid, eps)
        items.append((f"[k6] {tag} R={pos.shape[0]} n={pos.shape[1]}", call,
                      digest(call())))
        items.append(("    plain version", plain, digest(plain())))
    # CUDA events first: a profiled process launches more slowly afterwards
    call_ms = [cuda_ms(fn) for _, fn, _ in items]
    for (label, fn, dig), c_ms in zip(items, call_ms):
        per = kernel_ms(fn)
        parts = "" if len(per) < 2 else " (" + ", ".join(
            f"{short_name(name)} {ms:.4f}" for name, ms in per.items()) + ")"
        tail = "" if dig is None else f" digest {dig}"
        print(f"{label}: kernels {sum(per.values()):.4f} ms{parts}, call "
              f"{c_ms:.4f} ms{tail}", flush=True)

    if args.sass:
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        os.makedirs(args.sass, exist_ok=True)
        for k in (nearest.NEAREST, segsum.SEGSUM):
            lib = k.build()
            proc = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                                  text=True)
            with open(os.path.join(args.sass, lib.stem + ".sass"), "w") as fh:
                fh.write(proc.stdout + proc.stderr)
            print(f"sass of {lib.name}: {len(proc.stdout.splitlines())} lines "
                  f"(cuobjdump exit {proc.returncode})")
            for name, (n_ins, n_mul) in sass_inner_loops(proc.stdout).items():
                pairs = n_mul / 3  # three products a (query, point) pair
                per = f"{n_ins / pairs:.2f} a pair" if pairs else "no pairs"
                print(f"  inner loop of {name}: {n_ins} instructions, "
                      f"{n_mul} FMUL ({per})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
