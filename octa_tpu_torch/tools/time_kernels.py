"""Time K2 (masked nearest) and K3 (segment sum) on the card at the growth
loop's call shapes.

Usage, from the root of a checkout::

    python3 octa_tpu_torch/tools/time_kernels.py [ROOT] [--only k2|k3]
                                                 [--sass DIR]

``ROOT`` is a directory that holds an ``octa_tpu_torch`` package (default:
this checkout). To compare two versions of the package (a change of a
kernel's design against its undoing: the earlier version from git history),
unpack the other one into a directory of its own and run both in turns in
one go on one card (other, this, this, other).

Prints the card's name and power limit, then one line per case: the device
time of a call's kernels (``torch.profiler``, mean of 10 calls), the time of
a call (CUDA events, mean of 20 calls after 3: the host's share included
where it is the larger) and a digest of the output
(SHA-256 of its bytes, so that two versions can be shown to compute the same
bits). The cases are the four K2 calls of a growth iteration at batch 8 and
full capacity with random masks, the same four with the masks of a late
growth iteration (node arrays valid on a prefix, dead sink slots, a
new-node window that holds a few nodes), and K3's two shapes with random,
skewed and tree-shaped ids. ``--sass DIR`` writes ``cuobjdump -sass`` of
the built K2 and K3 libraries into ``DIR``.
"""
from __future__ import annotations

import argparse
import hashlib
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


def device_ms(fn, reps: int = 10):
    """Mean device time per call of ``fn`` in ms and the names of the device
    kernels of one call, from ``torch.profiler`` over ``reps`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ms = sum(e.self_device_time_total for e in kern) / 1e3 / reps
    return ms, [e.name for e in kern[:len(kern) // reps]]


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
    ap.add_argument("--only", choices=("k2", "k3"), default=None,
                    help="time one kernel's cases only")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from octa_tpu_torch.ops import nearest, segsum

    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: no CUDA card")
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    print(f"package {os.path.dirname(nearest.__file__)}", flush=True)

    # (label, function, digest of its output or None)
    items = []
    for tag, q, p, masks, want_idx, _ in ([] if args.only == "k3"
                                          else k2_cases(dev)):
        call = lambda q=q, p=p, masks=masks, want_idx=want_idx: \
            nearest.masked_nearest(q, p, masks, want_idx=want_idx)
        out = call()
        items.append((f"[k2] {tag} R={q.shape[0]} Q={q.shape[1]} "
                      f"N={p.shape[1]}", call,
                      digest(*(out if want_idx else (out,)))))
    for tag, seg, feats, nc, _ in [] if args.only == "k2" else k3_cases(dev):
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
    # CUDA events first: a profiled process launches more slowly afterwards
    call_ms = [cuda_ms(fn) for _, fn, _ in items]
    for (label, fn, dig), c_ms in zip(items, call_ms):
        k_ms = device_ms(fn)[0]
        tail = "" if dig is None else f" digest {dig}"
        print(f"{label}: kernels {k_ms:.4f} ms, call {c_ms:.4f} ms{tail}",
              flush=True)

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
