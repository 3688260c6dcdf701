"""Time ``Greenhouse.develop_forest`` at the full growth schedule on the card.

Usage, from the root of a checkout::

    python3 octa_tpu_torch/tools/time_growth.py [ROOT] [--batch 8] [--reps 3]
                                                [--banded] [--profile]

``ROOT`` is a directory that holds an ``octa_tpu_torch`` package (default:
this checkout). To compare two versions of the package, unpack the other one
into a directory of its own and run both in turns in one go on one card
(other, this, this, other): times taken on different occasions differ by
more than most changes do, because the growth loop is bound by the host.
``--banded`` grows in the banded configuration (K5): compare it with the
plain one the same way, in turns in one go.

Prints the card's name and power limit, then one line per repetition:
seconds, samples/s, iterations run (redone segments included), K2, K3, K5 and
K6 launches (K6 where the package has it) and a digest of the grown batch
(:func:`forest_digest`: equal digests show that two versions grew the same
forests). The first repetition also loads the kernels. ``--profile`` then
prints the last batch's counts (``Greenhouse.stage_counts``: iterations,
redone ones, host reads and K6 launches) and profiles 10 late iterations
from the last grown batch twice (:func:`profile_late_segment`; K5 is
``banded_kernel`` in packages before its staging kernel, ``stage_kernel`` +
``scan_kernel`` after), with the host time of each of the iteration's
spans where the package has them.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import subprocess
import sys
import time


def forest_digest(state) -> str:
    """Node counts per tree, the float64 sum of the existing nodes' positions
    and a SHA-256 of their positions, parents and radii, both forests of
    every sample."""
    h = hashlib.sha256()
    total = 0.0
    for f in (state.art, state.ven):
        for b, n in enumerate(f.n_nodes.tolist()):
            for arr in (f.pos[b, :n], f.parent[b, :n], f.radius[b, :n]):
                h.update(arr.cpu().contiguous().numpy().tobytes())
            total += float(f.pos[b, :n].double().sum())
    return (f"art nodes {state.art.n_nodes.tolist()} ven nodes "
            f"{state.ven.n_nodes.tolist()}; position sum {total!r}; "
            f"sha256 {h.hexdigest()[:16]}")


def profile_late_segment(g, state, ecap: int, tag: str, names: dict):
    """Where a late segment's time goes: 10 DVC iterations at the final
    capacities from the grown ``state`` under ``torch.profiler`` (restaged
    first in the banded configuration, as at a segment boundary); prints the
    wall, the device busy time and share, device kernels an iteration, the
    device time of the kernels whose names hold each of ``names``' values,
    and the top five kernels; then, for a package with spans, the host ms
    an iteration of each ``octa.grow.*`` span."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from octa_tpu_torch.sim import greenhouse as gh

    try:
        from octa_tpu_torch.utils import trace
    except ImportError:  # a package before its spans
        trace = None
    if g.banded:
        state = gh._restage_spatial(state)
    if trace is not None:
        trace.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        g._run_segment(state, 1, 100, 140, 10, 4, False, ecap)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    if busy == 0:
        print(f"[{tag}] device time not measured (profiler saw no kernels)")
        return
    ours = {k: sum(e.self_device_time_total for e in kern if n in e.key) / 1e3
            for k, n in names.items()}
    n_launch = sum(e.count for e in kern)
    top = sorted(kern, key=lambda e: e.self_device_time_total, reverse=True)[:5]
    print(f"[{tag}] 10 late DVC iterations at cap {state.art.pos.shape[1]} "
          f"scap {state.oxy.pos.shape[1]} under torch.profiler: wall "
          f"{wall:.4f} s, device busy {busy:.4f} s ({100 * busy / wall:.1f} %), "
          f"{n_launch} device kernels ({n_launch / 10:.0f} per iteration); "
          + " ".join(f"{k} {v:.1f} ms" for k, v in ours.items()) + "; top: "
          + "; ".join(f"{e.key[:50]} {e.self_device_time_total / 1e3:.1f} ms "
                      f"x{e.count}" for e in top), flush=True)
    if trace is not None:
        print(f"[{tag}] spans, host ms an iteration: " + " ".join(
            f"{k.removeprefix('octa.grow.')} {v['host_ms'] / 10:.2f}"
            for k, v in trace.totals().items()), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root", nargs="?", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--banded", action="store_true")
    ap.add_argument("--profile", action="store_true",
                    help="then profile 10 late iterations of the last rep")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from octa_tpu_torch.ops import nearest
    from octa_tpu_torch.ops.segsum import SEGSUM
    from octa_tpu_torch.sim import greenhouse as gh
    from octa_tpu_torch.sim.configs import vessel_graph_gen

    cfg = vessel_graph_gen()
    kernels = {"K2": nearest.NEAREST, "K3": SEGSUM}
    try:
        from octa_tpu_torch.ops.spacing import SPACING
        kernels["K6"] = SPACING
    except ImportError:  # a package before K6
        pass
    kwargs = {}
    if args.banded:  # an older package has neither the kernel nor the option
        kernels["K5"] = nearest.NEAREST_BANDED
        kwargs["banded"] = True
    g = gh.Greenhouse(cfg["Greenhouse"], seed=0, **kwargs)  # raises without a card
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    print(f"package {os.path.dirname(gh.__file__)} banded={args.banded}")
    for rep in range(args.reps):
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        state = g.develop_forest(cfg["Forest"], batch=args.batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        iters = sum(e["seg_len"] for e in g.stage_log)
        print(f"rep {rep}: {dt:.3f} s = {args.batch / dt:.3f} samples/s; "
              f"iterations run {iters}; launches "
              f"{ {t: k.launches for t, k in kernels.items()} }; "
              f"{forest_digest(state)}", flush=True)
    if args.profile:
        if hasattr(g, "stage_counts"):  # a package with the batch's notes
            print(f"last batch's counts: {g.stage_counts()}", flush=True)
        names = {"K2": "nearest_kernel", "K3": "segsum_kernel",
                 "K5": "banded_kernel", "K5 staging": "::stage_kernel",
                 "K5 scan": "::scan_kernel", "K6": "spacing_kernel"}
        for rep in range(2):
            profile_late_segment(g, state, g.stage_log[-1]["ecap"],
                                 f"profile {rep}", names)
    return 0


if __name__ == "__main__":
    sys.exit(main())
