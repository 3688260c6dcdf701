"""Time ``Greenhouse.develop_forest`` at the full growth schedule on the card.

Usage, from the root of a checkout::

    python3 octa_tpu_torch/tools/time_growth.py [ROOT] [--batch 8] [--reps 3]
                                                [--banded]

``ROOT`` is a directory that holds an ``octa_tpu_torch`` package (default:
this checkout). To compare two versions of the package, unpack the other one
into a directory of its own and run both in turns in one go on one card
(other, this, this, other): times taken on different occasions differ by
more than most changes do, because the growth loop is bound by the host.
``--banded`` grows in the banded configuration (K5): compare it with the
plain one the same way, in turns in one go.

Prints the card's name and power limit, then one line per repetition:
seconds, samples/s, iterations run (redone segments included), K2, K3 and K5
launches and a digest of the grown batch (:func:`forest_digest`: equal
digests show that two versions grew the same forests). The first repetition
also loads the kernels.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root", nargs="?", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--banded", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from octa_tpu_torch.ops import nearest
    from octa_tpu_torch.ops.segsum import SEGSUM
    from octa_tpu_torch.sim import greenhouse as gh
    from octa_tpu_torch.sim.configs import vessel_graph_gen

    cfg = vessel_graph_gen()
    kernels = {"K2": nearest.NEAREST, "K3": SEGSUM}
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
