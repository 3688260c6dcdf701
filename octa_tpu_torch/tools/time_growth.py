"""Time ``Greenhouse.develop_forest`` at the full growth schedule on the card.

Usage, from the root of a checkout::

    python3 octa_tpu_torch/tools/time_growth.py [ROOT] [--batch 8] [--reps 3]

``ROOT`` is a directory that holds an ``octa_tpu_torch`` package (default:
this checkout). To compare two versions of the package, unpack the other one
into a directory of its own and run both in turns in one go on one card
(other, this, this, other): times taken on different occasions differ by
more than most changes do, because the growth loop is bound by the host.

Prints the card's name and power limit, then one line per repetition:
seconds, samples/s, iterations run (redone segments included), K2 and K3
launches and the arterial node counts (equal counts show that two versions
grew the same forests). The first repetition also loads the kernels.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("root", nargs="?", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from octa_tpu_torch.ops.nearest import NEAREST
    from octa_tpu_torch.ops.segsum import SEGSUM
    from octa_tpu_torch.sim import greenhouse as gh
    from octa_tpu_torch.sim.configs import vessel_graph_gen

    cfg = vessel_graph_gen()
    g = gh.Greenhouse(cfg["Greenhouse"], seed=0)  # raises without a card
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    print(f"package {os.path.dirname(gh.__file__)}")
    for rep in range(args.reps):
        NEAREST.launches = SEGSUM.launches = 0
        t0 = time.perf_counter()
        state = g.develop_forest(cfg["Forest"], batch=args.batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        iters = sum(e["seg_len"] for e in g.stage_log)
        print(f"rep {rep}: {dt:.3f} s = {args.batch / dt:.3f} samples/s; "
              f"iterations run {iters}; K2 {NEAREST.launches} K3 "
              f"{SEGSUM.launches} launches; art nodes "
              f"{state.art.n_nodes.tolist()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
