"""Readings from which the limits of ``correct`` are set: each number of a
cell as the program gives it on many seeds, and as the control (the
reference in the next lower precision put in the program's place) and,
for training, the faults give it on a few. One process, one cell:

    python octa_bench/calibrate.py --workload <cell> --seeds 11,12,... \\
        --control-seeds 21,22,23 --seconds 3 [--out readings.jsonl]

on a machine with the card. Each line printed is one seed's readings.
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(_ROOT)

from octa_bench import harness  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    os.environ.update(harness.cache_env(_ROOT))
    cell = harness.Cell(a.workload)
    out = open(a.out, "a") if a.out else None
    jobs = [(int(s), False) for s in a.seeds.split(",") if s] + \
           [(int(s), True) for s in a.control_seeds.split(",") if s]
    for seed, control in jobs:
        t = time.perf_counter()
        res = harness.run_cell(cell, seed, a.seconds, False, "cuda", t,
                               calibrate=control)
        run = res["_run"]
        line = {"workload": a.workload, "seed": seed,
                "program": dict(run.checks), "s": time.perf_counter() - t,
                "setup_s": run.e2e.get("setup_s"),
                "e2e": {k: v for k, v in run.e2e.items()}}
        if control:
            line["control"] = dict(run.control)
            line["faults"] = {k: dict(v) for k, v in run.faults.items()}
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()


if __name__ == "__main__":
    main()
