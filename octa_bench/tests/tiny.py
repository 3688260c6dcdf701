"""Cells cut to a size the CPU runs in seconds, for the tests: training
images at 64² (labels) and 16² (inputs) in float32, the adapted path at
128² and 32² (below that a Dice moves with a handful of pixels), a short
growth, few files."""
from __future__ import annotations

import copy
import time

from octa_bench import harness

SIZES = {1216: 64, 304: 16}


def shrink(x):
    if isinstance(x, dict):
        return {k: shrink(v) for k, v in x.items()}
    if isinstance(x, list):
        return [shrink(v) for v in x]
    if isinstance(x, int) and not isinstance(x, bool):
        return SIZES.get(x, x)
    return x


def overrides(cell: harness.Cell) -> dict:
    cfg, tr = cell.config, cell.traffic
    if tr["kind"] == "engine_train":
        run = shrink(cfg["run"])
        # float32 steps: at 64² bfloat16's gradients stray further from the
        # reference than the limits set at 1216² allow
        run["General"]["amp"] = False
        if "GanSeg" in cfg["algorithm"]:
            run["General"]["model"]["upshape"] = [64, 64]
        return {"config": {"run": run},
                "traffic": {"data": {"graphs": 48, "backgrounds": 4,
                                     "images": 8, "res": 16},
                            "loader_samples": 2, "warm_steps": 3}}
    out = {"config": {"pipeline": {"res_in": 32, "res_lab": 128}}}
    if tr["kind"] == "segment":
        out["traffic"] = {"warm_requests": 1, "max_requests": 40,
                          "sample_from": 2, "sample_requests": 2}
    else:
        g = copy.deepcopy(cfg["growth"])
        for m in g["Greenhouse"]["modes"]:
            m["I"], m["N"] = 4, 100
        g["final_murray_sweeps"] = 8
        out["config"]["growth"] = g
        out["traffic"] = {"batch": 4}
    return out


# A growth of 8 iterations leaves its stumps a third of its nodes or more,
# against a few thousandths after the full schedule: the tiny size reads
# ``stump_share`` against this limit instead of the cell's.
TINY_LIMITS = {"stump_share": 0.9}


def run(name: str, seed: int = 2 ** 33 + 7, seconds: float = 0.5,
        calibrate: bool = False):
    """One CPU run of cell ``name`` at the tiny size: the result object
    (with ``_run``)."""
    cell = harness.Cell(name)
    cell.limits = {k: TINY_LIMITS.get(k, v) for k, v in cell.limits.items()}
    return harness.run_cell(cell, seed, seconds, False, "cpu",
                            time.perf_counter(), overrides(cell),
                            calibrate=calibrate)
