"""The benchmark's runner: finds a cell's files by name, runs its driver once
and prints one JSON result line.

``python octa_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``. The cell is an entry of ``workloads`` in the repository's
``BENCHMARK.json``; its configuration file is the ``file`` of its
``configs`` entry, its traffic ``octa_bench/traffic/<traffic>.json``, whose
``kind`` names the driver ``octa_bench/drivers/<kind>.py``, its limits
``octa_bench/limits/<cell>.json`` and each per-layer metric's reader
``octa_bench/metrics/<metric>.py``. Adding a cell, a mix or a metric adds
files; nothing here names one.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "octa_tpu")


class CellError(RuntimeError):
    """The run cannot give a result (no card, no program, a bad cell)."""


def cache_env(root: Path = ROOT) -> dict[str, str]:
    """Build and kernel caches at fixed paths inside the checkout, and no
    JAX behind a library's back; set before torch is imported."""
    build = root / "build"
    return {"TORCH_EXTENSIONS_DIR": str(build / "torch_extensions"),
            "TRITON_CACHE_DIR": str(build / "triton"),
            "CUDA_CACHE_PATH": str(build / "cuda_cache"),
            "USE_FLAX": "0", "USE_JAX": "0"}


def forbidden_loaded(modules=None) -> list[str]:
    """Top-level names in ``modules`` (``sys.modules``) that are JAX's or
    the JAX package's, compared whole."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def load_module(path: Path, name: str):
    if not path.is_file():
        raise CellError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise CellError(f"no file {path}")
    with open(path) as f:
        return json.load(f)


class Cell:
    """Everything the runner finds for one workload name."""

    def __init__(self, name: str, root: Path = ROOT):
        spec = load_json(root / "BENCHMARK.json")
        self.spec = spec
        by_name = {w["name"]: w for w in spec["workloads"]}
        if name not in by_name:
            raise CellError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = by_name[name]
        conf = {c["name"]: c for c in spec["configs"]}[self.workload["config"]]
        self.config = load_json(root / conf["file"])
        self.traffic = load_json(BENCH_DIR / "traffic"
                                 / f"{self.workload['traffic']}.json")
        self.driver_path = BENCH_DIR / "drivers" / f"{self.traffic['kind']}.py"
        lim = BENCH_DIR / "limits" / f"{name}.json"
        self.limits = load_json(lim) if lim.is_file() else {}
        self.chips = int(self.workload.get("chips", 1))

    def _applies(self, m: dict, reported: set[str] | None) -> bool:
        if "workloads" in m:
            return self.name in m["workloads"]
        return reported is None or m.get("moves") in reported

    def end_to_end(self) -> list[dict]:
        return [m for m in self.spec["end_to_end"] if self._applies(m, None)]

    def per_layer(self) -> list[dict]:
        reported = {m["name"] for m in self.end_to_end()}
        return [m for m in self.spec["per_layer"] if self._applies(m, reported)]


def read_per_layer(cell: Cell, record: dict) -> dict:
    """Each per-layer metric of the cell from its reader; a reader that finds
    nothing returns None and the metric is left out."""
    out = {}
    for m in cell.per_layer():
        mod = load_module(BENCH_DIR / "metrics" / f"{m['name']}.py",
                          f"octa_bench_metric_{m['name'].replace('.', '_')}")
        value = mod.read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(checks: list[tuple[str, float]], limits: dict) -> tuple[bool, dict]:
    """``correct`` and each number beside its limit: every number finite and
    at most its limit; a number with no limit fails."""
    table, ok = {}, bool(checks)
    for name, value in checks:
        limit = limits.get(name)
        table[name] = {"value": value, "limit": limit}
        good = (limit is not None and value is not None
                and math.isfinite(value) and value <= limit)
        ok = ok and good
    return ok, table


def device_info(torch, count: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


class Run:
    """What a driver is handed: the cell, the run's arguments and a scratch
    directory, and where it leaves what it measured."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str, t_start: float, tmp: str):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.t_start = t_start
        self.tmp = tmp
        #: filled by the driver
        self.t_first = None          # perf_counter at the first timed unit
        self.e2e: dict[str, float] = {}
        self.record: dict = {}
        self.attempted = 0
        self.failed = 0
        self.checks: list[tuple[str, float]] = []
        self.memory_peak = None
        self.device_trace = None     # measure.DeviceTrace of a traced run
        #: with ``calibrate``, the driver also reads the control (and, for
        #: training, the faults) into ``control`` and ``faults``
        self.calibrate = False
        self.control: list[tuple[str, float]] = []
        self.faults: dict[str, list[tuple[str, float]]] = {}

    def seed32(self, salt: int = 0) -> int:
        """The seed folded into 31 bits (``--seed`` may exceed 32 bits)."""
        return (self.seed * 1_000_003 + salt) % (2 ** 31 - 1)

    def sync(self, torch):
        """Wait for the device, where it is a card."""
        if self.device.startswith("cuda"):
            torch.cuda.synchronize()

    def free(self, torch):
        """Drop what the program left behind before the reference runs."""
        import gc

        gc.collect()
        if self.device.startswith("cuda"):
            torch.cuda.empty_cache()

    def window_closed(self, torch):
        """Read the device's peak memory once the window has closed, before
        anything else runs."""
        if self.device.startswith("cuda"):
            torch.cuda.synchronize()
            self.memory_peak = int(torch.cuda.max_memory_allocated(0))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             driver_overrides: dict | None = None,
             calibrate: bool = False) -> dict:
    """Run the cell's driver once; returns the result object (without the
    device fields, which only a run on the card has)."""
    t_start = time.perf_counter() if t_start is None else t_start
    driver = load_module(cell.driver_path,
                         f"octa_bench_driver_{cell.traffic['kind']}")
    with tempfile.TemporaryDirectory(prefix="octa_bench_") as tmp:
        run = Run(cell, seed, seconds, trace, device, t_start, tmp)
        run.calibrate = calibrate
        if driver_overrides:
            run.config = _merged(run.config, driver_overrides.get("config", {}))
            run.traffic = _merged(run.traffic,
                                  driver_overrides.get("traffic", {}))
        driver.run(run)
    if run.t_first is None:
        raise CellError("the driver timed nothing")
    run.e2e["setup_s"] = run.t_first - t_start
    ok, table = judge(run.checks, cell.limits)
    if trace:
        run.record["device_trace"] = run.device_trace
        metrics = read_per_layer(cell, run.record)
    else:
        metrics = {}
        for m in cell.end_to_end():
            if m["name"] in run.e2e:
                metrics[m["name"]] = {"value": float(run.e2e[m["name"]]),
                                      "unit": m["unit"]}
    result = {"correct": ok, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "_run": run}
    result["checks"] = table
    return result


def _merged(base: dict, over: dict) -> dict:
    out = json.loads(json.dumps(base))
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merged(out[k], v)
        else:
            out[k] = v
    return out


def parse_args(argv):
    p = argparse.ArgumentParser(description="Run one cell of the benchmark.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse_args(argv)
    try:
        import octa_tpu_torch  # noqa: F401  the system under test
    except ImportError as e:
        print(f"octa_bench: the program is not here ({e})", file=sys.stderr)
        return 2
    import torch

    try:
        cell = Cell(args.workload)
    except CellError as e:
        print(f"octa_bench: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"octa_bench: {cell.chips} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " present", file=sys.stderr)
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", t_start)
    run = result.pop("_run")
    bad = forbidden_loaded()
    if bad:
        print(f"octa_bench: modules loaded in this process: {bad}",
              file=sys.stderr)
        return 4
    device = device_info(torch, cell.chips)
    if run.memory_peak is not None:
        device["memory_peak_bytes"] = run.memory_peak
    if args.trace:
        dt = run.device_trace
        if dt is None or not dt.busy_s > 0:
            print("octa_bench: the traced run saw no device operation",
                  file=sys.stderr)
            return 5
        device["busy_s"] = dt.busy_s
        device["window_s"] = dt.window_s
    checks = result.pop("checks")
    line = dict(result, device=device)
    if args.trace and run.device_trace is not None:
        line["breakdown"] = run.device_trace.breakdown()
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
