"""Every file a cell needs is found by its name and parses; the benchmark
file keeps to its contract's shape."""
import json
import re

import pytest

from octa_bench import harness

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = harness.Cell(name)
    assert cell.driver_path.is_file()
    assert set(cell.limits) and all(v is not None for v in cell.limits.values())
    assert cell.config["networks"] and cell.config["run"]
    ends = {m["name"] for m in cell.end_to_end()}
    assert "setup_s" in ends and len(ends) >= 2
    layers = cell.per_layer()
    assert layers
    for m in layers:
        assert (harness.BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in ends
        mod = harness.load_module(harness.BENCH_DIR / "metrics"
                                  / f"{m['name']}.py", "m")
        assert callable(mod.read)


def test_benchmark_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["octa_bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in SPEC[k]}) == len(SPEC[k])
    assert len({m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}) \
        == len(SPEC["end_to_end"]) + len(SPEC["per_layer"])
    for c in SPEC["configs"]:
        assert (harness.ROOT / c["file"]).is_file()
        assert c["file"].startswith("octa_bench/")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


def test_traffic_and_config_files_parse():
    for d in ("traffic", "configs", "limits"):
        for f in (harness.BENCH_DIR / d).glob("*.json"):
            json.loads(f.read_text())
    for f in (harness.BENCH_DIR / "traffic").glob("*.json"):
        kind = json.loads(f.read_text())["kind"]
        assert (harness.BENCH_DIR / "drivers" / f"{kind}.py").is_file()


def test_unknown_cell_is_refused():
    with pytest.raises(harness.CellError):
        harness.Cell("no_such.cell")
