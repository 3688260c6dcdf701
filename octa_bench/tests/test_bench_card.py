"""On the card, at each cell's own size: the control (the reference one
precision below the configuration's, in the program's place) comes out not
correct while the program comes out correct. Run on a machine with the
card: ``python -m pytest octa_bench -m card``."""
import json
import subprocess
import sys

import pytest
import torch

from octa_bench import harness

CELLS = [w["name"] for w in json.loads(
    (harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(name, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = tmp_path / "readings.jsonl"
    subprocess.run([sys.executable, "octa_bench/calibrate.py", "--workload",
                    name, "--control-seeds", "31337", "--seconds", "1",
                    "--out", str(out)], cwd=harness.ROOT, check=True,
                   timeout=1200)
    line = json.loads(out.read_text().splitlines()[-1])
    limits = harness.Cell(name).limits
    assert harness.judge(list(line["program"].items()), limits)[0]
    assert not harness.judge(list(line["control"].items()), limits)[0]
