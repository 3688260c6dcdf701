"""Nothing the runner loads is JAX's or the JAX package's, by top-level
names compared whole; the runner refuses to run without a card or
without the program."""
import os
import shutil
import subprocess
import sys

from octa_bench import harness

CHILD = r"""
import sys, time
sys.path[0] = {root!r}
from octa_bench import harness
from octa_bench.tests import tiny
for d in ("drivers", "metrics", "reference"):
    for f in sorted((harness.BENCH_DIR / d).glob("*.py")):
        harness.load_module(f, "x_" + f.stem.replace(".", "_"))
res = tiny.run("gan_ves_seg.segment")
print("FORBIDDEN", harness.forbidden_loaded())
"""


def test_whole_names():
    assert harness.forbidden_loaded({"octa_tpu_torch.models": 1,
                                     "jaxtyping": 1, "flaxen": 1}) == []
    assert harness.forbidden_loaded({"octa_tpu.ops": 1, "jax.numpy": 1}) \
        == ["jax", "octa_tpu"]


def test_nothing_loaded_is_jax():
    out = subprocess.run([sys.executable, "-c",
                          CHILD.format(root=str(harness.ROOT))],
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "octa_bench/run.py", "--workload",
                          "gan_ves_seg.segment", "--seed", str(2 ** 40),
                          "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_alone_is_refused(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "octa_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "octa_bench/run.py", "--workload",
                          "gan_ves_seg.segment", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
