"""Run one cell of the benchmark once and print its result line.

    python octa_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. See ``octa_bench/README.md``.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(_ROOT)  # the checkout, not this folder

from octa_bench import harness  # noqa: E402

if __name__ == "__main__":
    os.environ.update(harness.cache_env(_ROOT))
    sys.exit(harness.main(sys.argv[1:], T_START))
