"""Runs one cell of the benchmark once; see ``perfbench/harness/cli.py``.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout of the repository, on a machine with a card.
"""
import time

T_PROCESS = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

if __name__ == "__main__":
    from perfbench.harness import cli
    sys.exit(cli.main(T_PROCESS))
