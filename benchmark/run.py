"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads, warms up, measures for ``--seconds`` and prints one JSON line last
(see ``harness.py``).  Stops with a message, and prints no result, without
the CUDA devices the cell asks for or without the program beside
``benchmark/``.
"""

import time

T_PROCESS = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_PROCESS))
