"""The port's benchmark: one run of one cell.

    python port_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line (the last of standard output) with `correct`,
`attempted`, `failed`, `metrics`, `device` (and with --trace 1
`breakdown`), the compared numbers under `check`, and those numbers beside
their limits as the last lines of standard error. Exits non-zero with no
result where there is no CUDA card, or where a JAX module was loaded.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from harness.run import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
