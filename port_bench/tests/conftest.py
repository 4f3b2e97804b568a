"""The benchmark's own tests (python -m pytest port_bench/tests): the
checkout's root and port_bench/ on the path, as port_bench/run.py sets it."""
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (os.path.dirname(BENCH), BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)
