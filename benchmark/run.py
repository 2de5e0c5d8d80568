#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line:

    python3 benchmark/run.py --workload sst-serve --seed 7 --seconds 30 --trace 0

from the root of a checkout on a machine with a CUDA device. The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
``checks``: each number that decided ``correct`` beside its limit, which
also close standard error). See ``benchmark/harness.py``.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
