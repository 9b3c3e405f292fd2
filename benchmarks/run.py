"""Run one cell of the benchmark once and print its result line.

    python benchmarks/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; see
``harness/runtime.py`` for how its files are found and what a run does.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from harness import runtime  # noqa: E402

if __name__ == "__main__":
    sys.exit(runtime.main())
