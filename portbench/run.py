"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and ``checks`` last: each number the
reference compared, beside its limit); the last lines of standard error
repeat the checks. Without a CUDA card, or with fewer than the cell asks
for, it prints no result and exits non-zero.
"""
import time

T_START = time.perf_counter()

import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
# the benchmark's modules import as the package ``portbench``, never as top-level names
sys.path[:] = [p for p in sys.path if pathlib.Path(p or ".").resolve() != HERE]
sys.path.insert(0, str(HERE.parent))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
