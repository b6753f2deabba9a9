"""Run one cell of the benchmark once:

    python3 sjbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the result as the last line of
standard output, and each compared number with its limit as the last lines
of standard error.
"""
import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
# the checkout's root (for ``sjbench``) and ``src`` (for the program); not
# this folder, whose module names would shadow the standard library's
sys.path[:] = [str(HERE.parent / "src"), str(HERE.parent)] + [
    p for p in sys.path if Path(p or ".").resolve() != HERE]

from sjbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
