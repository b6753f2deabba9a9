"""The control of a cell's comparison: the plain reference put in the
program's place and computed in the precision below the one the
configuration states.  Its numbers have to fail the cell's limits:

    python3 sjbench/control.py --workload <cell> --seeds 1 2 3

prints, per seed, each compared number beside its limit.  The benchmark's
own runs do not run it.
"""
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:] = [str(HERE.parent / "src"), str(HERE.parent)] + [
    p for p in sys.path if Path(p or ".").resolve() != HERE]

import torch  # noqa: E402

from sjbench import harness  # noqa: E402


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    cell = harness.Cell(harness.load_spec(), args.workload)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    kind = harness.load_module("kinds", cell.traffic["kind"])
    limits = cell.traffic["limits"]
    failed_all = True
    for seed in args.seeds:
        nums = kind.control(cell, seed, torch.device("cuda", 0))
        fails = [k for k, v in nums.items() if v > limits[k]]
        failed_all &= bool(fails)
        print(json.dumps({"workload": cell.name, "seed": seed, "control": nums,
                          "limits": limits, "fails": fails}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
