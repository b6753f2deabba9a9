"""Run the nine example twins (``examples/*_torch.py``) on the CUDA card,
each at its default size in a process of its own, and time each one.

Each twin runs as ``python examples/<name>_torch.py`` with no arguments
(its defaults: the reference's sizes, the card); ``distributed_scaleout``
also runs with ``--subprocess`` (its workers as child processes).  Prints
each run's wall seconds (host clock around the whole process: the
interpreter's start, the imports and the kernels' first use included),
its last lines, and one JSON line of the seconds; writes every run's full
output under ``--log-dir`` when given.  Exits 1 when a twin fails.

    python3 tools/examples_timing.py [--log-dir DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
RUNS = (("quickstart", ()), ("serve_decode", ()), ("batched_queries", ()),
        ("serve_estimates", ()), ("equal_space_serving", ()), ("planner_admission", ()),
        ("observability", ()), ("join_contamination", ()), ("distributed_scaleout", ()),
        ("distributed_scaleout", ("--subprocess",)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds a run")
    args = ap.parse_args(argv)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT / "src")] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH")
                               else []))}
    seconds, failed = {}, []
    for name, extra in RUNS:
        tag = name + "".join(extra).replace("--", "_")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(ROOT / "examples" / f"{name}_torch.py"),
                               *extra], capture_output=True, text=True, env=env, cwd=ROOT,
                              timeout=args.timeout)
        seconds[tag] = time.perf_counter() - t0
        if args.log_dir:
            os.makedirs(args.log_dir, exist_ok=True)
            Path(args.log_dir, f"{tag}.log").write_text(proc.stdout + proc.stderr)
        tail = "\n".join("    " + line for line in proc.stdout.splitlines()[-6:])
        print(f"{tag}: exit {proc.returncode} in {seconds[tag]:.2f} s\n{tail}", flush=True)
        if proc.returncode != 0:
            failed.append(tag)
            print(proc.stderr[-3000:], flush=True)
    print(json.dumps({"seconds": seconds, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
