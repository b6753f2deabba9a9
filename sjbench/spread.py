"""Run a cell several times, one process a run, and report each metric's
spread: the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) as a share of the median.

    python3 sjbench/spread.py --workload <cell> --seeds 1 2 3 4 5 6 --sets 2 \
        [--seconds 20] [--trace 0] [--out <dir>]

Each set runs every seed once, in order; the sets use the same seeds.  The
summary, one JSON line a metric, gives each set's median and spread, the
wider spread, and the spread with each set's run farthest from its median
left out.  Every run's result line is printed as it comes, and, with
``--out``, its output is kept there.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def spread(values):
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else float("inf")


def trimmed(values):
    """``values`` without the one farthest from their median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args()
    spec = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    seconds = args.seconds or spec["run_seconds"]
    out = Path(args.out) if args.out else None
    if out:
        out.mkdir(parents=True, exist_ok=True)
    sets = []
    for k in range(args.sets):
        runs = []
        for seed in args.seeds:
            cmd = [sys.executable, str(HERE / "run.py"), "--workload", args.workload,
                   "--seed", str(seed), "--seconds", str(seconds), "--trace", str(args.trace)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True, cwd=HERE.parent)
            wall = time.perf_counter() - t0
            if out:
                stem = out / f"{args.workload}.set{k}.{seed}"
                stem.with_suffix(".out").write_text(proc.stdout)
                stem.with_suffix(".err").write_text(proc.stderr)
            lines = proc.stdout.strip().splitlines()
            result = json.loads(lines[-1]) if proc.returncode == 0 and lines else None
            print(json.dumps({"set": k, "seed": seed, "rc": proc.returncode,
                              "wall_s": round(wall, 3), "result": result}), flush=True)
            if result is None:
                print(proc.stderr[-3000:], file=sys.stderr)
                continue
            runs.append(result)
        sets.append(runs)
    names = sorted({m for runs in sets for r in runs for m in r["metrics"]})
    for name in names:
        per = [[r["metrics"][name]["value"] for r in runs if name in r["metrics"]]
               for runs in sets]
        per = [v for v in per if len(v) >= 3]
        if not per:
            continue
        print(json.dumps({
            "metric": name,
            "medians": [statistics.median(v) for v in per],
            "spreads": [spread(v) for v in per],
            "widest": max(spread(v) for v in per),
            "trimmed_mean": statistics.mean(spread(trimmed(v)) for v in per)
            if all(len(v) >= 4 for v in per) else None,
            "all_runs": spread([x for v in per for x in v]),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
