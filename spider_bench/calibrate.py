"""Readings that a cell's limits are set from, on the card, in one process.

    python3 spider_bench/calibrate.py --workload solve.box-2d1r.sptc \
        --seeds 12 --control-seeds 3 --seconds 2 --first-seed 4000000000

Runs the cell's timed path on ``--seeds`` seeds (the lower reading of each
number compared is the largest of these), then the reference put in the
program's place in each lower precision on ``--control-seeds`` seeds (the
upper reading is the smallest of these), each run with a short window at
the cell's own sizes and load.  Prints one JSON line per run and a summary.
The benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CONTROLS = ("tf32", "bfloat16")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(1, str(ROOT / "src"))
    from sbench.harness import run_cell

    readings = {}
    runs = [(None, args.first_seed + i) for i in range(args.seeds)]
    runs += [(c, args.first_seed + 1000 + i) for c in CONTROLS
             for i in range(args.control_seeds)]
    for control, seed in runs:
        t = time.perf_counter()
        r = run_cell(ROOT, args.workload, seed, args.seconds, False,
                     device=args.device, control=control)
        for name, c in r["checks"].items():
            readings.setdefault((name, control), []).append(c["value"])
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": control, "correct": r["correct"],
                          "checks": r["checks"],
                          "wall_s": time.perf_counter() - t}), flush=True)
    summary = {}
    for (name, control), vals in readings.items():
        vals = [v for v in vals if v is not None]
        key = f"{name}.{control or 'program'}"
        summary[key] = {"n": len(vals), "min": min(vals, default=None),
                        "max": max(vals, default=None)}
    print(json.dumps({"workload": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
