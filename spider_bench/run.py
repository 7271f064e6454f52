"""Run one cell of repro_torch's benchmark once, on the card this process sees.

    python3 spider_bench/run.py --workload solve.box-2d1r.sptc --seed 7 \
        --seconds 30 --trace 0

Run from the root of a checkout.  The last line of standard output is the
result as one JSON object; the last lines of standard error are each number
the check compared, beside its limit.  ``--trace 1`` reports the cell's
per-layer metrics from a profiled window instead of its end-to-end ones.
Exits non-zero, printing no result, when there is no card (or fewer than
the cell asks for), or when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "spider_bench" / ".cache"


def _environment() -> None:
    """Every cache of the program at a fixed path inside the checkout, and
    the port's sources on the path."""
    os.environ["REPRO_TORCH_TUNER_CACHE"] = str(CACHE / "tuner_plans.json")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    sys.path.insert(1, str(ROOT / "src"))


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _environment()

    import torch
    from sbench.harness import run_cell
    from sbench.layout import Layout, forbidden_modules

    chips = Layout(ROOT).workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this process "
              f"sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", t_start=T_START)
    found = forbidden_modules(list(sys.modules))
    if found:
        print(f"the process loaded {found}: the benchmark measures "
              "repro_torch alone", file=sys.stderr)
        return 3
    print(f"card: {_power_limit()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
