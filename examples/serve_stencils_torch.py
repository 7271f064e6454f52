"""Stencil serving on the PyTorch/CUDA port: many users, small grids, one
driver — the counterpart of ``examples/serve_stencils.py``.

Simulates a wave of concurrent clients each submitting one modest grid
(different specs, jittered shapes) to a shared
``repro_torch.serving.StencilDriver`` on the card.  The driver buckets
jobs by tuner plan key, pads near-miss shapes to the bucket, executes
super-batches through ``tuned_apply_batched``, and streams results back
via futures — then prints the per-plan admission metrics (occupancy,
padding efficiency, p50/p99) and tuner cache hit rates.  Unlike the
reference example, every job's result is checked against the ``direct``
engine on the same grid, within 3e-5 * (1 + |direct|).

    PYTHONPATH=src python examples/serve_stencils_torch.py              # card
    PYTHONPATH=src python examples/serve_stencils_torch.py --device cpu
"""
import argparse
import threading
import time

import numpy as np
import torch

from repro_torch.core.engine import apply_stencil
from repro_torch.core.stencil import make_stencil
from repro_torch.device import resolve_device
from repro_torch.serving import BatchPolicy, StencilDriver

N_CLIENTS = 8
JOBS_PER_CLIENT = 6
TOL = 3e-5            # |got - direct| <= TOL * (1 + |direct|)


def client(driver, specs, seed, results, device):
    rng = np.random.default_rng(seed)
    jobs = []
    for _ in range(JOBS_PER_CLIENT):
        spec = specs[int(rng.integers(len(specs)))]
        dims = ((int(rng.integers(24, 49)), int(rng.integers(24, 49)))
                if spec.ndim == 2 else (int(rng.integers(100, 257)),))
        shape = tuple(s + 2 * spec.radius for s in dims)
        x = torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=device)
        jobs.append((spec, x, driver.submit(spec, x)))
    results[seed] = [(spec, x, f.result()) for spec, x, f in jobs]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    specs = [make_stencil("star", 2, 1, seed=1),
             make_stencil("box", 2, 2, seed=2),
             make_stencil("box", 1, 1, seed=3)]
    results = {}
    with StencilDriver(policy=BatchPolicy(max_batch=16, max_wait_ms=10.0),
                       mode="cost", device=device) as driver:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client,
                                    args=(driver, specs, s, results, device))
                   for s in range(N_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        metrics = driver.metrics()

    done = sum(len(v) for v in results.values())
    worst = 0.0
    for jobs in results.values():
        for spec, x, y in jobs:
            want = apply_stencil(spec, x, backend="direct")
            err = float(((y - want).abs() / (1 + want.abs())).max())
            worst = max(worst, err)
            assert y.shape == want.shape and err <= TOL, (
                f"{spec.name} {tuple(x.shape)}: served result off by {err}")
    o = metrics["overall"]
    print(f"served {done} jobs from {N_CLIENTS} clients in "
          f"{o['batches']} super-batches (occupancy {o['batch_occupancy']}) "
          f"in {wall:.3f}s ({done / wall:.1f} jobs/s)")
    print(f"latency p50={o['latency']['p50_ms']:.0f}ms "
          f"p99={o['latency']['p99_ms']:.0f}ms")
    for key, m in sorted(metrics["plans"].items()):
        print(f"  {key[:54]:54s} jobs={m['completed']:3d} "
              f"occ={m['batch_occupancy']:5.2f} "
              f"pad_eff={m['padding_efficiency']:.2f}")
    t = metrics["tuner"]
    print(f"tuner: plans hit rate {t['plan_hit_rate']}, "
          f"{t['tunes']} tunes, {t['engine_builds']} engine builds")
    print(f"every job vs the direct engine: max |err| / (1 + |direct|) = "
          f"{worst:.2e} (tol {TOL})")
    print("stencil serving OK")
    return {"jobs": done, "wall_s": wall, "jobs_per_s": done / wall,
            "max_rel_err": worst, "metrics": metrics}


if __name__ == "__main__":
    main()
