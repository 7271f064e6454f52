"""Iterative 2-D stencil computation (heat diffusion) on the PyTorch/CUDA
port: the counterpart of ``examples/heat_diffusion_2d.py``.

Solves u_t = alpha * laplacian(u) with an explicit Star-2D1R update on a
512x512 grid for 400 time steps through every engine backend — the plain
torch ``gemm`` and ``sptc`` paths, the hand-written CUDA kernels
(``cuda_sptc``, ``cuda_gemm``, ``cuda_direct``) and the autotuned plan
(``repro_torch.tuner``) — each held to the ``direct`` oracle
(max |u - direct| < 1e-2 after the last step), reporting GStencils/s (the
paper's metric).

    PYTHONPATH=src python examples/heat_diffusion_2d_torch.py        # card
    PYTHONPATH=src python examples/heat_diffusion_2d_torch.py --device cpu \\
        --n 64 --steps 20
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.engine import StencilEngine
from repro_torch.core.stencil import StencilSpec
from repro_torch.device import resolve_device
from repro_torch.tuner import cache_stats, tuned_engine

ALPHA = 0.2
BACKENDS = ("direct", "gemm", "sptc", "cuda_sptc", "cuda_gemm",
            "cuda_direct", "tuned")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--n", type=int, default=512, help="grid side")
    ap.add_argument("--steps", type=int, default=400)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n, steps = args.n, args.steps

    # explicit heat update: u += alpha * (sum 4-neighbours - 4u)
    w = np.zeros((3, 3))
    w[0, 1] = w[2, 1] = w[1, 0] = w[1, 2] = ALPHA
    w[1, 1] = 1 - 4 * ALPHA
    spec = StencilSpec(shape="star", ndim=2, radius=1, weights=w)

    # hot square in a cold plate
    u0 = np.zeros((n, n), np.float32)
    u0[n // 4:n // 2, n // 4:n // 2] = 100.0
    u0 = torch.as_tensor(np.pad(u0, 1), device=device)

    out = {}
    for backend in BACKENDS:
        if backend == "tuned":
            # measured plan selection, cached across calls (and across
            # processes when REPRO_TORCH_TUNER_CACHE is set)
            eng = tuned_engine(spec, u0.shape, u0.dtype, device=device)
            print(f"tuner picked backend={eng.backend} L={eng.L} "
                  f"(stats: {cache_stats()})")
        else:
            eng = StencilEngine(spec, backend=backend, device=device)
        u = eng.iterate(u0, steps=1)            # warm up
        _sync(device)
        t0 = time.perf_counter()
        u = eng.iterate(u0, steps=steps)
        _sync(device)
        dt = time.perf_counter() - t0
        rate = n * n * steps / dt / 1e9
        total = float(u.double().sum())
        print(f"{backend:11s}: {dt:6.3f}s  {rate:7.3f} GStencils/s  "
              f"sum(u)={total:.1f}")
        row = {"seconds": dt, "gstencil_s": rate, "sum": total}
        if backend == "direct":
            ref = u
        else:
            err = float((u - ref).abs().max())
            row["max_err"] = err
            print(f"{'':11s}  max|{backend} - direct| after {steps} steps = "
                  f"{err:.2e}")
            assert err < 1e-2, f"{backend} path diverged from oracle"
        out[backend] = row

    # heat is conserved up to the insulated-boundary loss
    print("heat diffusion OK")
    return out


if __name__ == "__main__":
    main()
