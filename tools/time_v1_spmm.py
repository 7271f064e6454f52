#!/usr/bin/env python3
"""Time the v1 compressed SpMM kernel (``csrc/sptc_spmm.cu``) on the card.

    python3 tools/time_v1_spmm.py [SRC ...]

For each source tree given (a ``src`` directory holding ``repro_torch``;
default: this checkout's), in a child process each: build the kernels from
it, then, for every spec of the paper suite at the paper's size (10240 x
10240 float32 grids, 104,857,600 points for 1-D), take the swapped windows
of the spec's sptc plan (``tile_windows(x2d, n_out, L, order=perm)``, as
``chip_smoke.py``'s phase 4 does), check the kernel against its plain
version (float32 limit 3e-5 relative to 1 + |plain|) and time it with CUDA
events (the stream held by a spin, median of 20), beside ``torch.matmul``
of the dense (L, 2L) operand on the same windows and the byte bound at
3.35 TB/s.  Giving two trees (a parent commit unpacked under ``build/``,
and this one) compares two versions on one card in one call.  Prints the
card's name and power limit first.  Needs a CUDA device.
"""
from __future__ import annotations

import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N_1D, N_2D = 104_857_600, 10_240
TOL = 3e-5
SPIN_CYCLES = 2_000_000


def _time_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def run(src: str) -> int:
    sys.path.insert(0, src)
    import torch

    from repro_torch.core.engine import StencilEngine, tile_windows
    from repro_torch.core.sptc import sptc_matmul_dense_equiv
    from repro_torch.core.stencil import paper_suite
    from repro_torch.kernels import build
    from repro_torch.kernels.sptc_spmm import ops
    from repro_torch.kernels.sptc_spmm.ref import sptc_spmm_windows_ref

    if not torch.cuda.is_available():
        print("time_v1_spmm: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    build.build()
    gen = torch.Generator(device=dev)
    for spec in paper_suite():
        r, d = spec.radius, spec.ndim
        dims = (N_1D,) if d == 1 else (N_2D, N_2D)
        gen.manual_seed(3)
        x = torch.randn(tuple(s + 2 * r for s in dims), generator=gen,
                        device=dev)
        plan = StencilEngine(spec, "cuda_sptc", device=dev).plan_ir
        if d == 1:
            x2d, n_out = x[:, None], N_1D
        elif plan.decompose.mode == "star-axis":
            x2d, n_out = x[:, r:r + N_2D], N_2D
        else:
            x2d, n_out = x[0:N_2D, :].T.contiguous(), N_2D
        L, sp = plan.L, plan.sparsify
        perm = torch.as_tensor(sp.perm, dtype=torch.int64, device=dev)
        win = tile_windows(x2d, n_out, L, order=perm)[0].contiguous()
        del x, x2d
        vals = torch.as_tensor(sp.operands[0].values, dtype=torch.float32,
                               device=dev)
        meta = torch.as_tensor(sp.operands[0].meta, device=dev)
        dense = sptc_matmul_dense_equiv(vals, meta, 2 * L)
        kern = lambda: ops.sptc_spmm_windows(vals, meta, win)
        want = sptc_spmm_windows_ref(vals, meta, win)
        diff = (kern().float() - want.float()).abs()
        rel = float((diff / (1 + want.float().abs())).max())
        del want, diff
        if not rel <= TOL:
            raise AssertionError(f"{spec.name}: max rel err {rel} > {TOL}")
        ms = _time_ms(kern, 20)
        lib_ms = _time_ms(lambda: torch.matmul(dense, win), 5)
        t, _, c = win.shape
        bound = ((win.numel() + t * L * c) * 4 + vals.numel() * 8) / 3.35e12 * 1e3
        print(f"[{src}] {spec.name} windows {tuple(win.shape)} L {L}: kernel "
              f"{ms:.4f} ms, bound {bound:.4f} ms ({100 * bound / ms:.0f} %), "
              f"torch.matmul {lib_ms:.4f} ms, max rel err {rel:.3g}",
              flush=True)
        del win, dense
        torch.cuda.empty_cache()
    return 0


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        return run(sys.argv[2])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}", flush=True)
    rc = 0
    for src in sys.argv[1:] or [str(ROOT / "src")]:
        rc |= subprocess.run([sys.executable, __file__, "--one", src]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
