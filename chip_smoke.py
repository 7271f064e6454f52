#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one Hopper card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, holds
each kernel against its plain torch version on the card, drives the main
path (``StencilEngine`` with the ``cuda_sptc``, ``cuda_gemm`` and
``cuda_direct`` backends) over the whole paper suite at the paper's size —
10240 x 10240 float32 grids for 2-D, 104,857,600 points for 1-D — against
the ``direct`` backend on the card, times every kernel with CUDA events and
prints one JSON line per kernel family plus a final contract line.  Every
phase raises on failure; the script exits non-zero without a result when
no CUDA device (or no ``repro_torch`` package beside it) is present.
Imports nothing of JAX or of the JAX reference package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_1D = 104_857_600                   # 1-D points, = 10240 * 10240
N_2D = 10_240                        # 2-D grid edge (benchmarks/fig9_throughput.py)
HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory rate
FP32_FLOP_PER_S = 67e12              # H100 SXM float32 outside the tensor cores
TOL = 3e-5                           # f32: |got - want| <= TOL * (1 + |want|)
TOL_BF16 = 1e-2                      # bf16 storage: one output rounding step
OUT_DIR = ROOT / "chiprun_out"


def _time_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` runs after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _err(got, want, tol: float) -> float:
    """Max |got - want|; raises when any element exceeds tol * (1 + |want|)."""
    d = (got.float() - want.float()).abs()
    bad = d > tol * (1 + want.float().abs())
    if bool(bad.any()) or not bool(got.isfinite().all()):
        raise AssertionError(f"mismatch: max |err| {float(d.max())} over "
                             f"{int(bad.sum())} elements (tol {tol})")
    return float(d.max())


def _bound_ms(bytes_moved: float, flops: float):
    t_mem = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return max(t_mem, t_ops), ("bytes" if t_mem >= t_ops else "operations")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.core.engine import StencilEngine, _windows
    from repro_torch.core.sparsify import sparsify_stencil_kernel
    from repro_torch.core.stencil import paper_suite
    from repro_torch.kernels import build
    from repro_torch.kernels.sptc_spmm import ops as sptc_ops
    from repro_torch.kernels.sptc_spmm.ref import sptc_fused_ref
    from repro_torch.kernels.stencil_direct import ops as direct_ops
    from repro_torch.kernels.stencil_direct.ref import stencil2d_ref
    from repro_torch.kernels.stencil_gemm import ops as gemm_ops
    from repro_torch.kernels.stencil_gemm.ref import windows_gemm_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("precision: torch.backends.cuda.matmul.allow_tf32 = False, "
          "torch.backends.cudnn.allow_tf32 = False (full float32 for the "
          "plain versions and the F.conv2d yardstick)")
    dev = torch.device("cuda", 0)
    f32 = torch.float32
    gen = torch.Generator(device=dev)
    results: dict = {"kernels": {}, "specs": {}}

    def randn(*shape, dtype=f32, seed=0):
        gen.manual_seed(seed)
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    # -- phase 1: build -----------------------------------------------------
    t0 = time.perf_counter()
    log = build.build()
    build.library()
    print(f"phase 1 build: {time.perf_counter() - t0:.1f} s "
          f"({build.library_path().name})")
    for line in log.splitlines():
        if "registers" in line or line.startswith("["):
            print("  ptxas", line.strip())

    # -- phase 2: every kernel against its plain version on the card --------
    rng = np.random.default_rng(0)
    worst = {"sptc": 0.0, "gemm": 0.0, "direct": 0.0}
    cases = {"sptc": 0, "gemm": 0, "direct": 0}
    for r in (1, 2, 3):
        sk = sparsify_stencil_kernel(rng.normal(size=2 * r + 1))
        L = sk.L
        n_out = 5 * L + 3
        for c in (1, 37, 300):
            for star in (True, False):
                for dt, comp in ((f32, None), (f32, torch.bfloat16),
                                 (torch.bfloat16, None)):
                    op = sptc_ops.fused_operand(sk.sparse, sk.perm, L,
                                                star_fast=star, dtype=dt,
                                                device=dev)
                    big = randn(n_out + 2 * r, c + 5, dtype=dt, seed=c + r)
                    x2d = big[:, 2:2 + c]            # row stride != C
                    got = sptc_ops.sptc_spmm_fused(op, x2d, n_out=n_out,
                                                   compute_dtype=comp)
                    want = sptc_fused_ref(op.values, op.meta_words, x2d,
                                          n_out=n_out, L=L, star_fast=star,
                                          compute_dtype=comp)
                    tol = TOL if dt == f32 else TOL_BF16
                    worst["sptc"] = max(worst["sptc"], _err(got, want, tol))
                    cases["sptc"] += 1
    for L in (4, 6, 8, 16):
        for c in (1, 37, 300):
            for dt in (f32, torch.bfloat16):
                km = randn(L, 2 * L, dtype=dt, seed=L)
                win = randn(7, 2 * L, c, dtype=dt, seed=c)
                got = gemm_ops.windows_gemm(km, win)
                tol = TOL if dt == f32 else TOL_BF16
                worst["gemm"] = max(worst["gemm"],
                                    _err(got, windows_gemm_ref(km, win), tol))
                cases["gemm"] += 1
    for spec in paper_suite():
        r = spec.radius
        taps = direct_ops.stencil_taps(spec.weights, dev)
        for dt in (f32, torch.bfloat16):
            tol = TOL if dt == f32 else TOL_BF16
            if spec.ndim == 1:
                x = randn(1000 + 2 * r, dtype=dt, seed=r)
                got = direct_ops.stencil1d(taps, x)
                want = stencil2d_ref(taps.host, x[None], 0, r)[0]
            else:
                x = randn(3, 37 + 2 * r, 300 + 2 * r, dtype=dt, seed=r)
                got = direct_ops.stencil2d(taps, x)
                want = stencil2d_ref(taps.host, x, r, r)
            worst["direct"] = max(worst["direct"], _err(got, want, tol))
            cases["direct"] += 1
    torch.cuda.synchronize()
    for k in worst:
        print(f"phase 2 {k}: {cases[k]} small cases, max |err| vs plain "
              f"{worst[k]:.3g} (tol {TOL} f32, {TOL_BF16} bf16, relative to "
              f"1 + |plain|)")

    # -- phase 3: the main path at full width --------------------------------
    suite = paper_suite()
    backends = ("cuda_sptc", "cuda_gemm", "cuda_direct")
    counters = {"cuda_sptc": sptc_ops.sptc_spmm_fused,
                "cuda_gemm": gemm_ops.windows_gemm,
                "cuda_direct": direct_ops.stencil2d}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    for spec in suite:
        r = spec.radius
        dims = (N_1D,) if spec.ndim == 1 else (N_2D, N_2D)
        x = randn(*(s + 2 * r for s in dims), seed=17 * spec.ndim + r)
        want = StencilEngine(spec, "direct", device=dev)(x)
        errs = {}
        for b in backends:
            got = StencilEngine(spec, b, device=dev)(x)
            if tuple(got.shape) != dims:
                raise AssertionError(f"{spec.name} {b}: shape {got.shape}")
            errs[b] = _err(got, want, TOL)
            del got
        results["specs"][spec.name] = {"max_abs_err_vs_direct": errs}
        print(f"phase 3 {spec.name} {'x'.join(map(str, dims))}: max |err| vs "
              f"direct " + " ".join(f"{b}={e:.3g}" for b, e in errs.items()))
        del x, want
    box3 = next(s for s in suite if s.name == "box-2d3r")
    r = box3.radius
    x = randn(N_2D + 2 * r, N_2D + 2 * r, seed=5)
    ref_eng = StencilEngine(box3, "direct", device=dev)
    want_it = ref_eng.iterate(x, 10)
    x2 = F.pad(x, (r,) * 4)                              # 2r halo for k = 2
    want_k2 = ref_eng(ref_eng(x2))
    want_blk = x                     # k = 2: two raw steps per re-pad
    for _ in range(5):
        want_blk = F.pad(ref_eng(ref_eng(want_blk)), (2 * r,) * 4)
    for b in backends:
        e_it = _err(StencilEngine(box3, b, device=dev).iterate(x, 10),
                    want_it, TOL)
        e_k2 = _err(StencilEngine(box3, b, device=dev, temporal_steps=2)(x2),
                    want_k2, TOL)
        e_k2it = _err(StencilEngine(box3, b, device=dev,
                                    temporal_steps=2).iterate(x, 10),
                      want_blk, TOL)
        print(f"phase 3 box-2d3r {b}: iterate(10) max |err| {e_it:.3g}, "
              f"temporal_steps=2 {e_k2:.3g}, k=2 iterate(10) {e_k2it:.3g}")
    del x, x2, want_it, want_k2, want_blk
    torch.cuda.synchronize()
    launches = {b: fn.launches for b, fn in counters.items()}
    print(f"phase 3 main path: {time.perf_counter() - t0:.1f} s, kernel "
          f"launches {launches}")
    for b, n in launches.items():
        if n == 0:
            raise AssertionError(f"main path never launched the {b} kernel")

    # -- phase 4: timing at the main path's shapes ---------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    rows = {}
    for spec in suite:
        r, d = spec.radius, spec.ndim
        dims = (N_1D,) if d == 1 else (N_2D, N_2D)
        pts = float(np.prod(dims))
        x = randn(*(s + 2 * r for s in dims), seed=3)
        line = {}
        # the first 1-D application the engine makes for this spec
        eng = StencilEngine(spec, "cuda_sptc", device=dev)
        plan = eng.plan_ir
        mode = plan.decompose.mode
        if d == 1:
            x2d, n_out = x[:, None], N_1D
        elif mode == "star-axis":
            x2d, n_out = x[:, r:r + N_2D], N_2D        # strided view, no copy
        else:
            x2d, n_out = x[0:N_2D, :].T.contiguous(), N_2D   # engine's copy
        w1 = plan.decompose.kernels[0]
        sp = plan.sparsify
        fop = sptc_ops.fused_operand(
            sp.operands[0], sp.perm, plan.L,
            star_fast="auto" if mode in ("single", "star-axis") else False,
            dtype=f32, device=dev)
        rows_in, c = x2d.shape
        conv_w = torch.as_tensor(np.asarray(w1), dtype=f32,
                                 device=dev).reshape(1, 1, -1, 1)
        conv_in = x2d.reshape(1, 1, rows_in, c)
        app = {
            "sptc": (lambda: sptc_ops.sptc_spmm_fused(fop, x2d, n_out=n_out),
                     lambda: sptc_fused_ref(fop.values, fop.meta_words, x2d,
                                            n_out=n_out, L=plan.L,
                                            star_fast=fop.star_fast)),
        }
        km = torch.as_tensor(
            StencilEngine(spec, "cuda_gemm", device=dev).plan_ir.kernel
            .matrices[0], dtype=f32, device=dev)
        win = _windows(x2d, n_out, plan.L)[0].contiguous()
        app["gemm"] = (lambda: gemm_ops.windows_gemm(km, win),
                       lambda: windows_gemm_ref(km, win))
        taps = direct_ops.stencil_taps(spec.weights, dev)
        xd = x[None] if d == 1 else x
        app["direct"] = (lambda: direct_ops.stencil2d(taps, xd),
                         lambda: stencil2d_ref(taps.host, xd, taps.rh,
                                               taps.rw))
        full_w = torch.as_tensor(np.asarray(spec.weights), dtype=f32,
                                 device=dev)
        full_w = full_w.reshape(1, 1, 1, -1) if d == 1 else full_w[None, None]
        full_in = x.reshape(1, 1, 1, -1) if d == 1 else x[None, None]
        lib = {"sptc": lambda: F.conv2d(conv_in, conv_w),
               "gemm": lambda: F.conv2d(conv_in, conv_w),
               "direct": lambda: F.conv2d(full_in, full_w)}
        for k, (kern, plain) in app.items():
            got, want = kern(), plain()
            err = _err(got, want, TOL)
            if k == "gemm":                  # tiles -> the (n_out, C) output
                got = got.reshape(-1, c)[:n_out]
            lib_err = float((lib[k]().reshape(got.shape) - got).abs().max())
            del got, want
            ms = _time_ms(kern, 20)
            plain_ms = _time_ms(plain, 5)
            library_ms = _time_ms(lib[k], 20)
            if k == "sptc":
                nbytes = (x2d.shape[0] * c + n_out * c) * 4
                flops = 2.0 * -(-n_out // plan.L) * c * \
                    int(torch.count_nonzero(fop.values))
                shape = f"x2d {tuple(x2d.shape)} n_out {n_out} L {plan.L} " \
                        f"star_fast {fop.star_fast}"
            elif k == "gemm":
                nbytes = (win.numel() + km.numel() + win.shape[0] * plan.L * c) * 4
                flops = 2.0 * win.shape[0] * c * km.numel()
                shape = f"windows {tuple(win.shape)} km {tuple(km.shape)}"
            else:
                nbytes = (x.numel() + pts) * 4
                flops = 2.0 * pts * len(taps.host)
                shape = f"x {tuple(xd.shape)} taps {len(taps.host)}"
            bound, by = _bound_ms(nbytes, flops)
            line[k] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                       "bound_ms": bound, "bound_by": by, "max_abs_err": err,
                       "library_max_abs_diff": lib_err, "shape": shape}
            print(f"timing {spec.name} {k}: kernel_ms {ms:.4f} plain_ms "
                  f"{plain_ms:.4f} library_ms(F.conv2d) {library_ms:.4f} "
                  f"bound_ms {bound:.4f} ({by}) launches "
                  f"{launches['cuda_' + k]} | {shape} | card {smi}")
        del app, lib, win, x2d, conv_in
        # end to end: engine GStencil/s for each backend, F.conv2d beside it
        conv_ms = _time_ms(lambda: F.conv2d(full_in, full_w), 10)
        e2e = {}
        for b in ("direct",) + backends:
            counters_before = {n: f.launches for n, f in counters.items()}
            eng = StencilEngine(spec, b, device=dev)
            eng(x)
            per_call = {n: f.launches - counters_before[n]
                        for n, f in counters.items()}
            e_ms = _time_ms(lambda: eng(x), 10)
            kern_ms = sum(per_call.get(f"cuda_{k}", 0) * line[k]["ms"]
                          for k in line) if b != "direct" else None
            e2e[b] = {"ms": e_ms, "gstencil_s": pts / e_ms / 1e6,
                      "launches_per_call": per_call.get(b),
                      "outside_kernel_share": (None if kern_ms is None else
                                               max(0.0, 1 - kern_ms / e_ms))}
        if d == 2:
            # the transposed copies cuda_sptc's engine makes: stencil axis
            # last ("rows" ops, star axis 1) is a unit row stride
            def copies():
                for op in plan.decompose.ops:
                    if mode == "rows" or op.axis == 1:
                        u = op.lead[0] if mode == "rows" else r
                        x[u:u + N_2D, :].T.contiguous()
            copy_ms = _time_ms(copies, 10)
            e2e["cuda_sptc"]["transpose_copy_ms"] = copy_ms
            e2e["cuda_sptc"]["transpose_copy_share"] = \
                copy_ms / e2e["cuda_sptc"]["ms"]
        line["engine"] = e2e
        line["conv2d"] = {"ms": conv_ms, "gstencil_s": pts / conv_ms / 1e6}
        rows[spec.name] = line
        print(f"engine {spec.name}: " + " ".join(
            f"{b}={v['gstencil_s']:.2f} GStencil/s ({v['ms']:.3f} ms"
            + ("" if v["outside_kernel_share"] is None else
               f", {v['launches_per_call']} launches, outside-kernel "
               f"{100 * v['outside_kernel_share']:.0f}%") + ")"
            for b, v in e2e.items())
            + f" | F.conv2d={pts / conv_ms / 1e6:.2f} GStencil/s "
              f"({conv_ms:.3f} ms)"
            + ("" if d == 1 else f" | cuda_sptc transpose copies "
               f"{e2e['cuda_sptc']['transpose_copy_ms']:.3f} ms "
               f"({100 * e2e['cuda_sptc']['transpose_copy_share']:.0f}% of "
               f"the call)") + f" | card {smi}")
        del x, full_in, eng
        torch.cuda.empty_cache()
    results["timing"] = rows

    # -- phase 5: summary -----------------------------------------------------
    canon = "box-2d1r"          # the canonical shape of the kernels line
    meta = {"sptc": ("cuda_sptc", "src/repro_torch/kernels/csrc/sptc_fused.cu",
                     "src/repro/kernels/sptc_spmm/kernel.py:112"),
            "gemm": ("cuda_gemm", "src/repro_torch/kernels/csrc/windows_gemm.cu",
                     "src/repro/kernels/stencil_gemm/kernel.py:24"),
            "direct": ("cuda_direct",
                       "src/repro_torch/kernels/csrc/stencil_direct.cu",
                       "src/repro/kernels/stencil_direct/kernel.py:28")}
    kernels = []
    for k, (name, src, repl) in meta.items():
        t = rows[canon][k]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": repl, "launches": launches[name],
                        "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"],
                        "shape": f"{canon}: {t['shape']}"})
    results["kernels"] = kernels
    results["card"] = smi
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_results.json").write_text(json.dumps(results,
                                                                indent=1))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
