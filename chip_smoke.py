#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one Hopper card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, finds
sparse tensor-core instructions in the SASS of the SpTC kernels and dense
ones in the windows GEMM's, holds each kernel against its plain torch
version on the card (the windows GEMM in each of its modes, at the
paper's 1-D shapes, and with a planted fault: its 3xTF32 lo terms
dropped; the 2-D rows kernel with a box engine's own tables on every L
the tuner offers, and with its row offsets reversed; the 2-D star kernel
with a star engine's own tables on every even L from 2r + 2 to 16, and
with its two axis operands swapped), and drives
fifteen paths and the five examples, each with the launch counters set to
0 just before it and read just after:

* the stencil engine (``StencilEngine`` with the ``cuda_sptc``,
  ``cuda_gemm`` and ``cuda_direct`` backends) over the whole paper suite at
  the paper's size — 10240 x 10240 float32 grids for 2-D, 104,857,600
  points for 1-D — against the ``direct`` backend on the card, and
  ``iterate`` on the benchmark cells' engines, each step written in place,
  against the re-pad loop bit for bit;
* the v1 compressed SpMM entry (``apply_sptc_v1``, one
  ``sptc_spmm_windows`` launch per row op) applying box-2d1r at
  10240 x 10240 from swapped windows, against ``direct``;
* the tuner (``plan_for`` in time mode on a fresh ``PlanCache``, then
  ``tuned_apply``) over the paper suite at the same size: every candidate
  kernel timed, a ``cuda_*`` plan for each spec, the tuned output against
  ``direct``, and the plans saved under ``build/`` and read back without a
  tune;
* stencil serving: ``StencilDriver`` fed by 8 client threads of 12 jobs each
  (star-2d1r and box-2d2r grids of edge 1025-2048, box-1d1r lengths of
  2-4 M points), every job against ``direct``, and each super-batch's
  kernel launches held to its plan's row ops;
* the halo-exchange engine (``ShardedStencilEngine``) with every shard on
  this card: the 2-D paper suite at 10240 x 10240 on meshes (2,) and
  (2, 2), a non-divisible 10237 x 10239 grid, the 1-D box at 104,857,600
  points on (4,), ``tuned_apply`` and ``StencilDriver`` with a mesh; every
  output against the single-device engine, and each step's launches held
  to (1 interior + 2 rims per partitioned axis) x the plan's launches;
* serving ``mamba2-2.7b`` at full width and depth (64 layers, bf16, random
  weights from a seed) through ``GenerateDriver``: 8 requests of 512-token
  prompts, 32 new tokens each, with the causal-conv1d kernel in every
  layer of every prefill;
* serving the hybrid ``zamba2-2.7b`` the same way (54 Mamba2 layers in 9
  groups of 6, one weight-shared attention/MLP block after each group,
  bf16, 2,422,670,240 random parameters): the conv kernel in all 54
  layers of every prefill, the shared block's K/V in ring caches; before
  it, the model cut to 12 layers holds the kernel against its plain
  version and prefill-then-decode against forward, with the ring wrapped;
* serving the dense ``qwen3-1.7b`` (28 layers, 1,720,574,976 parameters)
  and the MoE ``granite-moe-3b-a800m`` (32 layers, 40 experts top-8,
  3,298,793,472 parameters) the same way, at full width and depth in
  bf16 (Qwen3 also served a second time with its parameters as DTensors
  on the one-rank ``nccl`` host mesh, ``GenerateDriver`` inside
  ``use_mesh_rules``: the plain run's tokens, decode ms, idle share);
  before each, its 2-layer cut at full width in float32 holds
  prefill-then-decode against forward through a full and a wrapped ring
  (the MoE's cut drop-free); the profile splits out the attention core's
  and the MoE's device time, and the MoE's prefill reports the share of
  (token, choice) pairs its capacity drops;
* ``phi3-mini-3.8b``, ``starcoder2-7b`` and ``chatglm3-6b`` at full width
  and depth and ``mixtral-8x22b`` at full width cut to 4 of its 56 layers
  (281 GB in bf16 whole), one at a time: the parameter count, a 4 x 512
  prefill with finite logits and 8 greedy decode steps, timed;
* serving the enc-dec ``whisper-large-v3`` (32 + 32 layers,
  1,645,061,120 parameters) and the VLM ``llama-3.2-vision-11b`` (40 self
  layers and 8 tanh-gated cross layers, 11,520,053,256 parameters) as the
  dense model is served, each request with its own memory — (1500, 1280)
  frame or (1600, 4096) patch embeddings, the stub front ends' output;
  before each, its cut at full width in float32 (2 + 2 layers; 10 layers,
  two groups, the gates set non-zero) holds prefill-then-decode against
  forward through a full and a wrapped ring, and a planted fault (another
  memory) must move its logits; the profile splits out the
  cross-attention's and the encoder's device time;
* training ``qwen3-1.7b`` at full size (1,720,574,976 parameters, bf16,
  remat ``full``) through ``repro_torch.launch.train.main`` over the host
  mesh (one rank on ``nccl``, the state DTensors): 8 steps of 8 x 512
  tokens in 2 microbatches, the losses finite and falling, step time,
  tokens/s, peak memory and a profiled step with its NCCL kernels
  counted; then kill-and-resume of its
  bf16 smoke config through the launcher's checkpoints, bit for bit under
  deterministic algorithms, and every arch's smoke config trained 2 steps
  on the card against the CPU (Mamba2 and Zamba2 with ``use_kernels`` on
  must refuse to train: the conv kernel has no backward);
* the fleet dry-run (``python -m repro_torch.launch.dryrun``, in child
  processes): five cells of the ten archs traced on DTensors over a fake
  256- or 512-card H100 fleet, each record printed as a prediction; and
  its check on this card — Qwen3-1.7B's phase-train cell traced on a
  (1, 1) mesh must predict the argument bytes and FLOPs of one real step
  on the card exactly and its peak within 25 % of phase train's
  ``max_memory_allocated``;
* the examples, ``examples/{quickstart,heat_diffusion_2d,serve_stencils,
  serve_batched,train_lm}_torch.py``, each through its ``main`` at its own
  size (``train_lm`` 50 steps): quickstart's backends and heat diffusion's
  seven paths against ``direct`` (GStencil/s), every served stencil job
  against ``direct`` (jobs/s), Mamba2 served through the conv kernel and
  against ``use_kernels=False``, and training over the host mesh.

Phase vet also plants one retake: the first trace of one full-size audit
loses its markers, and the audit's launches must count the retaken call.
It reads the verifier's settings through ``load_config`` (the repo's
pyproject has no ``[tool.repro-torch-vet]`` block: the defaults), and
runs ``python -m repro_torch.vet`` three times on the card under a block
that re-ranks ``lowering-hot-gather`` (``VET_BLOCK``): the exit codes
and findings each severity must give.
Every profile is the launch audit's trace (``vet.lowering.trace_device``:
spins at its head and one at its tail, a trace that lost either end or a
counted kernel retaken), and holds the kernels it records to the
wrappers' launch counters.  The trace check after training runs with no
process group alive and reports any audit trace that lost device ops: the
ops by name and place, and which of its ends it kept.

The dense, MoE, enc-dec and VLM families reach no Pallas kernel in the
reference, so their five phases launch no kernel of the port, and each
checks that the conv kernel was launched no time; nor does training (the
reference trains on the plain conv).

It times every kernel with CUDA events at the paths' shapes and prints the
card, a ``kernels`` JSON line and a final contract line.  Every phase
raises on failure; the script exits non-zero without a result when no CUDA
device (or no ``repro_torch`` package beside it) is present.  Imports
nothing of JAX or of the JAX reference package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_1D = 104_857_600                   # 1-D points, = 10240 * 10240
N_2D = 10_240                        # 2-D grid edge (benchmarks/fig9_throughput.py)
TOL = 3e-5                           # f32: |got - want| <= TOL * (1 + |want|)
TOL_BF16 = 1e-2                      # bf16 storage: one output rounding step
#: the model cut (``LM_CUT``), logits with the conv kernel against the same
#: model whose conv is the kernel's plain version (f32 sums in the same tap
#: order, one rounding), relative to 1 + |plain|.  In f32 the kernel's fused
#: multiply-adds round the products differently (a few ulps); a product of
#: two bf16 values is exact in f32, so in bf16 the two agree bit for bit
#: and the f32 limit holds there too
LM_TOL_F32 = 1e-4
LM_TOL_BF16 = 1e-4
ARCH = "mamba2-2.7b"
HYBRID_ARCH = "zamba2-2.7b"
DENSE_ARCH = "qwen3-1.7b"
MOE_ARCH = "granite-moe-3b-a800m"
ENCDEC_ARCH = "whisper-large-v3"
VLM_ARCH = "llama-3.2-vision-11b"
#: the same logits against use_kernels=False, whose conv (the reference's
#: oracle) rounds to bf16 after every tap: a wider limit in bf16.  Through
#: the hybrid cut's twelve layers and two attention blocks those per-tap
#: roundings compound with depth, so there the bf16 comparison is
#: information only (None): the check that holds the kernel is the one
#: against its plain version
LM_TOL_OFF = {ARCH: {"float32": 1e-4, "bfloat16": 0.25},
              HYBRID_ARCH: {"float32": 1e-4, "bfloat16": None}}
#: each served model's parameter count, as the reference counts it
#: (``jax.eval_shape`` of its ``init_params`` gives the same)
N_PARAMS = {ARCH: 2_702_579_200, HYBRID_ARCH: 2_422_670_240,
            DENSE_ARCH: 1_720_574_976, MOE_ARCH: 3_298_793_472,
            ENCDEC_ARCH: 1_645_061_120, VLM_ARCH: 11_520_053_256}
#: the layers of each phase's cut model (Zamba2: two groups of six, so the
#: shared block is applied twice; the VLM: two groups of five self layers,
#: so two gated cross layers)
LM_CUT = {ARCH: 2, HYBRID_ARCH: 12, DENSE_ARCH: 2, MOE_ARCH: 2,
          ENCDEC_ARCH: 2, VLM_ARCH: 10}
#: what else the cut changes: the MoE's cut runs drop-free, as the
#: reference's smoke configs do, so decode equals forward; Whisper's keeps
#: 2 of its 32 encoder layers too
CUT_FIELDS = {MOE_ARCH: {"capacity_factor": 8.0},
              ENCDEC_ARCH: {"n_enc_layers": 2}}
#: prefill-then-decode against forward in float32: the reference's own
#: tolerances (tests/test_arch_smoke.py:83), relative to 1 + |want|
RING_TOL = {"hybrid": 2e-2, "dense": 1e-2, "moe": 1e-2, "encdec": 1e-2,
            "vlm": 1e-2}
#: the families whose requests carry a memory (frame or patch embeddings)
MEMORY_FAMILIES = ("encdec", "vlm")
RING_PROMPT, RING_WINDOW = 100, 48
#: phase lm-variants: (arch, layers or None for full depth, parameters as
#: the reference counts them, what the config exercises).  Mixtral whole is
#: 140,630,071,296 parameters, 281 GB in bf16, more than the card holds
VARIANTS = (("phi3-mini-3.8b", None, 3_821_079_552, "MHA, d_head 96"),
            ("starcoder2-7b", None, 7_399_351_296,
             "LN + GELU, 36/4 GQA, window 4096"),
            ("chatglm3-6b", None, 6_243_454_976,
             "32/2 GQA, RoPE on half the lanes"),
            ("mixtral-8x22b", 4, 10_418_903_040,
             "8 experts top-2, window 4096; 4 of 56 layers"))
VARIANT_PROMPT, VARIANT_STEPS = 512, 8
#: each model's conv input: (channels d_inner + 2 * state, the width of the
#: input projection it is a column slice of)
CONV_VIEWS = {ARCH: (5376, 10576), HYBRID_ARCH: (5248, 10448)}
N_REQUESTS, PROMPT_LEN, NEW_TOKENS, MAX_BATCH = 8, 512, 32, 4
OUT_DIR = ROOT / "chiprun_out"
#: GPU clock cycles of the spin kernel that holds the stream while the host
#: enqueues a timed call: about 1 ms at the H100's 1.98 GHz
SPIN_CYCLES = 2_000_000
#: traces of each kind in phase vet's check of the profiler
TRACE_CHECK_N = 200
#: the full-size audit of phase vet whose first trace loses its markers on
#: purpose, so the retake path runs and is checked in every run
PLANTED_RETAKE = ("box-2d1r", "cuda_sptc")
#: phase vet's configured CLI runs: a ``[tool.repro-torch-vet]`` block
#: with the plain sptc backend alone, a gather budget of 0 (every sptc
#: probe runs one window gather) and ``lowering-hot-gather`` at each
#: severity, with the CLI's exit code that severity must give
VET_BLOCK = """[tool.repro-torch-vet]
invariant_radii = [1]
baseline = "vet-baseline.json"

[tool.repro-torch-vet.severity]
"lowering-hot-gather" = "{severity}"

[tool.repro-torch-vet.lowering]
backends = ["sptc"]

[tool.repro-torch-vet.lowering.budgets.sptc]
gather = 0
"""
VET_SEVERITY_RC = (("warning", 0), ("error", 1), ("off", 0))
#: ``python -m repro_torch.vet`` (``runpy``, as ``-m`` runs it) with the
#: arguments after ``-c``; the kernel wrappers' launch counters go to
#: stderr as a last ``launches {...}`` line
VET_CLI = """
import json, runpy, sys
from repro_torch.kernels.sptc_spmm import ops as S
from repro_torch.kernels.stencil_gemm import ops as G
rc = 0
try:
    runpy.run_module("repro_torch.vet", run_name="__main__", alter_sys=True)
except SystemExit as e:
    rc = e.code
print("launches " + json.dumps({
    "sptc_spmm_fused": S.sptc_spmm_fused.launches,
    "sptc_spmm_rows2d": S.sptc_spmm_rows2d.launches,
    "sptc_spmm_star2d": S.sptc_spmm_star2d.launches,
    "windows_gemm": G.windows_gemm.launches,
    "sptc_spmm_windows": S.sptc_spmm_windows.launches}), file=sys.stderr)
sys.exit(rc)
"""
#: phase 2's random v1 operands (M, K/2), and the largest the wrapper takes
V1_SHAPES = ((4, 4), (6, 6), (6, 7), (17, 12), (40, 20))
V1_LARGEST = ((64, 96), (1, 6144), (6144, 1))
#: phase 4's rows by kernel: the launch counter's name in the kernels line
KERNEL_OF = {"sptc": "cuda_sptc", "gemm": "cuda_gemm", "direct": "cuda_direct",
             "spmm": "sptc_spmm", "rows2d": "sptc_rows2d",
             "star2d": "sptc_star2d", "star_rows": "sptc_rows2d"}
#: device names of the stencil kernels
STENCIL_KERNELS = ("sptc_mma_kernel", "sptc_rows2d_kernel",
                   "sptc_star2d_kernel", "windows_gemm_kernel",
                   "stencil2d_kernel")
#: phase dryrun: the fleet cells ``python -m repro_torch.launch.dryrun``
#: traces in child processes, (arch, cell, on the multi-pod fleet)
DRYRUN_CELLS = (("qwen3-1.7b", "decode_32k", False),
                ("mamba2-2.7b", "long_500k", True),
                ("granite-moe-3b-a800m", "prefill_32k", False),
                ("mixtral-8x22b", "decode_32k", False),
                ("llama-3.2-vision-11b", "prefill_32k", False))
#: seconds the dry-run's child processes may take, together
DRYRUN_TIMEOUT = 420
#: the one-card check: the traced peak against phase train's
#: ``max_memory_allocated`` (less what was held before it), relative
DRYRUN_PEAK_TOL = 0.25
#: the one-card trace, in a child process (the fake process group is its
#: default group): phase train's cell on a (1, 1) mesh of the card
DRYRUN_ONE_CARD = """
import json, sys
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import mesh as MS
from repro_torch.launch import train as TL
from repro_torch.launch.dryrun import lower_cell
args = TL.parse_args(json.loads(sys.argv[1]))
cfg, tc, _ = TL.configs(args)
try:
    rec = lower_cell(args.arch, ShapeCell("train", "train", args.seq,
                                          args.batch),
                     cfg_override=cfg, tc=tc,
                     mesh_override=((1, 1), ("data", "model")))
finally:
    MS.release()
print(json.dumps(rec))
"""


def _v1_operand(rng, m: int, kh: int):
    """A random (M, K/2) v1 operand: N(0, 1) values, a tenth of them zero,
    and 2:4 metadata drawn from [0, 4) (duplicates, descending slots, (0, 1)
    and (2, 3) segments); with an odd K/2 the last segment's field stays in
    {0, 1}, inside K, where the plain version can index it."""
    v = rng.normal(size=(m, kh)).astype(np.float32)
    v[rng.random((m, kh)) < 0.1] = 0
    mt = rng.integers(0, 4, size=(m, kh))
    if kh % 2:
        mt[:, -1] = rng.integers(0, 2, size=m)
    return v, mt


def _time_ms(fn, reps: int, hold: bool = True) -> float:
    """Median time of ``fn`` between two CUDA events over ``reps`` runs,
    after one warm-up.

    ``hold``: a spin kernel of ``SPIN_CYCLES`` runs on the stream before
    the first event, so the host has enqueued ``fn``'s launches before the
    device reaches them: the events bracket device time.  Without it they
    also bracket the host's launch latency, which is most of a kernel of
    tens of microseconds.
    """
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _rel(got, want) -> float:
    """max |got - want| / (1 + |want|): the measure ``_err`` limits."""
    d = (got.float() - want.float()).abs()
    return float((d / (1 + want.float().abs())).max())


@contextlib.contextmanager
def _model_conv(fn):
    """Run the Mamba2 model's ``use_kernels`` conv through ``fn``."""
    from repro_torch.models import ssm
    kept = ssm.conv1d_causal
    ssm.conv1d_causal = fn
    try:
        yield
    finally:
        ssm.conv1d_causal = kept


def _err(got, want, tol: float) -> float:
    """Max |got - want|; raises when any element exceeds tol * (1 + |want|)."""
    d = (got.float() - want.float()).abs()
    bad = d > tol * (1 + want.float().abs())
    if bool(bad.any()) or not bool(got.isfinite().all()):
        raise AssertionError(f"mismatch: max |err| {float(d.max())} over "
                             f"{int(bad.sum())} elements (tol {tol})")
    return float(d.max())


def _bound_ms(bytes_moved: float, flops: float):
    """The H100's least time for the work (``repro_torch.roofline``), float32
    operations at the rate outside the tensor cores."""
    from repro_torch.roofline import FP32_FLOPS, HBM_BW, kernel_roofline_time
    by = "bytes" if bytes_moved / HBM_BW >= flops / FP32_FLOPS else "operations"
    return kernel_roofline_time(flops, bytes_moved) * 1e3, by


def _sass_mma(lib_path: Path) -> dict:
    """Tensor-core instructions in the SASS of the built library, from the
    CUDA toolkit's ``cuobjdump``: sparse ones (``HMMA.SP``) in every
    ``sptc_mma_kernel`` (fused) and every ``sptc_spmm_kernel`` (v1)
    instantiation, and dense ones (``HMMA`` without ``.SP``) in every
    ``windows_gemm_kernel`` one.  Raises when an instantiation has none."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    wanted = {"sparse": ("sptc_mma_kernel", True),
              "sparse rows": ("sptc_rows2d_kernel", True),
              "sparse star": ("sptc_star2d_kernel", True),
              "sparse v1": ("sptc_spmm_kernel", True),
              "dense": ("windows_gemm_kernel", False)}
    found: dict = {k: {} for k in wanted}
    func = None
    for line in sass.splitlines():
        if "Function :" in line:
            func = line.split("Function :", 1)[1].strip()
            continue
        if not func or "HMMA" not in line:
            continue
        for k, (name, sparse) in wanted.items():
            if name in func and (".SP" in line) == sparse:
                instr = line.split("*/", 1)[-1].strip().rstrip(" ;")
                found[k].setdefault(func, []).append(instr)
    out = {}
    for k, (name, _) in wanted.items():
        kernels = [f for f in set(re.findall(r"Function : (\S+)", sass))
                   if name in f]
        if not kernels or set(kernels) - set(found[k]):
            raise AssertionError(
                f"no {k} HMMA in the SASS of "
                f"{sorted(set(kernels) - set(found[k])) or 'any'} {name} "
                f"({len(kernels)} found)")
        out[k] = {"kernel": name, "kernels": len(kernels),
                  "instructions": sum(len(v) for v in found[k].values()),
                  "mnemonics": sorted({i.split()[1] if i.startswith("@")
                                       else i.split()[0]
                                       for lst in found[k].values()
                                       for i in lst}),
                  "example": next(iter(found[k].values()))[0]}
    return out


def _time_row(kern, plain, lib, tol: float, nbytes: float, flops: float,
              shape: str, reps: int = 20) -> dict:
    """Check ``kern`` against ``plain`` once, then time kernel, plain
    version and library yardstick with CUDA events."""
    err = _err(kern(), plain(), tol)
    bound, by = _bound_ms(nbytes, flops)
    return {"ms": _time_ms(kern, reps), "plain_ms": _time_ms(plain, 5),
            "library_ms": _time_ms(lib, reps), "bound_ms": bound,
            "bound_by": by, "max_abs_err": err, "shape": shape,
            "launch_ms": _time_ms(kern, reps, hold=False)}


def _profile(fn, label: str, smi: str, top: int = 8, regions: tuple = (),
             counters: tuple = ()) -> dict:
    """Device time of one call of ``fn`` by kernel name (``torch.profiler``),
    and the share of the call's wall time the device spent idle.

    The trace is the launch audit's (``vet.lowering.trace_device``): it
    opens with spin kernels, left out here, and a trace that lost them (and
    with them the head of the call) is taken again, so ``fn`` runs once
    more per retake and must be safe to repeat.  ``wall_ms`` is the host's
    time of the kept call, synchronised, without the spins.  The kernel
    wrappers' regions (``KERNEL_REGIONS``), the engine's spans
    (``ENGINE_SPANS``) and ``regions`` also appear as device-side
    annotations spanning their kernels; those rows are not
    kernels and are left out of the busy time.  ``by_region`` holds the
    device time of the kernels launched inside each of ``regions``.
    ``counters`` are kernel wrappers (``KERNEL_REGIONS``' keys): the trace
    must hold each one's kernel exactly as many times as the wrapper
    counted launches in the kept call.  Raises when the trace holds no
    device time or another count of a counted kernel.
    """
    import torch
    from torch.autograd import DeviceType
    from repro_torch.kernels.common import ENGINE_SPANS, KERNEL_REGIONS
    from repro_torch.vet.lowering import is_marker, trace_device
    fn()
    torch.cuda.synchronize()
    runs = []

    def timed():
        before = [c.launches for c in counters]
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append(((time.perf_counter() - t0) * 1e3,
                     [c.launches - b for c, b in zip(counters, before)]))
    events, _, attempts = trace_device(
        timed, torch.device("cuda", torch.cuda.current_device()))
    wall_ms, launched = runs[-1]
    marks = set(KERNEL_REGIONS) | set(ENGINE_SPANS) | set(regions)
    by_name: dict = {}
    for e in events:
        if (e.device_type == DeviceType.CUDA and not e.is_user_annotation
                and not is_marker(e) and e.name not in marks):
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + (e.time_range.end - e.time_range.start)
                               / 1e3, n + 1)
    by_region = {e.key: e.device_time_total / 1e3
                 for e in events.key_averages()
                 if e.device_type == DeviceType.CPU and e.key in regions}
    rows = sorted(((ms, n, key) for key, (ms, n) in by_name.items()),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    if not rows or busy_ms <= 0:
        raise AssertionError(f"profile {label}: the trace holds no device "
                             f"time ({attempts} attempts)")
    for c, want in zip(counters, launched):
        kernel = KERNEL_REGIONS[c.__name__]
        got = sum(n for _, n, key in rows if kernel in key)
        if got != want:
            raise AssertionError(f"profile {label}: the trace holds {got} "
                                 f"{kernel} launches, {c.__name__} counted "
                                 f"{want}")
    print(f"profile {label}: wall {wall_ms:.2f} ms (profiled), device busy "
          f"{busy_ms:.2f} ms in {launches} kernels, idle share "
          f"{100 * max(0.0, 1 - busy_ms / wall_ms):.0f}%, trace attempts "
          f"{attempts}"
          + "".join(f", {c.__name__} {n} = counted" for c, n in
                    zip(counters, launched)) + f" | card {smi}")
    for ms, n, key in rows[:top]:
        print(f"  {ms:9.3f} ms {100 * ms / busy_ms:5.1f}% x{n:<5d} {key[:90]}")
    return {"wall_ms": wall_ms, "device_ms": busy_ms, "kernels": launches,
            "attempts": attempts,
            "counted": {c.__name__: n for c, n in zip(counters, launched)},
            "top": [{"ms": ms, "count": n, "name": key}
                    for ms, n, key in rows[:top]],
            "rows": rows, "by_region": by_region}


@contextlib.contextmanager
def _model_regions():
    """Open a profiler region around the LM's attention core (prefill's
    ``attention_core``, decode's ``decode_attention``: scores, softmax and
    PV, what a fused attention kernel would replace), around the decode
    step's ring write (``write_token``), around the MoE layer
    (``apply_moe``: routing, dispatch, experts, combine), around the
    cross-attention over a memory (prefill's ``_cross_attention`` and
    ``_cross_kv``, decode's ``_cross_attn_decode``: projections and core)
    and around Whisper's encoder (``encode``), so ``_profile`` can split
    their device time out.  Regions nest: an attention core inside a
    cross-attention or the encoder counts in both."""
    import torch
    from repro_torch.models import layers
    from repro_torch.models import model
    from repro_torch.serving import cache, engine
    targets = ((layers, "attention_core", "attention"),
               (layers, "decode_attention", "attention"),
               (cache, "write_token", "ring_write"),
               (layers, "apply_moe", "moe"),
               (model, "_cross_attention", "cross"),
               (engine, "_cross_kv", "cross"),
               (engine, "_cross_attn_decode", "cross"),
               (model, "encode", "encode"))
    kept = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]

    def wrap(fn, name):
        def inner(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return inner
    for mod, attr, name in targets:
        setattr(mod, attr, wrap(getattr(mod, attr), name))
    try:
        yield ("attention", "ring_write", "moe", "cross", "encode")
    finally:
        for mod, attr, fn in kept:
            setattr(mod, attr, fn)


def _ring_check(params, cfg, toks, phase: str, smi: str, mem=None) -> dict:
    """Prefill S tokens, then decode token S, against ``forward``'s logits
    at position S (float32, within the family's ``RING_TOL`` relative to
    1 + |forward|), both given the memory ``mem`` where the family reads
    one:
    once with a ring as long as the cache, once with sliding_window =
    decode_window = ``RING_WINDOW`` < S, where the ring wraps (the forward
    masks to the same window, so both see the same keys)."""
    from repro_torch.models import model as M
    from repro_torch.serving import engine as E
    s = toks.shape[1] - 1
    tol = RING_TOL[cfg.family]
    out = {}
    for window in (None, RING_WINDOW):
        c = cfg if window is None else cfg.scaled(sliding_window=window,
                                                  decode_window=window)
        full = M.forward(params, c, toks, memory=mem)[0][:, s]
        _, cc = E.prefill(params, c, toks[:, :s], s + 16, memory=mem)
        ring = int(cc["kv_pos"].shape[0])
        step, cc2 = E.decode_step(params, c, cc, toks[:, s:])
        if int(cc2["pos"]) != s + 1:
            raise AssertionError(f"decode left pos {int(cc2['pos'])}")
        row = {"window": window, "ring": ring, "wraps": s > ring,
               "max_abs_err": _err(step[:, 0], full, tol),
               "rel_err": _rel(step[:, 0], full), "tol": tol}
        out["wrapping" if window else "full"] = row
        print(f"phase {phase} {cfg.name} cut to {_layers(cfg)}, "
              f"float32: prefill {s} tokens then decode token {s} against "
              f"forward at position {s}, ring {ring} slots"
              f"{' (wrapped)' if row['wraps'] else ''}"
              f"{f', window {window}' if window else ''}: max rel err "
              f"{row['rel_err']:.3g} (tol {tol}) | card {smi}")
    if not out["wrapping"]["wraps"]:
        raise AssertionError("the ring check did not wrap the ring")
    return out


def _layers(cfg) -> str:
    """A config's depth in words: "2 + 2 layers" for an encoder-decoder."""
    enc = f"{cfg.n_enc_layers} + " if cfg.family == "encdec" else ""
    return f"{enc}{cfg.n_layers} layers"


def _memory(cfg, rng, batch: int = 0):
    """N(0, 1) float32 memory rows (frames or image tokens) from ``rng``:
    one request's (rows, D), or (batch, rows, D); None for a family that
    reads none."""
    rows = {"encdec": cfg.n_frames, "vlm": cfg.n_img_tokens}.get(cfg.family)
    if rows is None:
        return None
    import torch
    shape = ((batch,) if batch else ()) + (rows, cfg.d_model)
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))


def _open_gates(params, rng) -> list:
    """Set a VLM's tanh gates (zero at init, which hides the whole cross
    path) to values in [0.5, 1.5] with random signs; returns them."""
    gates = []
    for cp in params.get("cross", []):
        g = float(rng.uniform(0.5, 1.5) * rng.choice([-1.0, 1.0]))
        cp["attn"]["gate"].fill_(g)
        gates.append(g)
    return gates


def _full_depth_conv(params, cfg, batch0, logits, tag: str) -> dict:
    """A Mamba model at full depth: its prefill ``logits`` of ``batch0``
    against the same model whose conv is the kernel's plain version (bf16,
    within ``LM_TOL_BF16``), and against ``use_kernels=False`` in bf16 and
    (1 x 128 tokens) float32, information only."""
    import torch
    from repro_torch.kernels.conv1d.ref import conv1d_causal_plain
    from repro_torch.models import model as M
    out = {}
    with _model_conv(conv1d_causal_plain):
        plain = M.forward(params, cfg, batch0)[0]
    full_err = _err(logits, plain, LM_TOL_BF16)
    plain = M.forward(params, cfg.scaled(use_kernels=False), batch0)[0]
    full_diff = float((plain - logits).abs().max())
    logit_max = float(plain.abs().max())
    del plain
    print(f"{tag}: full depth, kernel vs its plain version in the model max "
          f"|logit diff| {full_err:.3g} (tol {LM_TOL_BF16}); use_kernels on "
          f"vs off max |logit diff| {full_diff:.3g} of max |logit| "
          f"{logit_max:.3g} (information only)")
    out["full_depth_bf16"] = {"max_abs_err_vs_plain": full_err,
                              "max_abs_logit_diff": full_diff,
                              "max_abs_logit": logit_max}
    # the same comparison in float32 (information only): without bf16's
    # per-tap rounding in the plain conv, the two runs differ by sum order
    cfg32 = cfg.scaled(dtype="float32")
    p32 = M.init_params(cfg32, 0, device=batch0.device)
    on = M.forward(p32, cfg32, batch0[:1, :128])[0]
    off = M.forward(p32, cfg32.scaled(use_kernels=False), batch0[:1, :128])[0]
    out["full_depth_f32"] = {"max_abs_logit_diff": float((on - off).abs().max()),
                             "max_abs_logit": float(off.abs().max())}
    del p32, on, off
    torch.cuda.empty_cache()
    print(f"{tag}: full depth in float32 (1 x 128 tokens), use_kernels on "
          f"vs off max |logit diff| "
          f"{out['full_depth_f32']['max_abs_logit_diff']:.3g} of max |logit| "
          f"{out['full_depth_f32']['max_abs_logit']:.3g} (information only)")
    return out


@contextlib.contextmanager
def _moe_keeps():
    """Record, for every ``moe_route`` call inside, (kept, all) (token,
    choice) pairs; yields the list (empty for a model without MoE)."""
    from repro_torch.models import layers
    kept_fn = layers.moe_route
    keeps: list = []

    def route(*args, **kwargs):
        r = kept_fn(*args, **kwargs)
        keeps.append((int(r.keep.sum()), r.keep.numel()))
        return r
    layers.moe_route = route
    try:
        yield keeps
    finally:
        layers.moe_route = kept_fn


def _phase_lm(dev, smi: str, arch: str, phase: str, cut: int) -> dict:
    """Serve ``arch`` at full width and depth through GenerateDriver, check
    it, and time and profile prefill and decode.  First the config cut to
    ``cut`` layers: for a family with Mamba layers it holds the conv kernel
    against its plain version in the model; for a family with attention,
    prefill-then-decode against forward.  A family without Mamba layers
    (dense, MoE, enc-dec, VLM) must launch the conv kernel no time.  The
    enc-dec and VLM families get a memory per request (frames, patches);
    their cut also plants a fault, another memory, which must move the
    logits, and the VLM's cut opens its gates."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.conv1d import ops as conv_ops
    from repro_torch.kernels.conv1d.ref import conv1d_causal_plain
    from repro_torch.models import layers
    from repro_torch.models import model as M
    from repro_torch.models.nn import count_params
    from repro_torch.serving import BatchPolicy, GenerateDriver
    from repro_torch.serving import engine as E

    t_phase = time.perf_counter()
    rng = np.random.default_rng(2)
    out: dict = {}
    tag = f"phase {phase} {arch}"
    family = get_config(arch).family
    mamba = family in ("ssm", "hybrid")
    if not mamba:
        # the cut at full width in float32: prefill-then-decode against
        # forward through a full and a wrapped ring, and no conv launch
        cfg2 = get_config(arch).scaled(n_layers=cut, dtype="float32",
                                       use_kernels=True,
                                       **CUT_FIELDS.get(arch, {}))
        p2 = M.init_params(cfg2, 1, device=dev)
        gates = _open_gates(p2, rng)
        ring_toks = torch.as_tensor(
            rng.integers(0, cfg2.vocab, (2, RING_PROMPT + 1)), device=dev)
        ring_mem = _memory(cfg2, rng, 2)
        if ring_mem is not None:
            ring_mem = ring_mem.to(dev)
        conv_ops.conv1d_causal.launches = 0
        out["ring"] = _ring_check(p2, cfg2, ring_toks, phase, smi,
                                  mem=ring_mem)
        if ring_mem is not None:
            out["memory_fault"] = _memory_fault(p2, cfg2, ring_toks,
                                                ring_mem, tag, smi)
        if conv_ops.conv1d_causal.launches:
            raise AssertionError(f"the {family} cut launched the conv kernel "
                                 f"{conv_ops.conv1d_causal.launches} times")
        out["cut_float32"] = {"conv1d_launches": 0, "n_layers": cut,
                              **CUT_FIELDS.get(arch, {})}
        if gates:
            out["cut_float32"]["gates"] = gates
        del p2, ring_toks, ring_mem
    # the config cut to `cut` layers: the kernel against its plain version
    # in the same model, against use_kernels=False, and a planted fault
    # (the plain conv with its taps shifted by one) that the first check
    # must fail
    cut_dtypes = ((("float32", LM_TOL_F32), ("bfloat16", LM_TOL_BF16))
                  if mamba else ())
    for dt, tol in cut_dtypes:
        cfg2 = get_config(arch).scaled(n_layers=cut, dtype=dt,
                                       use_kernels=True)
        p2 = M.init_params(cfg2, 1, device=dev)
        toks = torch.as_tensor(rng.integers(0, cfg2.vocab, (2, 64)),
                               device=dev)
        conv_ops.conv1d_causal.launches = 0
        on = M.forward(p2, cfg2, toks)[0]
        if conv_ops.conv1d_causal.launches != cfg2.n_layers:
            raise AssertionError(f"the {cut}-layer model launched the kernel "
                                 f"{conv_ops.conv1d_causal.launches} times")
        with _model_conv(conv1d_causal_plain):
            plain = M.forward(p2, cfg2, toks)[0]
        with _model_conv(lambda x, w: conv1d_causal_plain(
                x, torch.roll(w, 1, dims=0))):
            fault = M.forward(p2, cfg2, toks)[0]
        off = M.forward(p2, cfg2.scaled(use_kernels=False), toks)[0]
        row = {"rel_err_vs_plain": _rel(on, plain),
               "max_abs_err_vs_plain": float((on - plain).abs().max()),
               "mean_abs_err_vs_plain": float((on - plain).abs().mean()),
               "rel_err_vs_off": _rel(on, off),
               "max_abs_err_vs_off": float((on - off).abs().max()),
               "planted_fault_rel_err": _rel(fault, plain),
               "tol": tol, "tol_off": LM_TOL_OFF[arch][dt],
               "conv1d_launches": cfg2.n_layers}
        out[f"cut_{dt}"] = row
        print(f"{tag} cut to {cut} layers, {dt}: prefill logits, kernel vs "
              f"its plain version in the model: max rel err "
              f"{row['rel_err_vs_plain']:.3g} (max |err| "
              f"{row['max_abs_err_vs_plain']:.3g}, mean "
              f"{row['mean_abs_err_vs_plain']:.3g}; tol {tol}); vs "
              f"use_kernels=False {row['rel_err_vs_off']:.3g} (tol "
              f"{LM_TOL_OFF[arch][dt] or 'none: information only'}); "
              f"planted fault (taps shifted by one) vs "
              f"plain {row['planted_fault_rel_err']:.3g}; conv1d launches "
              f"{cfg2.n_layers} | card {smi}")
        tol_off = LM_TOL_OFF[arch][dt]
        if row["rel_err_vs_plain"] > tol or \
                (tol_off is not None and row["rel_err_vs_off"] > tol_off):
            raise AssertionError(f"{dt}: kernel model outside its limits")
        if row["planted_fault_rel_err"] <= tol:
            raise AssertionError(f"{dt}: a planted fault passes tol {tol}")
        if cfg2.family == "hybrid" and dt == "float32":
            ring_toks = torch.as_tensor(
                rng.integers(0, cfg2.vocab, (2, RING_PROMPT + 1)), device=dev)
            out["ring"] = _ring_check(p2, cfg2, ring_toks, phase, smi)
        del p2, on, plain, fault, off
    torch.cuda.empty_cache()

    cfg = get_config(arch).scaled(use_kernels=True)
    n_mamba = cfg.n_layers if mamba else 0      # conv launches per prefill
    t0 = time.perf_counter()
    params = M.init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    n_params = count_params(params)
    print(f"{tag}: {n_params:,} parameters ({cfg.dtype}, {_layers(cfg)}, "
          f"d_model {cfg.d_model}) drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    if n_params != N_PARAMS[arch]:
        raise AssertionError(f"{n_params:,} parameters, want "
                             f"{N_PARAMS[arch]:,}")
    prompts = [torch.as_tensor(rng.integers(0, cfg.vocab, PROMPT_LEN),
                               dtype=torch.int32) for _ in range(N_REQUESTS)]
    mems = [_memory(cfg, rng) for _ in range(N_REQUESTS)]
    cache_len = PROMPT_LEN + NEW_TOKENS
    driver = GenerateDriver(params, cfg, cache_len=cache_len, autostart=False,
                            policy=BatchPolicy(max_batch=MAX_BATCH,
                                               max_wait_ms=5.0))
    conv_ops.conv1d_causal.launches = 0
    t0 = time.perf_counter()
    futs = [driver.submit(p, NEW_TOKENS, memory=m)
            for p, m in zip(prompts, mems)]
    driver.start()
    toks_out = [f.result() for f in futs]
    wall = time.perf_counter() - t0
    driver.close()
    launches = conv_ops.conv1d_causal.launches
    stats = driver.metrics()["overall"]
    batches = stats["batches"]
    for i, t in enumerate(toks_out):
        if tuple(t.shape) != (NEW_TOKENS,) or int(t.min()) < 0 or \
                int(t.max()) >= cfg.vocab:
            raise AssertionError(f"request {i}: tokens {tuple(t.shape)}")
    if batches != N_REQUESTS // MAX_BATCH or launches != n_mamba * batches:
        raise AssertionError(f"{batches} batches, {launches} conv1d launches "
                             f"(want {n_mamba} per prefill)")
    print(f"{tag} main path: served {N_REQUESTS} requests of {PROMPT_LEN} "
          f"tokens"
          + (f" with a {tuple(mems[0].shape)} memory each"
             if mems[0] is not None else "")
          + f", {NEW_TOKENS} new tokens each, in {wall:.2f} s "
          f"({N_REQUESTS * NEW_TOKENS / wall:.1f} new tok/s), batches "
          f"{batches}, occupancy {stats['batch_occupancy']}, p50 "
          f"{stats['latency']['p50_ms']:.0f} ms, p99 "
          f"{stats['latency']['p99_ms']:.0f} ms; conv1d_causal launches "
          f"{launches} = {n_mamba} x {batches} prefills | card {smi}")

    # the first batch again: finite logits, the served first tokens, and
    # (Mamba layers) the full depth with the plain conv; an MoE's routing
    # is recorded to count the choices its capacity drops
    batch0 = torch.stack(prompts[:MAX_BATCH]).to(dev)
    mem0 = (torch.stack(mems[:MAX_BATCH]).to(dev)
            if mems[0] is not None else None)
    del mems
    with _moe_keeps() as keeps:
        logits, cc = E.prefill(params, cfg, batch0, cache_len, memory=mem0)
    if tuple(logits.shape) != (MAX_BATCH, PROMPT_LEN, cfg.vocab) or \
            logits.dtype != torch.float32 or not bool(logits.isfinite().all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                             f"{logits.dtype} not finite float32")
    first = torch.argmax(logits[:, -1], dim=-1).cpu()
    served = torch.stack([t[0] for t in toks_out[:MAX_BATCH]]).cpu()
    if not torch.equal(first.to(served.dtype), served):
        raise AssertionError(f"served first tokens {served.tolist()} != "
                             f"prefill argmax {first.tolist()}")
    if keeps:
        kept, pairs = (sum(k for k, _ in keeps), sum(n for _, n in keeps))
        out["moe_dropped_share"] = 1 - kept / pairs
        group = min(cfg.moe_group, MAX_BATCH * PROMPT_LEN)
        print(f"{tag}: prefill {MAX_BATCH} x {PROMPT_LEN} at capacity_factor "
              f"{cfg.capacity_factor} (cap {layers.moe_capacity(cfg, group)} "
              f"slots of {group} tokens x top-{cfg.top_k} / "
              f"{cfg.n_experts} experts): {pairs - kept:,} of {pairs:,} "
              f"(token, choice) pairs dropped over {len(keeps)} layers, "
              f"{100 * out['moe_dropped_share']:.2f}% (information only) | "
              f"card {smi}")
    print(f"{tag}: prefill logits finite float32, served first tokens = "
          f"argmax {served.tolist()}")
    if mamba:
        out.update(_full_depth_conv(params, cfg, batch0, logits, tag))

    # timing: prefill of one batch, then decode steps (host clock, synced)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cc = E.prefill(params, cfg, batch0, cache_len, memory=mem0)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    prefill_ms = statistics.median(times)
    tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
    del logits
    E.decode_step(params, cfg, cc, tok)                 # warm-up
    steps = 16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        lg, cc = E.decode_step(params, cfg, cc, tok)
        tok = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / steps
    print(f"timing {arch} prefill {MAX_BATCH} x {PROMPT_LEN}: "
          f"{prefill_ms:.2f} ms ({MAX_BATCH * PROMPT_LEN / prefill_ms * 1e3:.0f}"
          f" tok/s); decode step at batch {MAX_BATCH}: {decode_ms:.2f} ms | "
          f"card {smi}")
    # prefill and decode are safe to repeat (decode_step leaves the cache
    # it is handed as it was); the trace holds the conv kernel once per
    # Mamba layer of the prefill and never in decode, as counted
    with _model_regions() as regions:
        prof = _profile(lambda: E.prefill(params, cfg, batch0, cache_len,
                                          memory=mem0),
                        f"{arch} prefill {MAX_BATCH} x {PROMPT_LEN}", smi,
                        regions=regions, counters=(conv_ops.conv1d_causal,))
        dec = _profile(lambda: E.decode_step(params, cfg, cc, tok),
                       f"{arch} decode step at batch {MAX_BATCH}", smi,
                       regions=regions, counters=(conv_ops.conv1d_causal,))
    if prof["counted"]["conv1d_causal"] != n_mamba:
        raise AssertionError(f"the profiled prefill launched the conv kernel "
                             f"{prof['counted']['conv1d_causal']} times, "
                             f"want {n_mamba}")
    # the conv kernel's device time inside that prefill, by kernel name
    conv = [(ms, n) for ms, n, key in prof.pop("rows")
            if "conv1d_causal_kernel" in key]
    dec.pop("rows")
    if not mamba:
        out["conv_in_prefill"] = None       # no Mamba layer, no conv kernel
    else:
        c_ms, c_n = sum(r[0] for r in conv), sum(r[1] for r in conv)
        out["conv_in_prefill"] = {
            "ms": c_ms, "launches": c_n,
            "share_of_device": c_ms / prof["device_ms"],
            "share_of_wall": c_ms / prof["wall_ms"]}
        print(f"{tag}: conv1d_causal_kernel in the profiled prefill: "
              f"{c_ms:.3f} ms in {c_n} launches, "
              f"{100 * c_ms / prof['device_ms']:.2f}% of device time, "
              f"{100 * c_ms / prof['wall_ms']:.2f}% of the wall | card {smi}")
    if family != "ssm":
        # prefill writes no ring slot: its K/V is packed once; the encoder
        # runs in prefill only
        extra = {"moe": ("moe",), "encdec": ("cross", "encode"),
                 "vlm": ("cross",)}.get(family, ())
        pre = ("attention",) + extra
        regs_dec = ("attention", "ring_write") + tuple(
            r for r in extra if r != "encode")
        for name, pr, regs in (("prefill", prof, pre),
                               ("decode step", dec, regs_dec)):
            for reg in regs:
                ms = pr["by_region"].get(reg)
                if ms is None:
                    print(f"{tag}: {reg} share of the {name} not measured "
                          f"(no device time under its region)")
                    continue
                out[f"{reg}_in_{name.split()[0]}"] = {
                    "ms": ms, "share_of_device": ms / pr["device_ms"],
                    "share_of_wall": ms / pr["wall_ms"]}
                print(f"{tag}: {reg} in the profiled {name}: {ms:.3f} ms, "
                      f"{100 * ms / pr['device_ms']:.2f}% of device time, "
                      f"{100 * ms / pr['wall_ms']:.2f}% of the wall | card "
                      f"{smi}")
    out["profile"] = {"prefill": prof, "decode_step": dec}
    if phase == "lm-dense":
        out["under_rules"] = _serve_under_rules(
            params, cfg, prompts, toks_out, batch0, cache_len, decode_ms,
            tag, smi)
    out.update({"params": n_params, "serve_wall_s": wall, "batches": batches,
                "conv1d_launches": launches, "metrics": stats,
                "prefill_ms": prefill_ms,
                "prefill_tok_s": MAX_BATCH * PROMPT_LEN / prefill_ms * 1e3,
                "decode_ms_per_step": decode_ms, "n_layers": cfg.n_layers,
                "seconds": time.perf_counter() - t_phase})
    del params, cc, driver, mem0
    torch.cuda.empty_cache()
    print(f"phase {phase}: {out['seconds']:.1f} s")
    return out


def _serve_under_rules(params, cfg, prompts, want, batch0, cache_len: int,
                       plain_decode_ms: float, tag: str, smi: str) -> dict:
    """The model served again through ``GenerateDriver`` with its
    parameters as DTensors on the one-rank host mesh (``nccl``), laid out
    by ``param_shardings`` and served inside ``use_mesh_rules``, as a
    caller of the reference serves under a mesh: the tokens must equal the
    plain run's ``want``.  Then a decode step at batch ``MAX_BATCH`` under
    the rules, timed (host clock, synced) and profiled (idle share).  The
    group is released at the end."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import mesh as MS
    from repro_torch.launch.train import host_rules
    from repro_torch.models import model as M
    from repro_torch.models.nn import tree_map
    from repro_torch.serving import BatchPolicy, GenerateDriver
    from repro_torch.serving import engine as E

    mesh = MS.make_host_mesh(params["embed"].device)
    try:
        rules = host_rules()
        _, axes = M.init_params(cfg, device="meta", with_axes=True)
        dp = tree_map(SH.distribute, params,
                      SH.param_shardings(axes, params, rules, mesh))
        with SH.use_mesh_rules(mesh, rules):
            driver = GenerateDriver(dp, cfg, cache_len=cache_len,
                                    autostart=False, policy=BatchPolicy(
                                        max_batch=MAX_BATCH, max_wait_ms=5.0))
            t0 = time.perf_counter()
            futs = [driver.submit(p, NEW_TOKENS) for p in prompts]
            driver.start()
            got = [f.result() for f in futs]
            wall = time.perf_counter() - t0
            driver.close()
            same = sum(torch.equal(a.cpu(), b.cpu()) for a, b in zip(got, want))
            with implicit_replication():
                b0 = driver._place(batch0)
                logits, cc = E.prefill(dp, cfg, b0, cache_len)
                tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
                del logits
                E.decode_step(dp, cfg, cc, tok)               # warm-up
                steps = 16
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(steps):
                    lg, cc = E.decode_step(dp, cfg, cc, tok)
                    tok = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
                torch.cuda.synchronize()
                decode_ms = (time.perf_counter() - t0) * 1e3 / steps
                dec = _profile(lambda: E.decode_step(dp, cfg, cc, tok),
                               f"{cfg.name} decode step at batch {MAX_BATCH}"
                               f" under the mesh rules", smi)
        dec.pop("rows")
        backend = str(dist.get_backend())
    finally:
        MS.release()
    if dist.is_initialized():
        raise AssertionError("the serving check left a process group alive")
    idle = max(0.0, 1 - dec["device_ms"] / dec["wall_ms"])
    out = {"mesh": [list(mesh.shape), backend], "equal_requests": same,
           "requests": len(want), "serve_wall_s": wall,
           "decode_ms_per_step": decode_ms,
           "plain_decode_ms_per_step": plain_decode_ms,
           "decode_idle_share": idle, "profile_decode_step": dec}
    print(f"{tag} under the mesh rules (params as DTensors on the host mesh "
          f"{tuple(mesh.shape)}, {backend}, GenerateDriver inside "
          f"use_mesh_rules): served {len(want)} requests in {wall:.2f} s, "
          f"tokens equal the plain run for {same} of {len(want)}; decode "
          f"step at batch {MAX_BATCH} {decode_ms:.2f} ms (plain "
          f"{plain_decode_ms:.2f} ms), profiled: device busy "
          f"{dec['device_ms']:.2f} ms of wall {dec['wall_ms']:.2f} ms, idle "
          f"share {100 * idle:.1f}% | card {smi}")
    if same != len(want):
        raise AssertionError(f"served under the mesh rules: {same} of "
                             f"{len(want)} requests equal the plain run")
    return out


def _memory_fault(params, cfg, toks, mem, tag: str, smi: str) -> dict:
    """A planted fault: the cut's forward with its memory replaced by
    another seed's draw must move the logits by more than the ring check's
    tolerance (relative to 1 + |logits|), or that check could not see a
    broken cross path."""
    from repro_torch.models import model as M
    tol = RING_TOL[cfg.family]
    other = _memory(cfg, np.random.default_rng(99), mem.shape[0]).to(
        mem.device)
    want = M.forward(params, cfg, toks, memory=mem)[0]
    rel = _rel(M.forward(params, cfg, toks, memory=other)[0], want)
    print(f"{tag} cut to {_layers(cfg)}, float32: planted fault (the memory "
          f"replaced by another seed's draw): logits moved by max rel "
          f"{rel:.3g} (must exceed tol {tol}) | card {smi}")
    if not rel > tol:
        raise AssertionError(f"another memory moves the logits by {rel:.3g}, "
                             f"within tol {tol}: the cross path is not seen")
    return {"rel_err": rel, "tol": tol}


def _phase_variants(dev, smi: str) -> dict:
    """Each config of ``VARIANTS`` once at full width, freed before the
    next: its parameter count, a prefill of ``MAX_BATCH`` x
    ``VARIANT_PROMPT`` with finite float32 logits, ``generate`` with
    ``VARIANT_STEPS`` greedy decode steps whose first token is the
    prefill's argmax, no conv launch; the prefill (median of 3) and a
    decode step (mean of ``VARIANT_STEPS``) timed on the host's clock,
    synced."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.conv1d import ops as conv_ops
    from repro_torch.models import model as M
    from repro_torch.models.nn import count_params
    from repro_torch.serving import engine as E

    t_phase = time.perf_counter()
    rng = np.random.default_rng(3)
    out: dict = {}
    for arch, cut, n_want, what in VARIANTS:
        t_arch = time.perf_counter()
        cfg = get_config(arch).scaled(use_kernels=True)
        if cut:
            cfg = cfg.scaled(n_layers=cut)
        params = M.init_params(cfg, 0, device=dev)
        n = count_params(params)
        if n != n_want:
            raise AssertionError(f"{arch}: {n:,} parameters, want {n_want:,}")
        toks = torch.as_tensor(rng.integers(0, cfg.vocab,
                                            (MAX_BATCH, VARIANT_PROMPT)),
                               dtype=torch.int32, device=dev)
        cache_len = VARIANT_PROMPT + VARIANT_STEPS
        conv_ops.conv1d_causal.launches = 0
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cc = E.prefill(params, cfg, toks, cache_len)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        if tuple(logits.shape) != (MAX_BATCH, VARIANT_PROMPT, cfg.vocab) or \
                logits.dtype != torch.float32 or \
                not bool(logits.isfinite().all()):
            raise AssertionError(f"{arch}: prefill logits "
                                 f"{tuple(logits.shape)} {logits.dtype} not "
                                 f"finite float32")
        first = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        del logits
        gen, _ = E.generate(params, cfg, toks, VARIANT_STEPS, cache_len)
        if tuple(gen.shape) != (MAX_BATCH, VARIANT_STEPS) or \
                not torch.equal(gen[:, 0], first):
            raise AssertionError(f"{arch}: generate's first tokens "
                                 f"{gen[:, 0].tolist()} != prefill argmax "
                                 f"{first.tolist()}")
        tok = first[:, None]
        E.decode_step(params, cfg, cc, tok)                 # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(VARIANT_STEPS):
            lg, cc = E.decode_step(params, cfg, cc, tok)
            tok = torch.argmax(lg[:, -1:], dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / VARIANT_STEPS
        if conv_ops.conv1d_causal.launches:
            raise AssertionError(f"{arch}: {conv_ops.conv1d_causal.launches} "
                                 f"conv1d launches")
        row = {"params": n, "n_layers": cfg.n_layers,
               "prefill_ms": statistics.median(times),
               "decode_ms_per_step": decode_ms,
               "generated_first": first.tolist(), "what": what,
               "seconds": time.perf_counter() - t_arch}
        out[arch] = row
        depth = (f"{cut} of {get_config(arch).n_layers} layers (cut: 281 GB "
                 f"in bf16 whole)" if cut else f"{cfg.n_layers} layers")
        print(f"phase lm-variants {arch} ({what}): {n:,} parameters, "
              f"{depth}, {cfg.dtype}; prefill {MAX_BATCH} x {VARIANT_PROMPT} "
              f"{row['prefill_ms']:.2f} ms, finite float32 logits; "
              f"{VARIANT_STEPS} greedy decode steps, first tokens = argmax "
              f"{first.tolist()}, {decode_ms:.2f} ms per step; 0 conv1d "
              f"launches; {row['seconds']:.1f} s | card {smi}")
        del params, cc, gen, lg, tok, first
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase lm-variants: {out['seconds']:.1f} s")
    return out


#: phase train: the launcher's flags, Qwen3-1.7B at full size (bf16, remat
#: "full", its config's defaults), 8 steps of 8 x 512 tokens in 2
#: microbatches
TRAIN_ARGV = ("--arch", DENSE_ARCH, "--steps", "8", "--batch", "8", "--seq",
              "512", "--microbatches", "2", "--lr", "3e-3", "--log-every",
              "1")
#: the resume check: Qwen3's smoke config cast to bf16, 6 steps against 4,
#: a restart, and 2 more, under deterministic algorithms
RESUME_ARGV = ("--arch", DENSE_ARCH, "--smoke", "--dtype", "bfloat16",
               "--batch", "4", "--seq", "64", "--ckpt-every", "2",
               "--log-every", "1")
#: phase train-variants: each arch's smoke config (float32) trained 2 steps
#: on the card and on the CPU from the same weights and batches, loss and
#: grad norm relative to the CPU's.  The card sums in other orders (TF32
#: off), and AdamW's first step can move a weight whose gradient is ~0 by a
#: whole lr on one device and not the other; on an H100 the two land within
#: 1.7e-7 (loss) and 1.1e-5 (grad norm, Zamba2's), so the limits leave two
#: orders of magnitude of room and still fail a grad leaf gone missing
TRAIN_VARIANT_TOL = {"loss": 1e-4, "grad_norm": 1e-3}


@contextlib.contextmanager
def _train_regions():
    """Open profiler regions in a train step: the forward pass with its
    loss (``lm_loss``), the attention cores, the unembed (forward), the
    optimizer (``optimizer.apply``) and each dense layer body, named
    ``recompute`` when it runs off the main thread — remat's recomputation
    inside the backward pass, which autograd runs on its device thread —
    and ``layer`` otherwise.  Yields the region names and a dict counting
    the layer bodies by name."""
    import threading

    import torch
    from repro_torch.models import layers
    from repro_torch.models import model
    from repro_torch.training import optimizer
    main = threading.main_thread()
    calls = {"layer": 0, "recompute": 0}

    def wrap(fn, name):
        def inner(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return inner

    def body(fn, _):
        def inner(*args, **kwargs):
            name = "layer" if threading.current_thread() is main \
                else "recompute"
            calls[name] += 1
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return inner
    targets = ((layers, "attention_core", wrap, "attention"),
               (model, "unembed", wrap, "unembed"),
               (model, "lm_loss", wrap, "forward"),
               (optimizer, "apply", wrap, "optimizer"),
               (model, "_dense_block", body, "layer"))
    kept = [(mod, attr, getattr(mod, attr)) for mod, attr, _, _ in targets]
    for mod, attr, how, name in targets:
        setattr(mod, attr, how(getattr(mod, attr), name))
    try:
        yield ("forward", "attention", "unembed", "optimizer", "layer",
               "recompute"), calls
    finally:
        for mod, attr, fn in kept:
            setattr(mod, attr, fn)


def _phase_train(dev, smi: str) -> dict:
    """Train Qwen3-1.7B at full size through ``launch.train.main``
    (``TRAIN_ARGV``) over the host mesh, one rank on ``nccl`` (the phase
    makes the group, so the state stays DTensors for the profiled step, and
    releases it at the end): the parameter count, DTensor leaves, finite
    losses, the last below the first, no conv launch; the median step over
    steps 2-8, tokens/s, peak memory; then one more step through the
    launcher's mesh step, profiled, split into the forward pass, the
    attention cores, the unembed, the optimizer and remat's recompute, and
    its NCCL kernels counted."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as MS

    t_phase = time.perf_counter()
    steps: list = []
    gc.collect()                  # the served models' reference cycles
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mesh = MS.make_host_mesh(dev)
    try:
        out = _train_on_mesh(smi, mesh, steps, t_phase, held)
    finally:
        MS.release()
    if dist.is_initialized():
        raise AssertionError("phase train left a process group alive")
    return out


def _train_on_mesh(smi: str, mesh, steps: list, t_phase: float,
                   held: int) -> dict:
    """Phase train's body, on the host ``mesh`` the phase made."""
    import torch
    from repro_torch.distributed.sharding import is_dtensor, use_mesh_rules
    from repro_torch.kernels.conv1d import ops as conv_ops
    from repro_torch.launch import train as TL
    from repro_torch.models.nn import count_params, tree_leaves
    from repro_torch.training import data
    conv_ops.conv1d_causal.launches = 0
    state = TL.main(list(TRAIN_ARGV),
                    on_metrics=lambda s, m, sec: steps.append(
                        (s, float(m["loss"]), float(m["grad_norm"]), sec)))
    launches = conv_ops.conv1d_causal.launches
    peak = torch.cuda.max_memory_allocated()
    args = TL.parse_args(list(TRAIN_ARGV))
    cfg, tc, dc = TL.configs(args)
    n_params = count_params(state.params)
    losses = [loss for _, loss, _, _ in steps]
    if n_params != N_PARAMS[DENSE_ARCH]:
        raise AssertionError(f"{n_params:,} parameters, want "
                             f"{N_PARAMS[DENSE_ARCH]:,}")
    leaves = tree_leaves(state.tree())
    if not all(is_dtensor(t) and t.device_mesh == mesh for t in leaves):
        raise AssertionError("the trained state is not DTensors on the host "
                             "mesh")
    if [s for s, *_ in steps] != list(range(args.steps)) or \
            not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses {losses}")
    if launches:
        raise AssertionError(f"training launched the conv kernel {launches} "
                             f"times")
    step_ms = statistics.median(sec for _, _, _, sec in steps[1:]) * 1e3
    tokens = args.batch * args.seq
    out = {"params": n_params, "dtype": cfg.dtype,
           "remat": cfg.remat_policy if cfg.remat else "none",
           "batch": args.batch, "seq": args.seq,
           "microbatches": args.microbatches, "losses": losses,
           "grad_norms": [g for _, _, g, _ in steps],
           "step_s": [sec for *_, sec in steps],
           "median_step_ms_2_8": step_ms, "tokens_per_s": tokens / step_ms
           * 1e3, "peak_memory_gb": peak / 1e9,
           "held_before_gb": held / 1e9, "conv1d_launches": launches,
           "mesh": {"shape": list(mesh.shape),
                    "backend": str(torch.distributed.get_backend()),
                    "dtensor_leaves": len(leaves)}}
    print(f"phase train {DENSE_ARCH}: {n_params:,} parameters ({cfg.dtype}, "
          f"remat {out['remat']}) trained {args.steps} steps of "
          f"{args.batch} x {args.seq} tokens in {args.microbatches} "
          f"microbatches through launch.train.main over the host mesh "
          f"{tuple(mesh.shape)} ('data', {out['mesh']['backend']}; "
          f"{len(leaves)} DTensor leaves): loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; median step (steps 2-{args.steps}) "
          f"{step_ms:.1f} ms, {out['tokens_per_s']:.0f} tokens/s; peak "
          f"memory {out['peak_memory_gb']:.2f} GB "
          f"(torch.cuda.max_memory_allocated; {out['held_before_gb']:.2f} GB "
          f"held before the phase); conv1d launches 0 | card {smi}")
    # one more step under the profiler: a retake takes another step from
    # the state the last one left, which is as good a step to profile
    box = [state]
    with use_mesh_rules(mesh, TL.host_rules()):
        tok = data.sharded_batch(dc, args.steps, mesh)
    step = TL.mesh_step(cfg, tc, mesh)

    def one_step():
        box[0], _ = step(box[0], tok)
    with _train_regions() as (regions, calls):
        prof = _profile(one_step, f"{DENSE_ARCH} train step", smi,
                        regions=regions, counters=(conv_ops.conv1d_causal,))
    nccl = sum(n for _, n, key in prof.pop("rows") if "nccl" in key.lower())
    busy, reg = prof["device_ms"], prof["by_region"]
    runs = 1 + prof["attempts"]                 # the warm-up and the trace
    per_run = {k: v / runs for k, v in calls.items()}
    told = per_run["recompute"] == per_run["layer"] == \
        cfg.n_layers * args.microbatches
    shares = {}
    for name in regions:
        if name == "recompute" and not told:
            continue
        ms = reg.get(name)
        if ms is not None:
            shares[name] = {"ms": ms, "share_of_device": ms / busy}
    rest = busy - reg.get("forward", 0.0) - reg.get("optimizer", 0.0)
    shares["backward_and_rest"] = {"ms": rest, "share_of_device": rest / busy}
    out["profile"] = {**prof, "shares": shares, "layer_calls": per_run,
                      "recompute_told_apart": told, "nccl_kernels": nccl}
    print(f"phase train profiled step: busy {busy:.1f} ms of wall "
          f"{prof['wall_ms']:.1f} ms (idle share "
          f"{100 * max(0.0, 1 - busy / prof['wall_ms']):.1f}%), "
          f"{prof['kernels']} kernels; "
          + ", ".join(f"{k} {v['ms']:.1f} ms "
                      f"({100 * v['share_of_device']:.1f}%)"
                      for k, v in shares.items())
          + ("" if told else f"; recompute not told apart (layer bodies per "
             f"step {per_run})") + f"; NCCL kernels in the step {nccl} "
          f"(one-rank mesh) | card {smi}")
    del state, box
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase train: {out['seconds']:.1f} s")
    return out


def _phase_train_resume(dev, smi: str) -> dict:
    """Kill and resume on the card, bit for bit: Qwen3's smoke config in
    bf16 (bf16 checkpoint leaves) through ``launch.train.main``: 6 steps
    straight, against 4 steps that checkpoint, a restart from the newest
    checkpoint into a fresh state and 2 more steps, under deterministic
    algorithms (this phase only)."""
    import os
    import tempfile

    import torch
    from repro_torch.launch import train as TL
    from repro_torch.models.nn import tree_leaves
    from repro_torch.training import checkpoint as ckpt

    t_phase = time.perf_counter()
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    runs: dict = {"whole": [], "cut": [], "resumed": []}

    def record(key):
        return lambda s, m, sec: runs[key].append((s, float(m["loss"])))
    try:
        (ROOT / "build").mkdir(exist_ok=True)
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            argv = list(RESUME_ARGV) + ["--device", str(dev)]
            whole = TL.main(argv + ["--steps", "6"],
                            on_metrics=record("whole"))
            TL.main(argv + ["--steps", "4", "--ckpt-dir", tmp],
                    on_metrics=record("cut"))
            latest = ckpt.latest_step(tmp)
            with open(os.path.join(tmp, f"step_{latest:08d}",
                                   ckpt.MANIFEST)) as f:
                dtypes = [v["dtype"] for v in json.load(f)["leaves"].values()]
            resumed = TL.main(argv + ["--steps", "6", "--ckpt-dir", tmp],
                              on_metrics=record("resumed"))
    finally:
        torch.use_deterministic_algorithms(False)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
    if latest != 4 or [s for s, _ in runs["resumed"]] != [4, 5]:
        raise AssertionError(f"checkpoint {latest}, resumed steps "
                             f"{runs['resumed']}")
    if runs["cut"] + runs["resumed"] != runs["whole"]:
        raise AssertionError(f"losses {runs['cut'] + runs['resumed']} != "
                             f"{runs['whole']}")
    leaves = list(zip(tree_leaves(whole.tree()), tree_leaves(resumed.tree())))
    same = sum(torch.equal(a, b) for a, b in leaves)
    if same != len(leaves):
        raise AssertionError(f"{len(leaves) - same} of {len(leaves)} state "
                             f"leaves differ after the resume")
    out = {"losses": [loss for _, loss in runs["whole"]],
           "leaves": len(leaves), "bf16_leaves": dtypes.count("bfloat16"),
           "checkpoint_leaves": len(dtypes),
           "seconds": time.perf_counter() - t_phase}
    print(f"phase train resume {DENSE_ARCH} smoke in bf16 (deterministic "
          f"algorithms): 4 steps, checkpoint at step {latest} "
          f"({out['bf16_leaves']} of {len(dtypes)} leaves bfloat16), restart, "
          f"2 steps = 6 steps straight: losses bit-identical "
          f"{[round(x, 6) for x in out['losses']]}, all {len(leaves)} state "
          f"leaves bit-identical; {out['seconds']:.1f} s | card {smi}")
    return out


def _phase_train_variants(dev, smi: str) -> dict:
    """Each arch's smoke config (float32, 2 microbatches) trained 2 steps on
    the card and on the CPU (the plain path) from the same weights (a
    VLM's gates set non-zero) and batches: losses and grad norms within
    ``TRAIN_VARIANT_TOL``.  Mamba2 and Zamba2 with ``use_kernels`` on must
    refuse to train on the card (the conv kernel has no backward)."""
    import importlib

    import torch
    from repro_torch.configs import ARCHS, get_config
    from repro_torch.kernels.conv1d import ops as conv_ops
    from repro_torch.models import model as M
    from repro_torch.models.nn import tree_map
    from repro_torch.training import data
    from repro_torch.training import optimizer as O
    T = importlib.import_module("repro_torch.training.train_step")

    t_phase = time.perf_counter()
    out: dict = {}
    worst = dict.fromkeys(TRAIN_VARIANT_TOL, 0.0)
    for arch in ARCHS:
        cfg = get_config(arch, smoke=True)
        params = M.init_params(cfg, 0, device="cpu")
        _open_gates(params, np.random.default_rng(5))
        dc = data.DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4,
                             seed=7)
        mem = _memory(cfg, np.random.default_rng(6), 4)
        tc = T.TrainConfig(microbatches=2, opt=O.OptConfig(
            lr=1e-3, warmup_steps=0, total_steps=10))
        got = {}
        for device in ("cpu", dev):
            p = tree_map(lambda t: t.to(device, copy=True), params)
            state = T.TrainState(params=p, opt=O.init(p))
            rows = []
            for s in range(2):
                state, m = T.train_step(
                    cfg, tc, state, data.device_batch(dc, s, device),
                    None if mem is None else mem.to(device))
                rows.append({k: float(m[k]) for k in TRAIN_VARIANT_TOL})
            got[str(torch.device(device).type)] = rows
        errs = {k: max(abs(c[k] - h[k]) / abs(h[k])
                       for c, h in zip(got["cuda"], got["cpu"]))
                for k in TRAIN_VARIANT_TOL}
        row = {"card": got["cuda"], "cpu": got["cpu"], "rel_err": errs}
        for k, tol in TRAIN_VARIANT_TOL.items():
            worst[k] = max(worst[k], errs[k])
            if not errs[k] <= tol:
                raise AssertionError(f"{arch}: {k} on the card vs the CPU "
                                     f"{errs[k]:.3g} > {tol}")
        if cfg.family in ("ssm", "hybrid"):
            kcfg = cfg.scaled(use_kernels=True)
            p = tree_map(lambda t: t.to(dev, copy=True), params)
            before = conv_ops.conv1d_causal.launches
            try:
                T.loss_and_grads(kcfg, tc, p,
                                 data.device_batch(dc, 0, dev))
            except RuntimeError as exc:
                if "no backward" not in str(exc):
                    raise
                row["kernel_guard"] = str(exc)
            else:
                raise AssertionError(f"{arch}: training with use_kernels "
                                     f"did not raise")
            if conv_ops.conv1d_causal.launches != before:
                raise AssertionError(f"{arch}: the guard launched the kernel")
        out[arch] = row
        print(f"phase train-variants {arch} smoke: 2 steps of 4 x 32 in 2 "
              f"microbatches, loss {got['cuda'][0]['loss']:.5f} -> "
              f"{got['cuda'][1]['loss']:.5f}, card vs CPU rel err loss "
              f"{errs['loss']:.2e}, grad norm {errs['grad_norm']:.2e}"
              + ("; use_kernels=True refused to train (no backward)"
                 if "kernel_guard" in row else "") + f" | card {smi}")
    out["worst_rel_err"] = worst
    out["tol"] = TRAIN_VARIANT_TOL
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase train-variants: {len(ARCHS)} archs within "
          f"{TRAIN_VARIANT_TOL} (worst {worst}); {out['seconds']:.1f} s")
    return out


def _phase_dryrun(dev, smi: str, train: dict) -> dict:
    """The fleet dry-run (``repro_torch.launch.dryrun``): the
    ``DRYRUN_CELLS`` traced in child processes on ``cuda`` meshes of the
    fake fleet, each record printed (predictions: H100 SXM datasheet
    constants, nothing measured); and the check that holds the dry-run to
    the card — phase train's cell traced on a (1, 1) mesh (a child) against
    one real step on the card counted by the same ``DeviceCounter``:
    argument bytes and FLOPs equal, the traced peak within
    ``DRYRUN_PEAK_TOL`` of phase train's ``max_memory_allocated``."""
    import os

    import torch
    from repro_torch.configs.base import ShapeCell
    from repro_torch.kernels.conv1d import ops as conv_ops
    from repro_torch.launch import train as TL
    from repro_torch.launch.dryrun import count_step

    t_phase = time.perf_counter()
    OUT_DIR.mkdir(exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    children = []
    try:
        for arch, cell, multi in DRYRUN_CELLS:
            out = OUT_DIR / f"dryrun_{arch}_{cell}.jsonl"
            out.unlink(missing_ok=True)
            log = open(OUT_DIR / f"dryrun_{arch}_{cell}.log", "w")
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--cell", cell, "--out", str(out),
                   "--no-resume"] + (["--multi-pod"] if multi else [])
            children.append(((arch, cell, out), log, subprocess.Popen(
                cmd, env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
                text=True)))
        one_log = open(OUT_DIR / "dryrun_one_card.log", "w")
        one = subprocess.Popen(
            [sys.executable, "-c", DRYRUN_ONE_CARD, json.dumps(TRAIN_ARGV)],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=one_log,
            text=True)
        children.append((None, one_log, one))

        # meanwhile, one real step of phase train's cell on the card
        args = TL.parse_args(list(TRAIN_ARGV))
        cfg, tc, _ = TL.configs(args)
        cell = ShapeCell("train", "train", args.seq, args.batch)
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        conv_ops.conv1d_causal.launches = 0
        counted = count_step(cfg, cell, tc, dev)
        torch.cuda.synchronize()
        step_peak = torch.cuda.max_memory_allocated() - held
        launches = conv_ops.conv1d_causal.launches
        gc.collect()
        torch.cuda.empty_cache()
        if launches:
            raise AssertionError(f"the counted step launched the conv "
                                 f"kernel {launches} times")

        deadline = time.monotonic() + DRYRUN_TIMEOUT
        stdout, _ = one.communicate(
            timeout=max(1.0, deadline - time.monotonic()))
        for _, _, p in children:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for _, log, p in children:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    bad = [(what, p.returncode) for what, _, p in children if p.returncode]
    if bad:
        raise AssertionError(f"dry-run children failed: {bad} (logs under "
                             f"{OUT_DIR})")

    out: dict = {"cells": [], "card": smi}
    for (arch, cell_name, path), _, _ in children[:-1]:
        rec = json.loads(path.read_text().splitlines()[0])
        if not rec.get("ok") or rec["t_memory_s"] <= 0 or \
                rec["chips"] not in (256, 512):
            raise AssertionError(f"dry-run {arch} x {cell_name}: {rec}")
        out["cells"].append(rec)
        print(f"phase dryrun {arch} x {cell_name} on {rec['mesh']} "
              f"({rec['chips']} H100s; prediction, H100 SXM datasheet "
              f"constants): {rec['per_device_gb']:.2f} GB per device "
              f"(args {rec['arg_gb']:.2f}), compute "
              f"{rec['t_compute_s']:.4g} s, memory {rec['t_memory_s']:.4g} "
              f"s, collective {rec['t_collective_s']:.4g} s -> "
              f"{rec['bottleneck']}, mfu at roofline "
              f"{rec['mfu_at_roofline']:.4f}; {rec['n_collectives']} "
              f"collectives {rec['coll_by_axis_mb']} MB; "
              f"{len(rec['replicated'])} kinds of port-added moves; traced "
              f"in {rec['trace_s']} s")
        print("  " + json.dumps(rec))
    rec = json.loads(stdout.strip().splitlines()[-1])
    measured = train["peak_memory_gb"] - train["held_before_gb"]
    predicted = rec["peak_bytes"] / 1e9
    one_card = {
        "arch": args.arch, "batch": args.batch, "seq": args.seq,
        "microbatches": args.microbatches, "dtype": cfg.dtype,
        "arg_bytes_predicted": rec["arg_bytes"],
        "arg_bytes_card": counted.arg_bytes,
        "flops_predicted": rec["flops_perdev"], "flops_card": counted.flops,
        "peak_gb_predicted": predicted,
        "peak_gb_phase_train": measured,
        "peak_gb_counted_step": step_peak / 1e9,
        "peak_gb_counter_on_card": counted.peak / 1e9,
        "peak_rel_err": predicted / measured - 1, "trace_s": rec["trace_s"]}
    out["one_card"] = one_card
    print(f"phase dryrun one-card check, {args.arch} train "
          f"{args.batch} x {args.seq} in {args.microbatches} microbatches "
          f"({cfg.dtype}, remat {cfg.remat_policy}), prediction | "
          f"measurement: argument bytes {rec['arg_bytes']:,} | "
          f"{counted.arg_bytes:,} (the card's state and tokens); FLOPs "
          f"{rec['flops_perdev']:,} | {counted.flops:,} (the same counter "
          f"on one real step); peak {predicted:.2f} GB | {measured:.2f} GB "
          f"(phase train's torch.cuda.max_memory_allocated less "
          f"{train['held_before_gb']:.2f} GB held before it; "
          f"{100 * one_card['peak_rel_err']:+.1f}%), this step's "
          f"max_memory_allocated {step_peak / 1e9:.2f} GB, the counter's "
          f"live peak on the card {counted.peak / 1e9:.2f} GB | card {smi}")
    if rec["arg_bytes"] != counted.arg_bytes:
        raise AssertionError("dry-run argument bytes differ from the card's")
    if rec["flops_perdev"] != counted.flops:
        raise AssertionError("dry-run FLOPs differ from the card's count")
    if abs(one_card["peak_rel_err"]) > DRYRUN_PEAK_TOL:
        raise AssertionError(f"dry-run peak {predicted:.2f} GB against "
                             f"{measured:.2f} GB on the card")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase dryrun: {out['seconds']:.1f} s")
    return out


#: phase examples: the port's examples, in the order they run
EXAMPLES = ("quickstart", "heat_diffusion_2d", "serve_stencils",
            "serve_batched", "train_lm")
#: train_lm_torch's steps in the smoke (its default is 300)
EXAMPLE_TRAIN_STEPS = 50


def _example(name: str):
    """``examples/<name>_torch.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", ROOT / "examples" / f"{name}_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Tee:
    """Writes to stdout and keeps a copy (an example's printed lines)."""

    def __init__(self):
        self.lines: list = []

    def write(self, text: str) -> int:
        self.lines.append(text)
        return sys.__stdout__.write(text)

    def flush(self) -> None:
        sys.__stdout__.flush()


def _phase_examples(dev, smi: str, wrappers: dict) -> dict:
    """Each ``examples/<name>_torch.py`` (``EXAMPLES``) run on the card
    through its ``main`` at its own size (``train_lm`` for
    ``EXAMPLE_TRAIN_STEPS`` steps), the kernel wrappers' launch counters set
    to 0 just before each and read just after: quickstart's backends
    against ``direct``; heat diffusion's seven paths within 1e-2 of
    ``direct`` (the example asserts) and their GStencil/s; every served
    stencil job against ``direct`` (the example asserts) and jobs/s;
    serve_batched's three models, Mamba2 through the conv kernel and its
    tokens against the same call with ``use_kernels=False`` (a token that
    differs must be a near tie: both models' logits at that place within
    ``LM_TOL_OFF``); train_lm's losses finite and falling over the host
    mesh, no process group left.  ``wrappers``: the smoke's kernel names
    -> wrappers; returns each example's launches by those names."""
    import contextlib as ctx
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.models import model as M

    t_phase = time.perf_counter()
    out: dict = {"launches": {}}
    total = dict.fromkeys(wrappers, 0)
    for name in EXAMPLES:
        mod = _example(name)
        for f in wrappers.values():
            f.launches = 0
        t0 = time.perf_counter()
        tee = _Tee()
        with ctx.redirect_stdout(tee):
            if name == "train_lm":
                (ROOT / "build").mkdir(exist_ok=True)
                with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
                    res = mod.main(["--steps", str(EXAMPLE_TRAIN_STEPS),
                                    "--ckpt-dir", tmp])
            else:
                res = mod.main([])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launched = {k: f.launches for k, f in wrappers.items()}
        for k, n in launched.items():
            total[k] += n
        out["launches"][name] = launched
        row = {"seconds": seconds, "launches": launched}
        if name == "quickstart":
            row["max_abs_err_vs_direct"] = res["errors"]
            if not res["is_24"] or max(res["errors"].values()) > TOL * (
                    1 + float(res["direct"].abs().max())):
                raise AssertionError(f"quickstart: {res['errors']}")
            # the quickstart's 2-D box runs cuda_sptc as the rows kernel
            for k in ("sptc_rows2d", "cuda_gemm", "cuda_direct"):
                if not launched[k]:
                    raise AssertionError(f"quickstart launched no {k}")
            summary = ", ".join(f"{b} {e:.2e}"
                                for b, e in res["errors"].items())
            print(f"phase examples quickstart_torch: max |err| vs direct "
                  f"{summary} | card {smi}")
        elif name == "heat_diffusion_2d":
            row["paths"] = res
            summary = ", ".join(f"{b} {r['gstencil_s']:.3f}"
                                for b, r in res.items())
            print(f"phase examples heat_diffusion_2d_torch 512^2 x 400 "
                  f"steps, GStencil/s (host clock, synced): {summary}; each "
                  f"within 1e-2 of direct (worst "
                  f"{max(r.get('max_err', 0.0) for r in res.values()):.2e})"
                  f" | card {smi}")
        elif name == "serve_stencils":
            row.update({k: res[k] for k in ("jobs", "wall_s", "jobs_per_s",
                                            "max_rel_err")})
            print(f"phase examples serve_stencils_torch: {res['jobs']} jobs "
                  f"from 8 clients in {res['wall_s']:.3f} s "
                  f"({res['jobs_per_s']:.1f} jobs/s), every job vs direct "
                  f"max |err| / (1 + |direct|) {res['max_rel_err']:.2e} | "
                  f"card {smi}")
        elif name == "serve_batched":
            if not launched["conv1d_causal"]:
                raise AssertionError("serve_batched: Mamba2 never reached "
                                     "the conv1d kernel")
            with ctx.redirect_stdout(_Tee()):
                off, prompt, params, cfg = mod.run(ARCH, dev,
                                                   use_kernels=False)
            on = res[ARCH]
            diff = (on != off).nonzero().tolist()
            ties = []
            for b, j in {(b, min(jj for bb, jj in diff if bb == b))
                         for b, _ in diff}:
                seq = torch.cat([prompt[b:b + 1], on[b:b + 1, :j]], dim=1)
                lk = M.forward(params, cfg.scaled(use_kernels=True), seq)[0]
                lp = M.forward(params, cfg, seq)[0]
                ties.append(_rel(lk[:, -1], lp[:, -1]))
            row.update({"mamba2_tokens_differ": len(diff),
                        "near_tie_rel_err": ties})
            tol = LM_TOL_OFF[ARCH]["float32"]
            print(f"phase examples serve_batched_torch: qwen3, mamba2, "
                  f"mixtral smoke served; mamba2 conv1d_causal launches "
                  f"{launched['conv1d_causal']}, its tokens vs "
                  f"use_kernels=False on the card: {len(diff)} of "
                  f"{on.numel()} differ"
                  + (f" (first differing place of each row: logits rel err "
                     f"{[f'{t:.2e}' for t in ties]}, tol {tol})"
                     if diff else "") + f" | card {smi}")
            if any(t > tol for t in ties):
                raise AssertionError(f"serve_batched: Mamba2's tokens differ "
                                     f"beyond a near tie: {ties}")
        else:
            losses = [float(m.group(1)) for m in re.finditer(
                r"step +\d+ loss ([0-9.naif]+)", "".join(tee.lines))]
            step = int(res.opt.step)
            row.update({"losses_logged": losses, "steps": step})
            if step != EXAMPLE_TRAIN_STEPS or not losses or \
                    not all(np.isfinite(losses)) or \
                    not losses[-1] < losses[0]:
                raise AssertionError(f"train_lm: step {step}, logged losses "
                                     f"{losses}")
            if dist.is_initialized():
                raise AssertionError("train_lm left a process group alive")
            print(f"phase examples train_lm_torch: {step} steps over the "
                  f"host mesh, logged losses {losses}, no process group "
                  f"left | card {smi}")
        print(f"phase examples {name}_torch: {seconds:.1f} s, launches "
              f"{launched}")
        out[name] = row
    out["total_launches"] = total
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase examples: {out['seconds']:.1f} s")
    return out


@contextlib.contextmanager
def _record_tunes(log: list):
    """Append ``(spec, shape, TuneResult)`` of every tune the tuner runs."""
    from repro_torch.tuner import api
    kept = api.autotune

    def recording(spec, shape, *args, **kwargs):
        res = kept(spec, shape, *args, **kwargs)
        log.append((spec, tuple(shape), res))
        return res
    api.autotune = recording
    try:
        yield
    finally:
        api.autotune = kept


def _launched(eng, counters: dict) -> tuple:
    """The key in ``counters`` of the wrapper one call of a one-step 1-D or
    2-D engine launches, and its launches a call, whatever its batch
    (``engine.kernel_launches``)."""
    from repro_torch.core.engine import kernel_launches
    (name, n), = kernel_launches(eng.plan_ir, eng.device).items()
    key, = (k for k, fn in counters.items() if fn.__name__ == name)
    return key, n


def _phase_tuned(dev, smi: str, randn, counters: dict, timing: dict) -> dict:
    """The tuner's entry points over the paper suite at the paper's size:
    every candidate timed, a ``cuda_*`` plan, the tuned output against
    ``direct``, and the plans persisted and read back without a tune."""
    import torch
    from repro_torch.core.engine import StencilEngine
    from repro_torch.core.stencil import paper_suite
    from repro_torch.kernels.dispatch import CUDA_BACKENDS
    from repro_torch.tuner import (PlanCache, autotune, plan_for, tuned_apply,
                                   tuned_engine)
    out: dict = {}
    cache = PlanCache()
    shapes = {}
    for fn in counters.values():
        fn.launches = 0
    main = dict.fromkeys(counters, 0)    # the tuner's entry points' launches
    t_phase = time.perf_counter()
    for spec in paper_suite():
        r = spec.radius
        dims = (N_1D,) if spec.ndim == 1 else (N_2D, N_2D)
        pts = float(np.prod(dims))
        x = randn(*(s + 2 * r for s in dims), seed=29 * spec.ndim + r)
        shapes[spec.name] = tuple(x.shape)
        tunes: list = []
        c0 = {b: fn.launches for b, fn in counters.items()}
        t0 = time.perf_counter()
        with _record_tunes(tunes):
            plan = plan_for(spec, x.shape, x.dtype, device=dev, cache=cache,
                            mode="time")
        tune_s = time.perf_counter() - t0
        (_, _, res), = tunes
        cands = [{"plan": c.plan.describe(), "ms": None if c.score is None
                  else c.score * 1e3, "error": c.error}
                 for c in res.candidates]
        for c in cands:
            print(f"phase tuned {spec.name} candidate {c['plan']:<16} "
                  + (f"{c['ms']:.3f} ms" if c["error"] is None else
                     f"error {c['error']}") + f" | card {smi}")
        bad = [c for c in cands if c["error"] is not None]
        if bad or res.mode != "time":
            raise AssertionError(f"{spec.name}: candidates failed: {bad}")
        if plan.backend not in CUDA_BACKENDS:
            raise AssertionError(f"{spec.name}: tuned plan {plan} is not a "
                                 f"kernel")
        got = tuned_apply(spec, x, cache=cache, mode="time")
        torch.cuda.synchronize()
        for b, fn in counters.items():
            main[b] += fn.launches - c0[b]
        want = StencilEngine(spec, "direct", device=dev)(x)
        err = _err(got, want, TOL)
        del got, want
        eng = tuned_engine(spec, x.shape, x.dtype, device=dev, cache=cache,
                           mode="time")
        e_ms = _time_ms(lambda: eng(x), 10, hold=False)
        fixed = {b: v["gstencil_s"]
                 for b, v in timing[spec.name]["engine"].items()
                 if b in CUDA_BACKENDS}
        best_b = max(fixed, key=fixed.get)
        cost_plan = autotune(spec, x.shape, x.dtype, device=dev,
                             mode="cost").plan
        out[spec.name] = {
            "plan": plan.describe(), "cost_plan": cost_plan.describe(),
            "candidates": cands, "tune_s": tune_s,
            "max_abs_err_vs_direct": err, "ms": e_ms,
            "gstencil_s": pts / e_ms / 1e6,
            "fastest_fixed": best_b, "fastest_fixed_gstencil_s": fixed[best_b]}
        print(f"phase tuned {spec.name} {'x'.join(map(str, dims))}: plan "
              f"{plan.describe()} (tuned in {tune_s:.2f} s), max |err| vs "
              f"direct {err:.3g} (tol {TOL}); tuned engine "
              f"{pts / e_ms / 1e6:.2f} GStencil/s ({e_ms:.3f} ms), phase 4's "
              f"fastest fixed backend {best_b} {fixed[best_b]:.2f} GStencil/s;"
              f" cost mode would pick {cost_plan.describe()} | card {smi}")
        del x, eng
        torch.cuda.empty_cache()
    out["launches"] = main
    stats = cache.stats.as_dict()
    # persistence: the plans saved under build/, read back by a fresh cache
    path = cache.save(ROOT / "build" / "tuner_plans.json")
    fresh = PlanCache(path=path)
    for spec in paper_suite():
        again = plan_for(spec, shapes[spec.name], torch.float32, device=dev,
                         cache=fresh, mode="time")
        if again.describe() != out[spec.name]["plan"]:
            raise AssertionError(f"{spec.name}: persisted plan {again} != "
                                 f"{out[spec.name]['plan']}")
    fstats = fresh.stats.as_dict()
    if fstats["tunes"] != 0 or fstats["plan_hit_rate"] != 1.0:
        raise AssertionError(f"persisted cache retuned: {fstats}")
    out.update({"stats": stats, "reloaded_stats": fstats,
                "seconds": time.perf_counter() - t_phase})
    print(f"phase tuned: {time.perf_counter() - t_phase:.1f} s, tuner stats "
          f"{stats}; {len(fresh)} plans saved to {path.relative_to(ROOT)} and "
          f"read back by a fresh PlanCache: tunes {fstats['tunes']}, "
          f"plan_hit_rate {fstats['plan_hit_rate']}; kernel launches "
          f"{out['launches']} | card {smi}")
    return out


SERVE_SPECS = (("star", 2, 1, 1), ("box", 2, 2, 2), ("box", 1, 1, 3))
SERVE_CLIENTS, SERVE_JOBS = 8, 12
SERVE_EDGE_2D = (1025, 2048)                 # halo-inclusive, one bucket
SERVE_LEN_1D = (2_097_153, 4_194_304)


def _phase_serve_stencil(dev, smi: str, counters: dict) -> dict:
    """Modest grids from many clients through ``StencilDriver``: eight
    client threads of twelve jobs each, every job checked against
    ``direct``, and the kernel launches of each super-batch counted."""
    import threading

    import torch
    from repro_torch.core.engine import StencilEngine
    from repro_torch.core.stencil import make_stencil
    from repro_torch.kernels.dispatch import CUDA_BACKENDS
    from repro_torch.serving import BatchPolicy, StencilDriver
    from repro_torch.tuner import Plan, PlanCache

    specs = [make_stencil(sh, nd, r, seed=sd) for sh, nd, r, sd in SERVE_SPECS]
    cache = PlanCache()
    driver = StencilDriver(cache=cache, padding="bucket", mode="time",
                           policy=BatchPolicy(max_batch=16, max_wait_ms=5.0),
                           device=dev)

    def job_shape(rng, spec):
        lo, hi = SERVE_EDGE_2D if spec.ndim == 2 else SERVE_LEN_1D
        return tuple(int(v) for v in rng.integers(lo, hi + 1, size=spec.ndim))

    for fn in counters.values():
        fn.launches = 0
    tunes: list = []
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    with _record_tunes(tunes):
        warm = []
        for i, spec in enumerate(specs):          # tunes and builds
            gen.manual_seed(1000 + i)
            shape = job_shape(np.random.default_rng(1000 + i), spec)
            warm.append(driver.submit(spec, torch.randn(
                shape, generator=gen, device=dev)))
        for f in warm:
            f.result(timeout=600)
    warm_s = time.perf_counter() - t0
    if len(tunes) != len(specs):
        raise AssertionError(f"warm-up ran {len(tunes)} tunes")
    plans = {spec.name: res.plan for spec, _, res in tunes}
    engines = {spec.name: cache.engine(spec, plans[spec.name], device=dev)
               for spec in specs}
    before = {b: fn.launches for b, fn in counters.items()}
    groups_before = {k: v["batches"]
                     for k, v in driver.metrics()["plans"].items()}

    def run_wave(seed: int):
        """Every client thread makes and submits its jobs; all answered."""
        jobs: list = [None] * (SERVE_CLIENTS * SERVE_JOBS)
        errors: list = []

        def client(c: int) -> None:
            try:
                g = torch.Generator(device=dev)
                g.manual_seed(seed + c)
                rng = np.random.default_rng(seed + c)
                for j in range(SERVE_JOBS):
                    i = c * SERVE_JOBS + j
                    spec = specs[i % len(specs)]
                    x = torch.randn(job_shape(rng, spec), generator=g,
                                    device=dev)
                    jobs[i] = (spec, x, driver.submit(spec, x))
            except BaseException as exc:          # reported after the join
                errors.append(exc)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"client threads failed: {errors}")
        results = [f.result(timeout=600) for _, _, f in jobs]
        return jobs, results, time.perf_counter() - t0

    jobs, results, wall = run_wave(0)
    torch.cuda.synchronize()
    after = {b: fn.launches for b, fn in counters.items()}
    metrics = driver.metrics()
    wave = {b: after[b] - before[b] for b in counters}
    # the same traffic again under the profiler (a wave is safe to repeat:
    # it submits fresh jobs): the device's busy and idle shares of a wave,
    # and the kernels' share of its device time; the trace holds every
    # stencil kernel the wave's row ops launched
    prof = _profile(lambda: run_wave(100), "serve-stencil wave", smi, top=6,
                    counters=tuple(counters.values()))
    rows_w = prof.pop("rows")
    kern_w = sum(ms for ms, _, key in rows_w
                 if any(nm in key for nm in STENCIL_KERNELS))
    wave_prof = {"wall_ms": prof["wall_ms"], "device_ms": prof["device_ms"],
                 "kernel_ms": kern_w, "attempts": prof["attempts"],
                 "idle_share": max(0.0, 1 - prof["device_ms"]
                                   / prof["wall_ms"]),
                 "kernel_share_of_device": kern_w / prof["device_ms"],
                 "launches": prof["counted"]}
    print(f"phase serve-stencil profiled wave: device busy "
          f"{prof['device_ms']:.2f} ms of {prof['wall_ms']:.2f} ms "
          f"(idle share {100 * wave_prof['idle_share']:.0f}%), stencil "
          f"kernels {kern_w:.2f} ms = "
          f"{100 * wave_prof['kernel_share_of_device']:.0f}% of device "
          f"time | card {smi}")
    driver.close()

    # every super-batch launched each kernel once per row op of its plan
    want = dict.fromkeys(counters, 0)
    per_batch = {}
    key_spec = {driver.group_key(s, x): s for s, x, _ in jobs}
    for key, m in metrics["plans"].items():
        spec = key_spec[key]
        batches = m["batches"] - groups_before.get(key, 0)
        eng = engines[spec.name]
        kernel, n = _launched(eng, counters)
        want[kernel] += batches * n
        per_batch[spec.name] = {"plan": plans[spec.name].describe(),
                                "batches": batches, "kernel": kernel,
                                "launches_per_batch": n,
                                "occupancy": m["batch_occupancy"],
                                "padding_efficiency": m["padding_efficiency"]}
    if wave != want:
        raise AssertionError(f"launches in the wave {wave} != plan row ops "
                             f"x super-batches {want}")
    # every job against direct
    worst = 0.0
    ref = {s.name: StencilEngine(s, "direct", device=dev) for s in specs}
    points = 0
    for (spec, x, _), y in zip(jobs, results):
        worst = max(worst, _err(y, ref[spec.name](x), TOL))
        points += int(np.prod([s - 2 * spec.radius for s in x.shape]))
    overall = metrics["overall"]
    n_jobs = len(jobs)
    out = {"jobs": n_jobs, "wall_s": wall, "warmup_s": warm_s,
           "jobs_per_s": n_jobs / wall, "points": points,
           "gstencil_s": points / wall / 1e9,
           "max_abs_err_vs_direct": worst, "groups": per_batch,
           "launches_in_wave": wave, "metrics": metrics,
           "profiled_wave": wave_prof}
    print(f"phase serve-stencil: {n_jobs} jobs from {SERVE_CLIENTS} client "
          f"threads in {wall:.3f} s ({n_jobs / wall:.1f} jobs/s, "
          f"{points / wall / 1e9:.2f} GStencil/s served), warm-up wave "
          f"{warm_s:.1f} s; occupancy {overall['batch_occupancy']}, p50 "
          f"{overall['latency']['p50_ms']:.1f} ms, p99 "
          f"{overall['latency']['p99_ms']:.1f} ms; all jobs within {TOL} of "
          f"direct (max |err| {worst:.3g}) | card {smi}")
    for name, g in per_batch.items():
        print(f"phase serve-stencil {name}: plan {g['plan']}, {g['batches']} "
              f"super-batches, occupancy {g['occupancy']}, padding "
              f"efficiency {g['padding_efficiency']}, {g['kernel']} launches "
              f"per super-batch {g['launches_per_batch']} (the plan's row "
              f"ops, whatever the batch size) | card {smi}")
    print(f"phase serve-stencil tuner: {metrics['tuner']}; kernel launches "
          f"in the wave {wave} | card {smi}")
    out["launches"] = after                 # warm-up and timed waves

    # one full super-batch of each spec through each kernel: launches per
    # call stay at the plan's row ops, and the call's share outside kernels
    out["super_batch"] = {}
    for spec in specs:
        g = torch.Generator(device=dev)
        g.manual_seed(7)
        bucket = (SERVE_EDGE_2D[1],) * 2 if spec.ndim == 2 else \
            (SERVE_LEN_1D[1],)
        xs = torch.randn((16,) + bucket, generator=g, device=dev)
        row = {}
        for b in CUDA_BACKENDS:
            tuned = plans[spec.name]
            plan = tuned if tuned.backend == b else Plan.default(spec, b)
            eng = cache.engine(spec, plan, device=dev)
            eng.apply_batched(xs)
            torch.cuda.synchronize()
            c0 = {k: fn.launches for k, fn in counters.items()}
            ys = eng.apply_batched(xs)
            torch.cuda.synchronize()
            key, per_call = _launched(eng, counters)
            n = counters[key].launches - c0[key]
            if n != per_call:
                raise AssertionError(f"{spec.name} {b}: {n} launches for a "
                                     f"batch of 16")
            for i in (0, 15):
                _err(ys[i], ref[spec.name](xs[i]), TOL)
            del ys
            call_ms = _time_ms(lambda: eng.apply_batched(xs), 5, hold=False)
            prof = _profile(lambda: eng.apply_batched(xs),
                            f"super-batch {spec.name} {b} x16", smi, top=4,
                            counters=(counters[key],))
            if prof["counted"][counters[key].__name__] != n:
                raise AssertionError(f"{spec.name} {b}: the profiled call "
                                     f"launched another count than {n}")
            kern = sum(ms for ms, _, op in prof.pop("rows")
                       if any(nm in op for nm in STENCIL_KERNELS))
            row[b] = {"plan": plan.describe(), "launches": n,
                      "call_ms": call_ms, "kernel_device_ms": kern,
                      "outside_kernel_share": max(0.0, 1 - kern / call_ms),
                      "gstencil_s": 16 * float(np.prod(
                          [s - 2 * spec.radius for s in bucket]))
                      / call_ms / 1e6}
            print(f"super-batch {spec.name} {plan.describe()} x16 {bucket}: "
                  f"{n} launches, "
                  f"call {call_ms:.3f} ms ({row[b]['gstencil_s']:.2f} "
                  f"GStencil/s), kernels {kern:.3f} ms, outside-kernel share "
                  f"{100 * row[b]['outside_kernel_share']:.0f}% | card {smi}")
        out["super_batch"][spec.name] = row
        del xs
        torch.cuda.empty_cache()
    del jobs, results
    torch.cuda.empty_cache()
    return out


def _phase_vet(dev, smi: str, randn) -> dict:
    """The port's verifier on the card: invariants and code lint over
    ``src/repro_torch``, the launch audit at the probe shapes, its planted
    gather and the v1 control, then the whole paper suite at full size
    through ``cuda_sptc`` and ``cuda_gemm``, whose outside-kernel counts
    must equal those at the probe shape.  Every audited call's output is
    held against the direct engine's."""
    import torch
    from repro_torch.core.engine import StencilEngine
    from repro_torch.core.stencil import make_stencil, paper_suite
    from repro_torch.kernels.sptc_spmm import ops as sptc_ops
    from repro_torch.kernels.stencil_gemm import ops as gemm_ops
    from repro_torch.vet import code as vet_code
    from repro_torch.vet import invariants, lowering
    from repro_torch.vet.baseline import Baseline
    from repro_torch.vet.config import VetConfig, load_config
    from repro_torch.vet.findings import counts_by_severity

    out: dict = {}
    t_phase = time.perf_counter()
    traces0 = dict(lowering.TRACE_STATS)
    # the repo's pyproject holds no [tool.repro-torch-vet] block
    cfg, default = load_config(root=ROOT), VetConfig(root=ROOT)
    for field in dataclasses.fields(VetConfig):
        got, want = getattr(cfg, field.name), getattr(default, field.name)
        if got != want:
            raise AssertionError(f"load_config at {ROOT}: {field.name} "
                                 f"{got!r}, the default {want!r}")
    baseline = Baseline.load(cfg.baseline_path())
    tree = [ROOT / "src" / "repro_torch"]
    n_files = len(list(vet_code.iter_py_files(tree)))
    if n_files == 0:
        raise AssertionError(f"the code analyzer found no file under {tree}")
    for name, fs in (("invariants", invariants.run(cfg)),
                     ("code", vet_code.run(cfg, tree))):
        new, suppressed, _ = baseline.split(fs)
        out[name] = {"counts": counts_by_severity(new),
                     "baselined": len(suppressed),
                     "findings": [f.format() for f in new]}
        print(f"phase vet {name}: {counts_by_severity(new)}, "
              f"{len(suppressed)} baselined"
              + (f" ({n_files} files)" if name == "code" else ""))
        for f in new:
            print("  " + f.format())

    # a check of the profiler, not of the path: its launches are not counted
    out["trace_check"] = _trace_check(dev, smi)
    counters = {"sptc_spmm_fused": sptc_ops.sptc_spmm_fused,
                "sptc_spmm_rows2d": sptc_ops.sptc_spmm_rows2d,
                "sptc_spmm_star2d": sptc_ops.sptc_spmm_star2d,
                "windows_gemm": gemm_ops.windows_gemm,
                "sptc_spmm_windows": sptc_ops.sptc_spmm_windows}
    for fn in counters.values():
        fn.launches = 0
    findings, verdict = lowering.run(cfg, device=dev)
    out["verdict"] = verdict
    out["findings"] = [f.format() for f in findings]
    for kernel in sorted(verdict):
        v = verdict[kernel]
        print(f"phase vet audit {kernel}: "
              f"{'certified' if v['certified'] else 'NOT certified'}"
              + (f", rebuild {v['rebuild']}" if "rebuild" in v else ""))
        for probe, c in sorted(v["probes"].items()):
            print(f"  {probe}: " + " ".join(f"{k}={c[k]}" for k in c))
    for f in findings:
        print("  " + f.format())
    wrong = [f.format() for f in findings
             if f.rule == "launch-output-mismatch"]
    if wrong:
        raise AssertionError("audited calls disagree with direct: "
                             + "; ".join(wrong))

    # the controls: a planted standalone gather (before the launch, and
    # inside the kernel's region) and the v1 path must be flagged by the
    # fused rules, and compute the stencil all the same
    out["controls"] = {}
    fused_rules = ("pallas-fused-gather", "pallas-fused-overhead")
    for shape_kind in ("star", "box"):
        spec = make_stencil(shape_kind, 2, 1, seed=7)
        x = lowering.probe_input((22, 22), dev)
        for label, fn, want in (
                ("planted x2d[perm]", lowering.planted_gather(spec, dev),
                 fused_rules),
                ("planted x2d[perm] in region",
                 lowering.planted_gather(spec, dev, in_region=True),
                 fused_rules),
                ("v1 apply_sptc_v1", lowering.v1_path(spec),
                 fused_rules + ("pallas-fused-program",)),
                ("planted launch outside any region",
                 lowering.planted_outside_launch(spec, dev),
                 ("outside-device-ops",))):
            fs, got, _ = lowering.audit_fused(cfg, fn, spec, x,
                                              f"{label}/{spec.name}")
            rules = sorted({f.rule for f in fs})
            if "launch-output-mismatch" in rules:
                raise AssertionError(f"the {label} control on {spec.name} "
                                     "disagrees with direct")
            out["controls"][f"{label}/{spec.name}"] = {
                "rules": rules, "counts": got.counts}
            print(f"phase vet control {label} {spec.name}: flagged {rules}; "
                  + " ".join(f"{k}={v}" for k, v in got.counts.items()))
            if not set(rules) & set(want):
                raise AssertionError(f"the fused rules pass the {label} "
                                     f"control on {spec.name}")

    # the paper suite at full size: counts as at the probe shape
    out["suite"] = {}
    for spec in paper_suite():
        r = spec.radius
        dims = (N_1D,) if spec.ndim == 1 else (N_2D, N_2D)
        small = (200,) if spec.ndim == 1 else (16, 16)
        x_small = lowering.probe_input(tuple(s + 2 * r for s in small), dev)
        x = randn(*(s + 2 * r for s in dims), seed=41 * spec.ndim + r)
        direct = StencilEngine(spec, "direct", device=dev)
        want, want_small = direct(x), direct(x_small)
        audits, errs, calls = {}, {}, {}
        for b in ("cuda_gemm", "cuda_sptc"):
            eng = StencilEngine(spec, b, device=dev)
            key, per_call = _launched(eng, counters)
            counter = counters[key]
            small = lowering.audit_call(eng, x_small)
            probe = small.counts
            n0 = counter.launches
            full = lowering.audit_call(eng, x)
            errs[b] = _err(full.out, want, TOL)
            _err(small.out, want_small, TOL)
            full.out = small.out = None
            calls[b] = counter.launches - n0
            _check_audit_launches(f"{spec.name} {b}", calls[b], full,
                                  per_call)
            if (spec.name, b) == PLANTED_RETAKE:
                out["planted_retake"] = _planted_retake(
                    eng, x, want, counter, per_call, full,
                    f"{spec.name} {b}", smi)
            if full.counts != probe:
                raise AssertionError(
                    f"{spec.name} {b}: outside-kernel counts depend on the "
                    f"size: {probe} at {tuple(x_small.shape)}, {full.counts} "
                    f"at {tuple(x.shape)}")
            audits[b] = full
        dense = audits["cuda_gemm"].counts
        fs = lowering.check_fused(
            cfg, f"sptc_spmm_fused/{spec.name}", audits["cuda_sptc"].counts,
            audits["cuda_sptc"].regions, dense, spec)
        for b, a in audits.items():
            fs += lowering.check_device_ops(cfg, f"{b}/{spec.name}",
                                            a.counts)
        row = {}
        for b, a in audits.items():
            row[b] = dict(a.counts, kernel_ms=a.device_ms["kernel"],
                          outside_ms=a.device_ms["outside"],
                          kernel_share=a.kernel_share,
                          max_abs_err_vs_direct=errs[b],
                          launches=calls[b], attempts=a.attempts)
            print(f"phase vet {spec.name} {'x'.join(map(str, dims))} {b}: "
                  + " ".join(f"{k}={v}" for k, v in a.counts.items())
                  + f" | launches {calls[b]} in 1 + {a.attempts} calls "
                  f"(retaken {a.attempts - 1})"
                  + f" | device kernel {a.device_ms['kernel']:.3f} ms, "
                  f"outside {a.device_ms['outside']:.3f} ms, kernel share "
                  f"{100 * a.kernel_share:.1f}% (same counts at "
                  f"{'x'.join(map(str, x_small.shape))}), max |err| vs "
                  f"direct {errs[b]:.3g} | card {smi}")
        row["fused_rules"] = [f.format() for f in fs]
        print(f"phase vet {spec.name} cuda_sptc fused rules and "
              f"outside-device-ops (both backends): "
              + ("certified" if not fs else
                 "; ".join(f"[{f.rule}] {f.message}" for f in fs)))
        if any(f.rule == "outside-device-ops" for f in fs):
            raise AssertionError(f"{spec.name}: device work no torch op "
                                 f"explains: {[f.format() for f in fs]}")
        out["suite"][spec.name] = row
        del x, want
        torch.cuda.empty_cache()
    if "planted_retake" not in out:
        raise AssertionError(f"phase vet planted no retake: no audit of "
                             f"{PLANTED_RETAKE}")
    out["launches"] = {k: fn.launches for k, fn in counters.items()}
    for k, n in out["launches"].items():
        if n == 0:
            raise AssertionError(f"phase vet never launched {k}")
    out["configured"] = _vet_configured(smi, verdict[lowering.FUSED_KERNEL])
    out["seconds"] = time.perf_counter() - t_phase
    out["profiler_traces"] = {k: n - traces0[k]
                              for k, n in lowering.TRACE_STATS.items()}
    print(f"phase vet: {out['seconds']:.1f} s, kernel launches "
          f"{out['launches']}; card traces {out['profiler_traces']['traces']}"
          f", retaken {out['profiler_traces']['retaken']} (1 planted)")
    return out


def _vet_configured(smi: str, fused_verdict: dict) -> dict:
    """``python -m repro_torch.vet --analyzers invariants,lowering --json``
    on the card, from a directory whose pyproject holds ``VET_BLOCK``, once
    per severity of ``lowering-hot-gather``: the exit code of
    ``VET_SEVERITY_RC``; that rule on every sptc probe at the severity, or
    nowhere when it is off, and no other finding; no gemm probe; the fused
    kernel's verdict as in the default run (``fused_verdict``); the 2-D
    sparse kernels its probes run (the rows and the star kernel) and the
    gemm kernel launched."""
    import collections
    import os
    import tempfile

    from repro_torch.vet.lowering import FUSED_KERNEL

    out = {}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-c", VET_CLI, "--analyzers",
           "invariants,lowering", "--json"]
    want_fused = json.loads(json.dumps(fused_verdict))
    (ROOT / "build").mkdir(exist_ok=True)
    for severity, want_rc in VET_SEVERITY_RC:
        with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
            (Path(tmp) / "pyproject.toml").write_text(
                VET_BLOCK.format(severity=severity))
            t0 = time.perf_counter()
            res = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True,
                                 text=True, timeout=600)
            seconds = time.perf_counter() - t0
        label = f"phase vet configured lowering-hot-gather={severity}"
        tail = res.stderr.strip().splitlines()
        if not tail or not tail[-1].startswith("launches "):
            raise AssertionError(f"{label}: exit {res.returncode}, no "
                                 f"launch counts: {res.stderr[-3000:]}")
        launches = json.loads(tail[-1].split(" ", 1)[1])
        report = json.loads(res.stdout)
        verdict = report["verdict"]
        by_rule = dict(collections.Counter(
            f"{f['rule']}:{f['severity']}" for f in report["findings"]))
        probes = {k: len(v["probes"]) for k, v in verdict.items()}
        certified = {k: v["certified"] for k, v in verdict.items()}
        print(f"{label}: exit {res.returncode}, findings {by_rule}, probes "
              f"{probes}, certified {certified}, launches {launches}, "
              f"{seconds:.1f} s wall | card {smi}")
        sptc = sorted(verdict["sptc_spmm"]["probes"])
        want_flagged = [] if severity == "off" else sptc
        flagged = sorted(f["symbol"] for f in report["findings"]
                         if f["rule"] == "lowering-hot-gather"
                         and f["severity"] == severity)
        gemm = [p for v in verdict.values() for p in v["probes"]
                if "gemm" in p] + [k for k in verdict if "gemm" in k]
        problems = []
        if not sptc:
            problems.append("no sptc probe")
        if res.returncode != want_rc:
            problems.append(f"exit {res.returncode}, want {want_rc}")
        if flagged != want_flagged:
            problems.append(f"lowering-hot-gather on {flagged}, want "
                            f"{want_flagged}")
        if len(report["findings"]) != len(flagged):
            problems.append(f"findings {by_rule}")
        if gemm:
            problems.append(f"gemm in the verdict: {gemm}")
        if verdict.get(FUSED_KERNEL) != want_fused:
            problems.append(f"fused verdict {verdict.get(FUSED_KERNEL)}, "
                            f"the default run's {want_fused}")
        if not (launches["sptc_spmm_rows2d"] and launches["sptc_spmm_star2d"]
                and launches["windows_gemm"]):
            problems.append(f"launches {launches}")
        if problems:
            raise AssertionError(f"{label}: " + "; ".join(problems)
                                 + f" | {res.stderr[-2000:]}")
        out[severity] = {"rc": res.returncode, "findings": by_rule,
                         "probes": probes, "certified": certified,
                         "launches": launches, "seconds": seconds}
    return out


def _check_audit_launches(label: str, launches: int, audit, per_call: int):
    """An audited call's launches: ``per_call`` in the warm-up and in each
    of the ``audit.attempts`` traced runs (a retaken trace runs the call
    again), and ``per_call`` regions and kernels in the trace kept."""
    calls = 1 + audit.attempts
    if launches != calls * per_call or \
            audit.counts["programs"] != per_call or \
            audit.counts["kernels"] != per_call:
        raise AssertionError(
            f"{label}: {launches} launches in {calls} calls (1 warm-up, "
            f"{audit.attempts} traced), {audit.counts['programs']} regions "
            f"and {audit.counts['kernels']} kernels in the trace kept, for "
            f"{per_call} row ops")


def _planted_retake(eng, x, want, counter, per_call: int, unplanted,
                    label: str, smi: str) -> dict:
    """The audit of ``eng`` on ``x`` again, with the first trace's markers
    hidden (``vet.lowering.planted_lost_head``), as when the profiler loses
    a trace's head: the trace must be retaken, the launches must count the
    retake, and the trace kept must hold the unplanted audit's counts and
    the direct engine's output."""
    from repro_torch.vet import lowering
    n0 = counter.launches
    with lowering.planted_lost_head():
        a = lowering.audit_call(eng, x)
    launches = counter.launches - n0
    err = _err(a.out, want, TOL)
    a.out = None
    if a.attempts < 2:
        raise AssertionError(f"{label}: a trace without its markers was not "
                             f"retaken ({a.attempts} attempt)")
    _check_audit_launches(f"{label} (planted retake)", launches, a, per_call)
    if a.counts != unplanted.counts:
        raise AssertionError(f"{label}: the retaken audit counts {a.counts}, "
                             f"the unplanted one {unplanted.counts}")
    print(f"phase vet planted retake {label}: first trace's markers hidden, "
          f"retaken {a.attempts - 1} (1 planted), launches {launches} = "
          f"(1 + {a.attempts}) x {per_call}, counts of the trace kept equal "
          f"the unplanted audit's, max |err| vs direct {err:.3g} | card {smi}")
    return {"attempts": a.attempts, "launches": launches,
            "per_call": per_call, "counts": a.counts,
            "max_abs_err_vs_direct": err}


HALO_MESHES = ((2,), (2, 2))


def _device_ops(fn) -> list:
    """``(start, ms, name)`` of every device op of one call of ``fn``
    (``torch.profiler``, after a warm-up), in device order.

    The trace is the launch audit's (``vet.lowering.trace_device``): a
    spin kernel opens it and is left out, and a trace that lost it (and
    with it the head of the call) is taken again."""
    import torch
    from torch.autograd import DeviceType
    from repro_torch.kernels.common import ENGINE_SPANS, KERNEL_REGIONS
    from repro_torch.vet.lowering import is_marker, trace_device
    fn()
    events, _, _ = trace_device(fn, torch.device("cuda", 0))
    return sorted((e.time_range.start,
                   (e.time_range.end - e.time_range.start) / 1e3, e.name)
                  for e in events
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation
                  and e.name not in KERNEL_REGIONS
                  and e.name not in ENGINE_SPANS
                  and not is_marker(e))


def _halo_split(eng, ext, geo, per_call: int) -> dict:
    """One sharded step's device time (the state-resident step path of
    ``iterate``): the interior call's stencil kernels (the first
    ``per_call`` in device order: the interior is issued before the rims),
    the rims' stencil kernels, the exchange (its copies and zero fills,
    profiled alone) and the rest (the engine's work around its kernels,
    the results' copies into the next buffer, phantom-row zeroing)."""
    step = _device_ops(lambda: eng._steps(ext, geo, 1))
    exchange = _device_ops(lambda: eng._exchange(ext, geo))
    kern = [ms for _, ms, name in step
            if any(k in name for k in STENCIL_KERNELS)]
    total = sum(ms for _, ms, _ in step)
    out = {"interior_kernels_ms": sum(kern[:per_call]),
           "rim_kernels_ms": sum(kern[per_call:]),
           "exchange_ms": sum(ms for _, ms, _ in exchange),
           "device_ms": total, "device_ops": len(step),
           "exchange_ops": len(exchange), "stencil_kernels": len(kern)}
    out["rest_ms"] = total - out["interior_kernels_ms"] - \
        out["rim_kernels_ms"] - out["exchange_ms"]
    return out


def _device_sequence(audit) -> list:
    """The device ops of an audit's call, in order (its ``sequence`` less
    the top-level torch ops and regions)."""
    from repro_torch.kernels.common import KERNEL_REGIONS
    return [n for n in audit.sequence
            if not n.startswith("aten::") and n not in KERNEL_REGIONS]


def _lost_ops(want: list, got: list) -> list:
    """``(place in the call's device order, name)`` of every op of ``want``
    that ``got`` lacks (matched in order)."""
    import difflib
    sm = difflib.SequenceMatcher(a=want, b=got, autojunk=False)
    return [(i, want[i]) for tag, i1, i2, _, _ in sm.get_opcodes()
            if tag in ("delete", "replace") for i in range(i1, i2)]


def _trace_check(dev, smi: str, n: int = TRACE_CHECK_N,
                 label: str = "phase vet") -> dict:
    """How often a trace of one call loses device ops, and whether the
    launch audit's traces (``vet.lowering.trace_device``) ever do: ``n``
    bare traces and ``n`` audit traces of box-2d1r ``cuda_sptc`` at a
    probe shape, each held against the audit's first count (and the bare
    traces' lost device ops counted).  An audit trace with other counts is
    reported on a line of its own: the ops it lost, by name and place in
    the call's device order, and whether it kept its lead spins and its
    tail spin.  Raises if an audit trace differs."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.engine import StencilEngine
    from repro_torch.core.stencil import make_stencil
    from repro_torch.vet import lowering
    eng = StencilEngine(make_stencil("box", 2, 1, seed=7), "cuda_sptc",
                        device=dev)
    x = lowering.probe_input((18, 18), dev)
    first = lowering.audit_call(eng, x)
    want = first.counts
    want_seq = _device_sequence(first)
    n_ops = want["kernels"] + want["device_ops"]
    bare_lost, lost_ops = 0, []
    for _ in range(n):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng(x)
            torch.cuda.synchronize()
        got = lowering._summarize(prof.events(), True).counts
        bare_lost += got != want
        lost_ops.append(n_ops - got["kernels"] - got["device_ops"])
    t0 = dict(lowering.TRACE_STATS)
    wrong, lead_lost = [], []
    for i in range(n):
        a = lowering.profile_call(eng, x)
        lead_lost.append(a.trace["lead"] - a.trace["lead_kept"])
        if a.counts == want:
            continue
        lost = _lost_ops(want_seq, _device_sequence(a))
        report = {"trace": i, "counts": a.counts, "lost": lost,
                  "attempts": a.attempts, **a.trace}
        wrong.append(report)
        print(f"{label} trace check: audit trace {i} lost "
              f"{len(lost)} of {n_ops} device ops "
              f"{[f'#{p} {name[:60]}' for p, name in lost]}; lead spins "
              f"kept {a.trace['lead_kept']}/{a.trace['lead']}, tail spin "
              f"kept {a.trace['tail_kept']}, region kernels kept "
              f"{a.trace['kept']} of launched {a.trace['launched']}; "
              f"{a.attempts} attempts | card {smi}")
    stats = {k: lowering.TRACE_STATS[k] - t0[k] for k in t0}
    print(f"{label} trace check box-2d1r cuda_sptc 18x18: bare traces "
          f"that lost device ops {bare_lost}/{n} (lost of {n_ops}: at most "
          f"{max(lost_ops)}, mean {statistics.mean(lost_ops):.2f}); audit "
          f"traces {n} ({stats['retaken']} retaken: {stats['lost_head']} "
          f"without a lead spin, {stats['lost_tail']} without the tail "
          f"spin, {stats['short_kernels']} short of a launched kernel; "
          f"{stats['kept_lead_partly_lost']} kept with some lead spins "
          f"lost: at most {max(lead_lost)}, mean "
          f"{statistics.mean(lead_lost):.2f} of the kept traces' spins), "
          f"{len(wrong)} with other counts than {want['kernels']} "
          f"kernels + {want['device_ops']} device ops | card {smi}")
    if wrong:
        raise AssertionError(f"{len(wrong)} of {n} audit traces lost device "
                             f"ops: {wrong}")
    return {"n": n, "bare_lost": bare_lost, "bare_lost_ops_max":
            max(lost_ops), "bare_lost_ops_mean": statistics.mean(lost_ops),
            "audit_retaken": stats["retaken"], "audit_stats": stats,
            "lead_spins_lost_max": max(lead_lost),
            "lead_spins_lost_mean": statistics.mean(lead_lost),
            "audit_wrong": len(wrong), "counts": want}


def _phase_halo(dev, smi: str, randn) -> dict:
    """The halo-exchange engine with every shard on this card: the paper
    suite's 2-D specs at 10240² on meshes (2,) and (2, 2) through
    ``cuda_direct`` and ``cuda_sptc`` (box-2d1r also through ``cuda_gemm``
    and with ``temporal_steps=2``), a non-divisible 10237 x 10239 grid, the
    1-D box at 104,857,600 points on (4,), then ``tuned_apply`` and
    ``StencilDriver`` with a mesh.  Every sharded output is held against
    the single-device engine; launches, exchanges, GStencil/s beside the
    single-device engine's, and a profiled step's device-time split are
    printed."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.engine import StencilEngine
    from repro_torch.core.stencil import make_stencil, paper_suite
    from repro_torch.distributed import ShardedStencilEngine, grid_mesh
    from repro_torch.kernels.sptc_spmm import ops as sptc_ops
    from repro_torch.kernels.stencil_direct import ops as direct_ops
    from repro_torch.kernels.stencil_gemm import ops as gemm_ops
    from repro_torch.serving import BatchPolicy, StencilDriver
    from repro_torch.tuner import PlanCache, tuned_apply
    from repro_torch.vet.lowering import TRACE_STATS

    counters = {"cuda_sptc": sptc_ops.sptc_spmm_fused,
                "sptc_rows2d": sptc_ops.sptc_spmm_rows2d,
                "sptc_star2d": sptc_ops.sptc_spmm_star2d,
                "cuda_gemm": gemm_ops.windows_gemm,
                "cuda_direct": direct_ops.stencil2d}
    for fn in counters.values():
        fn.launches = 0
    aside = dict.fromkeys(counters, 0)     # the single-device comparisons

    @contextlib.contextmanager
    def not_main():
        c0 = {b: f.launches for b, f in counters.items()}
        yield
        for b, f in counters.items():
            aside[b] += f.launches - c0[b]

    def mesh(parts):
        return grid_mesh(parts, devices=[dev] * int(np.prod(parts)))

    suite = paper_suite()
    box1 = next(s for s in suite if s.name == "box-2d1r")
    cases = [(spec, (N_2D, N_2D), parts, b, 1)
             for spec in suite if spec.ndim == 2
             for parts in HALO_MESHES for b in ("cuda_direct", "cuda_sptc")]
    cases += [(box1, (N_2D, N_2D), parts, b, k) for parts in HALO_MESHES
              for b, k in (("cuda_gemm", 1), ("cuda_sptc", 2))]
    cases += [(box1, (N_2D - 3, N_2D - 1), (2, 2), b, 1)
              for b in ("cuda_direct", "cuda_sptc")]
    cases += [(next(s for s in suite if s.name == "box-1d1r"), (N_1D,), (4,),
               b, 1) for b in ("cuda_direct", "cuda_sptc")]
    t_phase = time.perf_counter()
    rows = []
    for i, (spec, dims, parts, b, k) in enumerate(cases):
        h = k * spec.radius
        pts = float(np.prod(dims))
        u = randn(*dims, seed=300 + i)
        x = F.pad(u[None], (h,) * (2 * len(dims)))[0]
        eng = ShardedStencilEngine(spec, mesh(parts), backend=b,
                                   temporal_steps=k)
        one = StencilEngine(spec, b, temporal_steps=k, device=dev)
        naxes = len(eng.partition())
        key, per_call = _launched(one, counters)
        per_call *= k
        want_launch = (1 + 2 * naxes) * per_call
        c0 = counters[key].launches
        eng.transport.reset()
        got = eng(x)
        torch.cuda.synchronize()
        launches = counters[key].launches - c0
        exchanges, sent = eng.transport.calls, eng.transport.sent_bytes
        with not_main():
            want = one(x)
            direct = StencilEngine(spec, "direct", temporal_steps=k,
                                   device=dev)(x)
        e_one = _err(got, want, TOL)
        e_direct = _err(got, direct, TOL)
        del got, want, direct
        got = eng.iterate(u, 4)
        with not_main():
            want = one.iterate(x, 4)[tuple(slice(h, -h) for _ in dims)]
        e_it = _err(got, want, TOL)
        del got, want
        if launches != want_launch or exchanges != 2 * naxes:
            raise AssertionError(
                f"halo {spec.name} {parts} {b}: {launches} launches, "
                f"{exchanges} exchanges in one step; want {want_launch} and "
                f"{2 * naxes}")
        ms = _time_ms(lambda: eng(x), 5, hold=False)
        it_ms = _time_ms(lambda: eng.iterate(u, 4), 2, hold=False) / 4
        with not_main():
            one_ms = _time_ms(lambda: one(x), 5, hold=False)
            one_it_ms = _time_ms(lambda: one.iterate(x, 4), 2,
                                 hold=False) / 4
        geo = eng._geometry(tuple(dims))
        ext = eng._scatter(u[None], geo)
        split = _halo_split(eng, ext, geo, per_call)
        del ext
        shards = eng.n_shards
        row = {"spec": spec.name, "dims": list(dims), "mesh": list(parts),
               "backend": b, "temporal_steps": k, "shards": shards,
               "launches_per_step": launches,
               "launch_formula": f"(1 interior + 2 rims x {naxes} axes) x "
                                 f"{per_call} launches per call, all "
                                 f"{shards} shards in each batched call",
               "exchanges_per_step": exchanges,
               "bytes_exchanged_per_step": sent,
               "max_abs_err_vs_single": e_one,
               "max_abs_err_vs_direct": e_direct,
               "iterate4_max_abs_err_vs_single": e_it,
               "call_ms": ms, "gstencil_s": pts / ms / 1e6,
               "single_call_ms": one_ms, "single_gstencil_s": pts / one_ms / 1e6,
               "iterate_step_ms": it_ms,
               "iterate_gstencil_s": pts / it_ms / 1e6,
               "single_iterate_step_ms": one_it_ms,
               "single_iterate_gstencil_s": pts / one_it_ms / 1e6,
               "step_split": split}
        rows.append(row)
        tag = f"/k{k}" if k != 1 else ""
        print(f"phase halo {spec.name} {'x'.join(map(str, dims))} mesh "
              f"{'x'.join(map(str, parts))} {b}{tag}: max |err| vs single "
              f"{e_one:.3g}, vs direct {e_direct:.3g}, iterate(4) {e_it:.3g} "
              f"(tol {TOL}); launches per step {launches} = "
              f"{row['launch_formula']}; exchanges per step {exchanges}, "
              f"{sent:,} bytes; sharded {row['gstencil_s']:.2f} GStencil/s "
              f"({ms:.3f} ms) vs single-device {row['single_gstencil_s']:.2f} "
              f"({one_ms:.3f} ms); iterate per step {it_ms:.3f} ms vs "
              f"{one_it_ms:.3f} ms; one step's device time: interior kernels "
              f"{split['interior_kernels_ms']:.3f} ms, rim kernels "
              f"{split['rim_kernels_ms']:.3f} ms, exchange "
              f"{split['exchange_ms']:.3f} ms ({split['exchange_ops']} ops), "
              f"rest {split['rest_ms']:.3f} ms, of {split['device_ms']:.3f} "
              f"ms in {split['device_ops']} device ops | card {smi}")
        del u, x, eng, one
        torch.cuda.empty_cache()

    # the tuner with a mesh, time mode: candidates timed as sharded engines
    out: dict = {"rows": rows}
    x = randn(N_2D + 2, N_2D + 2, seed=400)
    cache = PlanCache()
    t0 = time.perf_counter()
    got = tuned_apply(box1, x, cache=cache, mode="time", mesh=mesh((2, 2)))
    torch.cuda.synchronize()
    tune_s = time.perf_counter() - t0
    with not_main():
        e_t = _err(got, StencilEngine(box1, "direct", device=dev)(x), TOL)
    (key, plan), = cache._plans.items()
    out["tuned"] = {"key": key, "plan": plan.describe(), "seconds": tune_s,
                    "max_abs_err_vs_direct": e_t}
    print(f"phase halo tuned_apply box-2d1r {N_2D}x{N_2D} mesh 2x2 (time "
          f"mode): plan {plan.describe()} in {tune_s:.2f} s, key {key}, max "
          f"|err| vs direct {e_t:.3g} | card {smi}")
    del x, got, cache
    torch.cuda.empty_cache()

    # StencilDriver with a mesh: 16 star-2d1r jobs of 2048² (halo included)
    star1 = make_stencil("star", 2, 1, seed=1)
    dcache = PlanCache()
    driver = StencilDriver(cache=dcache, mode="time", device=dev,
                           mesh=mesh((2,)),
                           policy=BatchPolicy(max_batch=16, max_wait_ms=5.0))
    jobs = [randn(2048, 2048, seed=500 + j) for j in range(16)]
    t0 = time.perf_counter()
    results = driver.map([(star1, x) for x in jobs], timeout=600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    key = driver.group_key(star1, jobs[0])
    m = driver.metrics()
    driver.close()
    with not_main():
        ref = StencilEngine(star1, "direct", device=dev)
        e_d = max(_err(y, ref(x), TOL) for x, y in zip(jobs, results))
    out["driver"] = {"jobs": len(jobs), "wall_s": wall, "group_key": key,
                     "max_abs_err_vs_direct": e_d,
                     "batches": m["overall"]["batches"],
                     "plans": {k: p.describe()
                               for k, p in dcache._plans.items()}}
    print(f"phase halo StencilDriver mesh 2: {len(jobs)} star-2d1r jobs of "
          f"2048x2048 in {wall:.2f} s (tune included), "
          f"{m['overall']['batches']} batches, plans "
          f"{out['driver']['plans']}, max |err| vs direct {e_d:.3g} | card "
          f"{smi}")
    del jobs, results
    torch.cuda.empty_cache()
    out["launches"] = {b: f.launches - aside[b] for b, f in counters.items()}
    for b, n in out["launches"].items():
        if n == 0:
            raise AssertionError(f"phase halo never launched {b}")
    out["seconds"] = time.perf_counter() - t_phase
    out["profiler_traces"] = dict(TRACE_STATS)
    print(f"phase halo: {out['seconds']:.1f} s, sharded kernel launches "
          f"{out['launches']}; card traces since the start of the run "
          f"{out['profiler_traces']}")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.core.engine import (StencilEngine, apply_sptc_v1,
                                         grid_kernel, grid_operand,
                                         tile_windows)
    from repro_torch.core.sparsify import sparsify_stencil_kernel
    from repro_torch.core.sptc import sptc_matmul_dense_equiv
    from repro_torch.core.stencil import make_stencil, paper_suite
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import build
    from repro_torch.kernels.conv1d import ops as conv_ops
    from repro_torch.kernels.conv1d.ref import conv1d_causal_plain
    from repro_torch.kernels.sptc_spmm import ops as sptc_ops
    from repro_torch.kernels.sptc_spmm.fragments import tf32_round
    from repro_torch.kernels.sptc_spmm.ref import (sptc_fused_ref,
                                                   sptc_rows2d_ref,
                                                   sptc_spmm_windows_ref,
                                                   sptc_star2d_ref)
    from repro_torch.kernels.stencil_direct import ops as direct_ops
    from repro_torch.kernels.stencil_direct.ref import stencil2d_ref
    from repro_torch.kernels.stencil_gemm import ops as gemm_ops
    from repro_torch.kernels.stencil_gemm.ref import windows_gemm_ref
    from repro_torch.tuner.search import l_candidates

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

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {smi}")

    # -- phase 1: build -----------------------------------------------------
    t0 = time.perf_counter()
    log = build.build()
    build.library()
    print(f"phase 1 build: {time.perf_counter() - t0:.1f} s "
          f"({build.library_path().name})")
    for line in log.splitlines():
        if "registers" in line or line.startswith("["):
            print("  ptxas", line.strip())
    sass = _sass_mma(build.library_path())
    results["sass"] = sass
    for k, v in sass.items():
        print(f"phase 1 SASS: {v['instructions']} {k} HMMA instructions in "
              f"the {v['kernels']} {v['kernel']} instantiations "
              f"({', '.join(v['mnemonics'])}); e.g. {v['example']}")

    # -- phase 2: every kernel against its plain version on the card --------
    rng = np.random.default_rng(0)
    worst = {"sptc": 0.0, "rows2d": 0.0, "star2d": 0.0, "gemm": 0.0,
             "direct": 0.0, "spmm": 0.0, "conv1d": 0.0}
    cases = dict.fromkeys(worst, 0)
    dtypes = ((f32, None), (f32, torch.bfloat16), (torch.bfloat16, None))
    sptc_cases = [(r, L, c, star, n_out)
                  for r in (1, 2, 3) for L in (2 * r + 2, 16)
                  for c in (1, 37, 300) for star in (True, False)
                  for n_out in (5 * L + 3,)]
    sptc_cases += [(2, 20, c, False, 203) for c in (1, 37, 300)]
    sptc_cases += [(r, 2 * r + 2, 1, True, 100_003) for r in (1, 2, 3)]
    for r, L, c, star, n_out in sptc_cases:
        sk = sparsify_stencil_kernel(rng.normal(size=2 * r + 1), L=L)
        for dt, comp in dtypes:
            op = sptc_ops.fused_operand(sk.sparse, sk.perm, L,
                                        star_fast=star, dtype=dt, device=dev)
            # c = 300: odd row stride (305), rows 4-byte aligned; c = 37:
            # row stride 48, rows 16-byte aligned (vector staging); c = 1:
            # the 1-D variant, row stride 6
            big = randn(n_out + 2 * r, c + 5 + (6 if c == 37 else 0),
                        dtype=dt, seed=c + r)
            x2d = big[:, 2:2 + c] if c != 37 else big[:, 8:8 + c]
            got = sptc_ops.sptc_spmm_fused(op, x2d, n_out=n_out,
                                           compute_dtype=comp)
            want = sptc_fused_ref(op.values, op.meta_words, x2d,
                                  n_out=n_out, L=L, star_fast=star,
                                  compute_dtype=comp)
            # f32 storage with bf16 compute: bf16 operands, float32 sums
            # and output, so the float32 limit
            tol = TOL if dt == f32 else TOL_BF16
            worst["sptc"] = max(worst["sptc"], _err(got, want, tol))
            cases["sptc"] += 1
    # planted fault: the pair index of one non-zero flipped in the TF32
    # metadata table; the same check must fail
    sk = sparsify_stencil_kernel(rng.normal(size=3))
    op = sptc_ops.fused_operand(sk.sparse, sk.perm, sk.L, star_fast=False,
                                dtype=f32, device=dev)
    a = op.tf32.a.cpu()
    ks, t = [int(i) for i in torch.nonzero(a[0, :, 0, :4])[0]]
    e = op.tf32.e.clone()
    e[0, ks, :4] ^= 0xA << (4 * t)               # 0b0100 <-> 0b1110
    bad = dataclasses.replace(op, tf32=dataclasses.replace(op.tf32, e=e))
    x2d = randn(5 * sk.L + 5, 37, seed=99)
    want = sptc_fused_ref(op.values, op.meta_words, x2d, n_out=5 * sk.L + 3,
                          L=sk.L, star_fast=False)
    fault = _rel(sptc_ops.sptc_spmm_fused(bad, x2d, n_out=5 * sk.L + 3),
                 want)
    print(f"phase 2 sptc planted fault (pair index of row 0, k-step {ks}, "
          f"pair {t} flipped in the TF32 metadata): max rel err {fault:.3g} "
          f"(tol {TOL})")
    if not fault > TOL:
        raise AssertionError("a flipped metadata field passes the sptc check")
    results["sptc_planted_fault_rel_err"] = fault
    # the rows kernel with a box engine's own tables, on every L the tuner
    # offers, and the star kernel with a star engine's, on every even L from
    # 2r + 2 to 16: batches of 1-3, odd shapes, H < 8, H = W = 1, a view at
    # odd batch and row strides, rows off 16 bytes (4-, 8- and 16-byte
    # copies)
    def grids(r, dt):
        for b, h, w, view in ((1, 67, 131, "plain"), (3, 37, 29, "strided"),
                              (1, 5, 204 - 2 * r, "offset"),
                              (3, 130, 130 - 2 * r, "plain"),
                              (1, 8, 1001, "plain"), (2, 1, 1, "plain")):
            hh, ww = h + 2 * r, w + 2 * r
            if view == "strided":
                yield randn(b, hh + 3, ww + 5, dtype=dt,
                            seed=h + r)[:, 1:1 + hh, 3:3 + ww]
            elif view == "offset":
                yield randn(b * hh * ww + 1, dtype=dt,
                            seed=h + r)[1:].view(b, hh, ww)
            else:
                yield randn(b, hh, ww, dtype=dt, seed=h + r)

    for r in (1, 2, 3):
        box = make_stencil("box", 2, r, seed=r)
        star = make_stencil("star", 2, r, seed=r)
        for dt in (f32, torch.bfloat16):
            tol = TOL if dt == f32 else TOL_BF16
            for L in l_candidates(r):
                rop = grid_operand(StencilEngine(
                    box, "cuda_sptc", L=L, device=dev, dtype=dt).plan_ir,
                    dev, dt)
                rops = [(o.values, o.meta_words, o.star_fast)
                        for o in rop.ops]
                for xs in grids(r, dt):
                    got = sptc_ops.sptc_spmm_rows2d(rop, xs)
                    want = sptc_rows2d_ref(rops, rop.leads, xs,
                                           halo=rop.halo, L=rop.L)
                    worst["rows2d"] = max(worst["rows2d"],
                                          _err(got, want, tol))
                    cases["rows2d"] += 1
            for L in range(2 * r + 2, 17, 2):
                sop = grid_operand(StencilEngine(
                    star, "cuda_sptc", L=L, device=dev, dtype=dt).plan_ir,
                    dev, dt)
                sops = [(o.values, o.meta_words, o.star_fast)
                        for o in sop.ops]
                for xs in grids(r, dt):
                    got = sptc_ops.sptc_spmm_star2d(sop, xs)
                    want = sptc_star2d_ref(sops, xs, radius=r, L=L)
                    worst["star2d"] = max(worst["star2d"],
                                          _err(got, want, tol))
                    cases["star2d"] += 1
    # planted fault: the row offsets of the box's row ops reversed, so
    # each op reads another op's rows; the same check must fail
    rop = grid_operand(StencilEngine(make_stencil("box", 2, 1, seed=1),
                                     "cuda_sptc", device=dev).plan_ir,
                       dev, f32)
    xs = randn(2, 41, 77, seed=98)
    want = sptc_rows2d_ref([(o.values, o.meta_words, o.star_fast)
                            for o in rop.ops], rop.leads, xs, halo=rop.halo,
                           L=rop.L)
    fault = _rel(sptc_ops.sptc_spmm_rows2d(
        dataclasses.replace(rop, leads=rop.leads[::-1]), xs), want)
    print(f"phase 2 rows2d planted fault (row offsets {rop.leads} "
          f"reversed): max rel err {fault:.3g} (tol {TOL})")
    if not fault > TOL:
        raise AssertionError("reversed row offsets pass the rows2d check")
    results["rows2d_planted_fault_rel_err"] = fault
    # planted fault: the star kernel's tables of its two axis operands
    # swapped, so each axis runs the other's weights
    sop = grid_operand(StencilEngine(make_stencil("star", 2, 3, seed=3),
                                     "cuda_sptc", device=dev).plan_ir,
                       dev, f32)
    swapped = sptc_ops.star_operand(sop.ops[::-1], sop.radius)
    xs = randn(2, 47, 83, seed=97)
    want = sptc_star2d_ref([(o.values, o.meta_words, o.star_fast)
                            for o in sop.ops], xs, radius=sop.radius,
                           L=sop.L)
    fault = _rel(sptc_ops.sptc_spmm_star2d(dataclasses.replace(
        sop, tf32=swapped.tf32, bf16=swapped.bf16), xs), want)
    print(f"phase 2 star2d planted fault (the two axis operands' tables "
          f"swapped): max rel err {fault:.3g} (tol {TOL})")
    if not fault > TOL:
        raise AssertionError("swapped axis operands pass the star2d check")
    results["star2d_planted_fault_rel_err"] = fault
    # the windows GEMM in each of its modes (C = 1; 1 < C < 16; C >= 16,
    # even or odd), 7 tiles and several blocks with a ragged last warp
    # item (64 rows of A), windows 8-byte aligned and one element past
    # (element loads), then the paper's 1-D windows
    for L in (4, 6, 8, 10, 16, 24):
        for c in (1, 2, 3, 4, 8, 37, 300, 1024):
            for dt in (f32, torch.bfloat16):
                km = randn(L, 2 * L, dtype=dt, seed=L)
                for t in (7, 1541 if c < 16 else 77):
                    n = t * 2 * L * c
                    big = randn(n + 1, dtype=dt, seed=c + t)
                    for off in ((0, 1) if c in (1, 3, 37, 1024) else (0,)):
                        win = big[off:off + n].view(t, 2 * L, c)
                        got = gemm_ops.windows_gemm(km, win)
                        tol = TOL if dt == f32 else TOL_BF16
                        worst["gemm"] = max(worst["gemm"], _err(
                            got, windows_gemm_ref(km, win), tol))
                        cases["gemm"] += 1
    for L, t in ((4, N_1D // 4), (6, -(-N_1D // 6))):
        for dt in (f32, torch.bfloat16):
            km = randn(L, 2 * L, dtype=dt, seed=L)
            win = randn(t, 2 * L, 1, dtype=dt, seed=t)
            tol = TOL if dt == f32 else TOL_BF16
            worst["gemm"] = max(worst["gemm"], _err(
                gemm_ops.windows_gemm(km, win), windows_gemm_ref(km, win),
                tol))
            cases["gemm"] += 1
            del win
    # planted fault: the lo terms of the 3xTF32 split dropped, as the kernel
    # computes them for TF32-rounded operands (their lo terms are 0); the
    # same check must fail against the float32 operands' plain version
    km = randn(8, 16, seed=8)
    win = randn(29, 16, 1024, seed=29)
    fault = _rel(gemm_ops.windows_gemm(tf32_round(km), tf32_round(win)),
                 windows_gemm_ref(km, win))
    print(f"phase 2 gemm planted fault (lo terms of the 3xTF32 split "
          f"dropped): max rel err {fault:.3g} (tol {TOL})")
    if not fault > TOL:
        raise AssertionError("dropped 3xTF32 lo terms pass the gemm check")
    results["gemm_planted_fault_rel_err"] = fault
    for spec in paper_suite():
        r = spec.radius
        taps = direct_ops.stencil_taps(spec.weights, dev)
        for dt in (f32, torch.bfloat16):
            tol = TOL if dt == f32 else TOL_BF16
            for off in (0, 3):             # contiguous; rows at odd offset
                if spec.ndim == 1:         # H = 1: the flat tile
                    x = randn(1001 + 2 * r + off, dtype=dt, seed=r)[off:]
                    got = direct_ops.stencil1d(taps, x)
                    want = stencil2d_ref(taps.host, x[None], 0, r)[0]
                else:                      # batched, odd H and W
                    x = randn(3, 37 + 2 * r, 301 + 2 * r + off, dtype=dt,
                              seed=r)[:, :, off:]
                    got = direct_ops.stencil2d(taps, x)
                    want = stencil2d_ref(taps.host, x, r, r)
                worst["direct"] = max(worst["direct"], _err(got, want, tol))
                cases["direct"] += 1
    for shape, r in (("box", 1), ("star", 2), ("box", 3)):  # 3-D: slabs
        spec3 = make_stencil(shape, 3, r, seed=r)
        x = randn(21 + 2 * r, 33 + 2 * r, 45 + 2 * r, seed=r)
        got = dispatch.build(spec3, "cuda_direct", 2 * r + 2, dev)(x[None])[0]
        want = StencilEngine(spec3, "direct", device=dev)(x)
        worst["direct"] = max(worst["direct"], _err(got, want, TOL))
        cases["direct"] += 1
    for m in (8, 16):                    # v1 SpMM: (m, m) operand, K = 2m
        sk = sparsify_stencil_kernel(rng.normal(size=m - 1), L=m)
        for n in (1, 37, 1000):
            for dt in (f32, torch.bfloat16):
                vals = torch.as_tensor(sk.values, device=dev).to(dt)
                meta = torch.as_tensor(sk.meta, device=dev)
                big = randn(5, 2 * m, n + 3, dtype=dt, seed=m + n)
                win = big[:, :, 2:2 + n]                 # row stride != N
                tol = TOL if dt == f32 else TOL_BF16
                want = sptc_spmm_windows_ref(vals, meta, win)
                for got in (sptc_ops.sptc_spmm_windows(vals, meta, win),
                            sptc_ops.sptc_spmm(vals, meta, win[2])[None]):
                    ref = want if got.shape[0] > 1 else want[2:3]
                    worst["spmm"] = max(worst["spmm"], _err(got, ref, tol))
                    cases["spmm"] += 1
    # v1 SpMM on random 2:4 operands: M not a multiple of 16 and several M
    # blocks, an odd K/2, windows with row stride N + 3 and contiguous ones,
    # 70,001 tiles (past a grid's 65,535), and the largest operands the
    # wrapper takes ((6144, 1): 217.5 KB of tables)
    kinds = np.zeros(4, dtype=bool)
    spmm_cases = [(m, kh, n, 7) for m, kh in V1_SHAPES
                  for n in (1, 3, 37, 1000)]
    spmm_cases += [(6, 6, n, 70_001) for n in (1, 3)]
    spmm_cases += [(m, kh, n, 5) for m, kh in V1_LARGEST for n in (1, 3)]
    for m, kh, n, t in spmm_cases:
        v, mt = _v1_operand(rng, m, kh)
        a, b = mt[:, 0:kh // 2 * 2:2], mt[:, 1::2]     # both slots of a segment
        kinds |= [(a == b).any(), (a > b).any(), ((a == 0) & (b == 1)).any(),
                  ((a == 2) & (b == 3)).any()]
        for dt in (f32, torch.bfloat16):
            vals = torch.as_tensor(v, device=dev).to(dt)
            meta = torch.as_tensor(mt, device=dev)
            big = randn(t, 2 * kh, n + 3, dtype=dt, seed=m + n + t)
            tol = TOL if dt == f32 else TOL_BF16
            for win in (big[:, :, 2:2 + n], big[:, :, :n].contiguous()):
                got = sptc_ops.sptc_spmm_windows(vals, meta, win)
                worst["spmm"] = max(worst["spmm"], _err(
                    got, sptc_spmm_windows_ref(vals, meta, win), tol))
                cases["spmm"] += 1
            del big
    if not kinds.all():
        raise AssertionError(f"phase 2 v1 operands lack a kind of metadata "
                             f"(duplicate, descending, (0, 1), (2, 3)): {kinds}")
    # planted fault: the second pass dropped, as the kernel computes it for
    # the operand with the value of every slot that pass 1 takes set to 0
    # (float32: slot 1 of a segment whose two slots share an aligned pair)
    v, mt = _v1_operand(rng, 17, 12)
    a, b = mt[:, 0::2], mt[:, 1::2]
    cut = v.copy()
    cut[:, 1::2][((a >> 1) == (b >> 1)) & (v[:, 0::2] != 0)] = 0
    vals, meta = (torch.as_tensor(v, device=dev),
                  torch.as_tensor(mt, device=dev))
    win = randn(29, 24, 1000, seed=29)
    fault = _rel(sptc_ops.sptc_spmm_windows(torch.as_tensor(cut, device=dev),
                                            meta, win),
                 sptc_spmm_windows_ref(vals, meta, win))
    print(f"phase 2 spmm planted fault (pass 1 dropped): max rel err "
          f"{fault:.3g} (tol {TOL})")
    if not fault > TOL:
        raise AssertionError("a dropped second pass passes the spmm check")
    results["spmm_planted_fault_rel_err"] = fault
    del win
    for b in (1, 3):
        for t in (1, 3, 257):
            for d in (1, 37, 160, 5376):
                for dt in (f32, torch.bfloat16):
                    w = randn(4, d, dtype=dt, seed=d)
                    big = randn(b, t, 2 * d + 7, dtype=dt, seed=b + t + d)
                    for x in (big[:, :, :d].contiguous(), big[:, :, 3:3 + d]):
                        got = conv_ops.conv1d_causal(x, w)
                        tol = TOL if dt == f32 else TOL_BF16
                        worst["conv1d"] = max(worst["conv1d"], _err(
                            got, conv1d_causal_plain(x, w), tol))
                        cases["conv1d"] += 1
    # the models' own views: xbc, a column slice at offset d_inner = 5120 of
    # the input projection, Mamba2's (5376 of 10576) and Zamba2's (5248 of
    # 10448)
    for d, width in CONV_VIEWS.values():
        for b, t in ((1, 3), (3, 257), (4, 512)):
            for dt in (f32, torch.bfloat16):
                w = randn(4, d, dtype=dt, seed=d)
                x = randn(b, t, width, dtype=dt, seed=b + t)[:, :, 5120:5120 + d]
                tol = TOL if dt == f32 else TOL_BF16
                worst["conv1d"] = max(worst["conv1d"], _err(
                    conv_ops.conv1d_causal(x, w), conv1d_causal_plain(x, w),
                    tol))
                cases["conv1d"] += 1
    torch.cuda.synchronize()
    for k in worst:
        print(f"phase 2 {k}: {cases[k]} small cases, max |err| vs plain "
              f"{worst[k]:.3g} (tol {TOL} f32, {TOL_BF16} bf16, relative to "
              f"1 + |plain|)")

    # -- phase 3: the main path at full width --------------------------------
    suite = paper_suite()
    backends = ("cuda_sptc", "cuda_gemm", "cuda_direct")
    counters = {"cuda_sptc": sptc_ops.sptc_spmm_fused,
                "sptc_rows2d": sptc_ops.sptc_spmm_rows2d,
                "sptc_star2d": sptc_ops.sptc_spmm_star2d,
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
    # iterate writes each step into the next haloed grid: the benchmark
    # cells' engines against the re-pad loop (each call F.pad-ded), bit for
    # bit, every step counted in place
    for name, b in (("box-2d1r", "cuda_sptc"), ("box-1d2r", "cuda_sptc"),
                    ("box-2d1r", "cuda_direct"), ("star-2d3r", "cuda_sptc"),
                    ("box-2d3r", "cuda_sptc")):
        spec = next(s for s in suite if s.name == name)
        pad = (spec.radius,) * (2 * spec.ndim)
        dims = (N_1D,) if spec.ndim == 1 else (N_2D, N_2D)
        x = F.pad(randn(*dims, seed=29), pad)
        eng = StencilEngine(spec, b, device=dev)
        done = StencilEngine.iterate.steps_in_place
        got = eng.iterate(x, 10)
        in_place = StencilEngine.iterate.steps_in_place - done
        want = x
        for _ in range(10):
            want = F.pad(eng(want), pad)
        same = torch.equal(got, want)
        print(f"phase 3 {name} {b}: iterate(10), {in_place} steps in "
              f"place, equals the re-pad loop bit for bit: {same}")
        if not same or in_place != 10:
            raise AssertionError(f"{name} {b}: iterate in place differs "
                                 "from the re-pad loop")
        del x, got, want, eng
    torch.cuda.synchronize()
    launches = {b: fn.launches for b, fn in counters.items()}
    print(f"phase 3 main path: {time.perf_counter() - t0:.1f} s, kernel "
          f"launches {launches}")
    for b, n in launches.items():
        if n == 0:
            raise AssertionError(f"main path never launched the {b} kernel")

    # -- phase 3b: the v1 SpMM entry applying box-2d1r at full size ----------
    box1 = next(s for s in suite if s.name == "box-2d1r")
    x = randn(N_2D + 2, N_2D + 2, seed=23)
    want = StencilEngine(box1, "direct", device=dev)(x)
    sptc_ops.sptc_spmm_windows.launches = 0
    t0 = time.perf_counter()
    got = apply_sptc_v1(box1, x)
    torch.cuda.synchronize()
    launches["sptc_spmm"] = sptc_ops.sptc_spmm_windows.launches
    e_v1 = _err(got, want, TOL)
    print(f"phase 3b v1 path: box-2d1r {N_2D}x{N_2D} through "
          f"apply_sptc_v1 in {time.perf_counter() - t0:.2f} s, max |err| "
          f"vs direct {e_v1:.3g}, launches {launches['sptc_spmm']}")
    if launches["sptc_spmm"] == 0:
        raise AssertionError("v1 path never launched the sptc_spmm kernel")
    results["specs"]["box-2d1r"]["v1_sptc_spmm_max_abs_err"] = e_v1
    del x, want, got

    # -- phase vet: the verifier, with the launch audit on the card ----------
    vet = _phase_vet(dev, smi, randn)
    results["vet"] = vet

    # -- phase 4: timing at the main path's shapes ---------------------------
    rows = {}
    for spec in suite:
        r, d = spec.radius, spec.ndim
        dims = (N_1D,) if d == 1 else (N_2D, N_2D)
        pts = float(np.prod(dims))
        x = randn(*(s + 2 * r for s in dims), seed=3)
        line = {}
        eng = StencilEngine(spec, "cuda_sptc", device=dev)
        plan = eng.plan_ir
        mode = plan.decompose.mode
        # the first 1-D application the per-RowOp loop makes for this spec
        # (the dense kernels' windows are cut from it)
        if d == 1:
            x2d, n_out = x[:, None], N_1D
        elif mode == "star-axis":
            x2d, n_out = x[:, r:r + N_2D], N_2D        # strided view, no copy
        else:
            x2d, n_out = x[0:N_2D, :].T.contiguous(), N_2D   # the loop's copy
        w1 = plan.decompose.kernels[0]
        sp = plan.sparsify
        rows_in, c = x2d.shape
        conv_w = torch.as_tensor(np.asarray(w1), dtype=f32,
                                 device=dev).reshape(1, 1, -1, 1)
        conv_in = x2d.reshape(1, 1, rows_in, c)
        one = grid_kernel(plan)
        rows2d, star2d = one == "sptc_spmm_rows2d", one == "sptc_spmm_star2d"
        if rows2d:
            # the engine's one launch on the haloed grid where it lies, with
            # its own tables; the fused kernel is not on this spec's path
            rop = grid_operand(plan, dev, f32)
            rops = [(o.values, o.meta_words, o.star_fast) for o in rop.ops]
            xs = x[None]
            app = {"rows2d": (
                lambda: sptc_ops.sptc_spmm_rows2d(rop, xs),
                lambda: sptc_rows2d_ref(rops, rop.leads, xs, halo=rop.halo,
                                        L=rop.L))}
        else:
            fop = sptc_ops.fused_operand(
                sp.operands[0], sp.perm, plan.L,
                star_fast="auto" if mode in ("single", "star-axis")
                else False, dtype=f32, device=dev)
            app = {"sptc": (
                lambda: sptc_ops.sptc_spmm_fused(fop, x2d, n_out=n_out),
                lambda: sptc_fused_ref(fop.values, fop.meta_words, x2d,
                                       n_out=n_out, L=plan.L,
                                       star_fast=fop.star_fast))}
        if star2d:
            # the engine's one launch on the haloed grid where it lies, and
            # beside it the same star lowered as a rows plan (R = 2r + 1 row
            # ops) on the rows kernel
            sop = grid_operand(plan, dev, f32)
            sops = [(o.values, o.meta_words, o.star_fast) for o in sop.ops]
            rop = grid_operand(StencilEngine(
                spec, "cuda_sptc", star_fast_path=False, device=dev).plan_ir,
                dev, f32)
            rops = [(o.values, o.meta_words, o.star_fast) for o in rop.ops]
            xs = x[None]
            app["star2d"] = (
                lambda: sptc_ops.sptc_spmm_star2d(sop, xs),
                lambda: sptc_star2d_ref(sops, xs, radius=r, L=sop.L))
            app["star_rows"] = (
                lambda: sptc_ops.sptc_spmm_rows2d(rop, xs),
                lambda: sptc_rows2d_ref(rops, rop.leads, xs, halo=rop.halo,
                                        L=rop.L))
        km = torch.as_tensor(
            StencilEngine(spec, "cuda_gemm", device=dev).plan_ir.kernel
            .matrices[0], dtype=f32, device=dev)
        win = tile_windows(x2d, n_out, plan.L)[0].contiguous()
        app["gemm"] = (lambda: gemm_ops.windows_gemm(km, win),
                       lambda: windows_gemm_ref(km, win))
        # the v1 SpMM on the same windows strided-swapped (its pre-swapped
        # RHS) with the plan's first compressed operand
        perm = torch.as_tensor(sp.perm, dtype=torch.int64, device=dev)
        win_sw = tile_windows(x2d, n_out, plan.L, order=perm)[0].contiguous()
        vals = torch.as_tensor(sp.operands[0].values, dtype=f32, device=dev)
        meta_t = torch.as_tensor(sp.operands[0].meta, device=dev)
        dense = sptc_matmul_dense_equiv(vals, meta_t, 2 * plan.L)   # (L, 2L)
        app["spmm"] = (lambda: sptc_ops.sptc_spmm_windows(vals, meta_t, win_sw),
                       lambda: sptc_spmm_windows_ref(vals, meta_t, win_sw))
        taps = direct_ops.stencil_taps(spec.weights, dev)
        xd = x[None] if d == 1 else x
        app["direct"] = (lambda: direct_ops.stencil2d(taps, xd),
                         lambda: stencil2d_ref(taps.host, xd, taps.rh,
                                               taps.rw))
        full_w = torch.as_tensor(np.asarray(spec.weights), dtype=f32,
                                 device=dev)
        full_w = full_w.reshape(1, 1, 1, -1) if d == 1 else full_w[None, None]
        full_in = x.reshape(1, 1, 1, -1) if d == 1 else x[None, None]
        # the one PyTorch call computing each kernel's function on its
        # inputs; the windows GEMM's is the dense product on the windows
        lib = {"sptc": lambda: F.conv2d(conv_in, conv_w),
               "rows2d": lambda: F.conv2d(full_in, full_w),
               "star2d": lambda: F.conv2d(full_in, full_w),
               "star_rows": lambda: F.conv2d(full_in, full_w),
               "gemm": lambda: torch.matmul(km, win),
               "direct": lambda: F.conv2d(full_in, full_w),
               "spmm": lambda: torch.matmul(dense, win_sw)}
        lib_name = {"sptc": "F.conv2d", "rows2d": "F.conv2d",
                    "star2d": "F.conv2d", "star_rows": "F.conv2d",
                    "gemm": "torch.matmul", "direct": "F.conv2d",
                    "spmm": "torch.matmul"}
        for k, (kern, plain) in app.items():
            got, want = kern(), plain()
            err = _err(got, want, TOL)
            lib_got = lib[k]()
            if k in ("gemm", "spmm"):        # tiles -> the (n_out, C) output
                got = got.reshape(-1, c)[:n_out]
                lib_got = lib_got.reshape(-1, c)[:n_out]
            lib_err = float((lib_got.reshape(got.shape) - got).abs().max())
            del got, want, lib_got
            ms = _time_ms(kern, 20)
            plain_ms = _time_ms(plain, 5)
            library_ms = _time_ms(lib[k], 20)
            launch_ms = _time_ms(kern, 20, hold=False)
            if k == "sptc":
                nbytes = (x2d.shape[0] * c + n_out * c) * 4
                flops = 2.0 * -(-n_out // plan.L) * c * \
                    int(torch.count_nonzero(fop.values))
                shape = f"x2d {tuple(x2d.shape)} n_out {n_out} L {plan.L} " \
                        f"star_fast {fop.star_fast}"
            elif k in ("rows2d", "star2d", "star_rows"):
                ops = sop.ops if k == "star2d" else rop.ops
                nbytes = (x.numel() + pts) * 4
                flops = 2.0 * -(-N_2D // plan.L) * N_2D * sum(
                    int(torch.count_nonzero(o.values)) for o in ops)
                shape = f"xs {tuple(xs.shape)} L {plan.L} " + (
                    "2 axis ops (the engine's tables)" if k == "star2d" else
                    f"{len(ops)} row ops (" + ("the engine's tables)"
                                              if k == "rows2d" else
                                              "the star as a rows plan)"))
            elif k == "gemm":
                nbytes = (win.numel() + km.numel() + win.shape[0] * plan.L * c) * 4
                flops = 2.0 * win.shape[0] * c * km.numel()
                shape = f"windows {tuple(win.shape)} km {tuple(km.shape)}"
            elif k == "spmm":
                nbytes = (win_sw.numel() + win_sw.shape[0] * plan.L * c) * 4 \
                    + vals.numel() * 8
                flops = 2.0 * win_sw.shape[0] * c * int(torch.count_nonzero(vals))
                shape = f"windows {tuple(win_sw.shape)} values " \
                        f"{tuple(vals.shape)} (swapped, float32)"
            else:
                nbytes = (x.numel() + pts) * 4
                flops = 2.0 * pts * len(taps.host)
                shape = f"x {tuple(xd.shape)} taps {len(taps.host)}"
            bound, by = _bound_ms(nbytes, flops)
            line[k] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                       "library": lib_name[k],
                       "bound_ms": bound, "bound_by": by, "max_abs_err": err,
                       "library_max_abs_diff": lib_err, "shape": shape,
                       "launch_ms": launch_ms}
            if k == "gemm":                  # the paper's cuDNN yardstick too
                line[k]["conv2d_ms"] = _time_ms(
                    lambda: F.conv2d(conv_in, conv_w), 20)
            print(f"timing {spec.name} {k}: kernel_ms {ms:.4f} (with the "
                  f"host's launch {launch_ms:.4f}) plain_ms "
                  f"{plain_ms:.4f} library_ms({lib_name[k]}) {library_ms:.4f}"
                  + (f" F.conv2d_ms {line[k]['conv2d_ms']:.4f}"
                     if k == "gemm" else "")
                  + f" bound_ms {bound:.4f} ({by}, "
                  f"{100 * bound / ms:.0f}%) launches {launches[KERNEL_OF[k]]}"
                  f" | {shape} | card {smi}")
        del app, lib, win, win_sw, dense, x2d, conv_in
        if rows2d or star2d:
            del rop, rops, xs
        if star2d:
            del sop, sops
        # end to end: engine GStencil/s for each backend, F.conv2d beside it
        conv_ms = _time_ms(lambda: F.conv2d(full_in, full_w), 10, hold=False)
        e2e = {}
        for b in ("direct",) + backends:
            counters_before = {n: f.launches for n, f in counters.items()}
            eng = StencilEngine(spec, b, device=dev)
            eng(x)
            per_call = {n: f.launches - counters_before[n]
                        for n, f in counters.items()}
            e_ms = _time_ms(lambda: eng(x), 10, hold=False)
            kern_ms = sum(per_call.get(KERNEL_OF[k], 0) * line[k]["ms"]
                          for k in line) if b != "direct" else None
            e2e[b] = {"ms": e_ms, "gstencil_s": pts / e_ms / 1e6,
                      "launches_per_call": (None if b == "direct" else
                                            sum(per_call.values())),
                      "outside_kernel_share": (None if kern_ms is None else
                                               max(0.0, 1 - kern_ms / e_ms))}
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
              f"({conv_ms:.3f} ms) | card {smi}")
        del x, full_in, eng
        torch.cuda.empty_cache()
    results["timing"] = rows

    # conv1d at the serve shape and at the prefill_32k sequence length, x a
    # column slice of the (B, T, 2*d_inner + 2*state + heads) projection
    conv_rows = {}
    k = 4
    for label, arch, (b, t) in (("serve", ARCH, (4, 512)),
                                ("prefill_32k", ARCH, (4, 32768)),
                                ("serve_hybrid", HYBRID_ARCH, (4, 512))):
        d, proj_w = CONV_VIEWS[arch]
        proj = randn(b, t, proj_w, dtype=torch.bfloat16, seed=t)
        xc = proj[:, :, 5120:5120 + d]
        wc = randn(k, d, dtype=torch.bfloat16, seed=k)
        w_lib = wc.T.contiguous()[:, None, :]                      # (D, 1, K)
        row = _time_row(
            lambda: conv_ops.conv1d_causal(xc, wc),
            lambda: conv1d_causal_plain(xc, wc),
            lambda: F.conv1d(F.pad(xc.transpose(1, 2), (k - 1, 0)), w_lib,
                             groups=d), TOL_BF16,
            nbytes=2.0 * (2 * b * t * d + k * d), flops=2.0 * k * b * t * d,
            shape=f"x {(b, t, d)} bf16 (column slice of {(b, t, proj_w)}), "
                  f"w {(k, d)}", reps=20 if t <= 512 else 5)
        conv_rows[label] = row
        print(f"timing conv1d_causal {label} ({arch}): kernel_ms {row['ms']:.4f} (with "
              f"the host's launch {row['launch_ms']:.4f}) plain_ms {row['plain_ms']:.4f} library_ms(F.conv1d) "
              f"{row['library_ms']:.4f} bound_ms {row['bound_ms']:.4f} "
              f"({row['bound_by']}) | {row['shape']} | card {smi}")
        del proj, xc
        torch.cuda.empty_cache()
    results["timing"]["conv1d_causal"] = conv_rows

    # -- phase tuned: the tuner's entry points over the paper suite ----------
    tuned = _phase_tuned(dev, smi, randn, counters, rows)
    results["tuned"] = tuned

    # -- phase serve-stencil: modest grids from many clients -----------------
    serve = _phase_serve_stencil(dev, smi, counters)
    results["serve_stencil"] = serve

    # -- phase halo: the sharded engine, every shard on this card -----------
    halo = _phase_halo(dev, smi, randn)
    results["halo"] = halo
    for b in counters:     # the main path: phases 3, tuned, serve and halo
        launches[b] += (tuned["launches"][b] + serve["launches"][b]
                        + halo["launches"][b])
    # and phase vet's audited calls
    launches["cuda_sptc"] += vet["launches"]["sptc_spmm_fused"]
    launches["sptc_rows2d"] += vet["launches"]["sptc_spmm_rows2d"]
    launches["sptc_star2d"] += vet["launches"]["sptc_spmm_star2d"]
    launches["cuda_gemm"] += vet["launches"]["windows_gemm"]
    launches["sptc_spmm"] += vet["launches"]["sptc_spmm_windows"]

    # -- phase lm: mamba2-2.7b served at full width and depth ----------------
    lm = _phase_lm(dev, smi, ARCH, "lm", LM_CUT[ARCH])
    results["lm"] = lm

    # -- phase lm-hybrid: zamba2-2.7b served at full width and depth ---------
    hybrid = _phase_lm(dev, smi, HYBRID_ARCH, "lm-hybrid", LM_CUT[HYBRID_ARCH])
    results["lm_hybrid"] = hybrid

    # -- phases lm-dense, lm-moe: qwen3-1.7b and granite-moe-3b-a800m --------
    dense = _phase_lm(dev, smi, DENSE_ARCH, "lm-dense", LM_CUT[DENSE_ARCH])
    results["lm_dense"] = dense
    moe = _phase_lm(dev, smi, MOE_ARCH, "lm-moe", LM_CUT[MOE_ARCH])
    results["lm_moe"] = moe

    # -- phase lm-variants: the other dense and MoE configs at full width ---
    results["lm_variants"] = _phase_variants(dev, smi)

    # -- phases lm-encdec, lm-vlm: whisper-large-v3, llama-3.2-vision-11b ---
    encdec = _phase_lm(dev, smi, ENCDEC_ARCH, "lm-encdec", LM_CUT[ENCDEC_ARCH])
    results["lm_encdec"] = encdec
    vlm = _phase_lm(dev, smi, VLM_ARCH, "lm-vlm", LM_CUT[VLM_ARCH])
    results["lm_vlm"] = vlm
    # every LM phase's main path (the phases without Mamba layers launch
    # none)
    launches["conv1d_causal"] = sum(
        ph["conv1d_launches"] for ph in (lm, hybrid, dense, moe, encdec, vlm))

    # -- phases train, train-variants: training on the card ------------------
    results["train"] = _phase_train(dev, smi)
    results["train_resume"] = _phase_train_resume(dev, smi)
    results["train_variants"] = _phase_train_variants(dev, smi)
    # the profiler's head loss after minutes of load, bare against the
    # audit's traces (phase vet took the same check near the run's start),
    # with no process group alive: each training phase released its own
    import torch.distributed as dist
    if dist.is_initialized():
        raise AssertionError("a process group is alive before the late "
                             "trace check")
    print("late trace check: no process group alive")
    results["trace_check_late"] = _trace_check(dev, smi, TRACE_CHECK_N // 4,
                                               label="after training")

    # -- phase dryrun: the fleet dry-run, and its check on this card --------
    results["dryrun"] = _phase_dryrun(dev, smi, results["train"])

    # -- phase examples: examples/*_torch.py on the card ---------------------
    wrappers = {"cuda_sptc": sptc_ops.sptc_spmm_fused,
                "sptc_rows2d": sptc_ops.sptc_spmm_rows2d,
                "sptc_star2d": sptc_ops.sptc_spmm_star2d,
                "cuda_gemm": gemm_ops.windows_gemm,
                "cuda_direct": direct_ops.stencil2d,
                "sptc_spmm": sptc_ops.sptc_spmm_windows,
                "conv1d_causal": conv_ops.conv1d_causal}
    results["examples"] = _phase_examples(dev, smi, wrappers)
    for k, n in results["examples"]["total_launches"].items():
        launches[k] += n

    # -- phase 5: summary -----------------------------------------------------
    # the canonical shape of the kernels line: box-2d1r, and for the fused
    # kernel, which a 2-D box no longer runs, the star at its size
    canon = dict.fromkeys(KERNEL_OF, "box-2d1r")
    canon["sptc"] = "star-2d1r"
    canon["star2d"] = "star-2d3r"
    meta = {"sptc": ("src/repro_torch/kernels/csrc/sptc_fused.cu",
                     "src/repro/kernels/sptc_spmm/kernel.py:112"),
            # one launch for the R calls of the reference's fused kernel
            "rows2d": ("src/repro_torch/kernels/csrc/sptc_rows2d.cu",
                       "src/repro/kernels/sptc_spmm/kernel.py:112"),
            # one launch for the two calls of the reference's fused kernel
            "star2d": ("src/repro_torch/kernels/csrc/sptc_star2d.cu",
                       "src/repro/kernels/sptc_spmm/kernel.py:112"),
            "gemm": ("src/repro_torch/kernels/csrc/windows_gemm.cu",
                     "src/repro/kernels/stencil_gemm/kernel.py:24"),
            "direct": ("src/repro_torch/kernels/csrc/stencil_direct.cu",
                       "src/repro/kernels/stencil_direct/kernel.py:28"),
            "spmm": ("src/repro_torch/kernels/csrc/sptc_spmm.cu",
                     "src/repro/kernels/sptc_spmm/kernel.py:56")}
    timed = {KERNEL_OF[k]: (src, repl, rows[canon[k]][k], f"{canon[k]}: ")
             for k, (src, repl) in meta.items()}
    timed["conv1d_causal"] = ("src/repro_torch/kernels/csrc/conv1d_causal.cu",
                              "src/repro/kernels/conv1d/kernel.py:27",
                              conv_rows["serve"], f"{ARCH} prefill: ")
    # the worst share of bound over the paper suite of each stencil kernel
    # and of the v1 SpMM (phase 4's rows: the specs each kernel runs)
    worst_share = {}
    for k in meta:
        spec, row = min(((sp, rows[sp][k]) for sp in (s.name for s in suite)
                         if k in rows[sp]),
                        key=lambda it: it[1]["bound_ms"] / it[1]["ms"])
        worst_share[KERNEL_OF[k]] = {"spec": spec, "ms": row["ms"],
                                     "bound_ms": row["bound_ms"],
                                     "share": row["bound_ms"] / row["ms"]}
    results["worst_share"] = worst_share
    print("phase 5 worst share of bound over the paper suite: " + "; ".join(
        f"{n} {w['spec']} {w['ms']:.4f} ms, bound {w['bound_ms']:.4f} ms "
        f"({100 * w['share']:.0f}%)" for n, w in worst_share.items())
        + f" | card {smi}")
    kernels = []
    for name, (src, repl, t, where) in timed.items():
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": repl, "launches": launches[name],
                        "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"],
                        "shape": where + t["shape"]})
        if name in worst_share:
            kernels[-1]["worst_share"] = worst_share[name]
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
