"""Launch audit: certify the zero-runtime-overhead claim on the port's engines.

SPIDER's §3.3 contract: the on-the-fly input row swap folds into load
addressing, so the sparse hot path may do no more gather/copy work than
the dense path — the only gather allowed is the window read.  The
reference certifies this on XLA's optimized HLO; the port has no compiled
graph, so this analyzer runs an engine call under ``torch.profiler`` (CPU
activity, plus CUDA on the card) and counts what runs *outside* the
kernel wrappers' profiler regions (``repro_torch.kernels.common.region``).
An outermost region is one program, the counterpart of a ``pallas_call``.
On the CPU a region holds its kernel's plain version and is not descended
into.  On the card a region holds only the launch (a ctypes call, which
runs no torch op), so the audit walks into it: a torch op that a wrapper
ran inside its region still counts as outside work.

Counting: only ops that do work are counted, and each once — an op of a
class below is counted unless an enclosing op was already counted, so
the ``aten::copy_`` under an ``aten::clone`` under an ``aten::pad`` is one
copy.  Classes: products (``aten::mm``/``bmm``/``addmm``/``baddbmm``),
gathers (``aten::index``/``gather``/``index_select``/``take``), copies
(``aten::copy_``), scatters (``aten::index_put_``/``scatter*``, the
counterpart of a dynamic-update-slice) and adds (information only).
Host uploads are ``aten::lift_fresh`` (a tensor made from host data) on
the CPU and ``Memcpy HtoD`` device events on the card.  On the card the
device events are split into the region kernels (by the kernel names of
``KERNEL_REGIONS``) and everything else, with their device times.  Every
call is warmed up once, and the second call is profiled; its output is held
against the ``direct`` engine's.

Rules (the reference's rule ids where the meaning carries over):

  lowering-dot-count      plain gemm/sptc: products != one per 1-D
                          application per temporal step
  lowering-hot-gather     gathers > budget × applications (1 = the window
                          read)
  lowering-hot-overhead   scatters > budget (0) — runtime-indexed
                          addressing in a statically known access pattern
  lowering-sparse-parity  sptc moves more data than gemm on the same probe
                          (gathers + copies: the window read is a gather on
                          one path and the copy of an unfolded view on the
                          other), or scatters more
  pallas-fused-program    cuda_sptc: ``sptc_spmm_fused`` regions != one per
                          1-D application (on the card: or != the region
                          kernels launched)
  pallas-fused-gather     gathers outside the regions > budget ×
                          applications (the shipped kernel shows 0)
  pallas-fused-overhead   scatters outside, or more gathers or copies
                          outside than the dense cuda_gemm engine on the
                          same probe — a standalone permute the paper's row
                          swap eliminates
  launch-per-call-rebuild calls 2 and 3 of a fixed-shape engine run
                          different op/kernel sequences, or upload from the
                          host: tables belong in the constructor
  launch-output-mismatch  an audited call's output is not finite or differs
                          from the direct engine's by more than
                          ``OUTPUT_TOL`` × (1 + |direct|): an engine that
                          skipped work is not certified

``run`` returns the findings and ``verdict()``-style per-kernel counts
keyed ``stencil_gemm``, ``sptc_spmm`` and ``sptc_spmm_fused``, as the
reference keys them.  It runs on the card unless ``device="cpu"`` is
given (there the cuda_* engines run their kernels' plain versions inside
the same regions); ``device=None`` raises without a card.  The sharded
halo analyzer waits for the port's sharded engine.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.engine import (StencilEngine, _emit_const,
                                     _operand_fn, apply_sptc_v1)
from repro_torch.core.stencil import StencilSpec, make_stencil
from repro_torch.core.transform import decompose_rows, lower_spec
from repro_torch.device import Device, resolve_device
from repro_torch.kernels.common import KERNEL_REGIONS, region
from repro_torch.vet.config import VetConfig
from repro_torch.vet.findings import Finding

_PATH = "src/repro_torch/core/engine.py"

#: engine backend -> the kernel subsystem its audit certifies
BACKEND_KERNEL = {"gemm": "stencil_gemm", "sptc": "sptc_spmm"}
FUSED_KERNEL = "sptc_spmm_fused"

#: op classes counted outside the kernel regions (first match wins)
OP_CLASSES: Dict[str, Tuple[str, ...]] = {
    "products": ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm"),
    "gathers": ("aten::index", "aten::gather", "aten::index_select",
                "aten::take"),
    "copies": ("aten::copy_",),
    "scatters": ("aten::index_put_", "aten::index_put", "aten::scatter",
                 "aten::scatter_", "aten::scatter_add", "aten::scatter_add_",
                 "aten::scatter_reduce", "aten::scatter_reduce_"),
    "adds": ("aten::add", "aten::add_"),
}
_CLASS_OF = {op: c for c, ops in OP_CLASSES.items() for op in ops}
UPLOAD_OP = "aten::lift_fresh"
#: the counts that must not depend on the input's size
COUNT_KEYS = ("programs",) + tuple(OP_CLASSES) + ("uploads",)
#: float32: |got - direct| <= OUTPUT_TOL * (1 + |direct|)
OUTPUT_TOL = 3e-5

#: (spec ctor args, fuse_rows, temporal steps, probe input shape) — the
#: reference's probes; the k=2 probe certifies the per-step profile
PROBES: Tuple[Tuple[Tuple[str, int, int], bool, int, Tuple[int, ...]],
              ...] = (
    (("star", 2, 1), False, 1, (34, 34)),
    (("box", 2, 1), True, 1, (34, 34)),
    (("star", 2, 1), False, 2, (36, 36)),
)

#: (spec ctor args, probe input shape) — star exercises the metadata-free
#: fast path, box the faithful metadata decode
PALLAS_PROBES: Tuple[Tuple[Tuple[str, int, int], Tuple[int, ...]], ...] = (
    (("star", 2, 1), (22, 22)),
    (("box", 2, 1), (22, 22)),
)


def _finding(cfg: VetConfig, rule: str, symbol: str, message: str) -> Finding:
    return Finding(rule=rule, severity=cfg.severity_of(rule), path=_PATH,
                   line=0, symbol=symbol, message=message)


def n_applications(spec: StencilSpec, fused: bool) -> int:
    """1-D applications the engine performs (== expected product count)."""
    if fused:
        return 1
    if spec.ndim == 1:
        return 1
    if spec.shape == "star":
        return spec.ndim
    return len(decompose_rows(spec))


# ---------------------------------------------------------------------------
# One profiled call
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CallAudit:
    """What one call ran outside the kernel regions.

    ``counts`` holds ``COUNT_KEYS`` (``programs``: regions entered, every
    name) and, on the card, ``kernels`` (device launches of the region
    kernels) and ``device_ops`` (every other device kernel, memset or
    memcpy).  ``regions`` counts regions by name; ``sequence`` is the
    call's top-level ops and regions, then its device launches, in order.
    ``device_ms`` (card only) splits the call's device time into
    ``kernel`` and ``outside``; ``kernel_share`` is the first's share.
    ``out`` is the call's result.
    """

    counts: Dict[str, int]
    regions: Dict[str, int]
    sequence: Tuple[str, ...]
    device_ms: Optional[Dict[str, float]] = None
    out: object = None

    @property
    def kernel_share(self) -> Optional[float]:
        if not self.device_ms:
            return None
        total = self.device_ms["kernel"] + self.device_ms["outside"]
        return self.device_ms["kernel"] / total if total else None


def _summarize(events, on_card: bool) -> CallAudit:
    counts = dict.fromkeys(COUNT_KEYS, 0)
    regions: Dict[str, int] = {}
    sequence: List[str] = []

    def walk(e, covered: bool, in_region: bool) -> None:
        if e.name in KERNEL_REGIONS:
            if not in_region:
                regions[e.name] = regions.get(e.name, 0) + 1
                counts["programs"] += 1
            if not on_card:
                return                   # the plain version is the program
            in_region = True
        cls = _CLASS_OF.get(e.name)
        if cls is not None and not covered:
            counts[cls] += 1
            covered = True
        if e.name == UPLOAD_OP and not on_card:
            counts["uploads"] += 1
        for child in e.cpu_children:
            walk(child, covered, in_region)

    for e in sorted((e for e in events if e.device_type == DeviceType.CPU
                     and e.cpu_parent is None),
                    key=lambda e: e.time_range.start):
        if e.name.startswith(("aten::", *KERNEL_REGIONS)):
            sequence.append(e.name)
        walk(e, False, False)
    device_ms = None
    if on_card:
        kernel_names = tuple(KERNEL_REGIONS.values())
        counts["kernels"] = counts["device_ops"] = 0
        device_ms = {"kernel": 0.0, "outside": 0.0}
        # each region also shows on the device as a user annotation
        for e in sorted((e for e in events if e.device_type == DeviceType.CUDA
                         and e.name not in KERNEL_REGIONS
                         and not e.is_user_annotation),
                        key=lambda e: e.time_range.start):
            ms = (e.time_range.end - e.time_range.start) / 1e3
            sequence.append(e.name)
            if any(k in e.name for k in kernel_names):
                counts["kernels"] += 1
                device_ms["kernel"] += ms
                continue
            counts["device_ops"] += 1
            device_ms["outside"] += ms
            if "HtoD" in e.name:
                counts["uploads"] += 1
    return CallAudit(counts=counts, regions=regions,
                     sequence=tuple(sequence), device_ms=device_ms)


def profile_call(fn: Callable[[torch.Tensor], object],
                 x: torch.Tensor) -> CallAudit:
    """Profile one call of ``fn(x)`` (no warm-up): outside-region counts."""
    on_card = x.device.type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(x.device)
    with profile(activities=activities) as prof:
        out = fn(x)
        if on_card:
            torch.cuda.synchronize(x.device)
    audit = _summarize(prof.events(), on_card)
    audit.out = out
    return audit


def audit_call(fn: Callable[[torch.Tensor], object],
               x: torch.Tensor) -> CallAudit:
    """Warm ``fn`` up on ``x`` once, then profile a second call."""
    fn(x)
    return profile_call(fn, x)


def probe_input(shape: Tuple[int, ...], device: torch.device,
                seed: int = 0) -> torch.Tensor:
    """N(0, 1) float32 input made from a numpy seed, on ``device``."""
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(size=shape), dtype=torch.float32,
                           device=device)


def output_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / (1 + |want|); inf when ``got`` is not finite or
    has another shape."""
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        return float("inf")
    w = want.double()
    return float(((got.double() - w).abs() / (1 + w.abs())).max())


def check_output(cfg: VetConfig, symbol: str, got: torch.Tensor,
                 spec: StencilSpec, x: torch.Tensor, steps: int = 1
                 ) -> Tuple[List[Finding], float]:
    """Hold an audited call's output against the direct engine's on ``x``."""
    want = StencilEngine(spec, "direct", temporal_steps=steps,
                         device=x.device)(x)
    err = output_error(got, want)
    findings = [] if err <= OUTPUT_TOL else [_finding(
        cfg, "launch-output-mismatch", symbol,
        f"output differs from the direct engine's by {err:.3g} relative "
        f"(tolerance {OUTPUT_TOL}) — a count of the call's work certifies "
        "nothing if the call did not compute the stencil")]
    return findings, err


# ---------------------------------------------------------------------------
# Plain engines: products, hot gathers, scatters, sparse parity
# ---------------------------------------------------------------------------

def _probe_symbol(kernel: str, spec: StencilSpec, fused: bool,
                  steps: int) -> str:
    return (f"{kernel}/{spec.name}{'/fused' if fused else ''}"
            f"{f'/k{steps}' if steps != 1 else ''}")


def analyze_backend(cfg: VetConfig, backend: str, device: torch.device
                    ) -> Tuple[List[Finding], Dict[str, dict]]:
    """Findings + per-probe outside-kernel counts for one plain backend."""
    findings: List[Finding] = []
    per_probe: Dict[str, dict] = {}
    kernel = BACKEND_KERNEL.get(backend, backend)
    budget = cfg.lowering_budgets.get(backend, {})
    for (shape_kind, ndim, radius), fused, steps, probe_shape in PROBES:
        spec = make_stencil(shape_kind, ndim, radius, seed=7)
        symbol = _probe_symbol(kernel, spec, fused, steps)
        engine = StencilEngine(spec, backend=backend, fuse_rows=fused,
                               temporal_steps=steps, device=device)
        x = probe_input(probe_shape, device)
        got = audit_call(engine, x)
        counts = per_probe[symbol] = got.counts
        findings += check_output(cfg, symbol, got.out, spec, x, steps)[0]
        # every budget scales linearly in the temporal block size: the
        # zero-overhead profile must hold per step (§3.3)
        napps = n_applications(spec, fused) * steps
        if counts["products"] != napps:
            findings.append(_finding(
                cfg, "lowering-dot-count", symbol,
                f"expected {napps} product(s) (one per 1-D application per "
                f"step), the call ran {counts['products']}"))
        gather_budget = budget.get("gather", 1) * napps
        if counts["gathers"] > gather_budget:
            findings.append(_finding(
                cfg, "lowering-hot-gather", symbol,
                f"{counts['gathers']} gather(s) on the hot path (budget "
                f"{gather_budget}: the window read only) — a row swap or "
                "metadata gather failed to fold into load addressing (§3.3)"))
        scatter_budget = budget.get("scatter", 0) * napps
        if counts["scatters"] > scatter_budget:
            findings.append(_finding(
                cfg, "lowering-hot-overhead", symbol,
                f"{counts['scatters']} scatter op(s) on the hot path (budget "
                f"{scatter_budget}) — runtime-indexed addressing in a "
                "statically known access pattern"))
    return findings, per_probe


def _by_probe(per_probe: Dict[str, dict]) -> Dict[str, Tuple[str, dict]]:
    """Probe suffix (the symbol after the kernel name) -> (symbol, counts)."""
    return {sym.split("/", 1)[1]: (sym, c) for sym, c in per_probe.items()}


def sparse_parity(cfg: VetConfig, dense: Dict[str, dict],
                  sparse: Dict[str, dict]) -> List[Finding]:
    """sptc may not move or scatter more than gemm, probe by probe.  Raises
    when the two backends were not audited on the same probes."""
    out: List[Finding] = []
    by_dense, by_sparse = _by_probe(dense), _by_probe(sparse)
    if set(by_dense) != set(by_sparse):
        raise ValueError(f"sparse parity needs the same probes on both "
                         f"backends: gemm {sorted(by_dense)}, sptc "
                         f"{sorted(by_sparse)}")
    for probe in sorted(by_dense):
        (_, d), (s_sym, s) = by_dense[probe], by_sparse[probe]
        moved = (s["gathers"] + s["copies"], d["gathers"] + d["copies"])
        for what, (sv, dv) in (("gather + copy", moved),
                               ("scatter", (s["scatters"], d["scatters"]))):
            if sv > dv:
                out.append(_finding(
                    cfg, "lowering-sparse-parity", s_sym,
                    f"sptc hot path runs {sv} {what} op(s) vs gemm's {dv} — "
                    "sparse execution added runtime overhead the paper "
                    "claims is zero"))
    return out


# ---------------------------------------------------------------------------
# The fused cuda_sptc kernel: one program per application, nothing around it
# ---------------------------------------------------------------------------

def check_fused(cfg: VetConfig, symbol: str, counts: Dict[str, int],
                regions: Dict[str, int], dense: Dict[str, int],
                napps: int) -> List[Finding]:
    """The fused rules for one audited call against the dense cuda_gemm
    engine's counts on the same probe."""
    findings: List[Finding] = []
    budget = cfg.lowering_budgets.get("cuda_sptc", {})
    programs = regions.get(FUSED_KERNEL, 0)
    if programs != napps:
        findings.append(_finding(
            cfg, "pallas-fused-program", symbol,
            f"expected {napps} fused program(s) (one {FUSED_KERNEL} per 1-D "
            f"application), the call ran {programs}"))
    elif "kernels" in counts and counts["kernels"] != programs:
        findings.append(_finding(
            cfg, "pallas-fused-program", symbol,
            f"{programs} {FUSED_KERNEL} region(s) launched "
            f"{counts['kernels']} region kernel(s) on the card"))
    gather_budget = budget.get("gather", 1) * napps
    if counts["gathers"] > gather_budget:
        findings.append(_finding(
            cfg, "pallas-fused-gather", symbol,
            f"{counts['gathers']} gather(s) outside the fused program "
            f"(budget {gather_budget}) — windowing/swap/metadata work failed "
            "to fold into the kernel (§3.3)"))
    if counts["scatters"] > budget.get("scatter", 0) * napps:
        findings.append(_finding(
            cfg, "pallas-fused-overhead", symbol,
            f"{counts['scatters']} scatter op(s) outside the fused program — "
            "runtime-indexed addressing in a statically known access "
            "pattern"))
    for op in ("gathers", "copies"):
        if counts[op] > dense[op]:
            findings.append(_finding(
                cfg, "pallas-fused-overhead", symbol,
                f"{counts[op]} {op} outside the fused program vs the dense "
                f"cuda_gemm engine's {dense[op]} — a standalone permute the "
                "paper's row swap eliminates"))
    return findings


def audit_fused(cfg: VetConfig, fn: Callable[[torch.Tensor], object],
                spec: StencilSpec, x: torch.Tensor, symbol: str
                ) -> Tuple[List[Finding], CallAudit, CallAudit]:
    """Audit ``fn`` (a cuda_sptc engine, or a control) on ``x`` under the
    fused rules and hold its output against the direct engine's; returns
    (findings, its audit, the cuda_gemm engine's)."""
    got = audit_call(fn, x)
    dense = audit_call(StencilEngine(spec, backend="cuda_gemm",
                                     device=x.device), x)
    findings = check_fused(cfg, symbol, got.counts, got.regions,
                           dense.counts, n_applications(spec, fused=False))
    findings += check_output(cfg, symbol, got.out, spec, x)[0]
    return findings, got, dense


def analyze_fused(cfg: VetConfig, device: torch.device
                  ) -> Tuple[List[Finding], Dict[str, dict]]:
    """Certify the fused cuda_sptc engine's zero-overhead profile."""
    findings: List[Finding] = []
    per_probe: Dict[str, dict] = {}
    for (shape_kind, ndim, radius), probe_shape in PALLAS_PROBES:
        spec = make_stencil(shape_kind, ndim, radius, seed=7)
        symbol = f"{FUSED_KERNEL}/{spec.name}"
        fs, got, _ = audit_fused(
            cfg, StencilEngine(spec, backend="cuda_sptc", device=device),
            spec, probe_input(probe_shape, device), symbol)
        findings += fs
        per_probe[symbol] = got.counts
    return findings, per_probe


def planted_gather(spec: StencilSpec, device: Device = None,
                   in_region: bool = False
                   ) -> Callable[[torch.Tensor], torch.Tensor]:
    """A cuda_sptc engine whose every op first gathers its rows through a
    standalone ``x2d[perm]`` (the identity order, so the answer holds):
    the fault the fused rules exist to catch.  With ``in_region`` the
    gather runs inside the op's ``sptc_spmm_fused`` region, as a wrapper
    that gathered before its launch would run it; only the card's audit,
    which walks into regions, can see it there."""
    device = resolve_device(device)
    plan = lower_spec(spec, backend="cuda_sptc")

    def gathered_operand(plan, i: int, device: torch.device,
                         dtype: torch.dtype):
        op = _operand_fn(plan, i, device, dtype)

        def gathered(x2d: torch.Tensor, n_out: int) -> torch.Tensor:
            rows = torch.arange(x2d.shape[0], device=x2d.device)
            if not in_region:
                return op(x2d[rows], n_out)
            with region(FUSED_KERNEL):
                return op(x2d[rows], n_out)
        return gathered

    fn = _emit_const(plan, device, torch.float32,
                     operand_fn=gathered_operand)
    return lambda x: fn(x[None])[0]


def v1_path(spec: StencilSpec) -> Callable[[torch.Tensor], torch.Tensor]:
    """The v1 compressed SpMM entry: its swap is a window gather outside
    ``sptc_spmm_windows`` by design — the control the fused rules flag."""
    return lambda x: apply_sptc_v1(spec, x)


# ---------------------------------------------------------------------------
# Per-call rebuilds
# ---------------------------------------------------------------------------

def check_rebuild(cfg: VetConfig, fn: Callable[[torch.Tensor], object],
                  x: torch.Tensor, symbol: str
                  ) -> Tuple[List[Finding], dict]:
    """Calls 2 and 3 of ``fn`` on one shape must run one op/kernel sequence
    and upload nothing from the host."""
    fn(x)
    second, third = profile_call(fn, x), profile_call(fn, x)
    uploads = second.counts["uploads"] + third.counts["uploads"]
    same = second.sequence == third.sequence
    problems = ((["calls 2 and 3 ran different op/kernel sequences"]
                 if not same else [])
                + ([f"{uploads} host upload(s) in calls 2 and 3"]
                   if uploads else []))
    findings = [_finding(
        cfg, "launch-per-call-rebuild", symbol,
        "; ".join(problems) + " — a fixed-shape engine builds its tables "
        "once, in the constructor")] if problems else []
    return findings, {"same_sequence": same, "uploads": uploads}


def run(cfg: VetConfig, device: Device = None
        ) -> Tuple[List[Finding], Dict[str, dict]]:
    """All launch-audit findings + the per-kernel zero-overhead verdict.

    ``device=None`` is the card and raises without one.
    """
    device = resolve_device(device)
    findings: List[Finding] = []
    verdict: Dict[str, dict] = {}
    counts_by_backend: Dict[str, Dict[str, dict]] = {}
    for backend in cfg.lowering_backends:
        fs, per_probe = analyze_backend(cfg, backend, device)
        findings += fs
        counts_by_backend[backend] = per_probe
        verdict[BACKEND_KERNEL.get(backend, backend)] = {
            "probes": per_probe, "certified": not fs}
    if "gemm" in counts_by_backend and "sptc" in counts_by_backend:
        fs = sparse_parity(cfg, counts_by_backend["gemm"],
                           counts_by_backend["sptc"])
        findings += fs
        if fs:
            verdict["sptc_spmm"]["certified"] = False
    fused_findings, fused_probes = analyze_fused(cfg, device)
    findings += fused_findings
    verdict[FUSED_KERNEL] = {"probes": fused_probes,
                             "certified": not fused_findings}
    spec = make_stencil("star", 2, 1, seed=7)
    rebuilt = {b: BACKEND_KERNEL.get(b, b) for b in cfg.lowering_backends}
    rebuilt["cuda_sptc"] = FUSED_KERNEL
    for backend, kernel in rebuilt.items():
        fs, info = check_rebuild(
            cfg, StencilEngine(spec, backend=backend, device=device),
            probe_input((34, 34), device), f"{kernel}/{spec.name}")
        findings += fs
        verdict[kernel]["rebuild"] = info
        if fs:
            verdict[kernel]["certified"] = False
    return findings, verdict
