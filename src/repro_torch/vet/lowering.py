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
ran inside its region still counts as outside work.  The engine's own
spans (``ENGINE_SPANS``: ``engine.apply`` around a call) hold no work and
are walked through, their children taken as top-level ops.

Counting: only ops that do work are counted, and each once — an op of a
class below is counted unless an enclosing op was already counted, so
the ``aten::copy_`` under an ``aten::clone`` under an ``aten::pad`` is one
copy.  Classes: products (``aten::mm``/``bmm``/``addmm``/``baddbmm``),
gathers (``aten::index``/``gather``/``index_select``/``take``), copies
(``aten::copy_``), scatters (``aten::index_put_``/``scatter*``, the
counterpart of a dynamic-update-slice), adds and fills
(``aten::fill_``/``zero_``: a zero fill or memset).
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
                          1-D application, or, for a 2-D ``rows`` plan the
                          rows kernel takes, ``sptc_spmm_rows2d`` regions
                          != one for its R applications, or, for a 2-D
                          ``star-axis`` plan the star kernel takes,
                          ``sptc_spmm_star2d`` regions != one for its two
                          (on the card: or != the region kernels launched)
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
  outside-device-ops      (card) a ``cuda_*`` call's device ops outside the
                          region kernels exceed what its torch ops outside
                          the regions explain (one per copy, add and fill),
                          or it launched more region kernels than it
                          entered regions: device work no torch op shows
                          (a raw memset, a launch outside any region)

``run`` returns the findings and ``verdict()``-style per-kernel counts
keyed ``stencil_gemm``, ``sptc_spmm`` and ``sptc_spmm_fused``, as the
reference keys them, and ``sharded_halo``.  It runs on the card unless
``device="cpu"`` is given (there the cuda_* engines run their kernels'
plain versions inside the same regions); ``device=None`` raises without a
card.

The **sharded analyzer** (``analyze_sharded``) certifies the halo-exchange
step path of ``distributed/halo.py`` on the reference's probes, with every
shard of a ``LocalTransport`` mesh on the audited device, so it always
runs.  It counts the transport's shifts and watches, under a
``TorchDispatchMode``, every op of the step path outside the per-shard
program (the engine's emission, which the rules above audit):

  sharded-collective-budget  a fused k-step makes != 2 exchanges per
                          partitioned mesh axis (low + high edge; the
                          zero-flux boundary is the transport's zero fill)
  sharded-all-gather      an op whose output holds the global grid's
                          element count laid out as one grid (spanning
                          more than one shard along a partitioned axis),
                          or any ``torch.distributed`` collective other
                          than point to point: the global grid
                          rematerialized instead of width-k·r halos
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.core.engine import (GRID_WRAPPERS, StencilEngine,
                                     apply_sptc_v1, emit_grid, emit_row_ops,
                                     grid_kernel, kernel_launches,
                                     row_op_fn)
from repro_torch.core.stencil import StencilSpec, make_stencil
from repro_torch.core.transform import decompose_rows, lower_spec
from repro_torch.device import Device, resolve_device
from repro_torch.kernels.common import ENGINE_SPANS, KERNEL_REGIONS, region
from repro_torch.vet.config import VetConfig
from repro_torch.vet.findings import Finding, switched_on

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
    "fills": ("aten::fill_", "aten::zero_"),
}
_CLASS_OF = {op: c for c, ops in OP_CLASSES.items() for op in ops}
UPLOAD_OP = "aten::lift_fresh"
#: the counts that must not depend on the input's size
COUNT_KEYS = ("programs",) + tuple(OP_CLASSES) + ("uploads",)
#: float32: |got - direct| <= OUTPUT_TOL * (1 + |direct|)
OUTPUT_TOL = 3e-5

#: a trace on the card loses the device events at its head (on an H100,
#: torch 2.11: early in a process now and then, from one to all of a
#: call's device ops; after minutes of load, in most traces, a handful of
#: its first device events however long they run and whatever the host
#: does before them: chip_smoke.py's trace check after training); every
#: card trace opens with ``LEAD_SPINS`` short spins launched back to back
#: (doubled on every retake), which the loss eats first, and closes with
#: one tail spin launched after the call.  A trace is kept only when both
#: ends are vouched for (a lead spin and the tail spin) and it holds every
#: kernel the wrappers counted; any other is taken again, up to
#: ``TRACE_ATTEMPTS`` times.  A lead spin, not all of them: late in a run
#: the loss eats some spins of most traces and stops there (48 and 49 of
#: 50 audit traces of chip_smoke.py's late check, up to 17 of 64 spins;
#: once, early, 61 of 64; NVIDIA H100 80GB HBM3, 700.00 W), so a kept spin
#: is what shows the loss ended before the call
MARKER_KERNEL = "spin_kernel"
LEAD_SPINS = 64
LEAD_CYCLES = 2_000
#: the tail spin runs 50 times as long as a lead spin: at the card's
#: clocks (1-2 GHz) a lead spin takes 1-2 us and the tail 50-100 us, so
#: its length tells it apart
TAIL_CYCLES = 100_000
TAIL_MIN_US = 20.0
TRACE_ATTEMPTS = 8
#: card traces taken / retaken by ``trace_device`` in this process, the
#: retakes by what the trace lacked (a trace may lack several), and the
#: traces kept although the head loss ate some of their lead spins
TRACE_STATS = {"traces": 0, "retaken": 0, "lost_head": 0, "lost_tail": 0,
               "short_kernels": 0, "kept_lead_partly_lost": 0}

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


def _finding(cfg: VetConfig, rule: str, symbol: str, message: str,
             path: str = _PATH) -> Finding:
    # a rule set "off" is still checked; run() drops its findings
    sev = cfg.severity_of(rule)
    return Finding(rule=rule, severity="info" if sev == "off" else sev,
                   path=path, line=0, symbol=symbol, message=message)


def fused_programs(spec: StencilSpec,
                   device: Device = None) -> Dict[str, int]:
    """The programs a cuda_sptc engine's call of ``spec`` runs on ``device``
    (``None``: the card), by region (``engine.kernel_launches``): once the
    one-launch wrapper ``engine.grid_kernel`` names for the plan there
    (``sptc_spmm_rows2d`` for a 2-D box, ``sptc_spmm_star2d`` for a 2-D
    star on the card), else one ``sptc_spmm_fused`` per 1-D application."""
    return kernel_launches(lower_spec(spec, backend="cuda_sptc"), device)


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
    ``out`` is the call's result.  ``attempts`` is how many times the
    profiled call ran: 1, plus one for each card trace that was retaken
    (``trace_device``); ``audit_call``'s warm-up is one call more.
    ``trace`` (card only) describes the kept trace's ends and kernels
    (``_trace_ends``).
    """

    counts: Dict[str, int]
    regions: Dict[str, int]
    sequence: Tuple[str, ...]
    device_ms: Optional[Dict[str, float]] = None
    out: object = None
    attempts: int = 1
    trace: Optional[Dict[str, object]] = None

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

    def top_level(evs):
        for e in evs:
            if e.name in ENGINE_SPANS:
                yield from top_level(e.cpu_children)
            else:
                yield e

    for e in sorted(top_level(e for e in events
                              if e.device_type == DeviceType.CPU
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
        # each region and span also shows on the device as a user annotation
        for e in sorted((e for e in events if e.device_type == DeviceType.CUDA
                         and e.name not in KERNEL_REGIONS
                         and e.name not in ENGINE_SPANS
                         and not e.is_user_annotation
                         and not is_marker(e)),
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


def _wrappers() -> Dict[str, Callable]:
    """The kernel wrappers by region name (``KERNEL_REGIONS``' keys), each
    counting its launches in ``launches``."""
    from repro_torch.kernels.conv1d import ops as conv_ops
    from repro_torch.kernels.sptc_spmm import ops as sptc_ops
    from repro_torch.kernels.stencil_direct import ops as direct_ops
    from repro_torch.kernels.stencil_gemm import ops as gemm_ops
    return {"sptc_spmm_fused": sptc_ops.sptc_spmm_fused,
            "sptc_spmm_rows2d": sptc_ops.sptc_spmm_rows2d,
            "sptc_spmm_star2d": sptc_ops.sptc_spmm_star2d,
            "sptc_spmm_windows": sptc_ops.sptc_spmm_windows,
            "windows_gemm": gemm_ops.windows_gemm,
            "stencil2d": direct_ops.stencil2d,
            "conv1d_causal": conv_ops.conv1d_causal}


def _trace_ends(events, lead: int, launched: Dict[str, int]) -> dict:
    """What a card trace kept of its ends and of the wrappers' kernels:
    ``lead`` spins launched and ``lead_kept``, ``tail_kept`` (the spins
    that ran ``TAIL_MIN_US`` or longer: 0 or 1), ``launched`` and ``kept``
    region kernels by wrapper."""
    on_dev = [e for e in events if e.device_type == DeviceType.CUDA
              and not e.is_user_annotation]
    spins = [e.time_range.end - e.time_range.start
             for e in on_dev if is_marker(e)]
    tail = sum(us >= TAIL_MIN_US for us in spins)
    kept = {w: sum(KERNEL_REGIONS[w] in e.name for e in on_dev
                   if not is_marker(e) and e.name not in KERNEL_REGIONS)
            for w in launched}
    return {"lead": lead, "lead_kept": len(spins) - tail, "tail_kept": tail,
            "launched": dict(launched), "kept": kept,
            "device_events": len(on_dev)}


def trace_device(fn: Callable[[], object], device: torch.device):
    """``(events, result, attempts)`` of one profiled call of ``fn()`` on
    the card.

    The trace opens with ``LEAD_SPINS`` short ``MARKER_KERNEL`` spins on
    ``device``'s stream (doubled on each retake), synced before the call,
    and closes with one ``TAIL_CYCLES`` spin launched after it, before the
    final synchronise.  It is kept only when it holds a lead spin (a lost
    head stopped short of the call), the tail spin (nothing was lost at
    its end) and, of each kernel wrapper (``KERNEL_REGIONS``), at least as
    many kernels as the wrapper counted launches during the call (nothing
    of the wrappers' was lost between).  Any other trace is taken again, so
    ``fn`` runs ``attempts`` times (1 + the retakes) and a caller that
    counts its launches counts them all; after ``TRACE_ATTEMPTS`` such
    traces this raises.  The spins are left for the caller to skip
    (``is_marker``)."""
    events, out, attempts, _ = _trace(fn, device)
    return events, out, attempts


def _trace(fn: Callable[[], object], device: torch.device):
    """:func:`trace_device`, and ``_trace_ends`` of the kept trace."""
    wrappers = _wrappers()
    seen = []
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        TRACE_STATS["traces"] += 1
        lead = LEAD_SPINS << (attempt - 1)
        torch.cuda.synchronize(device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.cuda.device(device):
                for _ in range(lead):
                    torch.cuda._sleep(LEAD_CYCLES)
                torch.cuda.synchronize()
            before = {w: f.launches for w, f in wrappers.items()}
            out = fn()
            launched = {w: f.launches - before[w]
                        for w, f in wrappers.items()}
            with torch.cuda.device(device):
                torch.cuda._sleep(TAIL_CYCLES)
            torch.cuda.synchronize(device)
        events = prof.events()
        ends = _trace_ends(events, lead, launched)
        lacks = {"lost_head": not ends["lead_kept"],
                 "lost_tail": ends["tail_kept"] != 1,
                 "short_kernels": any(ends["kept"][w] < n
                                      for w, n in launched.items())}
        if not any(lacks.values()):
            TRACE_STATS["kept_lead_partly_lost"] += ends["lead_kept"] < lead
            return events, out, attempt, ends
        TRACE_STATS["retaken"] += 1
        for k, v in lacks.items():
            TRACE_STATS[k] += v
        seen.append({k: v for k, v in ends.items() if k != "lead"})
    raise RuntimeError(
        f"torch.profiler lost the head, the tail or a counted kernel of "
        f"{TRACE_ATTEMPTS} traces in a row (per trace: {seen}): no device "
        "count can be trusted")


def is_marker(event) -> bool:
    return MARKER_KERNEL in event.name


def profile_call(fn: Callable[[torch.Tensor], object],
                 x: torch.Tensor) -> CallAudit:
    """Profile one call of ``fn(x)`` (no warm-up): outside-region counts."""
    on_card = x.device.type == "cuda"
    attempts, ends = 1, None
    if on_card:
        events, out, attempts, ends = _trace(lambda: fn(x), x.device)
    else:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = fn(x)
        events = prof.events()
    audit = _summarize(events, on_card)
    audit.out = out
    audit.attempts = attempts
    audit.trace = ends
    return audit


def audit_call(fn: Callable[[torch.Tensor], object],
               x: torch.Tensor) -> CallAudit:
    """Warm ``fn`` up on ``x`` once, then profile a second call: ``fn``
    runs ``1 + attempts`` times in all."""
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
                spec: StencilSpec, device: Device = None) -> List[Finding]:
    """The fused rules for one audited call of ``spec`` on ``device``
    (``None``: the card) against the dense cuda_gemm engine's counts on the
    same probe: the call enters the regions :func:`fused_programs` names,
    and no more gathers, scatters or copies than its 1-D applications
    allow."""
    findings: List[Finding] = []
    budget = cfg.lowering_budgets.get("cuda_sptc", {})
    napps = n_applications(spec, fused=False)
    want = fused_programs(spec, device)
    got = {k: regions.get(k, 0) for k in (FUSED_KERNEL, *GRID_WRAPPERS)}
    if got != {k: want.get(k, 0) for k in got}:
        findings.append(_finding(
            cfg, "pallas-fused-program", symbol,
            f"expected fused program(s) {want} (one {FUSED_KERNEL} per 1-D "
            f"application, or one {' or '.join(GRID_WRAPPERS)} for every "
            f"row op of a 2-D box or star), the call ran {got}"))
    elif "kernels" in counts and counts["kernels"] != sum(got.values()):
        findings.append(_finding(
            cfg, "pallas-fused-program", symbol,
            f"{sum(got.values())} fused region(s) launched "
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


def check_device_ops(cfg: VetConfig, symbol: str,
                     counts: Dict[str, int]) -> List[Finding]:
    """``outside-device-ops`` for one card audit of a ``cuda_*`` call: each
    copy, add and fill outside the regions is one device op, and each
    region one kernel; anything beyond is device work no torch op shows.
    Counts without ``device_ops`` (a CPU audit) pass."""
    if "device_ops" not in counts:
        return []
    findings: List[Finding] = []
    explained = counts["copies"] + counts["adds"] + counts["fills"]
    if counts["device_ops"] > explained:
        findings.append(_finding(
            cfg, "outside-device-ops", symbol,
            f"{counts['device_ops']} device op(s) outside the region "
            f"kernels, but the torch ops outside the regions explain "
            f"{explained} ({counts['copies']} copies + {counts['adds']} adds "
            f"+ {counts['fills']} fills) — device work no torch op shows"))
    if counts["kernels"] > counts["programs"]:
        findings.append(_finding(
            cfg, "outside-device-ops", symbol,
            f"{counts['kernels']} region kernel(s) launched for "
            f"{counts['programs']} region(s) — a launch outside any region"))
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
                           dense.counts, spec, x.device)
    findings += check_device_ops(cfg, symbol, got.counts)
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
    """A cuda_sptc engine whose every program first gathers its input
    through a standalone index (the identity order, so the answer holds):
    the fault the fused rules exist to catch.  A program is each op's
    ``sptc_spmm_fused``, or the one launch of the wrapper
    ``engine.grid_kernel`` names for the plan on ``device``.  With
    ``in_region`` the gather runs inside the program's region, as a wrapper
    that gathered before its launch would run it; only the card's audit,
    which walks into regions, can see it there."""
    device = resolve_device(device)
    plan = lower_spec(spec, backend="cuda_sptc")
    name = grid_kernel(plan, device)
    if name is not None:
        one_fn = emit_grid(plan, device, torch.float32)

        def gathered_one(x: torch.Tensor) -> torch.Tensor:
            rows = torch.arange(x.shape[0], device=x.device)
            if not in_region:
                return one_fn(x[rows][None])[0]
            with region(name):
                return one_fn(x[rows][None])[0]
        return gathered_one

    def gathered_operand(plan, i: int, device: torch.device,
                         dtype: torch.dtype):
        op = row_op_fn(plan, i, device, dtype)

        def gathered(x2d: torch.Tensor, n_out: int) -> torch.Tensor:
            rows = torch.arange(x2d.shape[0], device=x2d.device)
            if not in_region:
                return op(x2d[rows], n_out)
            with region(FUSED_KERNEL):
                return op(x2d[rows], n_out)
        return gathered

    fn = emit_row_ops(plan, device, torch.float32,
                      operand_fn=gathered_operand)
    return lambda x: fn(x[None])[0]


def planted_outside_launch(spec: StencilSpec, device: Device = None
                           ) -> Callable[[torch.Tensor], torch.Tensor]:
    """A cuda_sptc engine whose every call on the card also launches the
    direct kernel through its ctypes launcher, outside any region and any
    torch op: device work only the card's device events show, the fault
    ``outside-device-ops`` exists to catch.  The answer holds."""
    from repro_torch.kernels.stencil_direct.kernel import stencil2d_launch
    from repro_torch.kernels.stencil_direct.ops import stencil_taps
    device = resolve_device(device)
    engine = StencilEngine(spec, "cuda_sptc", device=device)
    taps = stencil_taps(spec.weights, device)

    def fn(x: torch.Tensor) -> torch.Tensor:
        y = engine(x)
        if x.device.type == "cuda":       # a 1-D grid is one row
            x3, y3 = x.reshape((1, -1) + x.shape[-1:]), y.reshape(
                (1, -1) + y.shape[-1:])
            stencil2d_launch(x3, torch.empty_like(y3), taps.weights,
                             taps.star)
        return y
    return fn


@contextlib.contextmanager
def planted_lost_head() -> Iterator[None]:
    """Within this block the next card trace that ``trace_device`` takes
    shows no marker, as when the profiler loses the head of a trace, so
    that trace is retaken; the later traces are read as they are."""
    global is_marker
    first = TRACE_STATS["traces"] + 1
    kept = is_marker

    def hidden(event) -> bool:
        return kept(event) and TRACE_STATS["traces"] != first
    is_marker = hidden
    try:
        yield
    finally:
        is_marker = kept


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


# ---------------------------------------------------------------------------
# Sharded halo exchange: the exchange budget on the distributed step path
# ---------------------------------------------------------------------------

_SHARDED_PATH = "src/repro_torch/distributed/halo.py"

#: torch.distributed ops a step may run: point to point only
P2P_OPS = ("send", "recv_", "recv_any_source_")
_DIST_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")


def sharded_probes() -> Tuple[Tuple[Tuple[str, int, int], tuple, int,
                                    Tuple[int, ...]], ...]:
    """(spec ctor args, mesh parts, temporal steps, probe interior shape):
    the reference's probes, every shard on the audited device."""
    return ((("star", 2, 1), (2,), 1, (24, 24)),
            (("box", 2, 1), (2,), 2, (24, 24)),
            (("box", 2, 2), (2, 2), 1, (24, 24)))


class _StepPath(TorchDispatchMode):
    """Records the ops of a sharded step outside the per-shard program:
    those whose output is a rematerialized global grid, and any collective
    other than point to point."""

    def __init__(self, engine, geo) -> None:
        super().__init__()
        self.engine = engine
        self.numel = int(np.prod(geo.gshape))
        nd = engine.spec.ndim
        # the widest a shard's buffer gets along each partitioned axis
        self.limit = {a: geo.ext[a] for a in engine.partition()}
        self.nd = nd
        self.inside = 0
        self.global_grids: List[str] = []
        self.collectives: List[str] = []

    def _is_global(self, t: torch.Tensor) -> bool:
        if t.numel() < self.numel or t.dim() < self.nd:
            return False
        lead = t.dim() - self.nd
        return any(t.shape[lead + a] > lim for a, lim in self.limit.items())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.inside:
            return out
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns in _DIST_NAMESPACES and name not in P2P_OPS:
            self.collectives.append(f"{ns}.{name}")
        if any(isinstance(t, torch.Tensor) and self._is_global(t)
               for t in tree_leaves(out)):
            self.global_grids.append(f"{ns}.{name}")
        return out

    def run_steps(self, ext: torch.Tensor, geo, nblocks: int) -> torch.Tensor:
        eng = self.engine
        program = eng._shard_step

        def per_shard(x: torch.Tensor) -> torch.Tensor:
            self.inside += 1
            try:
                return program(x)
            finally:
                self.inside -= 1
        eng._shard_step = per_shard
        try:
            with self:
                return eng._steps(ext, geo, nblocks)
        finally:
            eng._shard_step = program


def audit_sharded(cfg: VetConfig, engine, u: torch.Tensor, nblocks: int,
                  symbol: str) -> Tuple[List[Finding], Dict[str, int]]:
    """Run ``nblocks`` fused steps of ``engine`` on the interior grid
    ``u``: the exchange count per step, the step path's global grids and
    collectives, and the result against the direct engine's ``iterate``."""
    geo = engine._geometry(tuple(u.shape))
    ext = engine._scatter(u[None], geo)
    engine.transport.reset()
    watch = _StepPath(engine, geo)
    got = engine._assemble(watch.run_steps(ext, geo, nblocks), geo)[0]
    naxes = len(engine.partition())
    expected = 2 * naxes
    per_step = engine.transport.calls / nblocks
    counts = {"collective-permute": (int(per_step) if per_step.is_integer()
                                     else per_step),
              "gather-like": len(watch.global_grids) + len(watch.collectives)}
    findings: List[Finding] = []

    def flag(rule: str, message: str) -> None:
        findings.append(_finding(cfg, rule, symbol, message,
                                 path=_SHARDED_PATH))
    if engine.transport.calls != expected * nblocks:
        flag("sharded-collective-budget",
             f"expected exactly {expected} exchanges per fused step (2 per "
             f"partitioned axis × {naxes} axes), the step path made "
             f"{counts['collective-permute']}")
    if counts["gather-like"]:
        what = sorted(set(watch.global_grids)) + sorted(
            set(watch.collectives))
        flag("sharded-all-gather",
             f"{counts['gather-like']} op(s) on the sharded step path "
             f"rematerialized the global grid or ran a collective other "
             f"than point to point ({', '.join(what)}) instead of "
             "exchanging width-k·r halos")
    h, k = engine.halo, engine.temporal_steps
    want = StencilEngine(engine.spec, "direct", temporal_steps=k,
                         device=u.device).iterate(
        F.pad(u, (h,) * (2 * u.dim())), k * nblocks)
    want = want[tuple(slice(h, -h) for _ in range(u.dim()))]
    err = output_error(got, want)
    if err > OUTPUT_TOL:
        findings.append(_finding(
            cfg, "launch-output-mismatch", symbol,
            f"sharded output differs from the direct engine's by {err:.3g} "
            f"relative (tolerance {OUTPUT_TOL})"))
    return findings, counts


def probe_mesh(parts: tuple, device: torch.device):
    """A ``LocalTransport`` mesh of ``parts`` with every shard on
    ``device``."""
    from repro_torch.distributed.halo import grid_mesh
    return grid_mesh(parts, devices=[device] * int(np.prod(parts)))


def analyze_sharded(cfg: VetConfig, device: torch.device
                    ) -> Tuple[List[Finding], Dict[str, dict]]:
    """Certify the halo-exchange budget on the sharded step path: per fused
    k-step exactly two exchanges per partitioned axis and nothing
    gather-shaped, for ``step`` (one block) and ``iterate`` (two), through
    ``cuda_sptc`` on the card and ``sptc`` on the CPU (the reference's
    backend)."""
    from repro_torch.distributed.halo import ShardedStencilEngine
    findings: List[Finding] = []
    per_probe: Dict[str, dict] = {}
    backend = "cuda_sptc" if device.type == "cuda" else "sptc"
    for (shape_kind, ndim, radius), parts, steps, shape in sharded_probes():
        spec = make_stencil(shape_kind, ndim, radius, seed=7)
        mesh_tag = "x".join(str(p) for p in parts)
        symbol = (f"halo/{spec.name}/mesh{mesh_tag}"
                  f"{f'/k{steps}' if steps != 1 else ''}")
        engine = ShardedStencilEngine(spec, probe_mesh(parts, device),
                                      backend=backend, temporal_steps=steps)
        u = probe_input(shape, device)
        for tag, nblocks in (("step", 1), ("iterate", 2)):
            fs, counts = audit_sharded(cfg, engine, u, nblocks,
                                       f"{symbol}/{tag}")
            findings += fs
            per_probe[f"{symbol}/{tag}"] = counts
    return findings, per_probe


def planted_over_exchange(spec: StencilSpec, parts: tuple,
                          device: torch.device, **kw):
    """A sharded engine whose transport sends every high edge twice: the
    fault ``sharded-collective-budget`` exists to catch (the answer holds,
    the second copy overwrites the first)."""
    from repro_torch.distributed.halo import ShardedStencilEngine
    from repro_torch.distributed.transport import LocalTransport

    class ThirdExchange(LocalTransport):
        def shift(self, src, dst, dim, axis, step):
            super().shift(src, dst, dim, axis, step)
            if step > 0:
                super().shift(src, dst, dim, axis, step)

    return ShardedStencilEngine(spec, probe_mesh(parts, device),
                                transport=ThirdExchange(), **kw)


def planted_global_gather(spec: StencilSpec, parts: tuple,
                          device: torch.device, **kw):
    """A sharded engine whose every step first concatenates all blocks
    into the global grid, as a partitioner that fell back to an
    all-gather would: the fault ``sharded-all-gather`` exists to catch."""
    from repro_torch.distributed.halo import ShardedStencilEngine

    class Gathering(ShardedStencilEngine):
        def _step(self, ext, out, geo):
            self._assemble(ext, geo)
            super()._step(ext, out, geo)

    return Gathering(spec, probe_mesh(parts, device), **kw)


def run(cfg: VetConfig, device: Device = None
        ) -> Tuple[List[Finding], Dict[str, dict]]:
    """All launch-audit findings + the per-kernel zero-overhead verdict.
    A rule set ``"off"`` reports nothing and leaves the verdict alone.

    ``device=None`` is the card and raises without one.
    """
    device = resolve_device(device)

    def on(fs: List[Finding]) -> List[Finding]:
        return switched_on(fs, cfg.severity_of)
    findings: List[Finding] = []
    verdict: Dict[str, dict] = {}
    counts_by_backend: Dict[str, Dict[str, dict]] = {}
    for backend in cfg.lowering_backends:
        fs, per_probe = analyze_backend(cfg, backend, device)
        fs = on(fs)
        findings += fs
        counts_by_backend[backend] = per_probe
        verdict[BACKEND_KERNEL.get(backend, backend)] = {
            "probes": per_probe, "certified": not fs}
    if "gemm" in counts_by_backend and "sptc" in counts_by_backend:
        fs = on(sparse_parity(cfg, counts_by_backend["gemm"],
                              counts_by_backend["sptc"]))
        findings += fs
        if fs:
            verdict["sptc_spmm"]["certified"] = False
    fused_findings, fused_probes = analyze_fused(cfg, device)
    fused_findings = on(fused_findings)
    findings += fused_findings
    verdict[FUSED_KERNEL] = {"probes": fused_probes,
                             "certified": not fused_findings}
    sharded_findings, sharded_ran = analyze_sharded(cfg, device)
    sharded_findings = on(sharded_findings)
    findings += sharded_findings
    verdict["sharded_halo"] = {"probes": sharded_ran,
                               "certified": not sharded_findings}
    spec = make_stencil("star", 2, 1, seed=7)
    rebuilt = {b: BACKEND_KERNEL.get(b, b) for b in cfg.lowering_backends}
    rebuilt["cuda_sptc"] = FUSED_KERNEL
    for backend, kernel in rebuilt.items():
        fs, info = check_rebuild(
            cfg, StencilEngine(spec, backend=backend, device=device),
            probe_input((34, 34), device), f"{kernel}/{spec.name}")
        fs = on(fs)
        findings += fs
        verdict[kernel]["rebuild"] = info
        if fs:
            verdict[kernel]["certified"] = False
    return findings, verdict
