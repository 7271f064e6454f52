"""Ahead-of-time verification of the SPIDER transform pipeline (pure NumPy).

SPIDER's correctness argument is *static*: for every stencil the repo can
execute, the banded kernel matrix, the strided-swap permutation, and the
2:4 encoding must satisfy checkable algebraic invariants **before any
kernel runs** (paper §3.2).  This analyzer re-derives each invariant on
kernel matrices only — no engine, no kernel execution — over the paper
benchmark suite's row kernels × a radius/L sweep:

  invariant-banded        K[i, j] == w[j-i] inside the band, 0 outside
  invariant-involution    strided_swap_perm is a self-inverse permutation
  invariant-24            the swapped matrix is genuinely 2:4 sparse
  invariant-meta          Sparse24.meta in [0,4), strictly increasing per
                          segment pair, consistent with meta_bits packing
  invariant-gather-range  gather_indices land inside [0, K) and in the
                          right segment
  invariant-roundtrip     decode(encode(Kp)) == Kp exactly

On top of the per-matrix algebra, the analyzer lowers probe specs into
the explicit :class:`~repro_torch.core.ir.LoweredPlan` IR and re-checks the
pipeline *as a whole* (still no engine, pure table inspection):

  invariant-plan-stages    every plan carries the canonical stage
                           subsequence for its backend family, passes
                           structural validation, and keeps its tables
                           mutually consistent (const, variable-
                           coefficient, and temporal-blocked probes)
  invariant-shared-pattern variable-coefficient plans share ONE 2:4
                           pattern / meta-bits / gather schedule across
                           all row operands — the property that lets the
                           swap permutation be computed once

The probes include the port's ``cuda_direct``/``cuda_gemm``/``cuda_sptc``
plans: a kernel backend lowers to the same stages as its plain family.

Every check doubles as a *failure-injection* point for tests: pass a
corrupted matrix / permutation / Sparse24 and the analyzer must produce
the corresponding finding.
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np

from repro_torch.core.ir import (BACKENDS, MATRIX_BACKENDS, SPARSE_BACKENDS,
                                 STAGE_ORDER, LoweredPlan)
from repro_torch.core.sparsify import (Sparse24, apply_col_perm, decode_24,
                                       encode_24, is_24_sparse,
                                       strided_swap_perm)
from repro_torch.core.stencil import paper_suite, star_mask
from repro_torch.core.transform import (decompose_rows, default_l,
                                        kernel_matrix, lower_spec)
from repro_torch.vet.config import VetConfig
from repro_torch.vet.findings import Finding, switched_on

_PATH = "src/repro_torch/core/sparsify.py"
_IR_PATH = "src/repro_torch/core/ir.py"


def _finding(cfg: VetConfig, rule: str, symbol: str, message: str,
             path: str = _PATH) -> Finding:
    # a rule set "off" is still checked; run() drops its findings
    sev = cfg.severity_of(rule)
    return Finding(rule=rule, severity="info" if sev == "off" else sev,
                   path=path, line=0, symbol=symbol, message=message)


def check_kernel_matrix(cfg: VetConfig, K: np.ndarray, w: np.ndarray,
                        L: int, symbol: str) -> List[Finding]:
    """Bandedness: row i holds w at columns [i, i+2r], zero elsewhere."""
    out: List[Finding] = []
    taps = w.shape[0]
    if K.shape != (L, 2 * L):
        out.append(_finding(cfg, "invariant-banded", symbol,
                            f"kernel matrix shape {K.shape} != ({L}, {2 * L})"))
        return out
    for i in range(L):
        band = K[i, i:i + taps]
        if not np.array_equal(band, w):
            out.append(_finding(cfg, "invariant-banded", symbol,
                                f"row {i} band does not equal the stencil "
                                f"kernel"))
            break
    mask = np.ones_like(K, dtype=bool)
    for i in range(L):
        mask[i, i:i + taps] = False
    if np.any(K[mask] != 0):
        out.append(_finding(cfg, "invariant-banded", symbol,
                            "non-zero entries outside the band"))
    return out


def check_involution(cfg: VetConfig, perm: np.ndarray,
                     symbol: str) -> List[Finding]:
    """The strided swap must be a self-inverse permutation of 2L columns."""
    out: List[Finding] = []
    n = perm.shape[0]
    if sorted(perm.tolist()) != list(range(n)):
        out.append(_finding(cfg, "invariant-involution", symbol,
                            "strided_swap_perm is not a permutation"))
        return out
    if not np.array_equal(perm[perm], np.arange(n)):
        out.append(_finding(cfg, "invariant-involution", symbol,
                            "strided_swap_perm is not an involution "
                            "(perm[perm] != identity)"))
    return out


def check_24_pattern(cfg: VetConfig, Kp: np.ndarray,
                     symbol: str) -> List[Finding]:
    """Post-swap matrix must hold <= 2 non-zeros per aligned 4-segment."""
    if Kp.shape[1] % 4 != 0:
        return [_finding(cfg, "invariant-24", symbol,
                         f"width {Kp.shape[1]} not a multiple of 4")]
    if not is_24_sparse(Kp):
        seg = (Kp.reshape(Kp.shape[0], -1, 4) != 0).sum(axis=-1)
        bad = np.argwhere(seg > 2)[0]
        return [_finding(cfg, "invariant-24", symbol,
                         f"strided swap failed: row {bad[0]} segment "
                         f"{bad[1]} holds {seg[bad[0], bad[1]]} non-zeros")]
    return []


def check_sparse24(cfg: VetConfig, sp: Sparse24, Kp: np.ndarray | None,
                   symbol: str) -> List[Finding]:
    """Metadata domain/order, gather ranges, bit packing, and round-trip."""
    out: List[Finding] = []
    meta = np.asarray(sp.meta)
    if meta.size and (meta.min() < 0 or meta.max() > 3):
        out.append(_finding(cfg, "invariant-meta", symbol,
                            f"meta outside [0, 4): min={meta.min()} "
                            f"max={meta.max()}"))
    pairs = meta.reshape(meta.shape[0], -1, 2)
    if np.any(pairs[:, :, 0] >= pairs[:, :, 1]):
        bad = np.argwhere(pairs[:, :, 0] >= pairs[:, :, 1])[0]
        out.append(_finding(cfg, "invariant-meta", symbol,
                            f"meta not strictly increasing in row {bad[0]} "
                            f"segment {bad[1]} (LSB-first order violated)"))
    words = sp.meta_bits()
    for f in range(min(16, meta.shape[1])):
        unpacked = (words[:, f // 16] >> (2 * (f % 16))) & 0x3
        if not np.array_equal(unpacked, meta[:, f].astype(np.uint32) & 0x3):
            out.append(_finding(cfg, "invariant-meta", symbol,
                                f"meta_bits field {f} disagrees with meta "
                                "(LSB-first packing broken)"))
            break
    idx = sp.gather_indices()
    if idx.size and (idx.min() < 0 or idx.max() >= sp.k):
        out.append(_finding(cfg, "invariant-gather-range", symbol,
                            f"gather index out of range [0, {sp.k}): "
                            f"min={idx.min()} max={idx.max()}"))
    else:
        seg = np.arange(idx.shape[1]) // 2          # segment of each slot
        if np.any(idx // 4 != seg[None, :]):
            out.append(_finding(cfg, "invariant-gather-range", symbol,
                                "gather index escapes its 4-wide segment"))
    if Kp is not None and not out:
        if not np.array_equal(decode_24(sp), Kp):
            out.append(_finding(cfg, "invariant-roundtrip", symbol,
                                "decode(encode(Kp)) != Kp — placeholder "
                                "rule or metadata corrupt"))
    return out


def verify_kernel(cfg: VetConfig, w: np.ndarray, L: int,
                  symbol: str) -> List[Finding]:
    """Run the full transform pipeline for one 1-D row kernel at one L."""
    out: List[Finding] = []
    try:
        K = kernel_matrix(np.asarray(w, dtype=np.float64), L=L,
                          pad_width=True)
    except ValueError as e:
        return [_finding(cfg, "invariant-banded", symbol,
                         f"kernel_matrix rejected the sweep point: {e}")]
    out += check_kernel_matrix(cfg, K, np.asarray(w, dtype=np.float64), L,
                               symbol)
    perm = strided_swap_perm(L)
    out += check_involution(cfg, perm, symbol)
    Kp = apply_col_perm(K, perm)
    out += check_24_pattern(cfg, Kp, symbol)
    if any(f.rule == "invariant-24" for f in out):
        return out                  # encoding would raise; finding suffices
    sp = encode_24(Kp)
    out += check_sparse24(cfg, sp, Kp, symbol)
    return out


def sweep_points(cfg: VetConfig):
    """(w, L, symbol) for every registry row kernel × radius/L sweep."""
    seen = set()
    # every 1-D row kernel the paper-suite registry can dispatch
    for spec in paper_suite():
        for lead, w in decompose_rows(spec):
            key = (spec.name, tuple(lead))
            if key in seen:
                continue
            seen.add(key)
            base = default_l(spec.radius)
            for L in sorted({base, -(-base // 8) * 8}):
                yield w, L, f"{spec.name}/row{lead}/L{L}"
    # synthetic radius sweep beyond the suite (arbitrary banded contents)
    rng = np.random.default_rng(0)
    for r in cfg.invariant_radii:
        w = rng.uniform(-1.0, 1.0, size=2 * r + 1)
        base = default_l(r)
        for L in sorted({base, base + 2, -(-base // 8) * 8}):
            yield w, L, f"synthetic-r{r}/L{L}"


# ---------------------------------------------------------------------------
# LoweredPlan (IR) invariants — the pipeline as a whole
# ---------------------------------------------------------------------------

#: expected stage-name subsequence per backend family
def _expected_stages(backend: str) -> Tuple[str, ...]:
    if backend in SPARSE_BACKENDS:
        return STAGE_ORDER
    if backend in MATRIX_BACKENDS:
        return tuple(n for n in STAGE_ORDER if n != "strided-swap")
    return (STAGE_ORDER[0], STAGE_ORDER[-1])


def check_lowered_plan(cfg: VetConfig, plan: LoweredPlan,
                       symbol: str) -> List[Finding]:
    """IR-level invariants: stage structure + the shared-pattern property."""
    out: List[Finding] = []
    try:
        plan.validate()
    except ValueError as e:
        return [_finding(cfg, "invariant-plan-stages", symbol,
                         f"plan failed structural validation: {e}",
                         path=_IR_PATH)]
    expected = _expected_stages(plan.emit.backend)
    if plan.stage_names() != expected:
        out.append(_finding(
            cfg, "invariant-plan-stages", symbol,
            f"stage sequence {plan.stage_names()} != expected {expected} "
            f"for backend {plan.emit.backend}", path=_IR_PATH))
    sp, gather = plan.sparsify, plan.gather
    if plan.emit.coefficient_mode == "var" and sp is not None:
        metas = {op.meta.tobytes() for op in sp.operands}
        bits = {op.meta_bits().tobytes() for op in sp.operands}
        if len(metas) > 1 or len(bits) > 1:
            out.append(_finding(
                cfg, "invariant-shared-pattern", symbol,
                f"variable-coefficient operands carry {len(metas)} distinct "
                f"2:4 patterns / {len(bits)} distinct meta-bit packings — "
                "the swap permutation can no longer be computed once",
                path=_IR_PATH))
        elif not sp.shared_pattern:
            out.append(_finding(
                cfg, "invariant-shared-pattern", symbol,
                "operands share one pattern but the plan does not record "
                "shared_pattern=True", path=_IR_PATH))
        if gather is not None and any(
                not np.array_equal(s, gather.slots[0])
                or not np.array_equal(t, gather.taps[0])
                for s, t in zip(gather.slots, gather.taps)):
            out.append(_finding(
                cfg, "invariant-shared-pattern", symbol,
                "variable-coefficient gather schedules differ across "
                "operands — the slot/tap tables must be computed once from "
                "the shared pattern", path=_IR_PATH))
    return out


def plan_probes(cfg: VetConfig) -> Iterator[Tuple[LoweredPlan, str]]:
    """(plan, symbol) probes: const, variable-coefficient, and temporal."""
    rng = np.random.default_rng(0)
    specs = [s for s in paper_suite() if s.ndim <= 2]
    for spec in specs:
        for backend in BACKENDS:
            yield (lower_spec(spec, backend=backend),
                   f"{spec.name}/{backend}")
        # temporal blocking: k is an IR-level attribute, stages unchanged
        yield (lower_spec(spec, backend="sptc", temporal_steps=2),
               f"{spec.name}/sptc/k2")
        # variable coefficients: small random field, star cross respected
        out_shape = (6,) * spec.ndim
        taps = 2 * spec.radius + 1
        c = rng.normal(size=out_shape + (taps,) * spec.ndim)
        if spec.shape == "star":
            c[..., ~star_mask(spec.ndim, spec.radius)] = 0.0
        for backend in ("gemm", "sptc"):
            yield (lower_spec(spec, backend=backend, coefficients=c),
                   f"{spec.name}/{backend}/var")
        if spec.ndim == 2 and spec.shape != "star":
            yield (lower_spec(spec, backend="sptc", fuse_rows=True),
                   f"{spec.name}/sptc/fused")


def run(cfg: VetConfig) -> List[Finding]:
    findings: List[Finding] = []
    for w, L, symbol in sweep_points(cfg):
        findings += verify_kernel(cfg, w, L, symbol)
    for plan, symbol in plan_probes(cfg):
        findings += check_lowered_plan(cfg, plan, symbol)
    return switched_on(findings, cfg.severity_of)
