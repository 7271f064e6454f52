"""Stencil -> matrix-multiplication transform and plan lowering (paper §3.2.1).

A 1-D stencil kernel ``w`` of radius ``r`` becomes a banded *kernel matrix*
``K`` of shape ``(L, 2r+L)`` with ``K[i, i+k] = w[k]``: ``Y = K @ X`` computes
``L`` consecutive stencil outputs for every column of ``X`` (the free axis).
Unlike TCStencil, ``K`` is rectangular — no blank rows.

We pad the width to ``2L`` (columns beyond ``2r+L`` are structurally zero) so
the strided-swap permutation (sparsify.py) is an involution on column pairs
``(j, j+L)`` and the 2:4 segment grid divides the width evenly.

Higher-dimensional stencils decompose by kernel rows (paper §3.2.1): a d-D
kernel is a sum over its leading (d-1)-D offsets of 1-D stencils applied along
the last axis; partial results accumulate.

:func:`lower_spec` is the front door: it runs the full ahead-of-time
pipeline — row-decompose → kernel-matrix build → strided-swap sparsify →
segment-gather schedule → backend emit — and returns the explicit
:class:`repro_torch.core.ir.LoweredPlan` that ``core/engine.py`` executes.
"""
from __future__ import annotations

import time
from typing import TYPE_CHECKING, List, Optional, Tuple

import numpy as np

from repro_torch.core.stencil import StencilSpec, star_mask

if TYPE_CHECKING:   # pragma: no cover — import cycle guard (ir -> sparsify)
    from repro_torch.core.ir import LoweredPlan


def default_l(radius: int) -> int:
    """Paper's choice: L = 2r+2 — exactly 50% band density (§3.2.2 step 1)."""
    return 2 * radius + 2


def kernel_matrix(w: np.ndarray, L: int | None = None,
                  pad_width: bool = True) -> np.ndarray:
    """Banded kernel matrix for a 1-D stencil kernel ``w`` (length 2r+1).

    Returns shape ``(L, 2L)`` if pad_width else ``(L, 2r+L)``.
    Requires ``L >= 2r+2`` and ``L`` even for 2:4 sparsifiability.
    """
    w = np.asarray(w)
    taps = w.shape[0]
    if taps % 2 != 1:
        raise ValueError("1-D stencil kernel must have odd length 2r+1")
    r = (taps - 1) // 2
    if L is None:
        L = default_l(r)
    if L < 2 * r + 2 or L % 2 != 0:
        raise ValueError(f"need even L >= 2r+2 = {2*r+2}, got {L}")
    width = 2 * L if pad_width else 2 * r + L
    K = np.zeros((L, width), dtype=w.dtype)
    for i in range(L):
        K[i, i:i + taps] = w
    return K


def decompose_rows(spec: StencilSpec) -> List[Tuple[Tuple[int, ...], np.ndarray]]:
    """Decompose a d-D stencil into 1-D row kernels (paper §3.2.1).

    Returns a list of ``(lead_offset, w_1d)`` where ``lead_offset`` indexes the
    leading d-1 axes of the kernel (0-based, i.e. offset - r gives the spatial
    shift) and ``w_1d`` is the (2r+1,) kernel row applied along the last axis.
    All-zero rows (star stencils' off-axis rows) are dropped.
    """
    w = spec.weights
    if spec.ndim == 1:
        return [((), w)]
    lead_shape = w.shape[:-1]
    out: List[Tuple[Tuple[int, ...], np.ndarray]] = []
    for lead in np.ndindex(*lead_shape):
        row = w[lead]
        if np.any(row != 0):
            out.append((lead, row))
    return out


def axis_decompose_star(spec: StencilSpec) -> List[np.ndarray]:
    """Fast path for star stencils: one 1-D kernel per axis.

    The center tap is kept in the *last*-axis kernel and zeroed in the others
    so that summing the per-axis 1-D applications counts it exactly once.
    Returns list of per-axis (2r+1,) kernels, index = axis.
    """
    if spec.shape != "star":
        raise ValueError("axis decomposition only applies to star stencils")
    r = spec.radius
    center = (r,) * spec.ndim
    kernels = []
    for axis in range(spec.ndim):
        idx = list(center)
        idx[axis] = slice(None)
        k = np.array(spec.weights[tuple(idx)])
        if axis != spec.ndim - 1:
            k[r] = 0.0
        kernels.append(k)
    return kernels


def band_density(radius: int, L: int) -> float:
    """Non-zero density of the (unpadded) kernel matrix: (2r+1)/(2r+L)."""
    return (2 * radius + 1) / (2 * radius + L)


# --------------------------------------------------------------------------
# Variable coefficients: per-output-point weight values, one shared pattern.
# --------------------------------------------------------------------------

def validate_coefficients(spec: StencilSpec,
                          coefficients: np.ndarray) -> np.ndarray:
    """Check a variable-coefficient field against its spec.

    ``coefficients`` has shape ``out_shape + (2r+1,)*d``: for each output
    point, the full kernel of weights applied there.  Star specs must keep
    the off-axis kernel entries zero (the structural pattern is per-spec,
    not per-point).
    """
    c = np.asarray(coefficients)
    d, r = spec.ndim, spec.radius
    kshape = (2 * r + 1,) * d
    if c.ndim != 2 * d or c.shape[d:] != kshape:
        raise ValueError(
            f"coefficients must have shape out_shape + {kshape}, got "
            f"{c.shape} for a {d}-D radius-{r} spec")
    if any(s < 1 for s in c.shape[:d]):
        raise ValueError("coefficient output shape must be non-empty")
    if spec.shape == "star":
        mask = star_mask(d, r)
        if np.any(c[..., ~mask] != 0):
            raise ValueError(
                "star spec: coefficients must be zero off the axis cross")
    return c


def _axis_coefficient_slabs(spec: StencilSpec,
                            c: np.ndarray) -> List[np.ndarray]:
    """Per-axis value slabs mirroring :func:`axis_decompose_star`.

    Slab ``axis`` has shape ``out_shape + (2r+1,)``; the center tap stays
    only in the last-axis slab so the summed applications count it once.
    """
    r, d = spec.radius, spec.ndim
    center = (r,) * d
    slabs: List[np.ndarray] = []
    for axis in range(d):
        kidx = list(center)
        kidx[axis] = slice(None)
        slab = np.array(c[(Ellipsis,) + tuple(kidx)])
        if axis != d - 1:
            slab[..., r] = 0.0
        slabs.append(slab)
    return slabs


def _row_coefficient_slabs(
        spec: StencilSpec, c: np.ndarray,
) -> List[Tuple[Tuple[int, ...], np.ndarray]]:
    """Per-row value slabs mirroring :func:`decompose_rows`.

    A row is kept when either the spec's constant weights or the
    coefficient field touch it — a row can be structurally present in the
    field even where the template weight happens to be zero.
    """
    lead_shape = spec.weights.shape[:-1]
    out: List[Tuple[Tuple[int, ...], np.ndarray]] = []
    for lead in np.ndindex(*lead_shape):
        slab = c[(Ellipsis,) + lead + (slice(None),)]
        if np.any(slab != 0) or np.any(spec.weights[lead] != 0):
            out.append((lead, np.asarray(slab)))
    return out


# --------------------------------------------------------------------------
# lower_spec: the full AOT pipeline, producing the explicit LoweredPlan.
# --------------------------------------------------------------------------

def lower_spec(spec: StencilSpec, backend: str = "direct",
               L: Optional[int] = None, star_fast_path: bool = True,
               fuse_rows: bool = False, temporal_steps: int = 1,
               coefficients: Optional[np.ndarray] = None) -> "LoweredPlan":
    """Lower a stencil spec into an explicit :class:`LoweredPlan`.

    Runs the paper's ahead-of-time pipeline (§3.2) stage by stage —
    row-decompose, kernel-matrix build, strided-swap 2:4 sparsify,
    segment-gather schedule, backend emit — and returns the ordered IR
    ``core/engine.py`` interprets.  Pure table construction: nothing here
    traces or compiles.

    ``coefficients`` switches the plan to variable-coefficient mode: the
    structural pattern becomes the all-ones band (so every operand shares
    ONE 2:4 pattern / meta-bits and the swap + gather tables are computed
    once) while the per-point values ride along as decompose-stage slabs.
    ``temporal_steps=k`` marks the plan as a fused k-step iterate.

    ``lower_spec.calls`` and ``lower_spec.seconds`` count the plans lowered
    in this process and their host time.
    """
    t0 = time.perf_counter()
    from repro_torch.core import ir
    from repro_torch.core.sparsify import sparsify_matrices

    if backend not in ir.BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; pick from "
                         f"{ir.BACKENDS}")
    if temporal_steps < 1:
        raise ValueError(f"temporal_steps must be >= 1, got {temporal_steps}")
    r, d = spec.radius, spec.ndim
    taps = 2 * r + 1
    if L is None:
        L = default_l(r)

    var = coefficients is not None
    coeff: Optional[np.ndarray] = None
    if var:
        coeff = validate_coefficients(spec, coefficients)
        if backend not in ("direct", "gemm", "sptc"):
            raise ValueError(
                "variable coefficients support the plain torch backends "
                "(direct/gemm/sptc) only")
        if temporal_steps != 1:
            raise ValueError(
                "variable coefficients cannot combine with temporal "
                "blocking: the value field is tied to one output shape")
        if fuse_rows:
            raise ValueError(
                "fuse_rows is a constant-coefficient optimization")

    # -- stage 1: row decomposition -------------------------------------
    ones = np.ones(taps, dtype=np.float64)
    slabs: Optional[List[np.ndarray]] = [] if var else None
    ops: List[ir.RowOp] = []
    kernels: List[np.ndarray] = []
    if d == 1:
        mode = "single"
        ops = [ir.RowOp(axis=0, lead=(), operand=0)]
        kernels = [ones if var else spec.weights]
        if var:
            assert slabs is not None and coeff is not None
            slabs.append(coeff)
    elif star_fast_path and spec.shape == "star":
        mode = "star-axis"
        axis_kernels = axis_decompose_star(spec)
        ops = [ir.RowOp(axis=a, lead=(), operand=a) for a in range(d)]
        kernels = [ones] * d if var else axis_kernels
        if var:
            assert slabs is not None and coeff is not None
            slabs.extend(_axis_coefficient_slabs(spec, coeff))
    elif var:
        mode = "rows"
        assert slabs is not None and coeff is not None
        for i, (lead, slab) in enumerate(
                _row_coefficient_slabs(spec, coeff)):
            ops.append(ir.RowOp(axis=d - 1, lead=lead, operand=i))
            kernels.append(ones)
            slabs.append(slab)
    else:
        mode = "fused-rows" if (fuse_rows and d == 2
                                and backend in ("gemm", "sptc")) else "rows"
        for i, (lead, w_1d) in enumerate(decompose_rows(spec)):
            ops.append(ir.RowOp(axis=d - 1, lead=lead, operand=i))
            kernels.append(w_1d)

    stages: List[ir.Stage] = [ir.RowDecompose(
        mode=mode, ops=tuple(ops), kernels=tuple(kernels),
        coefficients=tuple(slabs) if var else None)]

    # -- stages 2-4: matrices, sparsify, gather schedule ----------------
    if backend in ir.MATRIX_BACKENDS:
        mats = tuple(kernel_matrix(k, L=L, pad_width=True) for k in kernels)
        stages.append(ir.KernelMatrixBuild(L=L, matrices=mats))
        if backend in ir.SPARSE_BACKENDS:
            perm, operands, shared = sparsify_matrices(mats, L)
            stages.append(ir.StridedSwapSparsify(
                perm=perm, operands=operands, shared_pattern=shared))
            window = perm if mode == "fused-rows" else np.arange(2 * L)
            slots = tuple(perm[op.gather_indices()] for op in operands)
        else:
            window = np.arange(2 * L)
            slots = tuple(np.tile(np.arange(2 * L), (L, 1)) for _ in mats)
        stages.append(ir.SegmentGatherSchedule(
            window=window, slots=slots,
            taps=tuple(ir.tap_table(s, taps) for s in slots)))

    stages.append(ir.BackendEmit(
        backend=backend, fuse_rows=(mode == "fused-rows"),
        temporal_steps=temporal_steps,
        coefficient_mode="var" if var else "const"))

    plan = ir.LoweredPlan(spec=spec, L=L, stages=tuple(stages))
    plan.validate()
    lower_spec.calls += 1
    lower_spec.seconds += time.perf_counter() - t0
    return plan


lower_spec.calls = 0        # type: ignore[attr-defined]
lower_spec.seconds = 0.0    # type: ignore[attr-defined]
