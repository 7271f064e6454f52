"""Explicit lowering IR: the stencil engine's compilation pipeline as data.

The SPIDER transform (paper §3.2) is a fixed sequence of ahead-of-time
stages — every one of them pure table construction, no kernel execution:

    spec ──► row-decompose ──► kernel-matrix ──► strided-swap ──►
             gather-schedule ──► emit

A :class:`LoweredPlan` records that sequence explicitly, one frozen
dataclass per stage, so that

  * ``core/transform.py`` (:func:`~repro_torch.core.transform.lower_spec`)
    *produces* plans, and
  * ``core/engine.py`` merely *executes* them through one generic stage
    interpreter per backend, building every device table once.

Stage presence depends on the backend: ``direct`` plans stop after
row-decompose; ``gemm``-family plans add the kernel-matrix and gather
stages; ``sptc``-family plans carry all five.

Two workload attributes live at the IR level rather than inside the
stage tables:

  * ``BackendEmit.coefficient_mode`` — ``"var"`` plans apply per-output-
    point weight *values* while every row shares ONE sparsity pattern /
    meta-bits, so the swap permutation and gather tables are computed
    once (``RowDecompose.coefficients`` holds the per-row value slabs).
  * ``BackendEmit.temporal_steps`` — a ``k``-step temporal block: the
    emitted program applies the stencil ``k`` times in one compiled
    function, amortizing the AOT swap tables across steps (the input
    carries a ``k·r`` halo that shrinks by ``r`` per step).
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional, Tuple, Union

import numpy as np

from repro_torch.core.sparsify import Sparse24
from repro_torch.core.stencil import StencilSpec

#: every backend an emitted plan can target (the engine's dispatch set).
#: ``direct``/``gemm``/``sptc`` are plain torch ops on any device; the
#: ``cuda_*`` backends run hand-written CUDA kernels for Hopper
#: (``repro_torch.kernels``) and fall back to the kernels' plain torch
#: versions only for tensors that lie on the CPU.
BACKENDS: Tuple[str, ...] = ("direct", "gemm", "sptc", "cuda_direct",
                             "cuda_gemm", "cuda_sptc")

#: backends that execute through kernel matrices (stages 2-4 present)
MATRIX_BACKENDS: Tuple[str, ...] = tuple(
    b for b in BACKENDS if b.endswith(("gemm", "sptc")))

#: backends that execute the 2:4-compressed operand (stage 3 present)
SPARSE_BACKENDS: Tuple[str, ...] = tuple(
    b for b in BACKENDS if b.endswith("sptc"))

DECOMPOSE_MODES: Tuple[str, ...] = ("single", "star-axis", "rows",
                                    "fused-rows")
COEFFICIENT_MODES: Tuple[str, ...] = ("const", "var")


@dataclasses.dataclass(frozen=True)
class RowOp:
    """One 1-D stencil application the emitted program performs.

    ``axis`` is the input axis the 1-D kernel runs along; ``lead`` holds
    the leading-axis slice offsets for ``"rows"``-mode decompositions
    (empty otherwise); ``operand`` indexes this op's tables in the
    downstream stages (kernels, matrices, sparse operands, schedules).
    """

    axis: int
    lead: Tuple[int, ...]
    operand: int


@dataclasses.dataclass(frozen=True)
class RowDecompose:
    """Stage 1 — d-D stencil → ordered 1-D row applications (§3.2.1).

    ``kernels[i]`` is the constant ``(2r+1,)`` kernel of operand ``i``.
    In variable-coefficient mode, ``coefficients[i]`` additionally holds
    operand ``i``'s per-output-point values, shape ``out_shape + (2r+1,)``
    (``kernels`` then records the structural all-ones pattern row).
    """

    mode: str
    ops: Tuple[RowOp, ...]
    kernels: Tuple[np.ndarray, ...]
    coefficients: Optional[Tuple[np.ndarray, ...]] = None

    name: ClassVar[str] = "row-decompose"


@dataclasses.dataclass(frozen=True)
class KernelMatrixBuild:
    """Stage 2 — banded ``(L, 2L)`` kernel matrix per operand (§3.2.1)."""

    L: int
    matrices: Tuple[np.ndarray, ...]

    name: ClassVar[str] = "kernel-matrix"


@dataclasses.dataclass(frozen=True)
class StridedSwapSparsify:
    """Stage 3 — strided-swap column permutation + 2:4 encode (§3.2.2).

    ``perm`` is the single ``(2L,)`` involution shared by every operand;
    ``operands[i]`` is operand ``i``'s compressed ``Sparse24``.
    ``shared_pattern`` is True iff all operands carry identical metadata
    — guaranteed by construction for variable-coefficient plans.
    """

    perm: np.ndarray
    operands: Tuple[Sparse24, ...]
    shared_pattern: bool

    name: ClassVar[str] = "strided-swap"


@dataclasses.dataclass(frozen=True)
class SegmentGatherSchedule:
    """Stage 4 — fully static load addressing for the emitted program.

    ``window``   (2L,)  row order of the im2col window gather — identity
                 for dense execution; the strided-swap permutation when
                 the row swap folds into the fused window read (§3.3).
    ``slots[i]`` (L, S) input row *within the window* feeding each output
                 slot of operand ``i`` (S = K/2 compressed, 2L dense).
    ``taps[i]``  (L, S) kernel tap index each slot multiplies, ``-1``
                 where the slot is structurally zero.  Variable-
                 coefficient emission reads per-point values through this
                 table — it is computed once, from the shared pattern.
    """

    window: np.ndarray
    slots: Tuple[np.ndarray, ...]
    taps: Tuple[np.ndarray, ...]

    name: ClassVar[str] = "gather-schedule"


@dataclasses.dataclass(frozen=True)
class BackendEmit:
    """Stage 5 — how the interpreter turns the tables into a program."""

    backend: str
    fuse_rows: bool = False
    temporal_steps: int = 1
    coefficient_mode: str = "const"

    name: ClassVar[str] = "emit"


Stage = Union[RowDecompose, KernelMatrixBuild, StridedSwapSparsify,
              SegmentGatherSchedule, BackendEmit]

#: canonical stage order — plans carry a subsequence of this
STAGE_ORDER: Tuple[str, ...] = (RowDecompose.name, KernelMatrixBuild.name,
                                StridedSwapSparsify.name,
                                SegmentGatherSchedule.name, BackendEmit.name)


def tap_table(slots: np.ndarray, taps: int) -> np.ndarray:
    """Kernel-tap index per (row, slot); -1 where structurally zero.

    Kernel-matrix row ``i`` holds ``K[i, j] = w[j - i]`` inside the band,
    and slot ``(i, s)`` reads original column ``slots[i, s]`` — so the tap
    is the column offset relative to the row, masked to the band.
    """
    rel = slots - np.arange(slots.shape[0])[:, None]
    return np.where((rel >= 0) & (rel < taps), rel, -1).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class LoweredPlan:
    """The full lowering of one stencil spec: ordered, inspectable stages."""

    spec: StencilSpec
    L: int
    stages: Tuple[Stage, ...]

    # -- stage accessors -----------------------------------------------------
    def _find(self, cls: type) -> Optional[Stage]:
        for s in self.stages:
            if isinstance(s, cls):
                return s
        return None

    @property
    def decompose(self) -> RowDecompose:
        stage = self._find(RowDecompose)
        assert stage is not None, "every plan starts with row-decompose"
        return stage  # type: ignore[return-value]

    @property
    def kernel(self) -> Optional[KernelMatrixBuild]:
        return self._find(KernelMatrixBuild)  # type: ignore[return-value]

    @property
    def sparsify(self) -> Optional[StridedSwapSparsify]:
        return self._find(StridedSwapSparsify)  # type: ignore[return-value]

    @property
    def gather(self) -> Optional[SegmentGatherSchedule]:
        return self._find(SegmentGatherSchedule)  # type: ignore[return-value]

    @property
    def emit(self) -> BackendEmit:
        stage = self._find(BackendEmit)
        assert stage is not None, "every plan ends with backend emit"
        return stage  # type: ignore[return-value]

    # -- derived structure ---------------------------------------------------
    def stage_names(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self.stages)

    def n_applications(self) -> int:
        """1-D applications (== dots on matrix backends) per *step*."""
        if self.decompose.mode == "fused-rows":
            return 1
        return len(self.decompose.ops)

    def describe(self) -> str:
        """Compact pipeline rendering, e.g.
        ``star-2d1r -> row-decompose[star-axis x2] -> kernel-matrix[L4]
        -> strided-swap[2:4 shared] -> gather-schedule -> emit[sptc]``."""
        parts = [self.spec.name]
        for s in self.stages:
            if isinstance(s, RowDecompose):
                tag = f"[{s.mode} x{len(s.ops)}"
                if s.coefficients is not None:
                    tag += " var"
                parts.append(f"{s.name}{tag}]")
            elif isinstance(s, KernelMatrixBuild):
                parts.append(f"{s.name}[L{s.L}]")
            elif isinstance(s, StridedSwapSparsify):
                shared = " shared" if s.shared_pattern else ""
                parts.append(f"{s.name}[2:4{shared}]")
            elif isinstance(s, BackendEmit):
                tag = s.backend
                if s.fuse_rows:
                    tag += " fused"
                if s.temporal_steps != 1:
                    tag += f" k={s.temporal_steps}"
                parts.append(f"{s.name}[{tag}]")
            else:
                parts.append(s.name)
        return " -> ".join(parts)

    # -- structural validation ----------------------------------------------
    def validate(self) -> None:
        """Raise ValueError on any structural inconsistency between stages.

        This is the cheap, always-on check the engine runs at build time.
        """
        names = self.stage_names()
        order = [STAGE_ORDER.index(n) for n in names]
        if order != sorted(order) or len(set(order)) != len(order):
            raise ValueError(f"stage order {names} violates {STAGE_ORDER}")
        if names[0] != RowDecompose.name or names[-1] != BackendEmit.name:
            raise ValueError(
                f"plan must start with row-decompose and end with emit, "
                f"got {names}")
        dec, emit = self.decompose, self.emit
        if dec.mode not in DECOMPOSE_MODES:
            raise ValueError(f"unknown decompose mode {dec.mode!r}")
        if emit.backend not in BACKENDS:
            raise ValueError(f"unknown backend {emit.backend!r}")
        if emit.coefficient_mode not in COEFFICIENT_MODES:
            raise ValueError(
                f"unknown coefficient mode {emit.coefficient_mode!r}")
        if emit.temporal_steps < 1:
            raise ValueError(
                f"temporal_steps must be >= 1, got {emit.temporal_steps}")
        n_ops = len(dec.kernels)
        bad_ops = [op for op in dec.ops
                   if not 0 <= op.operand < n_ops]
        if bad_ops:
            raise ValueError(f"ops reference missing operands: {bad_ops}")
        if (emit.coefficient_mode == "var") != (dec.coefficients is not None):
            raise ValueError("coefficient slabs present iff mode is 'var'")
        if dec.coefficients is not None and \
                len(dec.coefficients) != n_ops:
            raise ValueError("one coefficient slab required per operand")
        kern = self.kernel
        if kern is not None:
            if len(kern.matrices) != n_ops:
                raise ValueError("one kernel matrix required per operand")
            for i, mat in enumerate(kern.matrices):
                if mat.shape != (kern.L, 2 * kern.L):
                    raise ValueError(
                        f"matrix {i} shape {mat.shape} != "
                        f"({kern.L}, {2 * kern.L})")
        sp = self.sparsify
        if sp is not None:
            if kern is None:
                raise ValueError("strided-swap requires kernel matrices")
            if len(sp.operands) != n_ops:
                raise ValueError("one sparse operand required per operand")
            metas = {op.meta.tobytes() for op in sp.operands}
            if sp.shared_pattern and len(metas) > 1:
                raise ValueError(
                    "shared_pattern set but operand metadata differs")
        gather = self.gather
        if gather is not None:
            if len(gather.slots) != n_ops or len(gather.taps) != n_ops:
                raise ValueError("one gather schedule required per operand")
            for i, (slots, taps) in enumerate(zip(gather.slots, gather.taps)):
                if slots.shape != taps.shape:
                    raise ValueError(
                        f"operand {i}: slots {slots.shape} != taps "
                        f"{taps.shape}")
                if slots.size and (slots.min() < 0
                                   or slots.max() >= 2 * self.L):
                    raise ValueError(
                        f"operand {i}: slot index escapes the 2L window")
        if emit.backend in MATRIX_BACKENDS and emit.backend != "cuda_direct":
            if kern is None or gather is None:
                raise ValueError(
                    f"backend {emit.backend} requires kernel-matrix and "
                    "gather-schedule stages")
        if emit.backend in SPARSE_BACKENDS and sp is None:
            raise ValueError(
                f"backend {emit.backend} requires the strided-swap stage")
        if emit.coefficient_mode == "var" and sp is not None \
                and not sp.shared_pattern:
            raise ValueError(
                "variable-coefficient plans must share one 2:4 pattern")
