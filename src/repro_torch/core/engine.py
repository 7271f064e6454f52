"""StencilEngine — a generic interpreter for :class:`~repro_torch.core.ir.LoweredPlan`.

``transform.lower_spec`` runs the ahead-of-time pipeline (row-decompose →
kernel-matrix → strided-swap 2:4 sparsify → gather schedule → backend emit)
and returns an explicit ``LoweredPlan``; this module executes that IR on
torch tensors.  Every table the plan holds (kernel matrices, compressed
operands, packed metadata words, window orders, slot/tap schedules, value
slabs) is turned into a device tensor of the engine's dtype ONCE, when the
engine is built; a call only launches work.

Backends (all mathematically equivalent; cross-checked in tests):
  direct       plain torch shifted multiply-add — the semantic oracle.
  gemm         dense kernel-matrix GEMM (generalized TCStencil, paper §3.2.1):
               banded (L, 2L) matrix times 2L-row input windows.
  sptc         simulated Sparse Tensor Core execution: strided-swap permuted
               + 2:4-compressed kernel, row swap folded into the gather
               (paper §3.2.2/§3.3).
  cuda_*       hand-written Hopper kernels (see repro_torch.kernels), same
               math; on a CPU tensor they run the kernels' plain versions.

Two workload classes ride on IR-level attributes:
  * variable coefficients (``coefficients=`` on the engine): per-output-point
    weight values applied through ONE shared 2:4 pattern (plain backends).
  * temporal blocking (``temporal_steps=k``): one call applies the stencil
    ``k`` times; the input carries a ``k·r`` halo that shrinks by ``r`` per
    step, and ``iterate`` advances ``k`` steps per loop iteration.

Input convention: ``x`` carries the halo — shape (N1+2kr, ..., Nd+2kr) for a
k-step engine — and the output is the (N1, ..., Nd) interior update.

Batches: every emission takes a leading batch axis, ``(B, *spatial)``, and
``__call__`` is the batch of one.  The constant-coefficient row-op paths
(``single``, ``star-axis``, ``rows``) fold the batch axis into the column
axis of each 1-D application, ``cuda_direct`` runs 1-D and 2-D batches on
its kernel's batch axis, and a 2-D ``rows`` plan on ``cuda_sptc`` runs the
whole batch through one ``sptc_spmm_rows2d`` launch: a super-batch costs as
many kernel launches as one job.  Fused rows, variable coefficients and
3-D ``cuda_direct`` loop over the jobs of a batch.

Copies on ``cuda_sptc``: a 2-D ``rows`` plan (a box, or a star without its
fast path) whose L and row ops the rows kernel holds
(:func:`takes_rows2d`: even L <= 16) reads the haloed batch where it lies,
with no copy, no zero fill and no add: one launch sums every row op on
chip (only an input whose last axis is not of unit stride, such as a
transposed view, is copied once first).  The per-RowOp loop runs
everything else, a 2-D ``rows`` plan with a larger L among them: each 1-D
application along the last axis copies its transposed slice to a unit
column stride, a ``star-axis`` application along the leading axis copies
only for a batch of more than one grid, and the R results are added into
a zero-filled accumulator.

Spans (``kernels/common.py::region``, on while a profiler is active):
``engine.iterate`` per ``iterate`` call, ``engine.apply`` per ``__call__``
and ``apply_batched`` around the emitted function, ``engine.pad`` per
re-pad in ``iterate``.  Inside ``engine.apply`` the per-RowOp loop's glue
has its own: ``engine.layout_copy`` around each copy made to give a
kernel a unit column stride (opened only when a copy is made, so a
contiguous grid opens none), and ``engine.accumulate`` around the zero
fill of the accumulator and each ``acc + y`` (1 + R a call of R row ops;
the ``single`` emission opens none).

Device rule: an engine runs on the card (``device=None`` means ``cuda``)
unless the caller passes ``device="cpu"``; without a card, ``device=None``
raises instead of silently running on the CPU.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.ir import BACKENDS, LoweredPlan, RowOp
from repro_torch.core.sparsify import decode_24, sparsify_stencil_kernel
from repro_torch.core.stencil import StencilSpec
from repro_torch.core.transform import default_l, kernel_matrix, lower_spec
from repro_torch.device import Device, resolve_device
from repro_torch.kernels.common import region
from repro_torch.kernels.sptc_spmm.ops import (FusedOperand, RowsOperand,
                                               fused_operand, rows2d_holds,
                                               rows_operand,
                                               sptc_spmm_fused,
                                               sptc_spmm_rows2d,
                                               sptc_spmm_windows)
from repro_torch.kernels.stencil_gemm.ops import windows_gemm

__all__ = ["BACKENDS", "StencilEngine", "apply_stencil", "apply_1d",
           "apply_sptc_v1", "kernel_launches", "resolve_device",
           "rows2d_operand", "takes_rows2d", "tile_windows"]

Tensor = torch.Tensor
ApplyFn = Callable[[Tensor], Tensor]
#: one 1-D application: (x2d, n_out) -> (n_out, C)
OpFn = Callable[[Tensor, int], Tensor]


def _rounded(w: float, dtype: torch.dtype) -> float:
    """``w`` rounded to ``dtype`` (the reference casts weights to x.dtype)."""
    return float(torch.tensor(w, dtype=torch.float64).to(dtype))


def _tensor(a: np.ndarray, dtype: torch.dtype,
            device: torch.device) -> Tensor:
    """A host table as a device tensor (the float64 tables cast to dtype)."""
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# 1-D application primitives (stencil axis leading, free axis trailing).
# Each reads device tables built by the engine's constructor.
# ---------------------------------------------------------------------------

def _pad_tiles(x2d: Tensor, n_out: int, L: int) -> Tuple[Tensor, int]:
    """Zero-pad (or trim) the row axis to exactly ``(ntiles + 1) * L`` rows,
    so ``ntiles`` full tile reads are in bounds."""
    ntiles = -(-n_out // L)
    need = (ntiles + 1) * L
    extra = need - x2d.shape[0]
    return (F.pad(x2d, (0, 0, 0, extra)) if extra > 0 else x2d[:need]), ntiles


def tile_windows(x2d: Tensor, n_out: int, L: int,
                 order: Optional[Tensor] = None) -> Tuple[Tensor, int]:
    """Overlapping (ntiles, 2L, C) windows of a (rows, C) input.

    Tile t covers outputs [tL, tL+L) and reads input rows [tL, tL+2L).
    Rows are zero-padded so every window is in-bounds; the pad rows only ever
    multiply structurally-zero kernel-matrix columns.  ``order`` reorders the
    rows within each window (the strided swap folded into the gather).
    """
    xp, ntiles = _pad_tiles(x2d, n_out, L)
    win = xp.unfold(0, 2 * L, L)                       # (ntiles, C, 2L) view
    if order is not None:
        win = win[:, :, order]
    return win.permute(0, 2, 1), ntiles


def _op_direct(taps: Sequence[Tuple[int, Union[float, Tensor]]], x2d: Tensor,
               n_out: int) -> Tensor:
    """Shifted multiply-adds in the input dtype; a tap's weight is a scalar
    (constant coefficients) or an (n_out, C) field (variable ones)."""
    acc = torch.zeros((n_out, x2d.shape[1]), dtype=x2d.dtype,
                      device=x2d.device)
    for k, wk in taps:
        acc = acc + wk * x2d[k:k + n_out]
    return acc


def _op_gemm(km: Tensor, x2d: Tensor, n_out: int, L: int) -> Tensor:
    win, ntiles = tile_windows(x2d, n_out, L)
    y = torch.einsum("lk,tkc->tlc", km.float(), win.float()).to(x2d.dtype)
    return y.reshape(ntiles * L, -1)[:n_out]


def _op_sptc(values: Tensor, comb: Tensor, x2d: Tensor, n_out: int,
             L: int) -> Tensor:
    """Compressed 2:4 SpMM with the row swap folded into load addressing.

    ``comb[m, j] = perm[4*seg(j) + meta[m, j]]`` — the plan's gather-schedule
    slots: the swap AND the metadata gather compose into ONE window gather.
    """
    xp, ntiles = _pad_tiles(x2d, n_out, L)
    xg = xp.unfold(0, 2 * L, L)[:, :, comb]            # (T, C, L, K/2)
    y = torch.einsum("mk,tcmk->tmc", values.float(), xg.float()
                     ).to(x2d.dtype)
    return y.reshape(ntiles * L, -1)[:n_out]


def _op_cuda_gemm(km: Tensor, x2d: Tensor, n_out: int, L: int) -> Tensor:
    win, ntiles = tile_windows(x2d, n_out, L)
    y = windows_gemm(km, win.contiguous())
    return y.reshape(ntiles * L, -1)[:n_out]


def _op_spmm_v1(values: Tensor, meta: Tensor, order: Tensor, x2d: Tensor,
                n_out: int, L: int) -> Tensor:
    """v1: the strided swap as a window gather outside the kernel, then the
    compressed SpMM over all tiles in one ``sptc_spmm_windows`` launch."""
    win, ntiles = tile_windows(x2d, n_out, L, order=order)
    y = sptc_spmm_windows(values, meta, win.contiguous())
    return y.reshape(ntiles * L, -1)[:n_out]


def _op_cuda_sptc(op: FusedOperand, x2d: Tensor, n_out: int) -> Tensor:
    """Fused: ONE kernel — window read, in-kernel swap + segment gather from
    the packed meta words, dot.  Nothing is windowed, permuted or gathered
    outside it; the kernel takes any row stride, so only a transposed view
    (unit row stride) is copied first: the per-RowOp loop's applications
    along the last axis of a 2-D or 3-D grid, and along the leading axis of
    a batch of several 2-D grids.  A 2-D ``rows`` plan the rows kernel holds
    never comes here (:func:`_emit_rows2d`)."""
    if x2d.shape[1] > 1 and x2d.stride(1) != 1:
        with region("engine.layout_copy"):
            x2d = x2d.contiguous()
    return sptc_spmm_fused(op, x2d, n_out=n_out)


# ---------------------------------------------------------------------------
# Variable-coefficient values: device tensors built once per engine from the
# plan's slot/tap schedule — shared 2:4 pattern.
# ---------------------------------------------------------------------------

def _values_tensor(w2d: np.ndarray, tap_tbl: np.ndarray, ntiles: int,
                   L: int, n_out: int) -> np.ndarray:
    """Per-slot value tensor (T, L, S, C) for one variable-coefficient op.

    ``w2d`` is the op's value slab rearranged output-major, shape
    ``(n_out, C, taps)``; ``tap_tbl`` the plan's (L, S) tap schedule.  Slot
    ``(t, l, s)`` of output row ``i = tL + l`` multiplies ``w2d[i, :,
    tap_tbl[l, s]]`` — zero where the slot is structurally dead (tap -1) or
    the row is tile padding.
    """
    gi = (np.arange(ntiles) * L)[:, None] + np.arange(L)[None, :]   # (T, L)
    valid = gi < n_out
    gi = np.minimum(gi, n_out - 1)
    tap_ok = tap_tbl >= 0
    tap_c = np.where(tap_ok, tap_tbl, 0)
    V = w2d[gi[:, :, None], :, tap_c[None, :, :]]                # (T, L, S, C)
    mask = (tap_ok[None, :, :] & valid[:, :, None])[..., None]
    return np.where(mask, V, np.zeros((), dtype=w2d.dtype))


def _op_var_gemm(V: Tensor, x2d: Tensor, n_out: int, L: int) -> Tensor:
    win, ntiles = tile_windows(x2d, n_out, L)
    y = torch.einsum("tlsc,tsc->tlc", V.float(), win.float()).to(x2d.dtype)
    return y.reshape(ntiles * L, -1)[:n_out]


def _op_var_sptc(V: Tensor, rows: Tensor, x2d: Tensor, n_out: int,
                 L: int) -> Tensor:
    xp, ntiles = _pad_tiles(x2d, n_out, L)
    xg = xp[rows]                                               # (T, L, S, C)
    y = torch.einsum("tmsc,tmsc->tmc", V.float(), xg.float()).to(x2d.dtype)
    return y.reshape(ntiles * L, -1)[:n_out]


# ---------------------------------------------------------------------------
# The stage interpreter: LoweredPlan -> function on tensors.
# ---------------------------------------------------------------------------

def _operand_fn(plan: LoweredPlan, i: int, device: torch.device,
                dtype: torch.dtype) -> OpFn:
    """Device tables of constant-coefficient operand ``i``, bound to its
    1-D application primitive."""
    backend, L = plan.emit.backend, plan.L
    tensor = functools.partial(_tensor, dtype=dtype, device=device)
    if backend == "direct":
        w = plan.decompose.kernels[i]
        taps = [(k, _rounded(w[k], dtype)) for k in range(w.shape[0])
                if w[k] != 0]
        return functools.partial(_op_direct, taps)
    if backend in ("gemm", "cuda_gemm"):
        kern = plan.kernel
        assert kern is not None
        op = _op_gemm if backend == "gemm" else _op_cuda_gemm
        return functools.partial(op, tensor(kern.matrices[i]), L=L)
    sp, gather = plan.sparsify, plan.gather
    assert sp is not None and gather is not None
    if backend == "sptc":
        return functools.partial(_op_sptc, tensor(sp.operands[i].values),
                                 tensor(gather.slots[i], dtype=torch.int64),
                                 L=L)
    if backend == "cuda_sptc":
        return functools.partial(_op_cuda_sptc,
                                 _fused_operand(plan, i, device, dtype))
    raise ValueError(f"unknown 1-D backend {backend}")


def _fused_operand(plan: LoweredPlan, i: int, device: torch.device,
                   dtype: torch.dtype) -> FusedOperand:
    """The fused kernels' tables of operand ``i`` of a cuda_sptc plan."""
    sp = plan.sparsify
    assert sp is not None
    # the banded values of a single/star-axis operand feed the plain
    # version's metadata-free path alone: on the card a star operand and a
    # box one run the same kernel from the same tables
    star = plan.decompose.mode in ("single", "star-axis")
    return fused_operand(sp.operands[i], sp.perm, plan.L,
                         star_fast="auto" if star else False, dtype=dtype,
                         device=device)


def _apply_op(fn: OpFn, x: Tensor, n_out: int, axis: int) -> Tensor:
    """Run one 1-D application along ``axis`` of ``x``; every other axis (a
    leading batch axis too) folds into the columns."""
    x = torch.movedim(x, axis, 0)
    rest = x.shape[1:]
    x2d = x.reshape(x.shape[0], -1)
    y = fn(x2d, n_out)
    return torch.movedim(y.reshape((n_out,) + rest), 0, axis)


def _op_slice(mode: str, op: RowOp, out_shape: Tuple[int, ...], r: int,
              d: int, lead: int = 0) -> Tuple[Tuple[slice, ...], int]:
    """(input slice, stencil axis) for one RowOp of a d-D application whose
    input carries ``lead`` leading batch axes; ``out_shape`` is spatial."""
    batch = (slice(None),) * lead
    if mode == "single":
        return batch + (slice(None),), lead
    if mode == "star-axis":
        sl = tuple(slice(None) if a == op.axis else slice(r, r + out_shape[a])
                   for a in range(d))
        return batch + sl, lead + op.axis
    sl = tuple(slice(u, u + out_shape[a])
               for a, u in enumerate(op.lead)) + (slice(None),)
    return batch + sl, lead + d - 1


def _accumulate(acc: Tensor, y: Tensor) -> Tensor:
    """The per-RowOp loop's ``acc + y`` in its span.  ``y`` is freed as the
    call returns, as it would be inline."""
    with region("engine.accumulate"):
        return acc + y


def _emit_const(plan: LoweredPlan, device: torch.device,
                dtype: torch.dtype,
                operand_fn: Callable[..., OpFn] = _operand_fn) -> ApplyFn:
    """Constant-coefficient single/star-axis/rows emission on ``(B,
    *spatial)`` — shape-generic; one 1-D application per RowOp for the
    whole batch (the per-RowOp loop; a plan :func:`takes_rows2d` takes
    never comes here from ``emit``).  ``operand_fn`` binds each operand's
    1-D application (the verifier passes a faulty one to build its
    controls)."""
    r, d = plan.spec.radius, plan.spec.ndim
    dec = plan.decompose
    mode = dec.mode
    op_fns = [operand_fn(plan, op.operand, device, dtype) for op in dec.ops]

    if mode == "single":
        f0 = op_fns[0]

        def fn1(xs: Tensor) -> Tensor:
            return _apply_op(f0, xs, xs.shape[1] - 2 * r, 1)
        return fn1

    def fn(xs: Tensor) -> Tensor:
        out_shape = tuple(s - 2 * r for s in xs.shape[1:])
        with region("engine.accumulate"):
            acc = torch.zeros((xs.shape[0],) + out_shape, dtype=xs.dtype,
                              device=xs.device)
        for op, f in zip(dec.ops, op_fns):
            sl, axis = _op_slice(mode, op, out_shape, r, d, lead=1)
            acc = _accumulate(acc, _apply_op(f, xs[sl], out_shape[axis - 1],
                                             axis))
        return acc
    return fn


def takes_rows2d(plan: LoweredPlan) -> bool:
    """Whether the plan's row ops run as ONE ``sptc_spmm_rows2d`` launch: a
    2-D ``rows`` plan on ``cuda_sptc`` whose L and row ops the rows kernel
    holds.  Every other plan keeps its emission."""
    return (plan.emit.backend == "cuda_sptc"
            and plan.decompose.mode == "rows" and plan.spec.ndim == 2
            and plan.emit.coefficient_mode == "const"
            and rows2d_holds(plan.L, [op.lead[0] for op in plan.decompose.ops],
                             2 * plan.spec.radius))


#: the wrapper each matrix backend launches once per RowOp
_ROW_OP_KERNELS = {"cuda_sptc": "sptc_spmm_fused", "cuda_gemm": "windows_gemm"}


def kernel_launches(plan: LoweredPlan) -> Dict[str, int]:
    """The kernel wrappers one call of a one-step, constant-coefficient
    1-D or 2-D engine on ``plan`` launches, by name (each wrapper's
    ``__name__`` and region), whatever its batch: ``sptc_spmm_rows2d``
    once for a plan :func:`takes_rows2d` takes, ``stencil2d`` once on
    ``cuda_direct``, a matrix kernel once per RowOp; none on a plain
    backend."""
    backend = plan.emit.backend
    if takes_rows2d(plan):
        return {"sptc_spmm_rows2d": 1}
    if backend == "cuda_direct":
        return {"stencil2d": 1}
    if backend in _ROW_OP_KERNELS:
        return {_ROW_OP_KERNELS[backend]: len(plan.decompose.ops)}
    return {}


def rows2d_operand(plan: LoweredPlan, device: torch.device,
                   dtype: torch.dtype) -> RowsOperand:
    """The rows kernel's tables of a plan :func:`takes_rows2d` takes: its
    row ops' fused tables, stacked, with each op's row offset."""
    ops = plan.decompose.ops
    return rows_operand([_fused_operand(plan, op.operand, device, dtype)
                         for op in ops], [op.lead[0] for op in ops],
                        2 * plan.spec.radius)


def _emit_rows2d(plan: LoweredPlan, device: torch.device,
                 dtype: torch.dtype) -> ApplyFn:
    """Every row op of a 2-D ``rows`` plan in one launch on ``(B, H + 2r,
    W + 2r)``: the batch is read where it lies and the ``(B, H, W)``
    interior written once, the R row ops summed on chip
    (``kernels/csrc/sptc_rows2d.cu``)."""
    rop = rows2d_operand(plan, device, dtype)

    def fn(xs: Tensor) -> Tensor:
        # the kernel takes any batch and row stride, not a column stride
        if xs.shape[2] > 1 and xs.stride(2) != 1:
            with region("engine.layout_copy"):
                xs = xs.contiguous()
        return sptc_spmm_rows2d(rop, xs)
    return fn


def _per_job(fn: ApplyFn) -> ApplyFn:
    """A one-grid function applied job by job over ``(B, *spatial)``."""
    def fb(xs: Tensor) -> Tensor:
        if xs.shape[0] == 1:
            return fn(xs[0])[None]
        return torch.stack([fn(x) for x in xs])
    return fb


def _emit_fused_2d(plan: LoweredPlan, device: torch.device,
                   dtype: torch.dtype) -> ApplyFn:
    """§Perf D emission: ONE window gather + ONE stacked GEMM for all
    2r+1 kernel rows of a 2-D stencil (vs 2r+1 of each).

    Every row kernel sees the same last-axis window structure; only the
    leading-axis slice differs.  So gather windows of the FULL input once,
    multiply by the (R·L, 2L) concatenation of the plan's per-row operands
    (R = #rows), then accumulate each row's result from a shifted column
    slice.  On the sptc path the stacked matrix is the dense decode of the
    2:4-compressed operands and the strided swap rides the window gather's
    load order (§3.3).
    """
    r, L = plan.spec.radius, plan.L
    dec, sp = plan.decompose, plan.sparsify
    R = len(dec.ops)
    order: Optional[Tensor] = None
    if sp is not None:
        mats = [decode_24(opnd) for opnd in sp.operands]
        order = torch.as_tensor(sp.perm, dtype=torch.int64, device=device)
    else:
        kern = plan.kernel
        assert kern is not None
        mats = [np.asarray(m) for m in kern.matrices]
    k_all = _tensor(np.concatenate(mats, axis=0), dtype, device)  # (R*L, 2L)
    leads = [int(op.lead[0]) for op in dec.ops]

    def fn(x: Tensor) -> Tensor:
        h_in = x.shape[0]
        h_out = h_in - 2 * r
        w_out = x.shape[1] - 2 * r
        # zero-cost row swap: perm folds into the window gather (§3.3)
        win, ntiles = tile_windows(x.T, w_out, L, order=order)  # (T,2L,H+2r)
        y = torch.einsum("lk,tkc->tlc", k_all.float(), win.float()
                         ).to(x.dtype)                       # (T, R*L, H+2r)
        yr = y.reshape(ntiles, R, L, h_in).permute(1, 0, 2, 3
                                                   ).reshape(R, ntiles * L, h_in)
        acc = torch.zeros((w_out, h_out), dtype=x.dtype, device=x.device)
        for i, u in enumerate(leads):
            acc = acc + yr[i, :w_out, u:u + h_out]
        return acc.T
    return fn


def _var_slab_2d(slab: np.ndarray, axis: int) -> np.ndarray:
    """Rearrange a value slab output-major: (n_out, C, taps) matching the
    (stencil-axis leading, free axis trailing) layout of ``_apply_op``."""
    w = np.moveaxis(slab, axis, 0)
    return np.ascontiguousarray(w.reshape(w.shape[0], -1, slab.shape[-1]))


def _emit_var(plan: LoweredPlan, device: torch.device,
              dtype: torch.dtype) -> ApplyFn:
    """Variable-coefficient emission — fixed-shape by construction.

    The coefficient field pins the output shape, so every table (including
    the per-slot value tensors) is built once here; the shared 2:4 pattern
    means ONE slot/tap schedule serves every operand.
    """
    r, d = plan.spec.radius, plan.spec.ndim
    dec, gather = plan.decompose, plan.gather
    mode, L = dec.mode, plan.L
    assert dec.coefficients is not None
    out_shape = dec.coefficients[0].shape[:-1]
    in_shape = tuple(s + 2 * r for s in out_shape)
    backend = plan.emit.backend
    tensor = functools.partial(_tensor, dtype=dtype, device=device)
    per_op: List[Tuple[Tuple[slice, ...], int, OpFn]] = []
    for op in dec.ops:
        sl, axis = _op_slice(mode, op, out_shape, r, d)
        w2d = _var_slab_2d(dec.coefficients[op.operand], axis)
        n_out = out_shape[axis]
        ntiles = -(-n_out // L)
        f: OpFn
        if backend == "direct":
            taps = [(k, tensor(w2d[:, :, k])) for k in range(w2d.shape[-1])
                    if np.any(w2d[:, :, k])]
            f = functools.partial(_op_direct, taps)
        elif backend == "gemm":
            assert gather is not None
            V = _values_tensor(w2d, gather.taps[op.operand], ntiles, L, n_out)
            f = functools.partial(_op_var_gemm, tensor(V), L=L)
        elif backend == "sptc":
            assert gather is not None
            V = _values_tensor(w2d, gather.taps[op.operand], ntiles, L, n_out)
            rows = ((np.arange(ntiles) * L)[:, None, None]
                    + gather.slots[op.operand][None, :, :])
            f = functools.partial(_op_var_sptc, tensor(V),
                                  tensor(rows, dtype=torch.int64), L=L)
        else:
            raise ValueError(
                f"variable coefficients unsupported on {backend}")
        per_op.append((sl, axis, f))

    def fn(x: Tensor) -> Tensor:
        if tuple(x.shape) != in_shape:
            raise ValueError(
                f"variable-coefficient engine is fixed-shape: expected "
                f"input {in_shape} (= out {out_shape} + 2r halo), got "
                f"{tuple(x.shape)}")
        acc = torch.zeros(out_shape, dtype=x.dtype, device=x.device)
        for sl, axis, f in per_op:
            acc = acc + _apply_op(f, x[sl], out_shape[axis], axis)
        return acc
    return fn


def _emit_step(plan: LoweredPlan, device: torch.device,
               dtype: torch.dtype) -> ApplyFn:
    """One stencil application on ``(B, *spatial)`` from the plan's tables
    (temporal_steps ignored)."""
    if plan.emit.backend == "cuda_direct":
        from repro_torch.kernels import dispatch as kdispatch
        fn: ApplyFn = kdispatch.build(plan.spec, plan.emit.backend, plan.L,
                                      device)
        return fn
    if plan.emit.coefficient_mode == "var":
        return _per_job(_emit_var(plan, device, dtype))
    if plan.decompose.mode == "fused-rows":
        return _per_job(_emit_fused_2d(plan, device, dtype))
    if takes_rows2d(plan):
        return _emit_rows2d(plan, device, dtype)
    return _emit_const(plan, device, dtype)


def emit(plan: LoweredPlan, device: Device = None,
         dtype: torch.dtype = torch.float32) -> ApplyFn:
    """LoweredPlan -> function on batches ``(B, *spatial)`` of ``dtype`` on
    ``device``.

    ``device=None`` is the card (raises without one).  All device tables
    are built here, once.  A temporal-blocked plan runs ``k`` applications
    per call: the halo shrinks by ``r`` per step, so a ``k·r``-halo input
    yields the interior update after ``k`` steps.
    """
    plan.validate()
    step = _emit_step(plan, resolve_device(device), dtype)
    k = plan.emit.temporal_steps
    if k == 1:
        return step

    def fn(x: Tensor) -> Tensor:
        for _ in range(k):
            x = step(x)
        return x
    return fn


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

class StencilEngine:
    """Applicator for one StencilSpec — lowers, then interprets.

    ``device=None`` runs on the current CUDA device and raises when there is
    none; pass ``device="cpu"`` for the CPU.  Every table is built on the
    engine's device in ``dtype`` here, so inputs must match both.
    """

    def __init__(self, spec: StencilSpec, backend: str = "direct",
                 L: Optional[int] = None, star_fast_path: bool = True,
                 fuse_rows: bool = False, temporal_steps: int = 1,
                 coefficients: Optional[np.ndarray] = None, *,
                 device: Device = None,
                 dtype: torch.dtype = torch.float32) -> None:
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}")
        self.device = resolve_device(device)
        self.dtype = dtype
        self.plan_ir: LoweredPlan = lower_spec(
            spec, backend=backend, L=L, star_fast_path=star_fast_path,
            fuse_rows=fuse_rows, temporal_steps=temporal_steps,
            coefficients=coefficients)
        self.spec = spec
        self.backend = backend
        self.L = self.plan_ir.L
        self.star_fast_path = star_fast_path and spec.shape == "star"
        # §Perf D: one window-gather + one stacked GEMM for all kernel rows
        self.fuse_rows = fuse_rows
        self.temporal_steps = temporal_steps
        self._fn = emit(self.plan_ir, self.device, dtype)

    # -- public API ----------------------------------------------------------
    def _check(self, x: Tensor, ndim: int, what: str) -> None:
        if x.device != self.device or x.dtype != self.dtype:
            raise ValueError(
                f"engine built for {self.dtype} on {self.device}, got "
                f"{x.dtype} on {x.device}")
        if x.dim() != ndim:
            raise ValueError(f"{self.spec.name} needs a {what} input, got "
                             f"shape {tuple(x.shape)}")

    def __call__(self, x: Tensor) -> Tensor:
        self._check(x, self.spec.ndim, f"{self.spec.ndim}-D")
        with region("engine.apply"):
            return self._fn(x[None])[0]

    def apply_batched(self, xs: Tensor) -> Tensor:
        """``(B, *spatial-with-halo)`` -> ``(B, *interior)``: every job in one
        pass, with as many kernel launches as one job on the row-op paths
        and 1-D/2-D ``cuda_direct`` (see the module docstring)."""
        self._check(xs, self.spec.ndim + 1,
                     f"(B, *spatial) {self.spec.ndim + 1}-D")
        with region("engine.apply"):
            return self._fn(xs)

    def iterate(self, x: Tensor, steps: int) -> Tensor:
        """Iterative (Jacobi-style) application with zero-halo re-padding.

        A temporal-blocked engine advances ``k`` steps per loop iteration
        (``x`` then carries the ``k·r`` halo); ``steps`` must be a multiple
        of ``k``.
        """
        k = self.temporal_steps
        if steps % k != 0:
            raise ValueError(
                f"steps={steps} must be a multiple of temporal_steps={k}")
        pad = (k * self.spec.radius,) * (2 * self.spec.ndim)
        with region("engine.iterate"):
            for _ in range(steps // k):
                x = _repad(self(x), pad)
        return x


def _repad(y: Tensor, pad: Tuple[int, ...]) -> Tensor:
    """``iterate``'s re-pad in its span.  ``y`` is freed as the call
    returns, as it would be inline: holding it into the next step keeps one
    more grid alive."""
    with region("engine.pad"):
        return F.pad(y, pad)


def apply_stencil(spec: StencilSpec, x: Tensor, backend: str = "direct",
                  L: Optional[int] = None, temporal_steps: int = 1,
                  coefficients: Optional[np.ndarray] = None) -> Tensor:
    """One-shot functional entry point on ``x``'s device and dtype,
    engine-cached by stencil content.

    Repeated calls with the same (spec, backend, L, temporal_steps,
    coefficients) on one device and dtype reuse one :class:`StencilEngine`
    (tables included) from the process-wide ``repro_torch.tuner`` cache.
    For measured backend/L selection use :func:`repro_torch.tuner.tuned_apply`.
    """
    from repro_torch.tuner.cache import default_cache
    from repro_torch.tuner.plan import Plan
    plan = Plan.default(spec, backend, L, temporal_steps=temporal_steps)
    return default_cache().engine(spec, plan, coefficients=coefficients,
                                  device=x.device, dtype=x.dtype)(x)


def apply_sptc_v1(spec: StencilSpec, x: Tensor,
                  L: Optional[int] = None) -> Tensor:
    """One application of ``spec`` through the v1 compressed SpMM entry.

    The sptc plan's row ops run on ``x``'s device and dtype, each as
    strided-swapped windows of its input slice times its 2:4-compressed
    operand (:func:`~repro_torch.kernels.sptc_spmm.ops.sptc_spmm_windows`),
    summed.  Builds its tables on every call; constant coefficients, one
    step.
    """
    plan = lower_spec(spec, backend="sptc", L=L)
    r, d, L = spec.radius, spec.ndim, plan.L
    sp = plan.sparsify
    assert sp is not None
    dev = x.device
    order = torch.as_tensor(sp.perm, dtype=torch.int64, device=dev)
    fns = [functools.partial(_op_spmm_v1, _tensor(o.values, x.dtype, dev),
                             torch.as_tensor(o.meta, device=dev), order, L=L)
           for o in sp.operands]
    out_shape = tuple(s - 2 * r for s in x.shape)
    acc = torch.zeros(out_shape, dtype=x.dtype, device=dev)
    for op in plan.decompose.ops:
        sl, axis = _op_slice(plan.decompose.mode, op, out_shape, r, d)
        acc = acc + _apply_op(fns[op.operand], x[sl], out_shape[axis], axis)
    return acc


# ---------------------------------------------------------------------------
# Standalone 1-D utility (kept for callers outside the plan pipeline)
# ---------------------------------------------------------------------------

def apply_1d(w: np.ndarray, x: Tensor, n_out: int, axis: int,
             backend: str, L: Optional[int] = None) -> Tensor:
    """Apply a 1-D stencil kernel along ``axis`` of ``x`` (halo included).

    Builds its tables on ``x``'s device in ``x.dtype`` on every call.
    """
    w = np.asarray(w)
    r = (w.shape[0] - 1) // 2
    if L is None:
        L = default_l(r)
    dev, dt = x.device, x.dtype
    tensor = functools.partial(_tensor, dtype=dt, device=dev)
    f: OpFn
    if backend == "direct":
        f = functools.partial(_op_direct, [(k, _rounded(w[k], dt))
                                           for k in range(w.shape[0])
                                           if w[k] != 0])
    elif backend in ("gemm", "cuda_gemm"):
        op = _op_gemm if backend == "gemm" else _op_cuda_gemm
        f = functools.partial(op, tensor(kernel_matrix(w, L=L, pad_width=True)),
                              L=L)
    elif backend == "sptc":
        sk = sparsify_stencil_kernel(w, L=L)
        comb = np.asarray(sk.perm)[sk.sparse.gather_indices()]
        f = functools.partial(_op_sptc, tensor(sk.values),
                              tensor(comb, dtype=torch.int64), L=L)
    elif backend == "cuda_sptc":
        sk = sparsify_stencil_kernel(w, L=L)
        f = functools.partial(_op_cuda_sptc, fused_operand(
            sk.sparse, sk.perm, L, star_fast="auto", dtype=dt, device=dev))
    else:
        raise ValueError(f"unknown 1-D backend {backend}")
    return _apply_op(f, x, n_out, axis)
