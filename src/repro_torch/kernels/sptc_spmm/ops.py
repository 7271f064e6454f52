"""Public wrappers of the SpTC kernels and the tables they read.

:func:`fused_operand` turns a compressed operand into device tables once
(the engine calls it in its constructor); :func:`sptc_spmm_fused` applies
them along the rows of a 2-D input.  :func:`rows_operand` stacks the
operands of a 2-D "rows" decomposition, and :func:`sptc_spmm_rows2d`
applies all of them to a batch of haloed grids in one launch;
:func:`star_operand` and :func:`sptc_spmm_star2d` do the same for the two
axis operands of a 2-D "star-axis" decomposition.
:func:`sptc_spmm` / :func:`sptc_spmm_windows` are the v1 compressed SpMM
over a pre-swapped RHS.  On a CUDA tensor a wrapper launches its
kernel or raises; it takes the plain torch version only for a tensor that
lies on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import (TYPE_CHECKING, Callable, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch.device import Device, resolve_device
from repro_torch.kernels.build import DTYPE_CODES, SMEM_LIMIT
from repro_torch.kernels.common import check_out, region
from repro_torch.kernels.sptc_spmm import fragments as fr
from repro_torch.kernels.sptc_spmm.kernel import (sptc_fused_launch,
                                                  sptc_rows2d_launch,
                                                  sptc_spmm_launch,
                                                  sptc_star2d_launch)
from repro_torch.kernels.sptc_spmm.ref import (sptc_fused_ref,
                                               sptc_rows2d_ref,
                                               sptc_spmm_windows_ref,
                                               sptc_star2d_ref)

if TYPE_CHECKING:
    from repro_torch.core.sparsify import Sparse24


@dataclasses.dataclass(frozen=True)
class FusedOperand:
    """Device tables of one compressed operand (L = K/2 = ``values.shape[0]``).

    ``values``     (L, K/2) in the input dtype — the banded layout of
                   ``contiguous_band_values`` when ``star_fast``; the plain
                   version reads it and ``meta_words``.
    ``meta_words`` (L, ceil(K/32)) int32 view of the packed uint32
                   ``Sparse24.meta_bits()`` words.
    ``tf32``       the kernel's per-lane ``mma.sp`` tables for float32
                   storage (pair-aligned 1:2 operand, 3xTF32); None for a
                   bfloat16 operand.
    ``bf16``       its tables for bfloat16 storage or compute (2:4 operand).
    """

    values: torch.Tensor
    meta_words: torch.Tensor
    star_fast: bool
    tf32: Optional[fr.Fragments]
    bf16: fr.Fragments


def fused_operand(operand: "Sparse24", perm, L: int, *,
                  star_fast: Union[bool, str] = "auto",
                  dtype: torch.dtype = torch.float32,
                  device: Device = None) -> FusedOperand:
    """Build the kernel's tables for ``operand`` on ``device`` (``None``:
    the card, raising without one).

    ``star_fast``: ``"auto"`` uses the metadata-free banded path whenever
    the swap∘meta gather is the identity band of the taps; ``True``
    requires it (ValueError otherwise); ``False`` always decodes the
    metadata.
    """
    # imported here: repro_torch.core's package imports the engine, which
    # imports this module
    from repro_torch.core.sparsify import (contiguous_band_values,
                                           strided_swap_perm)
    if not np.array_equal(np.asarray(perm), strided_swap_perm(L)):
        raise ValueError(
            "sptc_spmm_fused requires the strided-swap permutation — the "
            "kernel derives it in closed form (§3.3)")
    fast = (contiguous_band_values(operand, np.asarray(perm))
            if star_fast in ("auto", True) else None)
    if star_fast is True and fast is None:
        raise ValueError("operand's 2:4 pattern is not the identity band "
                         "of the taps; star fast path unavailable")
    vals = fast if fast is not None else operand.values
    words = np.ascontiguousarray(operand.meta_bits()).view(np.int32)
    device = resolve_device(device)
    # the kernel's tables, from the compressed (not banded) layout: the
    # same swapped matrix, so star and box operands take one kernel
    comp = torch.as_tensor(np.asarray(operand.values), dtype=dtype)
    a16, e16 = fr.bf16_tables(comp, operand.meta)
    tf32 = None
    if dtype == torch.float32:
        a32, e32 = fr.tf32_tables(fr.swapped_dense(operand))
        tf32 = fr.Fragments(a=torch.as_tensor(a32, device=device),
                            e=torch.as_tensor(e32, device=device),
                            k_step=fr.TF32_K)
    return FusedOperand(
        values=torch.as_tensor(np.asarray(vals), dtype=dtype, device=device),
        meta_words=torch.as_tensor(words, device=device),
        star_fast=fast is not None, tf32=tf32,
        bf16=fr.Fragments(a=torch.as_tensor(a16, device=device),
                          e=torch.as_tensor(e16, device=device),
                          k_step=fr.BF16_K))


def _check(op: FusedOperand, x2d: torch.Tensor, n_out: int,
           compute_dtype: Optional[torch.dtype]) -> None:
    if x2d.dim() != 2:
        raise ValueError(f"x2d must be (rows, C), got shape {tuple(x2d.shape)}")
    if x2d.dtype not in DTYPE_CODES:
        raise TypeError(f"x2d dtype {x2d.dtype} not in {tuple(DTYPE_CODES)}")
    if op.values.dtype != x2d.dtype:
        raise TypeError(f"values dtype {op.values.dtype} != x2d dtype "
                        f"{x2d.dtype}; build the operand in the input dtype")
    if op.values.device != x2d.device or op.meta_words.device != x2d.device:
        raise ValueError("operand tables and x2d lie on different devices")
    if x2d.shape[1] > 1 and x2d.stride(1) != 1:
        raise ValueError("x2d needs a unit column stride")
    L, kh = op.values.shape
    if L != kh or op.meta_words.shape != (L, -(-kh // 16)) \
            or op.meta_words.dtype != torch.int32:
        raise ValueError("operand tables do not match L / K/2")
    if L > fr.MAX_L:
        raise ValueError(f"L={L} exceeds {fr.MAX_L}: the kernel keeps the "
                         "operand's fragments in registers")
    if n_out < 0:
        raise ValueError(f"n_out must be >= 0, got {n_out}")
    if compute_dtype not in (None, torch.bfloat16):
        raise ValueError(f"compute_dtype must be None or bfloat16, got "
                         f"{compute_dtype}")


def sptc_spmm_fused(op: FusedOperand, x2d: torch.Tensor, *, n_out: int,
                    compute_dtype: Optional[torch.dtype] = None,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One fused application: window read → swap + gather → dot.

    ``x2d`` is the raw (>= n_out + 2r, C) haloed input — not windowed, not
    swapped, any row stride.  Returns the (n_out, C) stencil output in
    ``x2d.dtype``, accumulated in float32; ``compute_dtype=torch.bfloat16``
    rounds the window and the values to bf16 first.  ``out``, where given,
    is written and returned instead: a contiguous (n_out, C) tensor that
    shares no byte with ``x2d``, such as the interior of the next step's
    haloed line viewed as (n_out, 1).
    """
    _check(op, x2d, n_out, compute_dtype)
    if out is not None:
        check_out(out, (n_out, x2d.shape[1]), x2d)
        if not out.is_contiguous():
            raise ValueError("out must be contiguous: the kernel writes "
                             "whole (n_out, C) rows")
        if x2d.shape[1] % 2 == 0 and out.data_ptr() % (2 * out.element_size()):
            raise ValueError("out of an even C must start on an even "
                             "element: the kernel stores column pairs")
    L = op.values.shape[0]
    if x2d.device.type == "cpu":
        with region("sptc_spmm_fused"):
            y = sptc_fused_ref(op.values, op.meta_words, x2d, n_out=n_out,
                               L=L, star_fast=op.star_fast,
                               compute_dtype=compute_dtype)
            return y if out is None else out.copy_(y)
    if x2d.device.type != "cuda":
        raise ValueError(f"no kernel for device {x2d.device}")
    y = (torch.empty((n_out, x2d.shape[1]), dtype=x2d.dtype,
                     device=x2d.device) if out is None else out)
    if y.numel() == 0:
        return y
    # a float32 operand (checked above: the input's dtype) has both routes
    tf32 = x2d.dtype == torch.float32 and compute_dtype is None
    with region("sptc_spmm_fused"):
        sptc_fused_launch(x2d, y, op.tf32 if tf32 else op.bf16, n_out=n_out,
                          L=L, tf32=tf32)
    sptc_spmm_fused.launches += 1
    return y


sptc_spmm_fused.launches = 0    # type: ignore[attr-defined]


# ---------------------------------------------------------------------------
# every row op of a 2-D "rows" decomposition in one launch
# ---------------------------------------------------------------------------

#: the rows kernel's limits: one 16-row M block per operand, and row
#: offsets of 4 bits
ROWS2D_MAX_L = 16
ROWS2D_MAX_OPS = 16
ROWS2D_MAX_HALO = 15


@dataclasses.dataclass(frozen=True)
class RowsOperand:
    """Device tables of the R row ops of a 2-D "rows" decomposition.

    ``ops``    each op's :class:`FusedOperand` (the plain version reads
               their ``values`` and ``meta_words``);
    ``leads``  op u reads the input rows shifted by ``leads[u]``;
    ``halo``   2r: the input carries ``halo`` more rows and columns than
               the output;
    ``tf32``, ``bf16``  the ops' tables of each route stacked on the
               leading axis, (R, KS, 2, 32) and (R, KS, 32).
    """

    ops: Tuple[FusedOperand, ...]
    leads: Tuple[int, ...]
    halo: int
    tf32: Optional[fr.Fragments]
    bf16: fr.Fragments

    @property
    def L(self) -> int:
        return self.ops[0].values.shape[0]


def rows2d_holds(L: int, leads: Sequence[int], halo: int) -> bool:
    """Whether :func:`sptc_spmm_rows2d` takes R = ``len(leads)`` row ops of
    width ``L`` over a ``halo``-row halo."""
    return (2 <= L <= ROWS2D_MAX_L and L % 2 == 0
            and 1 <= len(leads) <= ROWS2D_MAX_OPS
            and 0 <= halo <= ROWS2D_MAX_HALO
            and all(0 <= u <= halo for u in leads))


def rows_operand(ops: Sequence[FusedOperand], leads: Sequence[int],
                 halo: int) -> RowsOperand:
    """Stack the row ops' tables for :func:`sptc_spmm_rows2d` (on their
    device, once)."""
    ops, leads = tuple(ops), tuple(int(u) for u in leads)
    if len(ops) != len(leads):
        raise ValueError(f"{len(ops)} operands for {len(leads)} leads")
    L = ops[0].values.shape[0] if ops else 0
    if not rows2d_holds(L, leads, halo):
        raise ValueError(f"sptc_spmm_rows2d takes even L <= {ROWS2D_MAX_L}, "
                         f"1-{ROWS2D_MAX_OPS} row ops and leads within a "
                         f"halo <= {ROWS2D_MAX_HALO}; got L={L}, "
                         f"leads={leads}, halo={halo}")
    tf32, bf16 = _stacked(ops)
    return RowsOperand(ops=ops, leads=leads, halo=int(halo), tf32=tf32,
                       bf16=bf16)


def _stacked(ops: Sequence[FusedOperand]
             ) -> Tuple[Optional[fr.Fragments], fr.Fragments]:
    """The ops' tables of each route stacked on the leading axis (the
    TF32 ones where every op has them)."""
    first = ops[0].values
    if any(o.values.shape[0] != first.shape[0]
           or o.values.dtype != first.dtype
           or o.values.device != first.device for o in ops):
        raise ValueError("operands differ in L, dtype or device")

    def stack(frags: Sequence[fr.Fragments]) -> fr.Fragments:
        return fr.Fragments(a=torch.cat([f.a for f in frags]),
                            e=torch.cat([f.e for f in frags]),
                            k_step=frags[0].k_step)

    tf32 = (stack([o.tf32 for o in ops])  # type: ignore[misc]
            if all(o.tf32 is not None for o in ops) else None)
    return tf32, stack([o.bf16 for o in ops])


def _check_grids(op: FusedOperand, xs: torch.Tensor,
                 halo: int) -> Tuple[int, int, int]:
    """Check a (B, H + halo, W + halo) batch of grids against an operand's
    tables; returns (B, H, W)."""
    if xs.dim() != 3:
        raise ValueError(f"xs must be (B, H + halo, W + halo), got shape "
                         f"{tuple(xs.shape)}")
    if xs.dtype not in DTYPE_CODES:
        raise TypeError(f"xs dtype {xs.dtype} not in {tuple(DTYPE_CODES)}")
    if op.values.dtype != xs.dtype:
        raise TypeError(f"operand dtype {op.values.dtype} != xs dtype "
                        f"{xs.dtype}; build the operands in the input dtype")
    if op.values.device != xs.device:
        raise ValueError("operand tables and xs lie on different devices")
    if xs.shape[2] > 1 and xs.stride(2) != 1:
        raise ValueError("xs needs a unit column stride")
    if xs.shape[1] < halo or xs.shape[2] < halo:
        raise ValueError(f"xs of shape {tuple(xs.shape)} is smaller than "
                         f"its halo of {halo}")
    if xs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {xs.device}")
    return xs.shape[0], xs.shape[1] - halo, xs.shape[2] - halo


def _one_launch(wrapper, gop: Union[RowsOperand, StarOperand],
                xs: torch.Tensor, halo: int,
                plain: Callable[[list], torch.Tensor],
                launch: Callable[[torch.Tensor, fr.Fragments, bool], None],
                out: Optional[torch.Tensor]) -> torch.Tensor:
    """The steps the one-launch 2-D wrappers share: check ``xs`` against
    ``gop``'s tables and a ``halo``-wide halo, and ``out`` against the (B,
    H, W) result; on the CPU ``plain`` on the ops' (values, meta words,
    star_fast) in the wrapper's region, written into ``out`` where given;
    on the card ``out`` or a contiguous (B, H, W) output, and ``launch(y,
    frags, tf32)`` with the route's stacked tables in the region, counted
    on ``wrapper.launches`` and, where the wrapper keeps ``row_ops``, the
    ops it sums on that."""
    b, h, w = _check_grids(gop.ops[0], xs, halo)
    if out is not None:
        check_out(out, (b, h, w), xs)
    name = wrapper.__name__
    if xs.device.type == "cpu":
        with region(name):
            y = plain([(o.values, o.meta_words, o.star_fast)
                       for o in gop.ops])
            return y if out is None else out.copy_(y)
    y = (torch.empty((b, h, w), dtype=xs.dtype, device=xs.device)
         if out is None else out)
    if y.numel() == 0:
        return y
    tf32 = xs.dtype == torch.float32
    with region(name):
        launch(y, gop.tf32 if tf32 else gop.bf16,  # type: ignore[arg-type]
               tf32)
    wrapper.launches += 1
    if hasattr(wrapper, "row_ops"):
        wrapper.row_ops += len(gop.ops)
    return y


def sptc_spmm_rows2d(rop: RowsOperand, xs: torch.Tensor, *,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every row op at once: ``y[b, i, j] = sum_u op_u(xs[b, i + leads[u],
    :])[j]``.

    ``xs`` is the raw (B, H + halo, W + halo) batch of haloed grids, any
    batch and row stride, unit column stride: read where it lies.  Returns
    the contiguous (B, H, W) interior in ``xs.dtype``, the R applications
    summed in float32, in order, and rounded once: in float32 the sums of
    :func:`sptc_spmm_fused` per op added as the per-RowOp loop adds them.
    ``out``, where given, is written and returned instead: any (B, H, W)
    view with a unit column stride that shares no byte with ``xs``, such
    as the interior of the next step's haloed grid.
    """
    return _one_launch(
        sptc_spmm_rows2d, rop, xs, rop.halo,
        lambda tables: sptc_rows2d_ref(tables, rop.leads, xs,
                                       halo=rop.halo, L=rop.L),
        lambda y, frags, tf32: sptc_rows2d_launch(
            xs, y, frags, halo=rop.halo, L=rop.L,
            lead_bits=sum(u << (4 * i) for i, u in enumerate(rop.leads)),
            tf32=tf32), out)


sptc_spmm_rows2d.launches = 0    # type: ignore[attr-defined]
#: the row ops those launches summed, R = ``len(rop.leads)`` a launch
sptc_spmm_rows2d.row_ops = 0     # type: ignore[attr-defined]


# ---------------------------------------------------------------------------
# both axis ops of a 2-D "star-axis" decomposition in one launch
# ---------------------------------------------------------------------------

#: the star kernel's widest operand: one 16-row M block
STAR2D_MAX_L = 16


@dataclasses.dataclass(frozen=True)
class StarOperand:
    """Device tables of the two axis ops of a 2-D "star-axis"
    decomposition.

    ``ops``    (the leading axis's op, the last axis's op), each a
               :class:`FusedOperand` (the plain version reads their
               ``values`` and ``meta_words``);
    ``radius`` r: the input carries 2r more rows and columns than the
               output;
    ``tf32``, ``bf16``  the two ops' tables of each route stacked on the
               leading axis, (2, KS, 2, 32) and (2, KS, 32).
    """

    ops: Tuple[FusedOperand, FusedOperand]
    radius: int
    tf32: Optional[fr.Fragments]
    bf16: fr.Fragments

    @property
    def L(self) -> int:
        return self.ops[0].values.shape[0]


def star2d_holds(L: int, radius: int) -> bool:
    """Whether :func:`sptc_spmm_star2d` takes a radius-``radius`` star's
    operands of width ``L``: even L from 2r + 2 to 16."""
    return radius >= 1 and L % 2 == 0 and 2 * radius + 2 <= L <= STAR2D_MAX_L


def star_operand(ops: Sequence[FusedOperand], radius: int) -> StarOperand:
    """Stack the two axis ops' tables, the leading axis's first, for
    :func:`sptc_spmm_star2d` (on their device, once)."""
    ops = tuple(ops)
    if len(ops) != 2:
        raise ValueError(f"a 2-D star has two axis ops, got {len(ops)}")
    L = ops[0].values.shape[0]
    if not star2d_holds(L, radius):
        raise ValueError(f"sptc_spmm_star2d takes even L from 2r + 2 to "
                         f"{STAR2D_MAX_L}; got L={L}, r={radius}")
    tf32, bf16 = _stacked(ops)
    return StarOperand(ops=ops, radius=int(radius),  # type: ignore[arg-type]
                       tf32=tf32, bf16=bf16)


def sptc_spmm_star2d(sop: StarOperand, xs: torch.Tensor, *,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Both axis ops at once: ``y[b, i, j] = op_0(xs[b, :, j + r])[i] +
    op_1(xs[b, i + r, :])[j]``.

    ``xs`` is the raw (B, H + 2r, W + 2r) batch of haloed grids, any batch
    and row stride, unit column stride: read where it lies.  Returns the
    contiguous (B, H, W) interior in ``xs.dtype``, the two applications
    summed in float32 and rounded once: in float32 the sums of
    :func:`sptc_spmm_fused` per op added as the per-RowOp loop adds them.
    ``out``, where given, is written and returned instead: any (B, H, W)
    view with a unit column stride that shares no byte with ``xs``; a row
    whose address is not a multiple of 16 bytes is stored 4 bytes a lane.
    """
    r = sop.radius
    return _one_launch(
        sptc_spmm_star2d, sop, xs, 2 * r,
        lambda tables: sptc_star2d_ref(tables, xs, radius=r, L=sop.L),
        lambda y, frags, tf32: sptc_star2d_launch(
            xs, y, frags, radius=r, L=sop.L, tf32=tf32), out)


sptc_spmm_star2d.launches = 0    # type: ignore[attr-defined]


# ---------------------------------------------------------------------------
# v1: compressed SpMM over a pre-swapped RHS
# ---------------------------------------------------------------------------

def sptc_spmm(values: torch.Tensor, meta: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """Compressed (M, K/2) x (K, N) -> (M, N): one tile of
    :func:`sptc_spmm_windows`."""
    if x.dim() != 2:
        raise ValueError(f"x must be (K, N), got shape {tuple(x.shape)}")
    return sptc_spmm_windows(values, meta, x[None])[0]


def sptc_spmm_windows(values: torch.Tensor, meta: torch.Tensor,
                      windows: torch.Tensor) -> torch.Tensor:
    """Over the leading tile axis: (T, K, N) -> (T, M, N), one launch.

    ``values`` (M, K/2) is cast to the windows' dtype (as the reference
    casts it); ``meta`` (M, K/2) holds 2-bit positions in [0, 4): a field
    outside that range is outside the contract (the reference's one-hot
    reads another segment's row with it, the plain version indexes with it
    unguarded, the kernel drops the slot).  Both slots of a segment may name
    one position (their products are summed), in either order.  A position
    past K (a field of 2 or 3 in the last segment of an odd K/2) matches
    nothing in the reference and the kernel.  The sums are float32, the
    result in ``windows.dtype``; ``windows`` may be any view with a unit
    column stride.  The kernel builds its tables from ``values`` and
    ``meta`` on the card: nothing is copied to the host.
    """
    if values.dim() != 2 or meta.shape != values.shape:
        raise ValueError(f"values and meta must both be (M, K/2), got "
                         f"{tuple(values.shape)} and {tuple(meta.shape)}")
    if windows.dim() != 3 or windows.shape[1] != 2 * values.shape[1]:
        raise ValueError(f"windows must be (T, K={2 * values.shape[1]}, N), "
                         f"got {tuple(windows.shape)}")
    if windows.dtype not in DTYPE_CODES:
        raise TypeError(f"windows dtype {windows.dtype} not in "
                        f"{tuple(DTYPE_CODES)}")
    if meta.dtype.is_floating_point or meta.dtype == torch.bool:
        raise TypeError(f"meta must be an integer tensor, got {meta.dtype}")
    if values.device != windows.device or meta.device != windows.device:
        raise ValueError("values, meta and windows lie on different devices")
    if windows.shape[2] > 1 and windows.stride(2) != 1:
        raise ValueError("windows need a unit column stride")
    if values.numel() * 8 > SMEM_LIMIT:
        # the contract's limit (M * K/2 <= 6144 slots); the kernel's tables
        # in shared memory fit every operand within it (kernel.table_bytes)
        raise ValueError(f"an operand of {tuple(values.shape)} is past the "
                         f"v1 limit of {SMEM_LIMIT // 8} slots (the kernel's "
                         f"tables live in shared memory)")
    values = values.to(windows.dtype)
    if windows.device.type == "cpu":
        with region("sptc_spmm_windows"):
            return sptc_spmm_windows_ref(values, meta, windows)
    if windows.device.type != "cuda":
        raise ValueError(f"no kernel for device {windows.device}")
    t, _, n = windows.shape
    y = torch.empty((t, values.shape[0], n), dtype=windows.dtype,
                    device=windows.device)
    if y.numel() == 0:
        return y
    values, meta = values.contiguous(), meta.to(torch.int32).contiguous()
    with region("sptc_spmm_windows"):
        sptc_spmm_launch(values, meta, windows, y)
    sptc_spmm_windows.launches += 1
    return y


sptc_spmm_windows.launches = 0    # type: ignore[attr-defined]
