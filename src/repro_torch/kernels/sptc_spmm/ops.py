"""Public wrappers of the two SpTC kernels and the tables they read.

:func:`fused_operand` turns a compressed operand into device tables once
(the engine calls it in its constructor); :func:`sptc_spmm_fused` applies
them.  :func:`sptc_spmm` / :func:`sptc_spmm_windows` are the v1 compressed
SpMM over a pre-swapped RHS.  On a CUDA tensor a wrapper launches its
kernel or raises; it takes the plain torch version only for a tensor that
lies on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional, Union

import numpy as np
import torch

from repro_torch.device import Device, resolve_device
from repro_torch.kernels.build import DTYPE_CODES, SMEM_LIMIT
from repro_torch.kernels.sptc_spmm import fragments as fr
from repro_torch.kernels.sptc_spmm.kernel import (sptc_fused_launch,
                                                  sptc_spmm_launch)
from repro_torch.kernels.sptc_spmm.ref import (sptc_fused_ref,
                                               sptc_spmm_windows_ref)

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
                    compute_dtype: Optional[torch.dtype] = None
                    ) -> torch.Tensor:
    """One fused application: window read → swap + gather → dot.

    ``x2d`` is the raw (>= n_out + 2r, C) haloed input — not windowed, not
    swapped, any row stride.  Returns the (n_out, C) stencil output in
    ``x2d.dtype``, accumulated in float32; ``compute_dtype=torch.bfloat16``
    rounds the window and the values to bf16 first.
    """
    _check(op, x2d, n_out, compute_dtype)
    L = op.values.shape[0]
    if x2d.device.type == "cpu":
        return sptc_fused_ref(op.values, op.meta_words, x2d, n_out=n_out,
                              L=L, star_fast=op.star_fast,
                              compute_dtype=compute_dtype)
    if x2d.device.type != "cuda":
        raise ValueError(f"no kernel for device {x2d.device}")
    y = torch.empty((n_out, x2d.shape[1]), dtype=x2d.dtype, device=x2d.device)
    if y.numel() == 0:
        return y
    # a float32 operand (checked above: the input's dtype) has both routes
    tf32 = x2d.dtype == torch.float32 and compute_dtype is None
    sptc_fused_launch(x2d, y, op.tf32 if tf32 else op.bf16, n_out=n_out, L=L,
                      tf32=tf32)
    sptc_spmm_fused.launches += 1
    return y


sptc_spmm_fused.launches = 0    # type: ignore[attr-defined]


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
    casts it); ``meta`` (M, K/2) holds 2-bit positions in [0, 4).  The sums
    are float32, the result in ``windows.dtype``; ``windows`` may be any
    view with a unit column stride.
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
        raise ValueError(f"an operand of {tuple(values.shape)} needs more "
                         f"than {SMEM_LIMIT} bytes of shared memory per block")
    values = values.to(windows.dtype)
    if windows.device.type == "cpu":
        return sptc_spmm_windows_ref(values, meta, windows)
    if windows.device.type != "cuda":
        raise ValueError(f"no kernel for device {windows.device}")
    t, _, n = windows.shape
    y = torch.empty((t, values.shape[0], n), dtype=windows.dtype,
                    device=windows.device)
    if y.numel() == 0:
        return y
    sptc_spmm_launch(values.contiguous(), meta.to(torch.int32).contiguous(),
                     windows, y)
    sptc_spmm_windows.launches += 1
    return y


sptc_spmm_windows.launches = 0    # type: ignore[attr-defined]
