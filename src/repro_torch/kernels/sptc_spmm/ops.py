"""Public wrapper of the fused SpTC kernel and the tables it reads.

:func:`fused_operand` turns a compressed operand into device tables once
(the engine calls it in its constructor); :func:`sptc_spmm_fused` applies
them.  On a CUDA tensor the wrapper launches the kernel or raises; it takes
the plain torch version only for a tensor that lies on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.core.sparsify import (Sparse24, contiguous_band_values,
                                       strided_swap_perm)
from repro_torch.kernels.build import DTYPE_CODES, SMEM_LIMIT
from repro_torch.kernels.sptc_spmm.kernel import sptc_fused_launch
from repro_torch.kernels.sptc_spmm.ref import sptc_fused_ref


@dataclasses.dataclass(frozen=True)
class FusedOperand:
    """Device tables of one compressed operand (L = K/2 = ``values.shape[0]``).

    ``values``     (L, K/2) in the input dtype — the banded layout of
                   ``contiguous_band_values`` when ``star_fast``.
    ``meta_words`` (L, ceil(K/32)) int32 view of the packed uint32
                   ``Sparse24.meta_bits()`` words.
    """

    values: torch.Tensor
    meta_words: torch.Tensor
    star_fast: bool


def fused_operand(operand: Sparse24, perm, L: int, *,
                  star_fast: Union[bool, str] = "auto",
                  dtype: torch.dtype = torch.float32,
                  device: Union[str, torch.device] = "cpu") -> FusedOperand:
    """Build the kernel's tables for ``operand`` on ``device``.

    ``star_fast``: ``"auto"`` uses the metadata-free banded path whenever
    the swap∘meta gather is the identity band of the taps; ``True``
    requires it (ValueError otherwise); ``False`` always decodes the
    metadata.
    """
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
    return FusedOperand(
        values=torch.as_tensor(np.asarray(vals), dtype=dtype, device=device),
        meta_words=torch.as_tensor(words, device=device),
        star_fast=fast is not None)


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
    if L * kh * 8 > SMEM_LIMIT:
        raise ValueError(f"L={L} needs more than {SMEM_LIMIT} bytes of "
                         "shared memory per block")
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
    sptc_fused_launch(x2d, y, op.values, op.meta_words, n_out=n_out, L=L,
                      star_fast=op.star_fast,
                      bf16_compute=compute_dtype is not None)
    sptc_spmm_fused.launches += 1
    return y


sptc_spmm_fused.launches = 0    # type: ignore[attr-defined]
