"""Launchers of the SpTC CUDA kernels.

``csrc/sptc_fused.cu`` replaces ``repro/kernels/sptc_spmm/kernel.py::
_fused_kernel``; ``csrc/sptc_spmm.cu`` replaces the v1 ``_sptc_kernel``;
``csrc/sptc_rows2d.cu`` runs every row op of a 2-D "rows" plan in one
launch, and ``csrc/sptc_star2d.cu`` both axis ops of a 2-D "star-axis"
plan, where the reference runs ``_fused_kernel`` once per row op.
The callers (:mod:`repro_torch.kernels.sptc_spmm.ops`) check the arguments
and allocate the outputs; this module only launches.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from repro_torch.kernels.build import DTYPE_CODES, check, library, stream_ptr

if TYPE_CHECKING:
    from repro_torch.kernels.sptc_spmm.fragments import Fragments


def table_bytes(m: int, kh: int, itemsize: int) -> int:
    """Shared memory of one block of the v1 kernel: the canonical tables of
    an (M, K/2) operand, for two passes, per (k-step, row) four 4-byte lane
    words and a 2-byte metadata word (a k-step is 4 pairs in float32, 4
    segments in bfloat16), and a 4-byte flag per 16-row M block."""
    k_step = 8 if itemsize == 4 else 16
    cells = 2 * -(-2 * kh // k_step) * m
    return cells * 16 + 4 * -(-m // 16) + cells * 2


def sptc_fused_launch(x2d: torch.Tensor, y: torch.Tensor,
                      frags: "Fragments", *, n_out: int, L: int,
                      tf32: bool) -> None:
    """Launch on the current stream; returns without synchronising.

    ``tf32``: float32 storage through ``mma.sp...tf32`` (3xTF32) with
    ``frags`` the operand's TF32 tables; otherwise bfloat16 storage or
    compute through ``mma.sp...bf16`` with its BF16 tables.
    """
    lib = library()
    with torch.cuda.device(x2d.device):
        status = lib.spider_sptc_fused(
            x2d.data_ptr(), y.data_ptr(), frags.a.data_ptr(),
            frags.e.data_ptr(), x2d.shape[0], x2d.shape[1], x2d.stride(0),
            n_out, L, frags.ksteps, 0 if tf32 else 1,
            DTYPE_CODES[x2d.dtype], stream_ptr(x2d.device))
    check(status, "spider_sptc_fused")


def sptc_rows2d_launch(xs: torch.Tensor, y: torch.Tensor,
                       frags: "Fragments", *, halo: int, L: int,
                       lead_bits: int, tf32: bool) -> None:
    """Launch on the current stream; returns without synchronising.

    ``xs`` (B, H + halo, W + halo) and ``y`` (B, H, W), each with a unit
    column stride; ``frags`` the row ops' tables of the route stacked on
    the leading axis; op u's row offset in bits [4u, 4u + 4) of
    ``lead_bits``.
    """
    lib = library()
    b, h, w = y.shape
    with torch.cuda.device(xs.device):
        status = lib.spider_sptc_rows2d(
            xs.data_ptr(), y.data_ptr(), frags.a.data_ptr(),
            frags.e.data_ptr(), b, h, w, xs.stride(0), xs.stride(1),
            y.stride(0), y.stride(1), halo, L, frags.a.shape[0], lead_bits,
            frags.ksteps, 0 if tf32 else 1, DTYPE_CODES[xs.dtype],
            stream_ptr(xs.device))
    check(status, "spider_sptc_rows2d")


def sptc_star2d_launch(xs: torch.Tensor, y: torch.Tensor,
                       frags: "Fragments", *, radius: int, L: int,
                       tf32: bool) -> None:
    """Launch on the current stream; returns without synchronising.

    ``xs`` (B, H + 2r, W + 2r) and ``y`` (B, H, W), each with a unit column
    stride; ``frags`` the two axis ops' tables of the route stacked on
    the leading axis, the leading axis's first.
    """
    lib = library()
    b, h, w = y.shape
    with torch.cuda.device(xs.device):
        status = lib.spider_sptc_star2d(
            xs.data_ptr(), y.data_ptr(), frags.a.data_ptr(),
            frags.e.data_ptr(), b, h, w, xs.stride(0), xs.stride(1),
            y.stride(0), y.stride(1), radius, L, frags.ksteps,
            0 if tf32 else 1, DTYPE_CODES[xs.dtype], stream_ptr(xs.device))
    check(status, "spider_sptc_star2d")


def sptc_spmm_launch(values: torch.Tensor, meta: torch.Tensor,
                     windows: torch.Tensor, y: torch.Tensor) -> None:
    """v1 SpMM over (T, K, N) windows into (T, M, N); launch on the current
    stream, returns without synchronising."""
    lib = library()
    t, _, n = windows.shape
    m, kh = values.shape
    with torch.cuda.device(windows.device):
        status = lib.spider_sptc_spmm(
            values.data_ptr(), meta.data_ptr(), windows.data_ptr(),
            y.data_ptr(), m, kh, n, windows.stride(1), windows.stride(0), t,
            DTYPE_CODES[windows.dtype], stream_ptr(windows.device))
    check(status, "spider_sptc_spmm")
