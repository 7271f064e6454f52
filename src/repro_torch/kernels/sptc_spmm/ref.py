"""Plain torch versions of the two SpTC kernels.

:func:`sptc_fused_ref` (``csrc/sptc_fused.cu``) repeats the fused kernel's
own steps with torch ops — unpack the 2-bit metadata from the packed words,
apply the closed-form strided swap, read the window rows, multiply-add in
float32 — so the packing is tested too, not only the stencil it encodes.

:func:`sptc_spmm_ref` / :func:`sptc_spmm_windows_ref` (``csrc/sptc_spmm.cu``,
the v1 compressed SpMM) are ``core/sptc.py``'s ``sptc_matmul``, the second
written out over the tile axis.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def sptc_spmm_ref(values: torch.Tensor, meta: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """(M, K/2) values + metadata  x  (K, N)  ->  (M, N)."""
    # imported here (as below): repro_torch.core's package imports the
    # engine, which imports this package
    from repro_torch.core.sptc import sptc_matmul
    return sptc_matmul(values, meta, x)


def sptc_spmm_windows_ref(values: torch.Tensor, meta: torch.Tensor,
                          windows: torch.Tensor) -> torch.Tensor:
    """Over the leading tile axis: windows (T, K, N) -> (T, M, N).

    Float32 accumulation, result in ``windows.dtype``.
    """
    from repro_torch.core.sptc import segment_gather
    m, half = values.shape
    if half * 2 != windows.shape[1]:
        raise ValueError(f"values width {half} != K/2 = "
                         f"{windows.shape[1] // 2}")
    xg = windows[:, segment_gather(meta, half)]           # (T, M, K/2, N)
    return torch.einsum("mk,tmkn->tmn", values.to(windows.dtype).float(),
                        xg.float()).to(windows.dtype)


def unpack_meta(meta_words: torch.Tensor, kh: int) -> torch.Tensor:
    """(L, nwords) int32 view of uint32 words -> (L, kh) 2-bit fields.

    ``torch.uint32`` has no shifts on the CPU, so the words are widened to
    int64 and masked back to their 32 bits before shifting.
    """
    words = meta_words.to(torch.int64) & 0xFFFFFFFF
    j = torch.arange(kh, device=meta_words.device)
    return (words[:, j // 16] >> (2 * (j % 16))) & 3


def strided_swap(p: torch.Tensor, L: int) -> torch.Tensor:
    """Closed-form strided-swap involution: odd p < L <-> p + L."""
    return torch.where(p % 2 == 1, torch.where(p < L, p + L, p - L), p)


def window_sources(meta_words: torch.Tensor, L: int, kh: int,
                   star_fast: bool) -> torch.Tensor:
    """(L, kh) window row read by every compressed slot of every output row."""
    m = torch.arange(L, device=meta_words.device)[:, None]
    j = torch.arange(kh, device=meta_words.device)[None, :]
    if star_fast:                       # banded layout: no metadata
        return m + j
    return strided_swap(4 * (j // 2) + unpack_meta(meta_words, kh), L)


def sptc_fused_ref(values: torch.Tensor, meta_words: torch.Tensor,
                   x2d: torch.Tensor, *, n_out: int, L: int, star_fast: bool,
                   compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """y[tL+m, c] = sum_j values[m, j] * x2d[tL + src(m, j), c].

    ``x2d`` (rows, C) is the raw, unswapped input; rows past its end read
    as zero.  ``compute_dtype`` rounds the window and the values to that
    type before the float32 multiply-add.  Returns (n_out, C) in
    ``x2d.dtype``.
    """
    kh = values.shape[1]
    src = window_sources(meta_words, L, kh, star_fast)
    tiles = -(-n_out // L)
    need = (tiles + 1) * L
    rows, c = x2d.shape
    xp = F.pad(x2d, (0, 0, 0, need - rows)) if need > rows else x2d[:need]
    win = xp.unfold(0, 2 * L, L)                       # (tiles, C, 2L) view
    vals = values if compute_dtype is None else values.to(compute_dtype)
    acc = torch.zeros((tiles, c, L), dtype=torch.float32, device=x2d.device)
    for j in range(kh):
        xj = win[:, :, src[:, j]]                      # (tiles, C, L)
        if compute_dtype is not None:
            xj = xj.to(compute_dtype)
        acc += vals[:, j].float() * xj.float()
    y = acc.to(x2d.dtype).permute(0, 2, 1).reshape(tiles * L, c)
    return y[:n_out]
