"""Strided-swap structured sparsification + 2:4 encoding (paper §3.2.2).

Pipeline (Figure 5):
  step 1  choose L = 2r+2 so the banded kernel matrix is exactly 50% dense;
  step 2  *strided swap*: permute columns so every aligned 4-element segment
          of every row holds at most 2 non-zeros (the 2:4 pattern).
          With the width padded to 2L, the permutation is: odd positions
          exchange halves (p <-> p+L for odd p < L); even positions fixed.
  step 3  encode into the SpTC compressed format: a value matrix of width
          K/2 (one zero placeholder per row of a 50%-dense band) plus 2-bit
          positional metadata, two strictly-increasing indices per segment,
          ordered from the least significant position.

Why step 2 works (proved by `tests/test_sparsify.py` over a radius sweep and
by hypothesis over arbitrary banded contents): row ``i`` of the band occupies
columns ``[i, i+2r]``, a contiguous run of length ``2r+1 = L-1``. After the
swap, positions ``p`` in ``[i, i+L-2]`` are non-zero only for even ``p`` (odd
positions there hold columns from the other half, which lie outside the band),
and the displaced odd columns land on odd positions whose even neighbours are
outside the band. Any aligned 4-segment therefore sees at most 2 from the even
class or at most 2 from the odd class, never more than 2 total at a boundary.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def strided_swap_perm(L: int) -> np.ndarray:
    """Column permutation of width 2L: odd positions swap halves.

    perm[p] = source column placed at position p. Involution: perm == argsort(perm).
    """
    if L % 2 != 0:
        raise ValueError("L must be even")
    perm = np.arange(2 * L)
    odd_lo = np.arange(1, L, 2)
    perm[odd_lo] = odd_lo + L
    perm[odd_lo + L] = odd_lo
    return perm


def apply_col_perm(mat: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Place source column perm[p] at position p."""
    return mat[:, perm]


def is_24_sparse(mat: np.ndarray) -> bool:
    """True iff every aligned 4-segment of every row has <= 2 non-zeros."""
    m, k = mat.shape
    if k % 4 != 0:
        raise ValueError("width must be a multiple of 4")
    seg = (mat.reshape(m, k // 4, 4) != 0).sum(axis=-1)
    return bool(np.all(seg <= 2))


@dataclasses.dataclass(frozen=True)
class Sparse24:
    """SpTC-compatible compressed operand (paper §3.2.2 step 3).

    values:  (M, K/2) — non-zeros (plus zero placeholders) per segment.
    meta:    (M, K/2) int8 in [0, 4) — intra-segment position of each value,
             strictly increasing within each segment pair, LSB-first.
    k:       original (padded) reduction width K.
    """

    values: np.ndarray
    meta: np.ndarray
    k: int

    @property
    def m(self) -> int:
        return self.values.shape[0]

    def gather_indices(self) -> np.ndarray:
        """(M, K/2) indices into the K dim: 4*segment + meta."""
        half = self.k // 2
        seg = (np.arange(half) // 2) * 4
        return seg[None, :] + self.meta.astype(np.int64)

    def meta_bits(self) -> np.ndarray:
        """Hardware bit packing: per row, one uint32 per 8 segments.

        Each 2-bit field holds one index, LSB-first within the word — the
        layout mma.sp consumes (paper Fig. 5 'metadata is sorted in increasing
        order starting from the least significant bit within each segment').
        """
        m, half = self.meta.shape
        fields_per_word = 16  # 16 x 2-bit fields
        nwords = -(-half // fields_per_word)
        pad = nwords * fields_per_word - half
        meta = np.pad(self.meta, ((0, 0), (0, pad)))
        words = np.zeros((m, nwords), dtype=np.uint32)
        for f in range(fields_per_word):
            words |= (meta[:, f::fields_per_word].astype(np.uint32) & 0x3) << (2 * f)
        return words


def encode_24(mat: np.ndarray) -> Sparse24:
    """Compress a 2:4-sparse matrix into (values, metadata).

    Deterministic placeholder rule for segments with < 2 non-zeros (indices
    must be strictly increasing):
      0 non-zeros            -> indices (2, 3), values (0, 0)
      1 non-zero at p < 3    -> indices (p, 3), values (v, 0)
      1 non-zero at p == 3   -> indices (2, 3), values (0, v)
    """
    m, k = mat.shape
    if k % 4 != 0:
        raise ValueError("width must be a multiple of 4")
    if not is_24_sparse(mat):
        raise ValueError("matrix is not 2:4 sparse; apply strided swap first")
    nseg = k // 4
    values = np.zeros((m, 2 * nseg), dtype=mat.dtype)
    meta = np.zeros((m, 2 * nseg), dtype=np.int8)
    for i in range(m):
        row = mat[i]
        for s in range(nseg):
            seg = row[4 * s:4 * s + 4]
            nz = np.flatnonzero(seg)
            if len(nz) == 2:
                idx = (int(nz[0]), int(nz[1]))
                val = (seg[nz[0]], seg[nz[1]])
            elif len(nz) == 1:
                p = int(nz[0])
                if p == 3:
                    idx, val = (2, 3), (0, seg[3])
                else:
                    idx, val = (p, 3), (seg[p], 0)
            else:
                idx, val = (2, 3), (0, 0)
            meta[i, 2 * s], meta[i, 2 * s + 1] = idx
            values[i, 2 * s], values[i, 2 * s + 1] = val
    return Sparse24(values=values, meta=meta, k=k)


def decode_24(sp: Sparse24) -> np.ndarray:
    """Reconstruct the dense (permuted) matrix — inverse of encode_24."""
    m = sp.m
    out = np.zeros((m, sp.k), dtype=sp.values.dtype)
    idx = sp.gather_indices()
    np.put_along_axis(out, idx, sp.values, axis=1)
    return out


def contiguous_band_values(sp: Sparse24, perm: np.ndarray) -> "np.ndarray | None":
    """Banded re-layout of a compressed operand, or None if not banded.

    When the composed gather ``comb[m, j] = perm[4*seg(j) + meta[m, j]]``
    is the identity band of the taps — every non-zero slot of row ``m``
    reads input row ``m + off`` with ``0 <= off < K/2`` — the 2:4 pattern
    carries no information beyond the band structure, and the kernel can
    skip the one-hot decompression entirely: it needs only the values
    re-laid-out by offset, ``out[m, off] = values[m, j]``.  This is the
    star-shape fast path (the swap∘meta permutation is the identity on
    the star taps); it holds for every banded (L, 2L) kernel matrix the
    stencil pipeline produces, and fails (returns None) for any operand
    whose pattern escapes the band.
    """
    comb = np.asarray(perm)[sp.gather_indices()]
    m, kh = sp.values.shape
    out = np.zeros_like(np.asarray(sp.values))
    for i in range(m):
        for j in range(kh):
            v = sp.values[i, j]
            if v == 0:
                continue
            off = comb[i, j] - i
            if not 0 <= off < kh:
                return None
            out[i, off] += v
    return out


def sparsify_matrices(mats: "tuple[np.ndarray, ...] | list[np.ndarray]",
                      L: int) -> "tuple[np.ndarray, tuple[Sparse24, ...], bool]":
    """Strided-swap + 2:4-encode a family of (L, 2L) kernel matrices.

    The lowering pipeline's stage-3 producer (see :mod:`repro_torch.core.ir`):
    ONE permutation serves every matrix, each matrix gets its own
    compressed operand, and the returned flag records whether all
    operands share identical metadata (the variable-coefficient
    shared-pattern invariant — trivially true when the matrices share
    one zero structure).
    """
    perm = strided_swap_perm(L)
    operands = []
    for K in mats:
        Kp = apply_col_perm(np.asarray(K), perm)
        if not is_24_sparse(Kp):   # structural guarantee; double-checked
            raise AssertionError("strided swap failed to produce 2:4 pattern")
        operands.append(encode_24(Kp))
    shared = len({op.meta.tobytes() for op in operands}) <= 1
    return perm, tuple(operands), shared


@dataclasses.dataclass(frozen=True)
class SparseStencilKernel:
    """A 1-D stencil kernel fully transformed for SpTC execution.

    Carries the compressed operand, the column permutation (== the input row
    permutation, it is an involution), and bookkeeping for tiling.
    """

    sparse: Sparse24
    perm: np.ndarray           # (2L,) strided-swap involution
    L: int                     # outputs per tile (M of the SpMM)
    radius: int
    window: int                # input rows consumed per tile = 2L (padded)

    @property
    def values(self) -> np.ndarray:
        return self.sparse.values

    @property
    def meta(self) -> np.ndarray:
        return self.sparse.meta


def sparsify_stencil_kernel(w: np.ndarray, L: int | None = None) -> SparseStencilKernel:
    """stencil row -> banded matrix -> strided swap -> 2:4 encode."""
    from repro_torch.core.transform import default_l, kernel_matrix

    w = np.asarray(w)
    r = (w.shape[0] - 1) // 2
    if L is None:
        L = default_l(r)
    K = kernel_matrix(w, L=L, pad_width=True)        # (L, 2L)
    perm = strided_swap_perm(L)
    Kp = apply_col_perm(K, perm)
    if not is_24_sparse(Kp):  # structural guarantee; double-checked anyway
        raise AssertionError("strided swap failed to produce 2:4 pattern")
    return SparseStencilKernel(sparse=encode_24(Kp), perm=perm, L=L,
                               radius=r, window=2 * L)
