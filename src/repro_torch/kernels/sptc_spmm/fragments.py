"""Per-lane register tables of the fused SpTC kernel's ``mma.sp`` operand.

The fused kernel (``csrc/sptc_fused.cu``) keeps the whole (L, 2L) swapped
operand in registers: every warp loads its A fragments and metadata words
once, from the tables built here, and reuses them for every tile.  The
tables are laid out in the order the kernel loads them, one 32-bit word
per lane, so the kernel does no index arithmetic on them:

``a``  (MB, KS, 2, 32): register ``r`` of lane ``l`` in k-step ``ks`` of
       16-row M block ``mb``;
``e``  (MB, KS, 32) int32: the metadata register of lane ``l``.

MB = ceil(L/16) blocks of 16 output rows (padded with zero rows); KS k-steps
of the instruction's depth cover K = 2L window positions (the padding is
zero).  Lane ``l`` is thread ``t = l % 4`` of group ``g = l // 4``: its A
registers hold rows ``g`` (``r = 0``) and ``g + 8`` (``r = 1``) of the M
block, and its metadata word holds the index fields of those two rows,
row ``g`` in bits 0-15 and row ``g + 8`` in bits 16-31, one 4-bit field per
aligned chunk of the k-step.  Every lane of a group carries the same word,
so any sparsity selector reads the right one.

Two routes, one per instruction:

* **TF32** (``mma.sp.m16n8k8.tf32``, float32 storage): PTX takes only 1:2
  sparsity, one non-zero per aligned pair of window positions.  The strided
  swap gives exactly that whenever L >= 2r+2 (an even position holds source
  column p, the odd one p+1±L, and the band spans only 2r < L-1 columns), so
  :func:`encode_12` re-encodes the operand pair by pair: its value and
  field 0b0100 (position 0) or 0b1110 (position 1).  The values stay full
  float32; the kernel splits them into TF32 high and low parts (3xTF32).
* **BF16** (``mma.sp.m16n8k16.bf16``, bfloat16 storage or compute): the
  2:4 operand as ``encode_24`` gives it, field ``idx0 | idx1 << 2`` per
  4-chunk, values packed two to a word (column 2t low, 2t+1 high).

:func:`decode_tf32` / :func:`decode_bf16` are the plain inverses, used by
the tests to hold the tables to the dense swapped matrix.

The v1 kernel (``csrc/sptc_spmm.cu``) takes any (M, K/2) operand with any
metadata in [0, 4), on the device, and builds its tables itself in its
prologue.  :func:`v1_tables` is the plain torch version of that
canonicalisation and :func:`decode_v1` its inverse.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Tuple

import numpy as np
import torch

if TYPE_CHECKING:
    from repro_torch.core.sparsify import Sparse24

ROWS = 16               # M of both instructions
TF32_K = 8              # K of mma.sp.m16n8k8.tf32 (4 compressed columns)
BF16_K = 16             # K of mma.sp.m16n8k16.bf16 (8 compressed columns)
FIELD_POS0, FIELD_POS1 = 0x4, 0xE   # TF32 1:2 field: non-zero at 0 / at 1
#: largest L whose fragments the kernel's register budget holds
MAX_L = 80

_LANE = np.arange(32)
_G, _T = _LANE // 4, _LANE % 4


@dataclasses.dataclass(frozen=True)
class Fragments:
    """One route's per-lane tables (see the module docstring)."""

    a: torch.Tensor
    e: torch.Tensor
    k_step: int

    @property
    def ksteps(self) -> int:
        return self.e.shape[1]


def _blocks(L: int, k_step: int) -> Tuple[int, int]:
    return -(-L // ROWS), -(-(2 * L) // k_step)


def _rows(mb: int) -> np.ndarray:
    """(MB, 2, 32) operand row of register r of every lane."""
    return (ROWS * np.arange(mb)[:, None, None] + _G[None, None, :]
            + 8 * np.arange(2)[None, :, None])


def _meta_words(fields: np.ndarray) -> np.ndarray:
    """(MB*16, KS, 4) 4-bit fields -> (MB, KS, 32) int32 lane words."""
    rows, ks, _ = fields.shape
    per_row = (fields.astype(np.uint32) << (4 * np.arange(4, dtype=np.uint32))
               ).sum(axis=-1, dtype=np.uint32)                # (rows, KS)
    per_row = per_row.reshape(rows // ROWS, ROWS, ks)
    lo, hi = per_row[:, _G, :], per_row[:, _G + 8, :]           # (MB, 32, KS)
    words = (lo | (hi << np.uint32(16))).transpose(0, 2, 1)
    return np.ascontiguousarray(words).view(np.int32)


def _fields(words: np.ndarray) -> np.ndarray:
    """Inverse of :func:`_meta_words`, read from group leaders (lane 4g)."""
    w = np.asarray(words).view(np.uint32)[:, :, ::4]            # (MB, KS, 8)
    halves = np.stack([w & 0xFFFF, w >> 16], axis=2)            # (MB,KS,2,8)
    nib = (halves[..., None] >> (4 * np.arange(4, dtype=np.uint32))) & 0xF
    mb, ks = w.shape[:2]
    # (MB, KS, half, g, chunk) -> (MB*16 rows, KS, chunk)
    return nib.transpose(0, 2, 3, 1, 4).reshape(mb * ROWS, ks, 4)


def encode_12(dense: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Pair-aligned 1:2 encoding of a (M, K) matrix, K even.

    Returns (values, positions), both (M, K/2): the non-zero of each aligned
    pair (2q, 2q+1) — zero where the pair is empty — and its position 0/1.
    Raises ``ValueError`` when a pair holds two non-zeros (a 2:4 operand
    that is not 1:2).
    """
    dense = np.asarray(dense)
    m, k = dense.shape
    if k % 2:
        raise ValueError(f"width {k} is odd")
    pairs = dense.reshape(m, k // 2, 2)
    nz = pairs != 0
    if np.any(nz.all(axis=-1)):
        row, q = np.argwhere(nz.all(axis=-1))[0]
        raise ValueError(
            f"operand is not 1:2 at pair granularity: row {row} holds two "
            f"non-zeros in pair ({2 * q}, {2 * q + 1})")
    pos = nz[..., 1].astype(np.int64)
    return np.take_along_axis(pairs, pos[..., None], -1)[..., 0], pos


def tf32_tables(dense: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(L, 2L) float32 swapped operand -> (a float32 (MB, KS, 2, 32),
    e int32 (MB, KS, 32)) for ``mma.sp.m16n8k8.tf32``."""
    dense = np.asarray(dense, dtype=np.float32)
    L = dense.shape[0]
    mb, ks = _blocks(L, TF32_K)
    padded = np.zeros((mb * ROWS, ks * TF32_K), dtype=np.float32)
    padded[:L, :2 * L] = dense
    vals, pos = encode_12(padded)                     # (MB*16, KS*4)
    cols = 4 * np.arange(ks)[:, None] + _T[None, :]    # (KS, 32)
    rows = _rows(mb)
    a = vals[rows[:, None, :, :], cols[None, :, None, :]]      # (MB,KS,2,32)
    fields = np.where(pos == 1, FIELD_POS1, FIELD_POS0).reshape(
        mb * ROWS, ks, 4)
    return np.ascontiguousarray(a), _meta_words(fields)


def bf16_tables(values: torch.Tensor, meta: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """2:4 operand (values (L, L) bfloat16, meta (L, L) in [0, 4), both as
    ``encode_24`` lays them out) -> (a int32 (MB, KS, 2, 32) packed pairs,
    e int32 (MB, KS, 32)) for ``mma.sp.m16n8k16.bf16``."""
    L = values.shape[0]
    mb, ks = _blocks(L, BF16_K)
    width = ks * BF16_K // 2                          # compressed columns
    bits = np.zeros((mb * ROWS, width), dtype=np.uint32)
    bits[:L, :L] = values.to(torch.bfloat16).view(torch.int16).cpu().numpy(
    ).view(np.uint16)
    # padding chunks: indices (0, 1) over zero values
    idx = np.tile(np.array([0, 1]), (mb * ROWS, width // 2))
    idx[:L, :L] = np.asarray(meta)
    cols = 8 * np.arange(ks)[:, None] + 2 * _T[None, :]        # (KS, 32)
    rows = _rows(mb)[:, None, :, :]
    a = bits[rows, cols[None, :, None, :]] | \
        (bits[rows, cols[None, :, None, :] + 1] << np.uint32(16))
    fields = (idx[:, 0::2] | (idx[:, 1::2] << 2)).reshape(mb * ROWS, ks, 4)
    return np.ascontiguousarray(a).view(np.int32), _meta_words(fields)


def decode_tf32(a: np.ndarray, e: np.ndarray, L: int) -> np.ndarray:
    """Plain inverse of :func:`tf32_tables`: the (L, 2L) float32 matrix."""
    a = np.asarray(a, dtype=np.float32)
    mb, ks = a.shape[:2]
    fields = _fields(e)                                   # (MB*16, KS, 4)
    if not np.isin(fields, (FIELD_POS0, FIELD_POS1)).all():
        raise ValueError("invalid TF32 metadata field")
    rows = _rows(mb)[:, None, :, :]                       # (MB, 1, 2, 32)
    k = np.arange(ks)[None, :, None, None]
    q = _T[None, None, None, :]
    cols = k * TF32_K + 2 * q + (fields[rows, k, q] == FIELD_POS1)
    out = np.zeros((mb * ROWS, ks * TF32_K), dtype=np.float32)
    out[rows, cols] = a
    return out[:L, :2 * L]


def decode_bf16(a: np.ndarray, e: np.ndarray, L: int) -> np.ndarray:
    """Plain inverse of :func:`bf16_tables`: the (L, 2L) matrix (float32
    of the bfloat16 values)."""
    words = np.asarray(a).view(np.uint32)
    mb, ks = words.shape[:2]
    fields = _fields(e).astype(np.int64)                  # (MB*16, KS, 4)
    idx = np.stack([fields & 3, fields >> 2], axis=-1)    # (.., 4, 2)
    if np.any(idx[..., 0] >= idx[..., 1]):
        raise ValueError("invalid 2:4 metadata field")
    halves = np.stack([words & 0xFFFF, words >> 16], axis=-1).astype(np.uint16)
    vals = torch.from_numpy(halves.view(np.int16)).view(torch.bfloat16
                                                         ).float().numpy()
    rows = _rows(mb)[:, None, :, :, None]                 # (MB,1,2,32,1)
    k = np.arange(ks)[None, :, None, None, None]
    t = _T[None, None, None, :, None]
    s = np.arange(2)[None, None, None, None, :]
    cols = k * BF16_K + 4 * t + idx[rows, k, t, s]
    out = np.zeros((mb * ROWS, ks * BF16_K), dtype=np.float32)
    np.add.at(out, (np.broadcast_to(rows, cols.shape), cols), vals)
    return out[:L, :2 * L]


def swapped_dense(operand: "Sparse24") -> np.ndarray:
    """The (L, 2L) swapped matrix a compressed operand encodes."""
    from repro_torch.core.sparsify import decode_24
    return decode_24(operand)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: float32 to 10 mantissa bits, to nearest, ties
    away from zero (the low 13 bits of the result are zero)."""
    bits = x.float().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x.float())


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's 3xTF32 split: ``hi = tf32(x)``, ``lo = tf32(x - hi)``;
    the products hi·hi + hi·lo + lo·hi keep float32 accuracy."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


# ---------------------------------------------------------------------------
# the v1 kernel's canonical operand
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class V1Tables:
    """The v1 kernel's shared-memory tables of one operand, as its prologue
    builds them (float32: TF32 pairs; bfloat16: 2:4 chunks).

    ``words``  (2, KS, M, 4) int32: lane word ``t`` of row ``m`` in k-step
               ``ks`` of each pass — a float32 value (compressed column t)
               or two bfloat16 values (columns 2t low, 2t + 1 high);
    ``fields`` (2, KS, M) int32: the row's four 4-bit metadata fields;
    ``second`` (MB,) bool: the 16-row M block runs pass 1.
    """

    words: torch.Tensor
    fields: torch.Tensor
    second: torch.Tensor


def _raw_bits(values: torch.Tensor) -> torch.Tensor:
    """Storage bits of float32 / bfloat16 values as non-negative int64."""
    if values.dtype == torch.float32:
        return values.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return values.contiguous().view(torch.int16).to(torch.int64) & 0xFFFF


def _as_int32(bits: torch.Tensor) -> torch.Tensor:
    """32-bit patterns held in int64 as int32 (two's complement)."""
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32)


def v1_tables(values: torch.Tensor, meta: torch.Tensor) -> V1Tables:
    """Canonicalise a compressed (M, K/2) operand for ``mma.sp``.

    A slot contributes when its field is in [0, 4), its position is inside
    K and its value is non-zero.  A segment's two contributing slots go into
    pass 0 together where the instruction allows it — TF32: in different
    aligned pairs (one non-zero per pair, field 0x4 or 0xE); BF16: at
    different positions, in ascending order (a lone one beside a zero at
    position 1, or 0 when it sits at 1) — and otherwise slot 1 goes into
    pass 1 at its own position.  So no value is merged or rounded: pass 0
    plus pass 1 is the dense operand exactly.
    """
    m, kh = values.shape
    tf32 = values.dtype == torch.float32
    if not tf32 and values.dtype != torch.bfloat16:
        raise TypeError(f"values must be float32 or bfloat16, got "
                        f"{values.dtype}")
    k = 2 * kh
    ks = -(-k // (TF32_K if tf32 else BF16_K))
    chunks = 4 * ks                         # pairs (TF32) or segments (BF16)
    nseg = chunks // 2 if tf32 else chunks
    width = 2 * nseg                        # slots, padded with empty ones
    vals = torch.zeros((m, width), dtype=torch.float32)
    vals[:, :kh] = values.float()
    bits = torch.zeros((m, width), dtype=torch.int64)
    bits[:, :kh] = _raw_bits(values)
    pos = torch.full((m, width), -1, dtype=torch.int64)
    pos[:, :kh] = meta.to(torch.int64)
    live = (pos >= 0) & (pos < 4) & (vals != 0)
    zero = torch.zeros((), dtype=torch.int64)
    if tf32:
        q = torch.arange(chunks)
        sa, sb = 2 * (q // 2), 2 * (q // 2) + 1           # slots of q's segment
        h, qin = q % 2, q < kh
        pa, pb = pos[:, sa], pos[:, sb]
        ia = live[:, sa] & qin & (pa >> 1 == h)
        ib = live[:, sb] & qin & (pb >> 1 == h)
        field = lambda p: torch.where(p & 1 == 1, FIELD_POS1, FIELD_POS0)
        w0 = torch.where(ia, bits[:, sa], torch.where(ib, bits[:, sb], zero))
        e0 = torch.where(ia, field(pa), torch.where(ib, field(pb), FIELD_POS0))
        both = ia & ib
        w1 = torch.where(both, bits[:, sb], zero)
        e1 = torch.where(both, field(pb), FIELD_POS0)
    else:
        s = torch.arange(chunks)
        pa, pb = pos[:, 0::2], pos[:, 1::2]
        ba, bb = bits[:, 0::2], bits[:, 1::2]
        ia = live[:, 0::2] & (4 * s + pa < k)
        ib = live[:, 1::2] & (4 * s + pb < k)
        dist = ia & ib & (pa != pb)
        lone = (ia | ib) & ~dist
        pp = torch.where(ia, pa, pb)                      # the lone position
        partner = torch.where(pp == 0, 1, 0)
        i0 = torch.where(dist, torch.minimum(pa, pb),
                         torch.where(lone, torch.minimum(pp, partner), 0))
        i1 = torch.where(dist, torch.maximum(pa, pb),
                         torch.where(lone, torch.maximum(pp, partner), 1))
        first = torch.where(ia, ba, bb)
        lo0 = torch.where(dist, torch.where(pa < pb, ba, bb),
                          torch.where(lone & (pp == i0), first, zero))
        hi0 = torch.where(dist, torch.where(pa < pb, bb, ba),
                          torch.where(lone & (pp == i1), first, zero))
        both = ia & ib & (pa == pb)
        lo1 = torch.where(both & (pp == i0), bb, zero)
        hi1 = torch.where(both & (pp == i1), bb, zero)
        w0, w1 = lo0 | (hi0 << 16), lo1 | (hi1 << 16)
        e0 = e1 = i0 | (i1 << 2)
    shift = 4 * torch.arange(4)

    def per_ks(w, e):
        words = w.reshape(m, ks, 4).permute(1, 0, 2)
        fields = (e.reshape(m, ks, 4) << shift).sum(-1).T
        return words, fields

    (wa, fa), (wb, fb) = per_ks(w0, e0), per_ks(w1, e1)
    rows = both.any(dim=1)
    mb = -(-m // ROWS)
    second = torch.zeros(mb * ROWS, dtype=torch.bool)
    second[:m] = rows
    return V1Tables(words=_as_int32(torch.stack([wa, wb])),
                    fields=_as_int32(torch.stack([fa, fb])),
                    second=second.reshape(mb, ROWS).any(dim=1))


def decode_v1(tables: V1Tables, kh: int, *, tf32: bool) -> torch.Tensor:
    """Plain inverse of :func:`v1_tables`: the (2, M, K) float32 operand of
    each pass.  Raises when a field is not one the instruction takes or a
    value lies past K."""
    words = tables.words.to(torch.int64) & 0xFFFFFFFF      # (2, KS, M, 4)
    fields = tables.fields.to(torch.int64) & 0xFFFF        # (2, KS, M)
    _, ks, m, _ = words.shape
    nib = (fields[..., None] >> (4 * torch.arange(4))) & 0xF
    if tf32:
        if not bool(torch.isin(nib, torch.tensor([FIELD_POS0, FIELD_POS1])
                               ).all()):
            raise ValueError("invalid TF32 metadata field")
        vals = _as_int32(words).view(torch.float32)
        c = torch.arange(4)
        cols = (TF32_K * torch.arange(ks)[:, None] + 2 * c[None, :]
                )[None, :, None, :] + (nib == FIELD_POS1).to(torch.int64)
        out = torch.zeros((2, ks, m, ks * TF32_K))
        out.scatter_(3, cols, vals)
        dense = out.sum(dim=1)                               # (2, M, KS*8)
    else:
        i0, i1 = nib & 3, nib >> 2
        if bool((i0 >= i1).any()):
            raise ValueError("invalid 2:4 metadata field")
        halves = torch.stack([words & 0xFFFF, words >> 16], dim=-1)
        vals = halves.to(torch.int16).view(torch.bfloat16).float()
        base = (BF16_K * torch.arange(ks)[:, None]
                + 4 * torch.arange(4)[None, :])[None, :, None, :]
        cols = torch.stack([base + i0, base + i1], dim=-1)   # (2,KS,M,4,2)
        out = torch.zeros((2, ks, m, ks * BF16_K))
        out.scatter_(3, cols.reshape(2, ks, m, 8), vals.reshape(2, ks, m, 8))
        dense = out.sum(dim=1)
    k = 2 * kh
    if bool((dense[..., k:] != 0).any()):
        raise ValueError("a value lies past K")
    return dense[..., :k]
