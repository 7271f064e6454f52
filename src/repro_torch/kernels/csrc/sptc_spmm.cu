// v1 compressed 2:4 SpMM on Hopper's sparse tensor cores (mma.sp):
//
//   y[t, m, n] = sum_j values[m, j] * x[t, 4*(j/2) + meta[m, j], n]
//
// per output row m and 4-wide reduction segment, only the 2 RHS rows that the
// 2-bit metadata selects contribute.  The RHS windows x (T, K, N) are
// pre-swapped by the caller; K = 2 * (K/2) = 2 * kh.  Metadata fields are in
// [0, 4): a field outside that range is outside the contract (the TPU kernel's
// one-hot, which spans all K positions, would read another segment's row
// with it; this kernel drops such a slot).  A position past K (a field of 2
// or 3 in the last segment of an odd kh) matches nothing, as in the TPU
// kernel.
//
// Replaces the TPU kernel src/repro/kernels/sptc_spmm/kernel.py::_sptc_kernel
// (pallas_call in _sptc_spmm_jit), the v1 building block behind the public
// entries sptc_spmm and sptc_spmm_windows.  It decompresses the operand to a
// dense (M, K) matrix with a one-hot and runs one MXU dot.
//
// Bound on the H100: bytes.  Per output the kernel does K/2 multiply-adds and
// moves K/M window elements and one output element: with M = L and K = 2L
// (SPIDER's operands), 2L FLOP per 12 bytes in float32, far under the tensor
// cores' ridge, so the floor is (window bytes + operand bytes + output
// bytes) / 3.35 TB/s and the tensor cores lower nothing; they must only not
// raise the time.
//
// Design.  The operand is A (16-row M blocks x K, the instruction's sparse
// side) and the windows are B (K x 8): with N = 1 (the 1-D path) the
// instruction's N axis walks tiles, B[k][n] = x[t0 + n, k, 0]; with N > 1 it
// walks columns.
//   * The operand arrives per call, on the device.  Each block builds the
//     canonical tables of the whole operand in shared memory in its
//     prologue, from values and meta as they lie in device memory (no host
//     table, no sync): per (k-step, row) four 32-bit lane words and a 16-bit
//     metadata word, for each of two passes, and per M block a flag that
//     says whether pass 1 holds anything.  Rows past M are not stored (a
//     lane reads them as zero), so the tables are the operand's size, not
//     its padding's, and every shape the wrapper accepts fits (227 KB at
//     most; kernels/sptc_spmm/kernel.py::table_bytes).
//   * Any metadata the contract allows.  float32 runs mma.sp.m16n8k8.tf32,
//     which takes 1:2 sparsity (one non-zero per aligned pair, field 0x4 or
//     0xE); bfloat16 runs mma.sp.m16n8k16.bf16, 2:4 with two distinct
//     positions in ascending order.  A segment's two non-zero slots go into
//     pass 0 together where the instruction allows it (tf32: different
//     pairs; bf16: different positions, sorted); otherwise slot 1 goes into
//     pass 1 at its own position.  So both slots naming one position are
//     summed in float32 by the tensor cores, as the plain version sums its
//     products, and no value is rounded.  Pass 1 runs only in an M block
//     whose flag is set (uniform per block, no divergence); SPIDER's
//     strided-swapped operands, 1:2 at pair granularity for L >= 2r+2, never
//     set it.  kernels/sptc_spmm/fragments.py::v1_tables is the plain torch
//     version of this canonicalisation.
//   * float32 as 3xTF32 (x and A split into a TF32 high part and a TF32
//     residual; lo*hi + hi*lo + hi*hi keeps float32 accuracy), each k-step
//     summed in a fresh accumulator and added in float32: the tensor cores'
//     accumulation truncates (the windows GEMM missed float32 accuracy over
//     20 chained k-steps).  bfloat16: float32 sums in the accumulator.
//   * Bytes in flight: a warp takes 8 n-blocks (64 tiles or 64 columns) at
//     a time and loads their B fragments straight from device memory into
//     registers, no barrier in the loop; persistent blocks walk the items,
//     so the prologue runs once per block.  With one or two k-steps (every
//     operand of the paper suite) all the item's loads are issued before
//     the first mma and each n-block's sum lives only until it is stored,
//     so a thread needs few registers and more warps keep loads in flight;
//     with more k-steps, the loads of a k-step come before its mma.
//     Columns mode: lane g's fragment column of n-block j is column
//     32 (j / 4) + 4 g + j % 4, so one 16-byte (float32) or 8-byte
//     (bfloat16) load per row fills four n-blocks, and a lane's D fragments
//     are 8 adjacent columns of a row, stored as two vectors.
//   * At L = 4, 12 of the 16 M rows are padding: tensor-core issue, not
//     bytes.
#include <type_traits>

#include "common.cuh"

namespace spider {
namespace v1 {

constexpr int kWarps = 8;
constexpr int kNB = 8;                 // n-blocks (8 wide) a warp takes at once
constexpr int kTiles = 0, kCols = 1;   // modes: N = 1 (tiles), N > 1 (columns)
constexpr uint32_t kPad = 0x4u;        // a valid field in both routes: position
                                       // 0 (tf32) / indices (0, 1) (bf16)
constexpr uint32_t kPadWord = 0x4444u; // four of them: a row past M

struct Params {
  const void* vals;        // (M, kh), the windows' dtype
  const int32_t* meta;     // (M, kh)
  const void* x;           // (tiles, K, N), strides stx, ldx, 1
  void* y;                 // (tiles, M, N) contiguous
  int64_t tiles, N, ldx, stx, items, col_blocks;
  int M, kh, K, nks, mb_count;
  bool vec_ld, vec_st;
};

// raw bits of a storage element
__device__ __forceinline__ uint32_t bits_of(float v) { return __float_as_uint(v); }
__device__ __forceinline__ uint32_t bits_of(__nv_bfloat16 v) {
  return *reinterpret_cast<const uint16_t*>(&v);
}

// One compressed slot: its value, raw bits, 2-bit field, and whether it
// contributes (inside the operand, a field in [0, 4), a non-zero value).
struct Slot {
  uint32_t bits;
  int pos;
  bool in;
};

template <typename T>
__device__ __forceinline__ Slot load_slot(const Params& p, int m, int j) {
  Slot s{0u, 0, false};
  if (j < p.kh) {
    const int64_t i = static_cast<int64_t>(m) * p.kh + j;
    const T v = static_cast<const T*>(p.vals)[i];
    s.bits = bits_of(v);
    s.pos = p.meta[i];
    s.in = s.pos >= 0 && s.pos < 4 && to_f32(v) != 0.f;
  }
  return s;
}

// Shared-memory tables: words[pass][ks][row] (uint4: the four lane words
// t = 0..3), flags[mb], fields[pass][ks][row] (16 bits: the four fields).
struct Tables {
  uint4* words;
  int* flags;
  uint16_t* fields;
};

__device__ __forceinline__ Tables tables(unsigned char* smem, const Params& p) {
  Tables tb;
  tb.words = reinterpret_cast<uint4*>(smem);
  tb.flags = reinterpret_cast<int*>(tb.words + 2 * p.nks * p.M);
  tb.fields = reinterpret_cast<uint16_t*>(tb.flags + p.mb_count);
  return tb;
}

// The prologue: canonical tables of the whole operand.  One thread per
// (k-step, row); its four chunks are the k-step's 4 pairs (tf32) or 4
// segments (bf16).
template <typename T>
__device__ void build_tables(const Params& p, const Tables& tb) {
  constexpr bool tf32 = sizeof(T) == 4;
  for (int i = threadIdx.x; i < p.mb_count; i += blockDim.x) tb.flags[i] = 0;
  __syncthreads();
  for (int u = threadIdx.x; u < p.nks * p.M; u += blockDim.x) {
    const int ks = u / p.M, m = u - ks * p.M;
    uint32_t w0[4], w1[4], f0 = 0u, f1 = 0u;
    bool second = false;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if constexpr (tf32) {
        // pair q holds positions 2q, 2q + 1 of segment q / 2
        const int q = 4 * ks + c, s = q >> 1, h = q & 1;
        const Slot a = load_slot<T>(p, m, 2 * s), b = load_slot<T>(p, m, 2 * s + 1);
        const bool ia = q < p.kh && a.in && (a.pos >> 1) == h;
        const bool ib = q < p.kh && b.in && (b.pos >> 1) == h;
        uint32_t v0 = 0u, v1 = 0u, e0 = kPad, e1 = kPad;
        if (ia || ib) {
          const Slot& first = ia ? a : b;
          v0 = first.bits;
          e0 = (first.pos & 1) ? 0xEu : 0x4u;
        }
        if (ia && ib) {                  // both in one pair: slot 1 to pass 1
          v1 = b.bits;
          e1 = (b.pos & 1) ? 0xEu : 0x4u;
          second = true;
        }
        w0[c] = v0;
        w1[c] = v1;
        f0 |= e0 << (4 * c);
        f1 |= e1 << (4 * c);
      } else {
        // segment s is the 4-chunk of positions 4s .. 4s + 3
        const int s = 4 * ks + c;
        const Slot a = load_slot<T>(p, m, 2 * s), b = load_slot<T>(p, m, 2 * s + 1);
        const bool ia = a.in && 4 * s + a.pos < p.K;
        const bool ib = b.in && 4 * s + b.pos < p.K;
        int i0 = 0, i1 = 1;
        uint32_t lo0 = 0u, hi0 = 0u, lo1 = 0u, hi1 = 0u;
        if (ia && ib && a.pos != b.pos) {        // two positions, sorted
          const bool ab = a.pos < b.pos;
          i0 = ab ? a.pos : b.pos;
          i1 = ab ? b.pos : a.pos;
          lo0 = ab ? a.bits : b.bits;
          hi0 = ab ? b.bits : a.bits;
        } else if (ia || ib) {                   // one position, a zero partner
          const int pp = ia ? a.pos : b.pos, partner = pp == 0 ? 1 : 0;
          i0 = pp < partner ? pp : partner;
          i1 = pp < partner ? partner : pp;
          const uint32_t v = ia ? a.bits : b.bits;
          (pp == i0 ? lo0 : hi0) = v;
          if (ia && ib) {                        // both name pp: slot 1 to pass 1
            (pp == i0 ? lo1 : hi1) = b.bits;
            second = true;
          }
        }
        w0[c] = lo0 | (hi0 << 16);
        w1[c] = lo1 | (hi1 << 16);
        const uint32_t e = static_cast<uint32_t>(i0 | (i1 << 2));
        f0 |= e << (4 * c);
        f1 |= e << (4 * c);
      }
    }
    tb.words[ks * p.M + m] = make_uint4(w0[0], w0[1], w0[2], w0[3]);
    tb.words[(p.nks + ks) * p.M + m] = make_uint4(w1[0], w1[1], w1[2], w1[3]);
    tb.fields[ks * p.M + m] = static_cast<uint16_t>(f0);
    tb.fields[(p.nks + ks) * p.M + m] = static_cast<uint16_t>(f1);
    if (second) atomicOr(&tb.flags[m >> 4], 1);
  }
  __syncthreads();
}

// The A fragment of pass `pass`, k-step ks, M block mb: rows g and g + 8,
// lane word t; rows past M read zero with padding fields.
__device__ __forceinline__ void a_fragment(const Tables& tb, const Params& p,
                                           int pass, int ks, int mb, int g,
                                           int t, uint32_t (&a)[2], uint32_t& e) {
  const int base = (pass * p.nks + ks) * p.M;
  const int r0 = 16 * mb + g, r1 = r0 + 8;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(tb.words + base);
  a[0] = r0 < p.M ? w[4 * r0 + t] : 0u;
  a[1] = r1 < p.M ? w[4 * r1 + t] : 0u;
  const uint32_t e0 = r0 < p.M ? tb.fields[base + r0] : kPadWord;
  const uint32_t e1 = r1 < p.M ? tb.fields[base + r1] : kPadWord;
  e = e0 | (e1 << 16);
}

// bits of one window element, zero unless `in`
template <typename T>
__device__ __forceinline__ uint32_t ld_bits(const T* x, int64_t off, bool in) {
  if (!in) return 0u;
  return bits_of(x[off]);
}

// B fragments of a k-step, tiles mode (N = 1): n-block j is tiles
// t0 + 8 j .. t0 + 8 j + 7, lane g's column tile t0 + 8 j + g.  tf32 rows
// k = 8 ks + t, + 4; bf16 rows 16 ks + 2t, + 1 (b0) and + 8, + 9 (b1).
template <typename T>
__device__ __forceinline__ void load_b_tiles(uint32_t (&b)[kNB][2], const Params& p,
                                             int64_t t0, int ks, int g, int t) {
  const T* x = static_cast<const T*>(p.x);
#pragma unroll
  for (int j = 0; j < kNB; ++j) {
    const int64_t tile = t0 + 8 * j + g;
    const bool ok = tile < p.tiles;
    const T* src = x + (ok ? tile : 0) * p.stx;
    if constexpr (sizeof(T) == 4) {
      const int k0 = 8 * ks + t, k1 = k0 + 4;
      b[j][0] = ld_bits(src, k0 * p.ldx, ok && k0 < p.K);
      b[j][1] = ld_bits(src, k1 * p.ldx, ok && k1 < p.K);
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 16 * ks + 2 * t + 8 * h;   // even, K even: k + 1 < K too
        if (p.vec_ld) {
          b[j][h] = ok && k < p.K ? *reinterpret_cast<const uint32_t*>(src + k) : 0u;
        } else {
          b[j][h] = ld_bits(src, k * p.ldx, ok && k < p.K) |
                    (ld_bits(src, (k + 1) * p.ldx, ok && k < p.K) << 16);
        }
      }
    }
  }
}

// B fragments of a k-step, columns mode: lane g's column of n-block
// j = 4 hh + jj is c0 + 32 hh + 4 g + jj.
template <typename T>
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[kNB][2], const Params& p,
                                            const T* xt, int64_t c0, int ks, int g,
                                            int t) {
#pragma unroll
  for (int hh = 0; hh < kNB / 4; ++hh) {
    const int64_t c = c0 + 32 * hh + 4 * g;
    const bool full = p.vec_ld && c + 3 < p.N;
    bool ok[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) ok[jj] = c + jj < p.N;
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 8 * ks + t + 4 * h;
        const T* src = xt + k * p.ldx + c;
        uint32_t v[4] = {0u, 0u, 0u, 0u};
        if (full) {
          if (k < p.K) {
            const uint4 u = *reinterpret_cast<const uint4*>(src);
            v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
          }
        } else {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) v[jj] = ld_bits(src, jj, ok[jj] && k < p.K);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) b[4 * hh + jj][h] = v[jj];
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 16 * ks + 2 * t + 8 * h;   // rows k, k + 1 (both < K or neither)
        const T* src = xt + k * p.ldx + c;
        uint2 u0 = make_uint2(0u, 0u), u1 = make_uint2(0u, 0u);
        if (k < p.K) {
          if (full) {
            u0 = *reinterpret_cast<const uint2*>(src);
            u1 = *reinterpret_cast<const uint2*>(src + p.ldx);
          } else {
            u0.x = ld_bits(src, 0, ok[0]) | (ld_bits(src, 1, ok[1]) << 16);
            u0.y = ld_bits(src, 2, ok[2]) | (ld_bits(src, 3, ok[3]) << 16);
            u1.x = ld_bits(src + p.ldx, 0, ok[0]) | (ld_bits(src + p.ldx, 1, ok[1]) << 16);
            u1.y = ld_bits(src + p.ldx, 2, ok[2]) | (ld_bits(src + p.ldx, 3, ok[3]) << 16);
          }
        }
        // (row k, row k + 1) of each column, row k in the low half
        b[4 * hh + 0][h] = __byte_perm(u0.x, u1.x, 0x5410);
        b[4 * hh + 1][h] = __byte_perm(u0.x, u1.x, 0x7632);
        b[4 * hh + 2][h] = __byte_perm(u0.y, u1.y, 0x5410);
        b[4 * hh + 3][h] = __byte_perm(u0.y, u1.y, 0x7632);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void store4(T* dst, const float (&v)[4], bool vec,
                                       int64_t left) {
  if (vec && left >= 4) {
    if constexpr (std::is_same_v<T, float>) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
      *reinterpret_cast<uint2*>(dst) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                     *reinterpret_cast<const uint32_t*>(&hi));
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < left) dst[i] = from_f32<T>(v[i]);
  }
}

// The A operand of one k-step and M block: pass 0, and pass 1 where the
// block's flag is set; float32 split into TF32 high and low parts.
struct Frag {
  uint32_t hi[2][2], lo[2][2], e[2];
};

template <typename T>
__device__ __forceinline__ Frag load_frag(const Tables& tb, const Params& p, int ks,
                                          int mb, bool two, int g, int t) {
  Frag f{};
  a_fragment(tb, p, 0, ks, mb, g, t, f.hi[0], f.e[0]);
  if (two) a_fragment(tb, p, 1, ks, mb, g, t, f.hi[1], f.e[1]);
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float v = __uint_as_float(f.hi[q][r]);
        f.hi[q][r] = tf32_cvt(v);
        f.lo[q][r] = tf32_cvt(v - __uint_as_float(f.hi[q][r]));
      }
    }
  }
  return f;
}

// d += one k-step's product with the B fragment (b0, b1) of an n-block
template <typename T>
__device__ __forceinline__ void mma_kstep(float (&d)[4], const Frag& f, bool two,
                                          uint32_t b0, uint32_t b1) {
  if constexpr (sizeof(T) == 4) {
    const float x0 = __uint_as_float(b0), x1 = __uint_as_float(b1);
    const uint32_t h0 = tf32_cvt(x0), h1 = tf32_cvt(x1);
    const uint32_t l0 = tf32_cvt(x0 - __uint_as_float(h0));
    const uint32_t l1 = tf32_cvt(x1 - __uint_as_float(h1));
    // this k-step's sum in a fresh accumulator, added in float32: the
    // tensor cores' own accumulation truncates
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (q == 1 && !two) break;
      mma_sp_tf32(acc, f.lo[q][0], f.lo[q][1], h0, h1, f.e[q]);
      mma_sp_tf32(acc, f.hi[q][0], f.hi[q][1], l0, l1, f.e[q]);
      mma_sp_tf32(acc, f.hi[q][0], f.hi[q][1], h0, h1, f.e[q]);
    }
#pragma unroll
    for (int v = 0; v < 4; ++v) d[v] += acc[v];
  } else {
    mma_sp_bf16(d, f.hi[0][0], f.hi[0][1], b0, b1, f.e[0]);
    if (two) mma_sp_bf16(d, f.hi[1][0], f.hi[1][1], b0, b1, f.e[1]);
  }
}

// D of n-block j, tiles mode: d0, d1 = row g, tiles t0 + 8j + 2t, + 1;
// d2, d3 = row g + 8.  y is (tiles, M) rows.
template <typename T>
__device__ __forceinline__ void store_tiles(T* y, const Params& p, int64_t t0,
                                            int j, int mb, int g, int t,
                                            const float (&d)[4]) {
  const int64_t tile = t0 + 8 * j + 2 * t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = 16 * mb + g + 8 * h;
    if (m >= p.M) continue;
    if (tile < p.tiles) y[tile * p.M + m] = from_f32<T>(d[2 * h]);
    if (tile + 1 < p.tiles) y[(tile + 1) * p.M + m] = from_f32<T>(d[2 * h + 1]);
  }
}

// D of n-blocks 4hh .. 4hh + 3, columns mode: row g's fragment columns 2t
// and 2t + 1 are columns c0 + 32 hh + 8t + jj and + 4 + jj of n-block
// 4hh + jj, so a lane holds 8 adjacent columns of a row (and of row g + 8)
template <typename T>
__device__ __forceinline__ void store_cols(T* y, const Params& p, int64_t tile,
                                           int64_t c0, int hh, int mb, int g,
                                           int t, const float (*d)[4]) {
  const int64_t c = c0 + 32 * hh + 8 * t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = 16 * mb + g + 8 * h;
    if (m >= p.M) continue;
    T* row = y + (tile * p.M + m) * p.N;
    const float v0[4] = {d[0][2 * h], d[1][2 * h], d[2][2 * h], d[3][2 * h]};
    const float v1[4] = {d[0][2 * h + 1], d[1][2 * h + 1], d[2][2 * h + 1],
                         d[3][2 * h + 1]};
    if (c < p.N) store4(row + c, v0, p.vec_st, p.N - c);
    if (c + 4 < p.N) store4(row + c + 4, v1, p.vec_st, p.N - c - 4);
  }
}

// kKS = 1 or 2: exactly that many k-steps (the paper suite's operands), all
// B fragments of an item in registers before the first mma, each n-block's
// sum kept only until it is stored, and B read once for every M block;
// fewer registers, so more warps hold loads in flight (3 blocks an SM with
// one k-step, 2 with two: tighter bounds spill, and were slower on the
// H100).  kKS = 0: any number of k-steps, the B fragments of one k-step at
// a time and the sums of all n-blocks kept across k-steps.
template <typename T, int kMode, int kKS>
__global__ void __launch_bounds__(kWarps * 32, kKS == 1 ? 3 : kKS == 2 ? 2 : 1)
sptc_spmm_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Tables tb = tables(smem_raw, p);
  build_tables<T>(p, tb);

  const T* x = static_cast<const T*>(p.x);
  T* y = static_cast<T*>(p.y);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  for (int64_t it = static_cast<int64_t>(blockIdx.x) * kWarps + warp; it < p.items;
       it += static_cast<int64_t>(gridDim.x) * kWarps) {
    // tiles mode: tiles t0 .. t0 + 8 kNB - 1; columns mode: one tile's
    // columns c0 .. c0 + 8 kNB - 1
    const int64_t tile = kMode == kTiles ? it * 8 * kNB : it / p.col_blocks;
    const int64_t c0 = kMode == kTiles ? 0 : it % p.col_blocks * 8 * kNB;
    const T* xt = x + tile * p.stx;
    auto load_b = [&](uint32_t (&b)[kNB][2], int ks) {
      if constexpr (kMode == kTiles) load_b_tiles<T>(b, p, tile, ks, g, t);
      else load_b_cols<T>(b, p, xt, c0, ks, g, t);
    };
    if constexpr (kKS > 0) {
      uint32_t b[kKS][kNB][2];               // every load of the item first
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) load_b(b[ks], ks);
      for (int mb = 0; mb < p.mb_count; ++mb) {
        const bool two = tb.flags[mb] != 0;
        Frag f[kKS];
#pragma unroll
        for (int ks = 0; ks < kKS; ++ks) f[ks] = load_frag<T>(tb, p, ks, mb, two, g, t);
#pragma unroll
        for (int hh = 0; hh < kNB / 4; ++hh) {
          float d[4][4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = 4 * hh + jj;
            d[jj][0] = d[jj][1] = d[jj][2] = d[jj][3] = 0.f;
#pragma unroll
            for (int ks = 0; ks < kKS; ++ks)
              mma_kstep<T>(d[jj], f[ks], two, b[ks][j][0], b[ks][j][1]);
            if constexpr (kMode == kTiles) store_tiles(y, p, tile, j, mb, g, t, d[jj]);
          }
          if constexpr (kMode == kCols) store_cols(y, p, tile, c0, hh, mb, g, t, d);
        }
      }
    } else {
      for (int mb = 0; mb < p.mb_count; ++mb) {
        const bool two = tb.flags[mb] != 0;
        float d[kNB][4];
#pragma unroll
        for (int j = 0; j < kNB; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
        for (int ks = 0; ks < p.nks; ++ks) {
          uint32_t b[kNB][2];                // every load of the k-step first
          load_b(b, ks);
          const Frag f = load_frag<T>(tb, p, ks, mb, two, g, t);
#pragma unroll
          for (int j = 0; j < kNB; ++j) mma_kstep<T>(d[j], f, two, b[j][0], b[j][1]);
        }
#pragma unroll
        for (int hh = 0; hh < kNB / 4; ++hh) {
          if constexpr (kMode == kTiles) {
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              store_tiles(y, p, tile, 4 * hh + jj, mb, g, t, d[4 * hh + jj]);
          } else {
            store_cols(y, p, tile, c0, hh, mb, g, t, d + 4 * hh);
          }
        }
      }
    }
  }
}

// Shared memory of one block (kernels/sptc_spmm/kernel.py::table_bytes).
inline size_t table_bytes(const Params& p) {
  const size_t cells = 2 * static_cast<size_t>(p.nks) * p.M;
  return cells * 16 + 4 * static_cast<size_t>(p.mb_count) + cells * 2;
}

template <typename T, int kMode, int kKS>
int launch(const Params& p, cudaStream_t stream) {
  // persistent blocks: the prologue runs once per block
  return launch_persistent(sptc_spmm_kernel<T, kMode, kKS>, kWarps * 32,
                           table_bytes(p), (p.items + kWarps - 1) / kWarps,
                           SmemOptIn::kPastDefault, stream, p);
}

template <typename T, int kMode>
int launch_ks(const Params& p, cudaStream_t s) {
  if (p.nks == 1) return launch<T, kMode, 1>(p, s);
  if (p.nks == 2) return launch<T, kMode, 2>(p, s);
  return launch<T, kMode, 0>(p, s);
}

template <typename T>
int launch_mode(Params p, cudaStream_t s) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p.x);
  if (p.N == 1) {
    p.items = (p.tiles + 8 * kNB - 1) / (8 * kNB);
    // bf16: a lane's two adjacent positions as one 4-byte load
    p.vec_ld = sizeof(T) == 2 && p.ldx == 1 && p.stx % 2 == 0 && addr % 4 == 0;
    return launch_ks<T, kTiles>(p, s);
  }
  p.col_blocks = (p.N + 8 * kNB - 1) / (8 * kNB);
  p.items = p.tiles * p.col_blocks;
  // four adjacent columns as one 16-byte (float32) or 8-byte (bf16) load,
  // and four outputs as one store
  p.vec_ld = p.ldx % 4 == 0 && p.stx % 4 == 0 && addr % (4 * sizeof(T)) == 0;
  p.vec_st = p.N % 4 == 0;
  return launch_ks<T, kCols>(p, s);
}

}  // namespace v1
}  // namespace spider

// vals: (M, kh) contiguous, same dtype as x; meta: (M, kh) int32 contiguous;
// x: (tiles, K, N) with tile stride stx, row stride ldx and unit column
// stride, K = 2*kh; y: (tiles, M, N) contiguous.
extern "C" int spider_sptc_spmm(const void* vals, const void* meta,
                                const void* x, void* y, int64_t M, int64_t kh,
                                int64_t N, int64_t ldx, int64_t stx,
                                int64_t tiles, int dtype, void* stream) {
  using namespace spider;
  using namespace spider::v1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || kh < 1 || N < 1 || tiles < 1 ||
      (dtype != kFloat32 && dtype != kBFloat16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t K = 2 * kh, k_step = dtype == kFloat32 ? 8 : 16;
  Params p{vals, static_cast<const int32_t*>(meta), x, y, tiles, N, ldx, stx,
           0, 1, static_cast<int>(M), static_cast<int>(kh), static_cast<int>(K),
           static_cast<int>((K + k_step - 1) / k_step),
           static_cast<int>((M + 15) / 16), false, false};
  if (dtype == kFloat32) return launch_mode<float>(p, s);
  return launch_mode<__nv_bfloat16>(p, s);
}
