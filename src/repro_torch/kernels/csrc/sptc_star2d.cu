// Both axis operands of a 2-D star stencil in one pass on Hopper's sparse
// tensor cores:
//
//   y[b, i, tL + m] += sum_p A_1[m, p] * x[b, i + r, tL + swap(p)]
//   y[b, tL + m, j] += sum_p A_0[m, p] * x[b, tL + swap(p), j + r]
//
// SPIDER's star decomposition (paper §3.2.1): A_0 is the leading axis's
// 1-D operand (centre tap zeroed), A_1 the last axis's (centre kept), each
// the (L, 2L) strided-swapped 2:4 matrix of its axis.  x is the raw haloed
// (B, H + 2r, W + 2r) grid with any batch and row stride and a unit column
// stride, read where it lies; y the (B, H, W) interior, written once: any
// batch and row stride and a unit column stride, so a contiguous tensor or
// the interior of the next step's haloed grid.
//
// Replaces no TPU kernel: the reference runs one pallas_call per axis
// (src/repro/kernels/sptc_spmm/kernel.py::_fused_kernel), the last axis's on
// a transposed copy of its slice, and adds the two results into a
// zero-filled accumulator.  On the card that glue moved the grid about nine
// times a step for work that needs one read and one write, so this kernel
// applies both axes itself.
//
// Bound on the H100: bytes.  Per output the product needs 2 * 2L
// multiply-adds of which 2L are non-zero, on one input and one output
// element: far below the tensor cores' ridge, so the floor is
// (bytes in + bytes out) / 3.35 TB/s.
//
// Design.  The work is cut into runs of RH output rows x CW output columns
// of one job, RH a multiple of L and of 8, CW one of L and of 32
// (run_rows, run_cols: 32-56 x 96-224).  A run's input rows [i0, i0 + RH +
// L) x columns [j0, j0 + CW + L) are staged in shared memory once (zero
// past the input's end) by cp.async copies as wide as the input's
// alignment allows, one run ahead of the compute through two buffers (a
// third, as sptc_rows2d.cu keeps, was 0-7 % slower: it leaves room for two
// blocks an SM, not three).  Both operands then read the same staged tile:
//   * the last axis (op 1): M = the L outputs of a column tile, K = its 2L
//     window positions along the row (the strided swap folded into the B
//     load's column), N = 8 output rows; a warp takes a tile and every
//     8-row slab of the run at once;
//   * the leading axis (op 0): M = the L outputs of a row tile, K = its 2L
//     window positions down the columns (the swap folded into the B load's
//     row), N = 8 output columns; a warp takes a row tile and four 8-column
//     blocks of a 32-column group at once.  Block v holds columns
//     4v + {0..3, 16..19} of the group: with a staged row stride of 4 mod 8
//     words the B loads of both ops and the sums' shared-memory traffic
//     fall in distinct banks.
// The two ops' accumulators cover the same outputs, transposed: op 1's
// sums are written to a float32 output tile in shared memory, and after a
// barrier op 0 adds its own sums to them (op 0's value + op 1's value, in
// float32, as the per-RowOp loop adds the two results).  After another,
// each warp stores whole rows of the tile, 16 bytes a lane where the row's
// address allows (elsewhere, such as every row of the interior of a haloed
// 10246-wide grid, 4 bytes a lane): the interior written once, in full
// sectors (storing from op 0's fragments instead took 7 % longer at L = 8
// and 14 % at L = 4, 4 % less at L = 6).  Each op is summed on the tensor cores exactly as sptc_fused.cu
// sums it (below), so in float32 the result equals the loop's bit for bit.
// Routes:
//   * float32: mma.sp.m16n8k8.tf32 on the pair-aligned 1:2 operand, as
//     3xTF32; with L <= 8 the low parts of A ride rows 8-15 of the M block
//     (two instructions a k-step, the halves of D summed at the end).  B is
//     split as big = x rounded to TF32 and small = x - big rounded to TF32;
//   * bfloat16: mma.sp.m16n8k16.bf16 on the 2:4 operand, rounded once.
#include "common.cuh"

namespace spider {
namespace star2d {

using namespace sptc;

constexpr int kRouteTF32 = 0;    // float32 storage, 3xTF32
constexpr int kRouteBF16 = 1;    // bfloat16 storage
constexpr int kWarps = 8;
constexpr int kGroup = 32;       // columns of op 0's four 8-column blocks
constexpr int kStages = 2;       // staged runs: one computed, one copied
constexpr int kSmemSM = 233472;  // an SM's shared memory on the H100

__host__ __device__ constexpr int gcd(int a, int b) { return b ? gcd(b, a % b) : a; }
__host__ __device__ constexpr int lcm(int a, int b) { return a / gcd(a, b) * b; }

// output rows a run: a multiple of L (op 0's row tiles) and of 8 (op 1's
// slabs), at least 32
__host__ __device__ constexpr int run_rows(int L) {
  return (32 + lcm(L, 8) - 1) / lcm(L, 8) * lcm(L, 8);
}

// output columns a run: a multiple of L (op 1's tiles) and of 32 (op 0's
// column groups), about 128
__host__ __device__ constexpr int run_cols(int L) {
  return lcm(L, kGroup) >= 96 ? lcm(L, kGroup)
                              : 128 / lcm(L, kGroup) * lcm(L, kGroup);
}

__host__ __device__ constexpr int k_steps(int L, int route) {
  return route == kRouteTF32 ? (2 * L + 7) / 8 : (2 * L + 15) / 16;
}

// Row stride, in elements, of the staged rows: CW + L columns after a
// shift of up to one 16-byte copy, rounded to whole copies, in 16-byte rows
// whose 4-byte word stride is 4 mod 8
template <typename T>
__host__ __device__ constexpr int staged_stride(int L) {
  const int size = static_cast<int>(sizeof(T));
  const int v = 16 / size;
  const int need = (run_cols(L) + L + v - 1 + v - 1) / v * v;
  const int words = (need * size + 3) / 4;
  return ((words + 3) / 8 * 8 + 4) * 4 / size;
}

// row stride of the float32 output tile: 4 mod 32 words
__host__ __device__ constexpr int out_stride(int L) { return run_cols(L) + 4; }

template <typename T>
__host__ __device__ constexpr int stage_bytes(int L) {
  return (run_rows(L) + L) * staged_stride<T>(L) * static_cast<int>(sizeof(T));
}

// the output tile and the split A fragments
template <int kRoute>
__host__ __device__ constexpr int fixed_bytes(int L) {
  return run_rows(L) * out_stride(L) * 4 + 2 * k_steps(L, kRoute) * 32 * (16 + 4);
}

template <typename T, int kRoute>
__host__ __device__ constexpr int smem_bytes(int L) {
  return kStages * stage_bytes<T>(L) + fixed_bytes<kRoute>(L);
}

// blocks an SM holds by shared memory (1 KB of it reserved a block): two
// or more where they fit, which caps the registers at 128 a thread
template <typename T, int kRoute>
__host__ __device__ constexpr int min_blocks(int L) {
  return 2 * (smem_bytes<T, kRoute>(L) + 1024) <= kSmemSM ? 2 : 1;
}

struct Params {
  const void* x;
  void* y;
  const uint32_t* a;       // (2, nks, 2, 32) A fragment words: op 0, op 1
  const uint32_t* e;       // (2, nks, 32) metadata words
  int64_t B, H, W, rows_in, cols_in, sb, ld;
  int64_t ob, oh;          // output batch and row strides
  int row_blocks, col_blocks, runs;   // 32-bit: a division a run is cheap
  int r;
  int vec, shift, row_vecs;   // bytes a copy, elements, copies a staged row
};

// run -> (job, row block, column block), column blocks fastest
__device__ __forceinline__ void locate(const Params& p, int run, int& b,
                                       int& rb, int& cb) {
  cb = run % p.col_blocks;
  const int rest = run / p.col_blocks;
  rb = rest % p.row_blocks;
  b = rest / p.row_blocks;
}

// Each warp copies whole staged rows, kBytes a copy (2: plain copies): a
// row inside the input with full copies and no arithmetic, a row at its
// edge clamped copy by copy.
template <typename T, int kS, int kRows, int kBytes>
__device__ void stage_rows(T* s, const T* x, const Params& p, int64_t row0,
                           int64_t col0) {
  constexpr int V = kBytes / static_cast<int>(sizeof(T));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t left0 = p.cols_in - col0;     // input columns from col0 on
  const T* const dummy = x - p.shift;         // aligned; nothing is read
  const bool inside = left0 >= p.row_vecs * V;
  for (int r = warp; r < kRows; r += kWarps) {
    const int64_t gr = row0 + r;
    const T* src = x + gr * p.ld + col0 + lane * V;
    T* dst = s + r * kS + lane * V;
    if constexpr (kBytes >= 4) {
      if (inside && gr < p.rows_in) {
        for (int c = 0; c < p.row_vecs * V - lane * V; c += 32 * V)
          cp_async<kBytes>(dst + c, src + c, kBytes);
        continue;
      }
    }
    src -= lane * V;
    dst -= lane * V;
    const int64_t left_row = gr < p.rows_in ? left0 : 0;
    for (int v = lane; v < p.row_vecs; v += 32) {
      const int c = v * V;
      const int64_t left = left_row - c;
      const int n = left <= 0 ? 0 : left >= V ? V : static_cast<int>(left);
      if constexpr (kBytes >= 4) {
        cp_async<kBytes>(dst + c, n > 0 ? src + c : dummy,
                         n * static_cast<int>(sizeof(T)));
      } else {
        dst[c] = n > 0 ? src[c] : from_f32<T>(0.f);
      }
    }
  }
}

// Start the copies of run `run` into buffer s (no wait): input rows
// [row0, row0 + RH + L) x columns [col0, col0 + CW + L) of job b, column c
// of a staged row at p.shift + c, zero past the input's end.  Each copy
// moves p.vec bytes from an address aligned to them: the rows and jobs of
// the input all lie p.shift elements past that alignment, so every staged
// row does too.
template <typename T, int L>
__device__ void stage_run(T* s, const Params& p, int run) {
  constexpr int kS = staged_stride<T>(L), kRows = run_rows(L) + L;
  int b, rb, cb;
  locate(p, run, b, rb, cb);
  const T* x = static_cast<const T*>(p.x) + b * p.sb;
  const int64_t row0 = rb * run_rows(L);
  const int64_t col0 = static_cast<int64_t>(cb) * run_cols(L) - p.shift;
  switch (p.vec) {
    case 16: stage_rows<T, kS, kRows, 16>(s, x, p, row0, col0); break;
    case 8: stage_rows<T, kS, kRows, 8>(s, x, p, row0, col0); break;
    case 4: stage_rows<T, kS, kRows, 4>(s, x, p, row0, col0); break;
    default: stage_rows<T, kS, kRows, 2>(s, x, p, row0, col0); break;
  }
  cp_async_commit();
}

// wait until this thread's copies have all landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// one k-step of one op on kN B columns: bj(n) the lane's B column of
// accumulator n, off the staged offsets of its window positions, ok[j]
// false where position j is K padding (read as zero; kPad: there is some)
template <typename T, int kRoute, bool kStacked, bool kPad, int kN, typename Col>
__device__ __forceinline__ void k_step(float (&e)[kN][4], const uint4 a,
                                       uint32_t meta, const int (&off)[4],
                                       const bool (&ok)[4], Col bj) {
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    const T* c = bj(n);
    if constexpr (kRoute == kRouteTF32) {
      float x0 = to_f32(c[off[0]]), x1 = to_f32(c[off[1]]);
      if constexpr (kPad) {
        x0 = ok[0] ? x0 : 0.f;
        x1 = ok[1] ? x1 : 0.f;
      }
      const uint32_t h0 = tf32_int(x0), h1 = tf32_int(x1);
      const uint32_t l0 = tf32_int(x0 - __uint_as_float(h0));
      const uint32_t l1 = tf32_int(x1 - __uint_as_float(h1));
      if constexpr (!kStacked) mma_sp_tf32(e[n], a.z, a.w, h0, h1, meta);
      mma_sp_tf32(e[n], a.x, a.y, l0, l1, meta);
      mma_sp_tf32(e[n], a.x, a.y, h0, h1, meta);
    } else {
      uint32_t b0 = ld_bf16x2(c, off[0], off[1]);
      uint32_t b1 = ld_bf16x2(c, off[2], off[3]);
      if constexpr (kPad) {
        b0 &= (ok[0] ? 0xFFFFu : 0u) | (ok[1] ? 0xFFFF0000u : 0u);
        b1 &= (ok[2] ? 0xFFFFu : 0u) | (ok[3] ? 0xFFFF0000u : 0u);
      }
      mma_sp_bf16(e[n], a.x, a.y, b0, b1, meta);
    }
  }
}

// an op's value of D element k (rows g, g + 8 of the M block, columns 2t,
// 2t + 1): stacked TF32 sums the low parts' half into the high one's
template <bool kStacked>
__device__ __forceinline__ float op_value(const float (&d)[4], int k) {
  if constexpr (kStacked) return d[k] + d[k + 2];
  return d[k];
}

// four sums to y, 4-element aligned, in the storage type
template <typename T>
__device__ __forceinline__ void store4(T* y, float4 v) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(y) = v;
  } else {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    *reinterpret_cast<uint2*>(y) = make_uint2(
        *reinterpret_cast<const uint32_t*>(&lo),
        *reinterpret_cast<const uint32_t*>(&hi));
  }
}

template <typename T, int kRoute, int L>
__global__ void __launch_bounds__(kWarps * 32, (min_blocks<T, kRoute>(L)))
sptc_star2d_kernel(const Params p) {
  constexpr int kKS = k_steps(L, kRoute);
  constexpr int kS = staged_stride<T>(L);
  constexpr int kSO = out_stride(L);
  constexpr int RH = run_rows(L), CW = run_cols(L);
  constexpr int kBufElems = (RH + L) * kS;
  constexpr int kSlabs = RH / 8;           // op 1: 8-row slabs of a run
  constexpr int kTiles = CW / L;           // op 1: column tiles of a run
  constexpr int kItems0 = RH / L * (CW / kGroup);   // op 0: (row tile, group)
  // TF32 with L <= 8 (two k-steps or fewer): rows 8-15 of the M block are
  // padding, so they carry the low parts of rows 0-7 (same metadata) and
  // one mma.sp covers A_hi and A_lo; the two halves of D are summed at the
  // end
  constexpr bool stacked = kRoute == kRouteTF32 && kKS <= 2;
  constexpr int kHalves = stacked || L <= 8 ? 1 : 2;
  constexpr int kB = kRoute == kRouteTF32 ? 2 : 4;
  constexpr bool kPad = 2 * L % (kRoute == kRouteTF32 ? 8 : 16) != 0;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const bufs = reinterpret_cast<T*>(smem_raw);            // kStages buffers
  float* const out = reinterpret_cast<float*>(bufs + kStages * kBufElems);
  // per (op, k-step, lane): A words {hi0, hi1, lo0, lo1}, then the metadata
  uint4* const s_a = reinterpret_cast<uint4*>(out + RH * kSO);
  uint32_t* const s_e = reinterpret_cast<uint32_t*>(s_a + 2 * kKS * 32);
  T* const y = static_cast<T*>(p.y);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  int run = blockIdx.x;
  if (run < p.runs) stage_run<T, L>(bufs, p, run);     // the first run's copies

  // the operands' A fragments, split once (visible after the loop's first
  // __syncthreads)
  for (int i = threadIdx.x; i < 2 * kKS * 32; i += blockDim.x) {
    const int f = i >> 5, l = i & 31;
    const uint32_t w0 = p.a[(f * 2) * 32 + l], w1 = p.a[(f * 2 + 1) * 32 + l];
    uint32_t m = p.e[f * 32 + l];
    uint4 v;
    if constexpr (kRoute == kRouteTF32) {
      const float f0 = __uint_as_float(w0), f1 = __uint_as_float(w1);
      const uint32_t h0 = tf32_int(f0), h1 = tf32_int(f1);
      const uint32_t l0 = tf32_int(f0 - __uint_as_float(h0));
      const uint32_t l1 = tf32_int(f1 - __uint_as_float(h1));
      if constexpr (stacked) {
        v = make_uint4(h0, l0, 0u, 0u);
        m = (m & 0xFFFFu) | (m << 16);
      } else {
        v = make_uint4(h0, h1, l0, l1);
      }
    } else {
      v = make_uint4(w0, w1, 0u, 0u);
    }
    s_a[i] = v;
    s_e[i] = m;
  }

  // window positions of this lane's B rows: tf32 m16n8k8 k = t, t + 4;
  // bf16 m16n8k16 k = 2t, 2t + 1, 2t + 8, 2t + 9.  A position >= 2L is K
  // padding, read as zero.  off1: op 1's staged column offsets; off0: op
  // 0's staged row offsets
  int off1[kKS][4], off0[kKS][4];
  bool ok[kKS][4];
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int pos = kRoute == kRouteTF32 ? ks * 8 + t + 4 * j
                                           : ks * 16 + 2 * t + (j & 1) + 8 * (j >> 1);
      ok[ks][j] = j < kB && pos < 2 * L;
      const int src = ok[ks][j] ? strided_swap(pos, L) : 0;
      off1[ks][j] = src;
      off0[ks][j] = src * kS;
    }
  }
  // op 0: the lane's B column in its group's block v is 4v + colg
  const int colg = (g & 3) + 16 * (g >> 2);

  // run i is computed from buffer i % 2 while run i + 1 is copied into the
  // other
  for (int i = 0; run < p.runs; run += gridDim.x, ++i) {
    cp_async_wait_all();
    __syncthreads();      // run i staged; buffer i - 1 and the tile free
    const int ahead = run + static_cast<int>(gridDim.x);
    if (ahead < p.runs) stage_run<T, L>(bufs + (i + 1) % 2 * kBufElems, p, ahead);
    const T* const s = bufs + i % 2 * kBufElems + p.shift;
    int b, rb, cb;
    locate(p, run, b, rb, cb);

    // op 1, the last axis: a column tile q and every slab; B column n of
    // slab j is output row 8j + n, its input row shifted by r
    for (int q = warp; q < kTiles; q += kWarps) {
      float e[kSlabs][4];
#pragma unroll
      for (int j = 0; j < kSlabs; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) e[j][k] = 0.f;
      const T* const base = s + (p.r + g) * kS + q * L;
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        const int f = (kKS + ks) * 32 + lane;
        k_step<T, kRoute, stacked, kPad, kSlabs>(
            e, s_a[f], s_e[f], off1[ks], ok[ks],
            [&](int j) { return base + 8 * j * kS; });
      }
      // D: e0, e1 = output column g (+ 8 in half 1) of the tile, rows 2t,
      // 2t + 1 of the slab
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
        const int m = g + 8 * h;
        if (m >= L) continue;
        float* o = out + 2 * t * kSO + q * L + m;
#pragma unroll
        for (int j = 0; j < kSlabs; ++j, o += 8 * kSO) {
          o[0] = op_value<stacked>(e[j], 2 * h);
          o[kSO] = op_value<stacked>(e[j], 2 * h + 1);
        }
      }
    }
    __syncthreads();      // op 1's sums in the tile

    // op 0, the leading axis: a row tile and the four blocks of a column
    // group; B column n of block v is column 4v + (n & 3) + 16 (n >> 2) of
    // the group, its input column shifted by r
    for (int it = warp; it < kItems0; it += kWarps) {
      const int tr = it / (CW / kGroup), grp = it % (CW / kGroup);
      float e[4][4];
#pragma unroll
      for (int v = 0; v < 4; ++v)
#pragma unroll
        for (int k = 0; k < 4; ++k) e[v][k] = 0.f;
      const T* const base = s + tr * L * kS + p.r + grp * kGroup + colg;
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        const int f = ks * 32 + lane;
        k_step<T, kRoute, stacked, kPad, 4>(
            e, s_a[f], s_e[f], off0[ks], ok[ks],
            [&](int v) { return base + 4 * v; });
      }
      // D: e0, e1 = output row g (+ 8 in half 1) of the tile, columns
      // 2t, 2t + 1 of the block: 4v + 2 (t & 1) + 16 (t >> 1) of the group
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
        const int m = g + 8 * h;
        if (m >= L) continue;
        float* o = out + (tr * L + m) * kSO + grp * kGroup + 2 * (t & 1) +
                   16 * (t >> 1);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          float2* o2 = reinterpret_cast<float2*>(o + 4 * v);
          const float2 s1 = *o2;
          *o2 = make_float2(op_value<stacked>(e[v], 2 * h) + s1.x,
                            op_value<stacked>(e[v], 2 * h + 1) + s1.y);
        }
      }
    }
    __syncthreads();      // both ops' sums in the tile

    // the interior, a warp a row: 16-byte stores (8 in bfloat16) where the
    // row's first address is a multiple of them and the tile lies inside it
    const int64_t col0 = static_cast<int64_t>(cb) * CW;
    const int n = static_cast<int>(min64(CW, p.W - col0));
    for (int row = warp; row < RH; row += kWarps) {
      const int64_t grow = static_cast<int64_t>(rb) * RH + row;
      if (grow >= p.H) break;
      const int64_t base = b * p.ob + grow * p.oh + col0;
      const float* o = out + row * kSO;
      if (n == CW &&
          reinterpret_cast<uintptr_t>(y + base) % (4 * sizeof(T)) == 0) {
        for (int c = 4 * lane; c < CW; c += 128)
          store4<T>(y + base + c, *reinterpret_cast<const float4*>(o + c));
      } else {
        for (int c = lane; c < n; c += 32) y[base + c] = from_f32<T>(o[c]);
      }
    }
  }
}

template <typename T, int kRoute, int L>
int launch(Params p, cudaStream_t stream) {
  const int64_t size = sizeof(T);
  p.vec = widest_copy(size, p.ld, p.B, p.sb);
  const int V = p.vec / static_cast<int>(size);
  p.shift = static_cast<int>(reinterpret_cast<uintptr_t>(p.x) / size % V);
  p.row_vecs = (p.shift + run_cols(L) + L + V - 1) / V;
  const int64_t row_blocks = (p.H + run_rows(L) - 1) / run_rows(L);
  const int64_t col_blocks = (p.W + run_cols(L) - 1) / run_cols(L);
  if (p.B * row_blocks * col_blocks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  p.row_blocks = static_cast<int>(row_blocks);
  p.col_blocks = static_cast<int>(col_blocks);
  p.runs = static_cast<int>(p.B * row_blocks * col_blocks);
  const size_t smem = smem_bytes<T, kRoute>(L);
  // persistent blocks, each walking runs
  return launch_persistent(sptc_star2d_kernel<T, kRoute, L>, kWarps * 32, smem,
                           p.runs, SmemOptIn::kAlwaysCarveout, stream, p);
}

template <typename T, int kRoute>
int launch_l(Params p, int64_t L, cudaStream_t s) {
  switch (L) {
    case 4: return launch<T, kRoute, 4>(p, s);
    case 6: return launch<T, kRoute, 6>(p, s);
    case 8: return launch<T, kRoute, 8>(p, s);
    case 10: return launch<T, kRoute, 10>(p, s);
    case 12: return launch<T, kRoute, 12>(p, s);
    case 14: return launch<T, kRoute, 14>(p, s);
    case 16: return launch<T, kRoute, 16>(p, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace star2d
}  // namespace spider

// x: (B, H + 2r, W + 2r) with batch stride sb, row stride ld and unit
// column stride; y: (B, H, W) with batch stride ob, row stride oh and unit
// column stride; a, e: the two axis operands'
// per-lane fragment tables of the route, the leading axis's first, (2, nks,
// 2, 32) and (2, nks, 32) (kernels/sptc_spmm/fragments.py, one 16-row M
// block each).  Even L from 2r + 2 to 16.  route 0: float32 storage as
// 3xTF32; route 1: bfloat16 storage.
extern "C" int spider_sptc_star2d(const void* x, void* y, const void* a,
                                  const void* e, int64_t B, int64_t H,
                                  int64_t W, int64_t sb, int64_t ld,
                                  int64_t ob, int64_t oh, int64_t r,
                                  int64_t L, int64_t nks, int route, int dtype,
                                  void* stream) {
  using namespace spider::star2d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = r >= 1 && L % 2 == 0 && 2 * r + 2 <= L && L <= 16 &&
                  (route == kRouteTF32 || route == kRouteBF16) &&
                  nks == k_steps(static_cast<int>(L), route) && B >= 1 &&
                  H >= 1 && W >= 1;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, y, static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(e),
           B, H, W, H + 2 * r, W + 2 * r, sb, ld, ob, oh, 0, 0, 0,
           static_cast<int>(r), 0, 0, 0};
  if (dtype == spider::kFloat32 && route == kRouteTF32)
    return launch_l<float, kRouteTF32>(p, L, s);
  if (dtype == spider::kBFloat16 && route == kRouteBF16)
    return launch_l<__nv_bfloat16, kRouteBF16>(p, L, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
