// Every row operand of a 2-D stencil in one pass on Hopper's sparse tensor
// cores:
//
//   y[b, i, tL + m] = sum_u sum_p A_u[m, p] * x[b, i + lead_u, tL + swap(p)]
//
// for the R row ops of a "rows" decomposition (op u runs its 1-D operand
// A_u, the (L, 2L) strided-swapped 2:4 matrix, along the last axis of the
// input rows shifted by lead_u).  x is the raw haloed (B, H + 2r, W + 2r)
// grid with any batch and row stride and a unit column stride, read where
// it lies; y the (B, H, W) interior, written once: any batch and row
// stride and a unit column stride, so a contiguous tensor or the interior of
// the next step's haloed grid.
//
// Replaces no TPU kernel: the reference runs one pallas_call per row op
// (src/repro/kernels/sptc_spmm/kernel.py::_fused_kernel) on a transposed
// copy of the input slice and adds the R results.  On the card that glue
// moved the grid about ten times a step for work that needs one read and
// one write, so this kernel applies the whole row decomposition itself.
//
// Bound on the H100: bytes.  Per output the product needs R * 2L
// multiply-adds of which R * L are non-zero, on one input and one output
// element: far below the tensor cores' ridge, so the floor is
// (bytes in + bytes out) / 3.35 TB/s.
//
// Design.  The work is cut into runs: 64 output rows of one job x T tiles
// of L outputs along W.  A run's input rows [i0, i0 + 64 + 2r) x columns
// [t0 L, (t0 + T + 1) L) are staged in shared memory once (zero-filled past
// the input's end), so the overlapping windows and the 2r halo rows are
// read from device memory once per run.  Each warp copies whole rows with
// cp.async copies as wide as the input's alignment allows, two runs ahead
// through a ring of three buffers.  mma.sp takes M as the L outputs of a
// tile, K as its 2L window positions (the strided swap folded into the B
// load address, as in sptc_fused.cu) and N as 8 output rows; for row op u
// the B operand comes from the staged rows shifted by lead_u, and all R
// operands add into the same float32 accumulators.  Each warp takes a tile
// and its eight 8-row slabs at once (eight independent accumulators); the
// operands' A fragments are split once per block into shared memory and
// read per (op, k-step), which every (L, R) fits.  Routes:
//   * float32: mma.sp.m16n8k8.tf32 on the pair-aligned 1:2 operand, as
//     3xTF32; with L <= 8 the low parts of A ride rows 8-15 of the M block
//     (two instructions a k-step, the halves of D summed at the end).  B is
//     split as big = x rounded to TF32 and small = x - big rounded to TF32,
//     each by integer arithmetic (as cvt.rna.tf32.f32 for finite values):
//     the split of sptc_fused.cu;
//   * bfloat16: mma.sp.m16n8k16.bf16 on the 2:4 operand.
// The sums are float32, rounded once to the storage type and stored from
// the fragments: each store instruction writes a tile's columns in four
// rows.
#include "common.cuh"

namespace spider {
namespace rows2d {

using namespace sptc;

constexpr int kRouteTF32 = 0;    // float32 storage, 3xTF32
constexpr int kRouteBF16 = 1;    // bfloat16 storage
constexpr int kWarps = 8;
constexpr int kSlabs = 8;        // 8-row slabs a warp computes at once
constexpr int kRunRows = 8 * kSlabs;   // output rows per run
constexpr int kColTarget = 128;  // output columns per run (about)
constexpr int kStages = 3;       // staged runs: one computed, two copied
constexpr int kMaxL = 16;        // one 16-row M block
constexpr int kMaxR = 16;        // row ops (4-bit leads in one int64)

// tiles per run: about kColTarget outputs, a multiple of the warps
__host__ __device__ constexpr int tiles_per_run(int L) {
  return kColTarget / L / kWarps * kWarps > kWarps
             ? kColTarget / L / kWarps * kWarps : kWarps;
}

__host__ __device__ constexpr int k_steps(int L, int route) {
  return route == kRouteTF32 ? (2 * L + 7) / 8 : (2 * L + 15) / 16;
}

// Elements a staged row of L needs: (T + 1) L columns after a shift of up
// to one 16-byte copy, rounded to whole copies, and a zero column where the
// k-steps run past 2L.
template <typename T>
__host__ __device__ constexpr int staged_need(int L, int route) {
  const int v = 16 / static_cast<int>(sizeof(T));
  const int cols = (tiles_per_run(L) + 1) * L + v - 1;
  const int k_step = route == kRouteTF32 ? 8 : 16;
  return (cols + v - 1) / v * v + ((2 * L) % k_step != 0 ? 1 : 0);
}

// Row stride, in elements, of the staged rows for every L that takes kKS
// k-steps: 16-byte rows whose 4-byte word stride is 4 mod 8, so the eight
// B rows of a fragment fall in distinct banks.
template <typename T>
__host__ __device__ constexpr int staged_stride(int kKS, int route) {
  int need = 0;
  for (int L = 2; L <= kMaxL; L += 2)
    if (k_steps(L, route) == kKS && staged_need<T>(L, route) > need)
      need = staged_need<T>(L, route);
  const int size = static_cast<int>(sizeof(T));
  const int words = (need * size + 3) / 4;
  return ((words + 3) / 8 * 8 + 4) * 4 / size;
}

struct Params {
  const void* x;
  void* y;
  const uint32_t* a;       // (R, nks, 2, 32) A fragment words
  const uint32_t* e;       // (R, nks, 32) metadata words
  int64_t B, H, W, rows_in, cols_in, sb, ld, lead_bits;
  int64_t ob, oh;          // output batch and row strides
  int64_t tiles, row_blocks, col_blocks, runs;
  int L, R, nks, halo, tiles_per_run;
  int vec, shift, row_vecs;   // bytes a copy, elements, copies a staged row
};

// wait until this thread's copies leave at most one run in flight
__device__ __forceinline__ void cp_async_wait_ahead() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 2));
}

// run -> (job, row block, column block), column blocks fastest
__device__ __forceinline__ void locate(const Params& p, int64_t run,
                                       int64_t& b, int64_t& rb, int64_t& cb) {
  cb = run % p.col_blocks;
  const int64_t rest = run / p.col_blocks;
  rb = rest % p.row_blocks;
  b = rest / p.row_blocks;
}

// Each warp copies whole staged rows, kBytes a copy (2: plain copies): a
// row inside the input with full copies and no arithmetic, a row at its
// edge clamped copy by copy.
template <typename T, int kS, int kBytes>
__device__ void stage_rows(T* s, const T* x, const Params& p, int64_t row0,
                           int64_t col0) {
  constexpr int V = kBytes / static_cast<int>(sizeof(T));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t left0 = p.cols_in - col0;     // input columns from col0 on
  const T* const dummy = x - p.shift;         // aligned; nothing is read
  const bool inside = left0 >= p.row_vecs * V;
  for (int r = warp; r < kRunRows + p.halo; r += kWarps) {
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
// [row0, row0 + 64 + halo) x columns [col0, col0 + (T + 1) L) of job b, row
// stride kS in shared memory, column c of a row at p.shift + c, zero past
// the input's end.  Each copy moves p.vec bytes from an address aligned to
// them: the rows and jobs of the input all lie p.shift elements past that
// alignment, so every staged row does too, and the B loads of the eight
// rows of a fragment stay in distinct banks.
template <typename T, int kS>
__device__ void stage_run(T* s, const Params& p, int64_t run) {
  int64_t b, rb, cb;
  locate(p, run, b, rb, cb);
  const T* x = static_cast<const T*>(p.x) + b * p.sb;
  const int64_t row0 = rb * kRunRows;
  const int64_t col0 = cb * p.tiles_per_run * p.L - p.shift;
  switch (p.vec) {
    case 16: stage_rows<T, kS, 16>(s, x, p, row0, col0); break;
    case 8: stage_rows<T, kS, 8>(s, x, p, row0, col0); break;
    case 4: stage_rows<T, kS, 4>(s, x, p, row0, col0); break;
    default: stage_rows<T, kS, 2>(s, x, p, row0, col0); break;
  }
  cp_async_commit();
}

template <typename T, int kRoute, int kKS>
__global__ void __launch_bounds__(kWarps * 32)
sptc_rows2d_kernel(const Params p) {
  constexpr int kS = staged_stride<T>(kKS, kRoute);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int buf_elems = (kRunRows + p.halo) * kS;
  T* const bufs = reinterpret_cast<T*>(smem_raw);      // kStages buffers
  // per (op, k-step, lane): A words {hi0, hi1, lo0, lo1}, then the metadata
  uint4* const s_a = reinterpret_cast<uint4*>(bufs + kStages * buf_elems);
  uint32_t* const s_e = reinterpret_cast<uint32_t*>(s_a + p.R * kKS * 32);
  T* const y = static_cast<T*>(p.y);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int L = p.L, K2 = 2 * L;
  // TF32 with L <= 8 (two k-steps or fewer): rows 8-15 of the M block are
  // padding, so they carry the low parts of rows 0-7 (same metadata) and
  // one mma.sp covers A_hi and A_lo; the two halves of D are summed at the
  // end
  constexpr bool stacked = kRoute == kRouteTF32 && kKS <= 2;

  int64_t run = blockIdx.x;
  // the first kStages - 1 runs' copies
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    const int64_t r = run + static_cast<int64_t>(i) * gridDim.x;
    if (r < p.runs) stage_run<T, kS>(bufs + i * buf_elems, p, r);
    else cp_async_commit();
  }
  // where the k-steps run past 2L, the last column of every staged row is
  // never copied to: zero, read by the K padding
  if (K2 % (kRoute == kRouteTF32 ? 8 : 16) != 0)
    for (int i = threadIdx.x; i < kStages * (kRunRows + p.halo); i += blockDim.x)
      bufs[(i + 1) * kS - 1] = from_f32<T>(0.f);

  // the operands' A fragments, split once (visible after the loop's first
  // __syncthreads)
  for (int i = threadIdx.x; i < p.R * kKS * 32; i += blockDim.x) {
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
  // bf16 m16n8k16 k = 2t, 2t + 1, 2t + 8, 2t + 9.  Position >= 2L is K
  // padding (-1), read from the zero column.
  constexpr int kB = kRoute == kRouteTF32 ? 2 : 4;
  int src[kKS][kB];
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks) {
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      const int pos = kRoute == kRouteTF32 ? ks * 8 + t + 4 * j
                                           : ks * 16 + 2 * t + (j & 1) + 8 * (j >> 1);
      src[ks][j] = pos < K2 ? strided_swap(pos, L) : -1;
    }
  }

  // run i is computed from buffer i % 3 while runs i + 1 and i + 2 are
  // copied into the other two (one commit group a run, empty past the end)
  for (int i = 0; run < p.runs; run += gridDim.x, ++i) {
    cp_async_wait_ahead();
    __syncthreads();                        // run i staged; buffer i - 1 free
    const int64_t ahead = run + static_cast<int64_t>(kStages - 1) * gridDim.x;
    if (ahead < p.runs)
      stage_run<T, kS>(bufs + (i + kStages - 1) % kStages * buf_elems, p, ahead);
    else
      cp_async_commit();
    const T* const s = bufs + i % kStages * buf_elems;
    int64_t b, rb, cb;
    locate(p, run, b, rb, cb);
    const int64_t row0 = rb * kRunRows;
    const int64_t tile0 = cb * p.tiles_per_run;
    const int t_run = static_cast<int>(min64(p.tiles_per_run, p.tiles - tile0));
    for (int q = warp; q < t_run; q += kWarps) {
      // staged offsets of the B rows from this tile's first column
      int off[kKS][kB];
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks)
#pragma unroll
        for (int j = 0; j < kB; ++j)
          off[ks][j] = src[ks][j] >= 0 ? src[ks][j] : kS - 1 - p.shift - q * L;
      // every slab is computed (the staged rows past the input are zero);
      // the stores keep the rows inside the output
      // TF32: each row op is summed on the tensor cores into e from zero,
      // its low parts' products first, as sptc_fused.cu sums it, and then
      // added to d in float32, as the per-RowOp loop adds the ops (the
      // tensor cores' sums truncate, so a small product is never added to
      // another op's large sum there); bfloat16 sums every op in d
      float d[kSlabs][4], e[kSlabs][4];
#pragma unroll
      for (int j = 0; j < kSlabs; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) d[j][k] = 0.f;
#pragma unroll 1
      for (int u = 0; u < p.R; ++u) {
        const int lead = static_cast<int>((p.lead_bits >> (4 * u)) & 15);
        // lane's B column: output row 8 j + g of the slab, its input row
        // shifted by the op's lead
        const T* bu = s + (lead + g) * kS + p.shift + q * L;
        if constexpr (kRoute == kRouteTF32) {
#pragma unroll
          for (int j = 0; j < kSlabs; ++j)
#pragma unroll
            for (int k = 0; k < 4; ++k) e[j][k] = 0.f;
        }
#pragma unroll
        for (int ks = 0; ks < kKS; ++ks) {
          const int f = (u * kKS + ks) * 32 + lane;
          const uint4 a = s_a[f];
          const uint32_t meta = s_e[f];
#pragma unroll
          for (int j = 0; j < kSlabs; ++j) {
            const T* bj = bu + 8 * j * kS;
            if constexpr (kRoute == kRouteTF32) {
              const float x0 = to_f32(bj[off[ks][0]]), x1 = to_f32(bj[off[ks][1]]);
              const uint32_t h0 = tf32_int(x0), h1 = tf32_int(x1);
              const uint32_t l0 = tf32_int(x0 - __uint_as_float(h0));
              const uint32_t l1 = tf32_int(x1 - __uint_as_float(h1));
              if constexpr (!stacked) mma_sp_tf32(e[j], a.z, a.w, h0, h1, meta);
              mma_sp_tf32(e[j], a.x, a.y, l0, l1, meta);
              mma_sp_tf32(e[j], a.x, a.y, h0, h1, meta);
            } else {
              const uint32_t b0 = ld_bf16x2(bj, off[ks][0], off[ks][1]);
              const uint32_t b1 = ld_bf16x2(bj, off[ks][2], off[ks][3]);
              mma_sp_bf16(d[j], a.x, a.y, b0, b1, meta);
            }
          }
        }
        // D: e0, e1 = output column g of the tile, rows 2t, 2t + 1 of the
        // slab; e2, e3 = column g + 8 (stacked: the low part's products of
        // column g)
        if constexpr (kRoute == kRouteTF32) {
#pragma unroll
          for (int j = 0; j < kSlabs; ++j) {
            if constexpr (stacked) {
              d[j][0] += e[j][0] + e[j][2];
              d[j][1] += e[j][1] + e[j][3];
            } else {
#pragma unroll
              for (int k = 0; k < 4; ++k) d[j][k] += e[j][k];
            }
          }
        }
      }
#pragma unroll
      for (int h = 0; h < (stacked ? 1 : 2); ++h) {
        const int m = g + 8 * h;
        const int64_t col = (tile0 + q) * L + m;
        if (m >= L || col >= p.W) continue;
        const int64_t row = row0 + 2 * t;
        T* yq = y + b * p.ob + row * p.oh + col;
#pragma unroll
        for (int j = 0; j < kSlabs; ++j, yq += 8 * p.oh) {
          if (row + 8 * j < p.H) yq[0] = from_f32<T>(d[j][2 * h]);
          if (row + 8 * j + 1 < p.H) yq[p.oh] = from_f32<T>(d[j][2 * h + 1]);
        }
      }
    }
  }
}

template <typename T, int kRoute, int kKS>
int launch(Params p, cudaStream_t stream) {
  constexpr int kS = staged_stride<T>(kKS, kRoute);
  const int64_t size = sizeof(T);
  p.tiles_per_run = tiles_per_run(p.L);
  p.vec = widest_copy(size, p.ld, p.B, p.sb);
  const int V = p.vec / static_cast<int>(size);
  p.shift = static_cast<int>(reinterpret_cast<uintptr_t>(p.x) / size % V);
  const int cols = (p.tiles_per_run + 1) * p.L;
  p.row_vecs = (p.shift + cols + V - 1) / V;
  if (staged_need<T>(p.L, kRoute) > kS) return static_cast<int>(cudaErrorInvalidValue);
  p.tiles = (p.W + p.L - 1) / p.L;
  p.row_blocks = (p.H + kRunRows - 1) / kRunRows;
  p.col_blocks = (p.tiles + p.tiles_per_run - 1) / p.tiles_per_run;
  p.runs = p.B * p.row_blocks * p.col_blocks;
  const size_t smem =
      kStages * static_cast<size_t>(kRunRows + p.halo) * kS * sizeof(T) +
      static_cast<size_t>(p.R) * kKS * 32 * (sizeof(uint4) + 4);
  // persistent blocks, each walking runs
  return launch_persistent(sptc_rows2d_kernel<T, kRoute, kKS>, kWarps * 32, smem,
                           p.runs, SmemOptIn::kAlwaysCarveout, stream, p);
}

}  // namespace rows2d
}  // namespace spider

// x: (B, H + halo, W + halo) with batch stride sb, row stride ld and unit
// column stride; y: (B, H, W) with batch stride ob, row stride oh and unit
// column stride; a, e: the R row operands' per-lane
// fragment tables of the route stacked on the leading axis (R, nks, 2, 32)
// and (R, nks, 32) (kernels/sptc_spmm/fragments.py, one 16-row M block
// each); lead_bits: op u's row offset in bits [4u, 4u + 4).  route 0:
// float32 storage as 3xTF32; route 1: bfloat16 storage.
extern "C" int spider_sptc_rows2d(const void* x, void* y, const void* a,
                                  const void* e, int64_t B, int64_t H,
                                  int64_t W, int64_t sb, int64_t ld,
                                  int64_t ob, int64_t oh, int64_t halo,
                                  int64_t L, int64_t R, int64_t lead_bits,
                                  int64_t nks, int route, int dtype,
                                  void* stream) {
  using namespace spider::rows2d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok = L >= 2 && L % 2 == 0 && L <= kMaxL && R >= 1 && R <= kMaxR &&
            halo >= 0 && halo <= 15 && (route == kRouteTF32 || route == kRouteBF16) &&
            nks == k_steps(static_cast<int>(L), route) && B >= 1 && H >= 1 && W >= 1;
  for (int64_t u = 0; ok && u < R; ++u) ok = ((lead_bits >> (4 * u)) & 15) <= halo;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  Params p{x, y, static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(e),
           B, H, W, H + halo, W + halo, sb, ld, lead_bits, ob, oh,
           0, 0, 0, 0, static_cast<int>(L), static_cast<int>(R),
           static_cast<int>(nks), static_cast<int>(halo), 0, 0, 0, 0};
  if (dtype == spider::kFloat32 && route == kRouteTF32) {
    switch (nks) {
      case 1: return launch<float, kRouteTF32, 1>(p, s);
      case 2: return launch<float, kRouteTF32, 2>(p, s);
      case 3: return launch<float, kRouteTF32, 3>(p, s);
      case 4: return launch<float, kRouteTF32, 4>(p, s);
    }
  }
  if (dtype == spider::kBFloat16 && route == kRouteBF16) {
    switch (nks) {
      case 1: return launch<__nv_bfloat16, kRouteBF16, 1>(p, s);
      case 2: return launch<__nv_bfloat16, kRouteBF16, 2>(p, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
