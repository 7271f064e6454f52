// Fused SpTC stencil application on Hopper's sparse tensor cores:
//
//   y[tL + m, c] = sum_p A[m, p] * x[tL + swap(p), c],  p < 2L
//
// A is the (L, 2L) strided-swapped operand (2:4, and 1:2 at pair
// granularity), x the raw haloed input; the strided swap is applied in the
// load addressing of the B fragments, so nothing is swapped or gathered in
// device memory (paper section 3.3).
//
// Replaces the TPU kernel src/repro/kernels/sptc_spmm/kernel.py::_fused_kernel
// (pallas_call in _sptc_fused_jit), which decompresses the operand to dense
// in VMEM and runs a dense MXU dot.
//
// Bound on the H100: bytes.  Per output the product needs 2L multiply-adds
// of which L are non-zero, on one input and one output element: far below
// the tensor cores' ridge, so the floor is (bytes in + bytes out) / 3.35 TB/s.
//
// Design.  The operand is the same for every tile, so it lives in
// registers: each warp loads the A fragments and metadata words of one
// 16-row M block once, from per-lane tables built on the host
// (kernels/sptc_spmm/fragments.py), and reuses them for every tile.  Only B
// streams.  The work is cut into runs of consecutive row tiles x a block of
// columns; a run's rows [t0 L, (t0 + T) L + L) are staged in shared memory,
// so the overlapping 2L-row windows are read from device memory once.  Each
// block walks runs through a ring of three buffers: cp.async copies of the
// next two runs fly while the warps compute on this one (zero-filled past
// the input's end; the K padding reads as zero).  Each warp takes a tile and runs mma.sp for all
// its 8-column slabs at once, so eight independent accumulators hide the
// instruction latency:
//   * float32: mma.sp.m16n8k8.tf32 on the pair-aligned 1:2 operand, as
//     3xTF32 (x and A split into a TF32 high part and a TF32 residual;
//     hi*hi + hi*lo + lo*hi keeps float32 accuracy);
//   * bfloat16 storage, or float32 with bfloat16 compute (rounded to
//     bfloat16 in the B-fragment load): mma.sp.m16n8k16.bf16 on the 2:4
//     operand, float32 sums.
// With one column (the 1-D path, x (N, 1)) the N axis of the instruction
// walks tiles instead of columns: B[k][n] = x[(t0 + n) L + swap(k)], and the
// outputs are staged in shared memory for a coalesced store.  Operands with
// L > 16 take several M blocks, one per group of warps.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace spider {

constexpr int kRouteTF32 = 0;    // float32 storage, 3xTF32
constexpr int kRouteBF16 = 1;    // bfloat16 storage or compute
constexpr int kWarps = 8;
constexpr int kColBlock = 64;    // columns a run stages (column mode)
constexpr int kColPad = 8;       // staged row padding: conflict-free B loads
constexpr int kRowTarget = 128;  // staged rows per run (column mode)
constexpr int kElems1D = 4096;   // staged elements per run (1-D mode)
constexpr int kSlabs = 8;        // 8-wide slabs a warp computes at once
constexpr int kStages = 3;       // staged runs: one computed, two in flight
constexpr int kMaxL = 80;        // the A fragments of kKS = 20 k-steps

struct FusedParams {
  const void* x;
  void* y;
  const uint32_t* a;       // (MB, nks, 2, 32) A fragment words
  const uint32_t* e;       // (MB, nks, 32) metadata words
  int64_t rows, C, ld, n_out, tiles;
  int64_t runs, col_blocks;
  int L, nks, mb_count, tiles_per_run, buf_elems;
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// bytes of a 16-byte vector of V elements inside [0, n) from element i
template <typename T>
__device__ __forceinline__ int vec_bytes(int64_t i, int64_t n) {
  constexpr int V = 16 / sizeof(T);
  const int64_t left = n - i;
  return (left <= 0 ? 0 : left >= V ? V : static_cast<int>(left)) * sizeof(T);
}

// window position p holds source row swap(p): odd p < L <-> p + L
__device__ __forceinline__ int strided_swap(int p, int L) {
  return (p & 1) ? (p < L ? p + L : p - L) : p;
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mma_sp_tf32(float (&d)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b0,
                                            uint32_t b1, uint32_t e) {
  asm("mma.sp::ordered_metadata.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6,%7}, {%0,%1,%2,%3}, %8, 0x0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "r"(b1), "r"(e));
}

__device__ __forceinline__ void mma_sp_bf16(float (&d)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b0,
                                            uint32_t b1, uint32_t e) {
  asm("mma.sp::ordered_metadata.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6,%7}, {%0,%1,%2,%3}, %8, 0x0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "r"(b1), "r"(e));
}

// cp.async of `bytes` (<= size) from src, the rest of the size zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait for the oldest of the kStages groups in flight
__device__ __forceinline__ void cp_async_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 1));
}

// Copy one staged element (zero unless `in`): cp.async for 4-byte types, a
// plain load for bfloat16 (cp.async moves 4 bytes at least).  `base` is a
// valid address for the zero-fill.
template <typename T>
__device__ __forceinline__ void stage_elem(T* dst, const T* src, bool in,
                                           const T* base) {
  if constexpr (sizeof(T) == 4) {
    cp_async4(dst, in ? src : base, in ? 4 : 0);
  } else {
    *dst = in ? *src : from_f32<T>(0.f);
  }
}

// Start the copies of run `run` into buffer s (no wait).  Column mode: rows
// [t0 L, t0 L + R) x columns [col0, col0 + 64) with row stride 64 + 8;
// 1-D mode: R consecutive rows of the single column.
template <typename T, bool kCols1>
__device__ void stage_run(T* s, const FusedParams& p, int64_t run) {
  const T* x = static_cast<const T*>(p.x);
  constexpr int V = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int64_t t0 = (run / p.col_blocks) * p.tiles_per_run;
  const int t_run = static_cast<int>(min64(p.tiles_per_run, p.tiles - t0));
  const int64_t row0 = t0 * p.L;
  if (kCols1) {
    // whole 8-tile slabs, so every B load of the last slab stays staged
    const int R = ((t_run + 7) / 8 * 8 + 1) * p.L;
    const int nv = aligned && p.ld == 1 && row0 % V == 0 ? R / V : 0;
    for (int i = threadIdx.x; i < nv; i += blockDim.x) {
      const int64_t gr = row0 + static_cast<int64_t>(i) * V;
      const int bytes = vec_bytes<T>(gr, p.rows);
      cp_async16(s + i * V, bytes > 0 ? x + gr : x, bytes);
    }
    for (int i = nv * V + threadIdx.x; i < R; i += blockDim.x) {
      const int64_t gr = row0 + i;
      stage_elem(s + i, x + gr * p.ld, gr < p.rows, x);
    }
  } else {
    const int64_t col0 = (run % p.col_blocks) * kColBlock;
    const int R = (t_run + 1) * p.L;
    constexpr int stride = kColBlock + kColPad;
    if (aligned && p.ld % V == 0) {
      constexpr int CV = kColBlock / V;
      for (int i = threadIdx.x; i < R * CV; i += blockDim.x) {
        const int r = i / CV, cv = i - r * CV;
        const int64_t gr = row0 + r, gc = col0 + cv * V;
        const int bytes = gr < p.rows ? vec_bytes<T>(gc, p.C) : 0;
        cp_async16(s + r * stride + cv * V, bytes > 0 ? x + gr * p.ld + gc : x,
                   bytes);
      }
    } else {                     // rows not 16-byte aligned: element copies
      for (int i = threadIdx.x; i < R * kColBlock; i += blockDim.x) {
        const int r = i / kColBlock, c = i - r * kColBlock;
        const int64_t gr = row0 + r, gc = col0 + c;
        stage_elem(s + r * stride + c, x + gr * p.ld + gc,
                   gr < p.rows && gc < p.C, x);
      }
    }
  }
  cp_async_commit();
}

// the B operand of one staged element, as float
template <typename T>
__device__ __forceinline__ float ld_f32(const T* b, int off) {
  return off < 0 ? 0.f : to_f32(b[off]);
}

// two staged elements as one bf16x2 register (low half first)
template <typename T>
__device__ __forceinline__ uint32_t ld_bf16x2(const T* b, int off0, int off1) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const uint16_t* h = reinterpret_cast<const uint16_t*>(b);
    const uint32_t lo = off0 < 0 ? 0u : h[off0], hi = off1 < 0 ? 0u : h[off1];
    return lo | (hi << 16);
  } else {                       // float32 storage, bfloat16 compute
    const __nv_bfloat162 v = __floats2bfloat162_rn(ld_f32(b, off0), ld_f32(b, off1));
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

template <typename T, int kRoute, bool kCols1, int kKS>
__global__ void __launch_bounds__(kWarps * 32)
sptc_mma_kernel(const FusedParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const bufs = reinterpret_cast<T*>(smem_raw);      // kStages buffers
  float* s_out = reinterpret_cast<float*>(bufs + kStages * p.buf_elems);
  T* y = static_cast<T*>(p.y);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int L = p.L, K2 = 2 * L;
  const int stride = kCols1 ? 1 : kColBlock + kColPad;
  const bool even_c = p.C % 2 == 0;                 // float2 / bf16x2 stores

  // start the first copies before the operand loads: run i of this block
  // goes to buffer i % kStages
  int64_t run = blockIdx.x;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    const int64_t r = run + static_cast<int64_t>(i) * gridDim.x;
    if (r < p.runs) stage_run<T, kCols1>(bufs + i * p.buf_elems, p, r);
    else cp_async_commit();
  }

  // -- the operand of this warp's M block, in registers ---------------------
  const int wpm = kWarps / p.mb_count;      // warps per M block
  const int mb = warp / wpm, wq = warp - mb * wpm;
  const bool active = mb < p.mb_count;
  // TF32 with L <= 8: rows 8-15 of the M block are padding, so they carry
  // the low parts of rows 0-7 (same metadata) and one mma.sp covers
  // A_hi and A_lo; the two halves of D are summed at the end
  const bool stacked = kRoute == kRouteTF32 && L <= 8;
  uint32_t a_hi[kKS][2], a_lo[kKS][2], meta[kKS];
  int off[kKS][4];                          // staged offsets of the B rows
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks) {
    a_hi[ks][0] = a_hi[ks][1] = a_lo[ks][0] = a_lo[ks][1] = meta[ks] = 0u;
    if (active && ks < p.nks) {
      const int f = mb * p.nks + ks;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const uint32_t w = p.a[(f * 2 + r) * 32 + lane];
        if constexpr (kRoute == kRouteTF32) {
          a_hi[ks][r] = to_tf32(__uint_as_float(w));
          a_lo[ks][r] = to_tf32(__uint_as_float(w) - __uint_as_float(a_hi[ks][r]));
        } else {
          a_hi[ks][r] = w;
        }
      }
      meta[ks] = p.e[f * 32 + lane];
      if (stacked) {
        a_hi[ks][1] = a_lo[ks][0];
        meta[ks] = (meta[ks] & 0xFFFFu) | (meta[ks] << 16);
      }
    }
    // B fragment rows of this lane: tf32 m16n8k8 k = t, t+4; bf16 m16n8k16
    // k = 2t, 2t+1, 2t+8, 2t+9.  Position >= 2L is K padding (-1: zero).
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int pos = kRoute == kRouteTF32 ? ks * 8 + t + 4 * j
                                           : ks * 16 + 2 * t + (j & 1) + 8 * (j >> 1);
      off[ks][j] = pos < K2 ? strided_swap(pos, L) * stride : -1;
    }
  }

  for (int i = 0; run < p.runs; run += gridDim.x, ++i) {
    // the copies of the next kStages - 1 runs fly while this one is computed
    const int64_t ahead = run + static_cast<int64_t>(kStages - 1) * gridDim.x;
    if (ahead < p.runs)
      stage_run<T, kCols1>(bufs + (i + kStages - 1) % kStages * p.buf_elems, p, ahead);
    else
      cp_async_commit();
    cp_async_wait_oldest();
    __syncthreads();
    const T* s = bufs + i % kStages * p.buf_elems;
    const int64_t t0 = (run / p.col_blocks) * p.tiles_per_run;
    const int t_run = static_cast<int>(min64(p.tiles_per_run, p.tiles - t0));
    const int64_t col0 = kCols1 ? 0 : (run % p.col_blocks) * kColBlock;
    // column mode: a group is one tile, its slabs 8-column blocks; 1-D
    // mode: a group is 8 slabs of 8 tiles each
    const int n_slabs = kCols1 ? (t_run + 7) / 8
                               : static_cast<int>(min64(kSlabs, (p.C - col0 + 7) / 8));
    const int groups = kCols1 ? (n_slabs + kSlabs - 1) / kSlabs : t_run;
    for (int q = wq; active && q < groups; q += wpm) {
      const int slabs = kCols1 ? min(kSlabs, n_slabs - q * kSlabs) : n_slabs;
      float d[kSlabs][4];
#pragma unroll
      for (int j = 0; j < kSlabs; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        if (ks >= p.nks) break;
#pragma unroll
        for (int j = 0; j < kSlabs; ++j) {
          if (j >= slabs) break;
          // lane's B column: tile 64 q + 8 j + g (1-D), column 8 j + g
          const T* b = kCols1 ? s + (kSlabs * 8 * q + 8 * j + g) * L
                              : s + q * L * stride + 8 * j + g;
          if constexpr (kRoute == kRouteTF32) {
            const float x0 = ld_f32(b, off[ks][0]), x1 = ld_f32(b, off[ks][1]);
            const uint32_t h0 = to_tf32(x0), h1 = to_tf32(x1);
            const uint32_t l0 = to_tf32(x0 - __uint_as_float(h0));
            const uint32_t l1 = to_tf32(x1 - __uint_as_float(h1));
            if (!stacked) mma_sp_tf32(d[j], a_lo[ks][0], a_lo[ks][1], h0, h1, meta[ks]);
            mma_sp_tf32(d[j], a_hi[ks][0], a_hi[ks][1], l0, l1, meta[ks]);
            mma_sp_tf32(d[j], a_hi[ks][0], a_hi[ks][1], h0, h1, meta[ks]);
          } else {
            const uint32_t b0 = ld_bf16x2(b, off[ks][0], off[ks][1]);
            const uint32_t b1 = ld_bf16x2(b, off[ks][2], off[ks][3]);
            mma_sp_bf16(d[j], a_hi[ks][0], a_hi[ks][1], b0, b1, meta[ks]);
          }
        }
      }
      // D: d0, d1 = row g, columns 2t, 2t+1; d2, d3 = row g + 8
      if (stacked) {
#pragma unroll
        for (int j = 0; j < kSlabs; ++j) {
          d[j][0] += d[j][2];
          d[j][1] += d[j][3];
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mb * 16 + g + 8 * h;
        if (m >= L) continue;
        if (kCols1) {
#pragma unroll
          for (int j = 0; j < kSlabs; ++j) {
            if (j >= slabs) break;
            const int tile = kSlabs * 8 * q + 8 * j + 2 * t;
            s_out[tile * L + m] = d[j][2 * h];
            s_out[(tile + 1) * L + m] = d[j][2 * h + 1];
          }
          continue;
        }
        const int64_t row = (t0 + q) * L + m;
        if (row >= p.n_out) continue;
        T* dst = y + row * p.C + col0 + 2 * t;
        const int64_t cols = p.C - col0 - 2 * t;      // columns left from dst
#pragma unroll
        for (int j = 0; j < kSlabs; ++j) {
          if (j >= slabs || 8 * j >= cols) break;
          if (even_c && 8 * j + 1 < cols) {
            if constexpr (std::is_same_v<T, float>) {
              *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(d[j][2 * h], d[j][2 * h + 1]);
            } else {
              *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
                  __floats2bfloat162_rn(d[j][2 * h], d[j][2 * h + 1]);
            }
          } else {
            dst[8 * j] = from_f32<T>(d[j][2 * h]);
            if (8 * j + 1 < cols) dst[8 * j + 1] = from_f32<T>(d[j][2 * h + 1]);
          }
        }
      }
    }
    if (kCols1) {                           // coalesced store of (T, L)
      __syncthreads();
      const int64_t row0 = t0 * L;
      for (int i = threadIdx.x; i < t_run * L; i += blockDim.x)
        if (row0 + i < p.n_out) y[row0 + i] = from_f32<T>(s_out[i]);
    }
    __syncthreads();                        // this buffer and s_out are free
  }
}

template <typename T, int kRoute, bool kCols1, int kKS>
int launch_mma(FusedParams p, cudaStream_t stream) {
  size_t smem;
  if (kCols1) {
    p.tiles_per_run = std::max(8, (kElems1D / p.L) / 8 * 8);
    p.buf_elems = ((p.tiles_per_run + 1) * p.L + 7) / 8 * 8;   // 16-byte multiple
    p.col_blocks = 1;
    smem = kStages * static_cast<size_t>(p.buf_elems) * sizeof(T) +
           static_cast<size_t>(p.tiles_per_run) * p.L * sizeof(float);
  } else {
    p.tiles_per_run = std::max(1, kRowTarget / p.L - 1);
    p.buf_elems = (p.tiles_per_run + 1) * p.L * (kColBlock + kColPad);
    p.col_blocks = (p.C + kColBlock - 1) / kColBlock;
    smem = kStages * static_cast<size_t>(p.buf_elems) * sizeof(T);
  }
  p.runs = (p.tiles + p.tiles_per_run - 1) / p.tiles_per_run * p.col_blocks;
  auto kernel = sptc_mma_kernel<T, kRoute, kCols1, kKS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kWarps * 32, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // persistent blocks, each walking runs through kStages buffers
  const int64_t blocks = std::min<int64_t>(p.runs, static_cast<int64_t>(sms) * per_sm);
  kernel<<<static_cast<unsigned>(blocks), kWarps * 32, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kRoute, bool kCols1>
int launch_ks(FusedParams p, cudaStream_t s) {
  if (p.nks <= 2) return launch_mma<T, kRoute, kCols1, 2>(p, s);
  if (p.nks <= 4) return launch_mma<T, kRoute, kCols1, 4>(p, s);
  return launch_mma<T, kRoute, kCols1, 20>(p, s);
}

template <typename T, int kRoute>
int launch_route(FusedParams p, cudaStream_t s) {
  return p.C == 1 ? launch_ks<T, kRoute, true>(p, s)
                  : launch_ks<T, kRoute, false>(p, s);
}

}  // namespace spider

// x: (rows, C) with row stride ld and unit column stride; y: (n_out, C)
// contiguous; a, e: the per-lane fragment tables of the route
// (kernels/sptc_spmm/fragments.py), nks k-steps each.  route 0: float32
// storage as 3xTF32; route 1: bfloat16 storage, or float32 storage with
// bfloat16 compute.
extern "C" int spider_sptc_fused(const void* x, void* y, const void* a,
                                 const void* e, int64_t rows, int64_t C,
                                 int64_t ld, int64_t n_out, int64_t L,
                                 int64_t nks, int route, int dtype,
                                 void* stream) {
  using namespace spider;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t k_step = route == kRouteTF32 ? 8 : 16;
  if (L < 2 || L % 2 || L > kMaxL || nks != (2 * L + k_step - 1) / k_step ||
      C < 1 || n_out < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  FusedParams p{x, y, static_cast<const uint32_t*>(a),
                static_cast<const uint32_t*>(e), rows, C, ld, n_out,
                (n_out + L - 1) / L, 0, 0, static_cast<int>(L),
                static_cast<int>(nks), static_cast<int>((L + 15) / 16), 0, 0};
  if (dtype == kFloat32 && route == kRouteTF32)
    return launch_route<float, kRouteTF32>(p, s);
  if (dtype == kFloat32 && route == kRouteBF16)
    return launch_route<float, kRouteBF16>(p, s);
  if (dtype == kBFloat16 && route == kRouteBF16)
    return launch_route<__nv_bfloat16, kRouteBF16>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* spider_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
