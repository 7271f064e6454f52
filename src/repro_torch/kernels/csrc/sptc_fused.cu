// Fused SpTC stencil application: window read -> strided swap in the load
// addressing -> 2-bit metadata unpacked from the packed words -> dot.
//
// Replaces the TPU kernel src/repro/kernels/sptc_spmm/kernel.py::_fused_kernel
// (pallas_call in _sptc_fused_jit).
//
// Bound on the H100: bytes.  Per output the kernel does K/2 = L multiply-adds
// and moves one input and one output element, 2*L FLOP per 8 bytes in float32:
// far below the card's 20 FLOP/byte float32 ridge, so the floor is
// (bytes in + bytes out) / 3.35 TB/s.
//
// Design: this is the simple first version.  One thread per (row tile t,
// column c), c fastest so a warp reads consecutive columns.  Each thread
// writes the L outputs of its tile.  The compressed values and the decoded
// source row of every slot (metadata unpack + closed-form swap, both done
// here, in the kernel) are staged once per block in shared memory; window
// rows are read straight from device memory and reused through L1.  Rows past
// the end of the input read as zero, so the caller pads nothing.  No tensor
// cores yet: mma.sp / wgmma.sp, TMA and warp specialisation come later.
#include "common.cuh"

namespace spider {

// window position p of a tile holds source row perm[p]; the strided-swap
// permutation exchanges the halves at odd positions (an involution)
__device__ __forceinline__ int strided_swap(int p, int L) {
  return (p & 1) ? (p < L ? p + L : p - L) : p;
}

template <typename T, bool kStarFast, bool kBf16Compute>
__global__ void __launch_bounds__(kThreads)
sptc_fused_kernel(const T* __restrict__ x, T* __restrict__ y,
                  const T* __restrict__ vals,
                  const int32_t* __restrict__ meta_words, int64_t rows,
                  int64_t C, int64_t ld, int64_t n_out, int L, int kh,
                  int nwords) {
  extern __shared__ float smem[];
  float* s_vals = smem;                                   // (L, kh)
  int* s_src = reinterpret_cast<int*>(smem + L * kh);     // (L, kh)
  for (int i = threadIdx.x; i < L * kh; i += blockDim.x) {
    const int m = i / kh, j = i - (i / kh) * kh;
    float v = to_f32(vals[i]);
    if (kBf16Compute) v = round_bf16(v);
    s_vals[i] = v;
    int src;
    if (kStarFast) {
      // banded layout: slot j of row m reads window row m + j, no metadata
      src = m + j;
    } else {
      const uint32_t word = static_cast<uint32_t>(meta_words[m * nwords + j / 16]);
      const int meta = (word >> (2 * (j % 16))) & 3;
      src = strided_swap(4 * (j / 2) + meta, L);
    }
    s_src[i] = src;
  }
  __syncthreads();

  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t tiles = (n_out + L - 1) / L;
  if (idx >= tiles * C) return;
  const int64_t t = idx / C;
  const int64_t c = idx - t * C;
  const int64_t base = t * L;
  for (int m = 0; m < L && base + m < n_out; ++m) {
    float acc = 0.f;
    for (int j = 0; j < kh; ++j) {
      const int64_t row = base + s_src[m * kh + j];
      float xv = row < rows ? to_f32(x[row * ld + c]) : 0.f;
      if (kBf16Compute) xv = round_bf16(xv);
      acc = fmaf(s_vals[m * kh + j], xv, acc);
    }
    y[(base + m) * C + c] = from_f32<T>(acc);
  }
}

template <typename T, bool kStarFast, bool kBf16Compute>
void launch(const void* x, void* y, const void* vals, const void* meta_words,
            int64_t rows, int64_t C, int64_t ld, int64_t n_out, int64_t L,
            int64_t kh, int64_t nwords, cudaStream_t stream) {
  const int64_t tiles = (n_out + L - 1) / L;
  const size_t smem = static_cast<size_t>(L * kh) * (sizeof(float) + sizeof(int));
  sptc_fused_kernel<T, kStarFast, kBf16Compute>
      <<<grid_for(tiles * C), kThreads, smem, stream>>>(
          static_cast<const T*>(x), static_cast<T*>(y),
          static_cast<const T*>(vals), static_cast<const int32_t*>(meta_words),
          rows, C, ld, n_out, static_cast<int>(L), static_cast<int>(kh),
          static_cast<int>(nwords));
}

template <typename T>
void launch_dtype(int star_fast, int bf16_compute, const void* x, void* y,
                  const void* vals, const void* meta_words, int64_t rows,
                  int64_t C, int64_t ld, int64_t n_out, int64_t L, int64_t kh,
                  int64_t nwords, cudaStream_t s) {
  if (star_fast && bf16_compute)
    launch<T, true, true>(x, y, vals, meta_words, rows, C, ld, n_out, L, kh, nwords, s);
  else if (star_fast)
    launch<T, true, false>(x, y, vals, meta_words, rows, C, ld, n_out, L, kh, nwords, s);
  else if (bf16_compute)
    launch<T, false, true>(x, y, vals, meta_words, rows, C, ld, n_out, L, kh, nwords, s);
  else
    launch<T, false, false>(x, y, vals, meta_words, rows, C, ld, n_out, L, kh, nwords, s);
}

}  // namespace spider

// x: (rows, C) with row stride ld and unit column stride; y: (n_out, C)
// contiguous; vals: (L, kh) contiguous, same dtype as x; meta_words:
// (L, nwords) int32 view of the packed uint32 metadata words.
extern "C" int spider_sptc_fused(const void* x, void* y, const void* vals,
                                 const void* meta_words, int64_t rows,
                                 int64_t C, int64_t ld, int64_t n_out,
                                 int64_t L, int64_t kh, int64_t nwords,
                                 int star_fast, int bf16_compute, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == spider::kFloat32)
    spider::launch_dtype<float>(star_fast, bf16_compute, x, y, vals, meta_words,
                                rows, C, ld, n_out, L, kh, nwords, s);
  else if (dtype == spider::kBFloat16)
    spider::launch_dtype<__nv_bfloat16>(star_fast, bf16_compute, x, y, vals,
                                        meta_words, rows, C, ld, n_out, L, kh,
                                        nwords, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* spider_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
