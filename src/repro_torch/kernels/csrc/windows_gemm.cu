// Dense windows GEMM: (T, 2L, C) input windows times the banded (L, 2L)
// kernel matrix gives (T, L, C), accumulated in float32.
//
// Replaces the TPU kernel src/repro/kernels/stencil_gemm/kernel.py::_gemm_kernel
// (pallas_call in _windows_gemm_jit).
//
// Bound on the H100: bytes.  Per output the kernel does 2L multiply-adds and
// moves two window elements (the windows hold every input row twice) and one
// output element: 4*L FLOP per 12 bytes in float32, under the card's 20
// FLOP/byte float32 ridge for every L the engine uses, so the floor is
// (window bytes + matrix bytes + output bytes) / 3.35 TB/s.
//
// Design: this is the simple first version.  One thread per (tile t, column
// c), c fastest, computing the L outputs of its tile; the kernel matrix is
// staged in shared memory as float32 and the window column is re-read through
// L1.  The windows are gathered outside the kernel, as the reference does;
// folding the window read in, and the tensor cores, come later.
#include "common.cuh"

namespace spider {

template <typename T>
__global__ void __launch_bounds__(kThreads)
windows_gemm_kernel(const T* __restrict__ km, const T* __restrict__ win,
                    T* __restrict__ y, int64_t tiles, int L, int K, int64_t C) {
  extern __shared__ float s_km[];                         // (L, K)
  for (int i = threadIdx.x; i < L * K; i += blockDim.x) s_km[i] = to_f32(km[i]);
  __syncthreads();

  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= tiles * C) return;
  const int64_t t = idx / C;
  const int64_t c = idx - t * C;
  const T* w = win + t * K * C + c;
  T* out = y + t * L * C + c;
  for (int m = 0; m < L; ++m) {
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc = fmaf(s_km[m * K + k], to_f32(w[k * C]), acc);
    out[m * C] = from_f32<T>(acc);
  }
}

template <typename T>
void launch(const void* km, const void* win, void* y, int64_t tiles, int64_t L,
            int64_t K, int64_t C, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(L * K) * sizeof(float);
  windows_gemm_kernel<T><<<grid_for(tiles * C), kThreads, smem, stream>>>(
      static_cast<const T*>(km), static_cast<const T*>(win), static_cast<T*>(y),
      tiles, static_cast<int>(L), static_cast<int>(K), C);
}

}  // namespace spider

// km: (L, K) contiguous; win: (tiles, K, C) contiguous; y: (tiles, L, C)
// contiguous; all of one dtype.
extern "C" int spider_windows_gemm(const void* km, const void* win, void* y,
                                   int64_t tiles, int64_t L, int64_t K,
                                   int64_t C, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == spider::kFloat32)
    spider::launch<float>(km, win, y, tiles, L, K, C, s);
  else if (dtype == spider::kBFloat16)
    spider::launch<__nv_bfloat16>(km, win, y, tiles, L, K, C, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
