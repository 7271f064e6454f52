// Direct 2-D stencil: (B, H + 2rh, W + 2rw) -> (B, H, W) by shifted
// multiply-adds over the non-zero taps only, accumulated in float32.
//
// Replaces the TPU kernel src/repro/kernels/stencil_direct/kernel.py::
// _stencil_kernel (pallas_call in _stencil2d_jit).
//
// Bound on the H100: bytes for every stencil of the paper suite.  Per output
// the kernel does one multiply-add per non-zero tap (at most 49, box r = 3)
// and moves one input and one output element: at most 98 FLOP per 8 bytes in
// float32, about 12 FLOP/byte, under the card's 20 FLOP/byte float32 ridge.
// The floor is (bytes in + bytes out) / 3.35 TB/s.
//
// Design: this is the simple first version.  One thread per output, the
// column fastest so a warp reads consecutive addresses; the taps (u, v, w)
// sit in a small device buffer that every block stages in shared memory, and
// the halo reads of neighbouring threads are served by L1.  The ragged edge
// needs no padding: each thread reads only inside the haloed input.  A
// leading batch axis takes the place of vmap, so 3-D stencils run slab by
// slab through the same kernel.
#include "common.cuh"

namespace spider {

template <typename T>
__global__ void __launch_bounds__(kThreads)
stencil2d_kernel(const T* __restrict__ x, T* __restrict__ y,
                 const int32_t* __restrict__ tap_u,
                 const int32_t* __restrict__ tap_v,
                 const float* __restrict__ tap_w, int ntaps, int64_t B,
                 int64_t H, int64_t W, int64_t sb, int64_t sh) {
  extern __shared__ float s_w[];                          // (ntaps,)
  int64_t* s_off = reinterpret_cast<int64_t*>(s_w + 2 * ((ntaps + 1) / 2));
  for (int k = threadIdx.x; k < ntaps; k += blockDim.x) {
    s_w[k] = tap_w[k];
    s_off[k] = tap_u[k] * sh + tap_v[k];
  }
  __syncthreads();

  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= B * H * W) return;
  const int64_t b = idx / (H * W);
  const int64_t rem = idx - b * (H * W);
  const int64_t h = rem / W;
  const int64_t w = rem - h * W;
  const T* xp = x + b * sb + h * sh + w;
  float acc = 0.f;
  for (int k = 0; k < ntaps; ++k) acc = fmaf(s_w[k], to_f32(xp[s_off[k]]), acc);
  y[idx] = from_f32<T>(acc);
}

template <typename T>
void launch(const void* x, void* y, const void* tap_u, const void* tap_v,
            const void* tap_w, int64_t ntaps, int64_t B, int64_t H, int64_t W,
            int64_t sb, int64_t sh, cudaStream_t stream) {
  // weights padded to an even count so the int64 offsets stay 8-byte aligned
  const size_t smem = static_cast<size_t>(2 * ((ntaps + 1) / 2)) * sizeof(float) +
                      static_cast<size_t>(ntaps) * sizeof(int64_t);
  stencil2d_kernel<T><<<grid_for(B * H * W), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y),
      static_cast<const int32_t*>(tap_u), static_cast<const int32_t*>(tap_v),
      static_cast<const float*>(tap_w), static_cast<int>(ntaps), B, H, W, sb, sh);
}

}  // namespace spider

// x: (B, H + 2rh, W + 2rw) with batch stride sb, row stride sh and unit
// column stride; y: (B, H, W) contiguous; tap_u, tap_v: (ntaps,) int32 row
// and column offsets; tap_w: (ntaps,) float32 weights.
extern "C" int spider_stencil2d(const void* x, void* y, const void* tap_u,
                                const void* tap_v, const void* tap_w,
                                int64_t ntaps, int64_t B, int64_t H, int64_t W,
                                int64_t sb, int64_t sh, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == spider::kFloat32)
    spider::launch<float>(x, y, tap_u, tap_v, tap_w, ntaps, B, H, W, sb, sh, s);
  else if (dtype == spider::kBFloat16)
    spider::launch<__nv_bfloat16>(x, y, tap_u, tap_v, tap_w, ntaps, B, H, W, sb, sh, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
