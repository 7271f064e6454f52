// Depthwise causal conv1d: y[b,t,d] = sum_k w[k,d] * x[b, t-K+1+k, d], with
// zero history before t = 0 and float32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/conv1d/kernel.py::_conv_kernel
// (pallas_call in _conv1d_jit), the short convolution of every Mamba2 block.
//
// Bound on the H100: bytes.  Per output the kernel does K multiply-adds and
// moves one input and one output element: for K = 4 in bf16, 8 FLOP per
// 4 bytes, far below the card's ridge, so the floor is
// (bytes in + bytes out) / 3.35 TB/s.
//
// Design: the simple first version.  One thread per channel d of one batch
// row b and one run of time steps; threads of a warp take neighbouring
// channels, so every load and store is coalesced (D is the innermost axis).
// The K weights of the channel and the last K-1 inputs live in registers, so
// each input is read once (plus K-1 history reads per run).  The TPU version
// pads D to 128 lanes and copies x with a left halo; here nothing is padded:
// reads before t = 0 are masked to zero, the ragged channel edge is masked,
// and x is read through its batch and time strides, so the model's column
// slice of the input projection (row stride 2*d_inner + 2*state + heads) is
// read in place.
#include "common.cuh"

namespace spider {

constexpr int kConvThreads = 128;   // channels per block
constexpr int64_t kConvRun = 64;    // time steps per thread
constexpr int kConvMaxTaps = 8;     // kernels/conv1d/kernel.py MAX_TAPS

template <typename T, int K>
__global__ void __launch_bounds__(kConvThreads)
conv1d_causal_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     T* __restrict__ y, int64_t Tlen, int64_t D, int64_t sb,
                     int64_t st, int64_t run) {
  const int64_t d = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t b = blockIdx.z;
  const int64_t t0 = static_cast<int64_t>(blockIdx.y) * run;
  if (d >= D || t0 >= Tlen) return;
  const int64_t t1 = t0 + run < Tlen ? t0 + run : Tlen;

  float wk[K];
#pragma unroll
  for (int k = 0; k < K; ++k) wk[k] = to_f32(w[k * D + d]);

  const T* xb = x + b * sb + d;
  T* yb = y + b * Tlen * D + d;
  // h[k] holds x[t - (K-1) + k]; the first K-1 come from before the run
  float h[K];
#pragma unroll
  for (int k = 0; k < K - 1; ++k) {
    const int64_t tt = t0 - (K - 1) + k;
    h[k] = tt >= 0 ? to_f32(xb[tt * st]) : 0.f;
  }
#pragma unroll 4
  for (int64_t t = t0; t < t1; ++t) {
    h[K - 1] = to_f32(xb[t * st]);
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) acc = fmaf(wk[k], h[k], acc);
    yb[t * D] = from_f32<T>(acc);
#pragma unroll
    for (int k = 0; k < K - 1; ++k) h[k] = h[k + 1];
  }
}

template <typename T, int K>
int launch_conv(const void* x, const void* w, void* y, int64_t B, int64_t Tlen,
                int64_t D, int64_t sb, int64_t st, cudaStream_t stream) {
  // a longer run per thread once the time axis outgrows the grid's y limit
  const int64_t run = (Tlen + 65534) / 65535 > kConvRun
                          ? (Tlen + 65534) / 65535 : kConvRun;
  const dim3 grid(static_cast<unsigned>((D + kConvThreads - 1) / kConvThreads),
                  static_cast<unsigned>((Tlen + run - 1) / run),
                  static_cast<unsigned>(B));
  conv1d_causal_kernel<T, K><<<grid, kConvThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      Tlen, D, sb, st, run);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_conv_taps(int64_t K, const void* x, const void* w, void* y,
                     int64_t B, int64_t Tlen, int64_t D, int64_t sb,
                     int64_t st, cudaStream_t s) {
  switch (K) {
    case 1: return launch_conv<T, 1>(x, w, y, B, Tlen, D, sb, st, s);
    case 2: return launch_conv<T, 2>(x, w, y, B, Tlen, D, sb, st, s);
    case 3: return launch_conv<T, 3>(x, w, y, B, Tlen, D, sb, st, s);
    case 4: return launch_conv<T, 4>(x, w, y, B, Tlen, D, sb, st, s);
    case 5: return launch_conv<T, 5>(x, w, y, B, Tlen, D, sb, st, s);
    case 6: return launch_conv<T, 6>(x, w, y, B, Tlen, D, sb, st, s);
    case 7: return launch_conv<T, 7>(x, w, y, B, Tlen, D, sb, st, s);
    case 8: return launch_conv<T, 8>(x, w, y, B, Tlen, D, sb, st, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace spider

// x: (B, T, D) with batch stride sb, time stride st and unit channel stride;
// w: (K, D) contiguous, same dtype as x; y: (B, T, D) contiguous.
extern "C" int spider_conv1d_causal(const void* x, const void* w, void* y,
                                    int64_t B, int64_t Tlen, int64_t D,
                                    int64_t sb, int64_t st, int64_t K,
                                    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K < 1 || K > spider::kConvMaxTaps || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == spider::kFloat32)
    return spider::launch_conv_taps<float>(K, x, w, y, B, Tlen, D, sb, st, s);
  if (dtype == spider::kBFloat16)
    return spider::launch_conv_taps<__nv_bfloat16>(K, x, w, y, B, Tlen, D, sb,
                                                   st, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
