// Direct 2-D stencil: (B, H + 2rh, W + 2rw) -> (B, H, W) by shifted
// multiply-adds over the taps, accumulated in float32.  The output is any
// (B, H, W) view with a unit column stride: a contiguous tensor, or the
// interior of the next step's haloed grid.
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
// Design.  Each block stages an output tile plus its halo in shared memory
// (float32, from coalesced loads), so every input element is read from
// device memory about once.  The taps are
// template extents with the weights passed by value in the kernel's
// parameters, so each weight is an operand of its multiply-add and the tap
// loops unroll; star stencils skip the taps off the centre row and column
// at compile time.  Two tile shapes:
//   * tall (rh > 0): 32 x 64 outputs; each thread computes a strip of 8
//     outputs down one column and keeps a sliding window of 2rw + 1 staged
//     values in registers, so a staged value is read once per tap column,
//     not once per tap;
//   * flat (rh = 0, among them the 1-D path's single row): 1 x 1024 outputs,
//     four per thread, so a one-row input does not fill a tall tile with
//     padding.
// Ragged edges (odd W and H) are masked, never padded.  Index arithmetic
// inside a slab is 32-bit; the batch axis is gridDim.z (3-D stencils run
// slab by slab through the same kernel).
#include "common.cuh"

namespace spider {

constexpr int kMaxR = 3;                 // taps up to 7 x 7 (box r = 3)
constexpr int kTallH = 32, kTallW = 64, kStrip = 8;
constexpr int kFlatW = 1024, kFlatPer = kFlatW / kThreads;

struct DirectParams {
  const void* x;
  void* y;
  int64_t B, H, W, sb, sh;
  int64_t ob, oh;                          // output batch and row strides
  float w[(2 * kMaxR + 1) * (2 * kMaxR + 1)];   // (2rh+1, 2rw+1) row-major
};

template <typename T, int RH, int RW, bool STAR>
__global__ void __launch_bounds__(kThreads)
stencil2d_kernel(const DirectParams p) {
  constexpr int KH = 2 * RH + 1, KW = 2 * RW + 1;
  constexpr bool kFlat = RH == 0;
  constexpr int TH = kFlat ? 1 : kTallH, TW = kFlat ? kFlatW : kTallW;
  constexpr int SH = TH + 2 * RH, SW = TW + 2 * RW;     // staged tile
  __shared__ float s[SH * SW];
  const T* x = static_cast<const T*>(p.x);
  T* y = static_cast<T*>(p.y);
  const int H = static_cast<int>(p.H), W = static_cast<int>(p.W);
  const int h_in = H + 2 * RH, w_in = W + 2 * RW;
  const int tiles_h = (H + TH - 1) / TH;
  const int w0 = blockIdx.x * TW;

  for (int64_t b = blockIdx.z; b < p.B; b += gridDim.z) {
    const T* xb = x + b * p.sb;
    T* yb = y + b * p.ob;
    for (int th = blockIdx.y; th < tiles_h; th += gridDim.y) {
      const int h0 = th * TH;
      __syncthreads();                   // the previous tile is consumed
      for (int i = threadIdx.x; i < SH * SW; i += kThreads) {
        const int r = i / SW, c = i - r * SW;
        const int gr = h0 + r, gc = w0 + c;
        s[i] = gr < h_in && gc < w_in
                   ? to_f32(xb[static_cast<int64_t>(gr) * p.sh + gc]) : 0.f;
      }
      __syncthreads();

      if constexpr (kFlat) {
#pragma unroll
        for (int j = 0; j < kFlatPer; ++j) {
          const int c = threadIdx.x + kThreads * j;
          float acc = 0.f;
#pragma unroll
          for (int v = 0; v < KW; ++v) acc = fmaf(p.w[v], s[c + v], acc);
          if (h0 < H && w0 + c < W)
            yb[static_cast<int64_t>(h0) * p.oh + w0 + c] = from_f32<T>(acc);
        }
      } else {
        const int tx = threadIdx.x % TW, ty = threadIdx.x / TW;
        float acc[kStrip];
#pragma unroll
        for (int o = 0; o < kStrip; ++o) acc[o] = 0.f;
        // input row i of the strip feeds outputs o = i - u, tap row u
#pragma unroll
        for (int i = 0; i < kStrip + 2 * RH; ++i) {
          float val[KW];
          const float* row = s + (ty * kStrip + i) * SW + tx;
#pragma unroll
          for (int v = 0; v < KW; ++v) val[v] = row[v];
#pragma unroll
          for (int u = 0; u < KH; ++u) {
            const int o = i - u;
            if (o < 0 || o >= kStrip) continue;
#pragma unroll
            for (int v = 0; v < KW; ++v)
              if (!STAR || u == RH || v == RW)
                acc[o] = fmaf(p.w[u * KW + v], val[v], acc[o]);
          }
        }
        const int gw = w0 + tx;
#pragma unroll
        for (int o = 0; o < kStrip; ++o) {
          const int gh = h0 + ty * kStrip + o;
          if (gh < H && gw < W)
            yb[static_cast<int64_t>(gh) * p.oh + gw] = from_f32<T>(acc[o]);
        }
      }
    }
  }
}

template <typename T, int RH, int RW, bool STAR>
int launch_direct(const DirectParams& p, cudaStream_t stream) {
  constexpr int TH = RH == 0 ? 1 : kTallH, TW = RH == 0 ? kFlatW : kTallW;
  const int64_t gx = (p.W + TW - 1) / TW, gy = (p.H + TH - 1) / TH;
  if (gx > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(gx),
                  static_cast<unsigned>(gy < 65535 ? gy : 65535),
                  static_cast<unsigned>(p.B < 65535 ? p.B : 65535));
  stencil2d_kernel<T, RH, RW, STAR><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// (rh, rw, star) -> the kernel instantiated for those extents; star applies
// only where both radii are positive
template <typename T>
int launch_taps(int rh, int rw, bool star, const DirectParams& p,
                cudaStream_t s) {
#define SPIDER_CASE(RH, RW)                                                  \
  case RH * 4 + RW:                                                          \
    return (RH > 0 && RW > 0 && star)                                        \
               ? launch_direct<T, RH, RW, (RH > 0 && RW > 0)>(p, s)          \
               : launch_direct<T, RH, RW, false>(p, s);
  switch (rh * 4 + rw) {
    SPIDER_CASE(0, 0) SPIDER_CASE(0, 1) SPIDER_CASE(0, 2) SPIDER_CASE(0, 3)
    SPIDER_CASE(1, 0) SPIDER_CASE(1, 1) SPIDER_CASE(1, 2) SPIDER_CASE(1, 3)
    SPIDER_CASE(2, 0) SPIDER_CASE(2, 1) SPIDER_CASE(2, 2) SPIDER_CASE(2, 3)
    SPIDER_CASE(3, 0) SPIDER_CASE(3, 1) SPIDER_CASE(3, 2) SPIDER_CASE(3, 3)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SPIDER_CASE
}

}  // namespace spider

// x: (B, H + 2rh, W + 2rw) with batch stride sb, row stride sh and unit
// column stride; y: (B, H, W) with batch stride ob, row stride oh and unit
// column stride; weights: host (2rh+1, 2rw+1)
// float32 row-major, copied into the kernel's parameters; star: every
// non-zero weight lies on the centre row or column.  rh, rw <= 3; H and W
// below 2^31 - 8.
extern "C" int spider_stencil2d(const void* x, void* y, const float* weights,
                                int64_t rh, int64_t rw, int star, int64_t B,
                                int64_t H, int64_t W, int64_t sb, int64_t sh,
                                int64_t ob, int64_t oh, int dtype,
                                void* stream) {
  using namespace spider;
  if (rh < 0 || rw < 0 || rh > kMaxR || rw > kMaxR || B < 1 || H < 1 ||
      W < 1 || H + 2 * rh > 0x7FFFFFF0 || W + 2 * rw > 0x7FFFFFF0)
    return static_cast<int>(cudaErrorInvalidValue);
  DirectParams p{x, y, B, H, W, sb, sh, ob, oh, {}};
  for (int64_t i = 0; i < (2 * rh + 1) * (2 * rw + 1); ++i) p.w[i] = weights[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int r_h = static_cast<int>(rh), r_w = static_cast<int>(rw);
  if (dtype == kFloat32) return launch_taps<float>(r_h, r_w, star != 0, p, s);
  if (dtype == kBFloat16)
    return launch_taps<__nv_bfloat16>(r_h, r_w, star != 0, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
