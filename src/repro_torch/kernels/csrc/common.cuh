// Shared helpers for the SPIDER Hopper kernels: storage-type loads and
// stores with float32 arithmetic, and the launch shape used by every kernel.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace spider {

// dtype codes shared with the Python wrappers (kernels/build.py)
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// round a float32 value to bfloat16 precision and back
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

inline unsigned int grid_for(int64_t threads) {
  return static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
}

// Helpers of the sparse tensor-core kernels that stage their input with
// cp.async (sptc_rows2d.cu, sptc_star2d.cu).
namespace sptc {

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// window position p holds source column swap(p): odd p < L <-> p + L
__device__ __forceinline__ int strided_swap(int p, int L) {
  return (p & 1) ? (p < L ? p + L : p - L) : p;
}

// float32 -> TF32 bits, to nearest with ties away from zero (as
// cvt.rna.tf32.f32 for finite values), in two integer instructions
__device__ __forceinline__ uint32_t tf32_big(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
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

// cp.async of kBytes (4, 8 or 16) from src: `bytes` of them read, the rest
// zero-filled
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                 :: "r"(s), "l"(src), "n"(kBytes), "r"(bytes));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// two staged bfloat16 elements as one register (low half first)
__device__ __forceinline__ uint32_t ld_bf16x2(const __nv_bfloat16* b, int off0,
                                              int off1) {
  const uint16_t* h = reinterpret_cast<const uint16_t*>(b);
  return static_cast<uint32_t>(h[off0]) | (static_cast<uint32_t>(h[off1]) << 16);
}

}  // namespace sptc

}  // namespace spider
