// Shared helpers for the SPIDER Hopper kernels: storage-type loads and
// stores with float32 arithmetic, the launch shape of the simple kernels,
// and the one copy of the tensor-core kernels' instructions, copies and
// persistent launch.
#pragma once

#include <cstdint>
#include <initializer_list>
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

// -- helpers of the tensor-core kernels (sptc_fused.cu, sptc_spmm.cu,
// sptc_rows2d.cu, sptc_star2d.cu, windows_gemm.cu) -------------------------

__host__ __device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// window position p holds source row (or column) swap(p): odd p < L <-> p + L
__device__ __forceinline__ int strided_swap(int p, int L) {
  return (p & 1) ? (p < L ? p + L : p - L) : p;
}

// float32 -> TF32 bits by cvt.rna.tf32.f32: to nearest, ties away from zero
__device__ __forceinline__ uint32_t tf32_cvt(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// float32 -> TF32 bits in two integer instructions: as tf32_cvt for finite
// values, not for infinities and NaNs
__device__ __forceinline__ uint32_t tf32_int(float v) {
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

// The widest copy (16, 8 or 4 bytes) from whose alignment every row and job
// of an input of `size`-byte elements lies the same number of elements: row
// stride ld, B jobs batch stride sb (in elements); `size` if none.
inline int widest_copy(int64_t size, int64_t ld, int64_t B, int64_t sb) {
  for (int v : {16, 8, 4})
    if (v > size && ld * size % v == 0 && (B == 1 || sb * size % v == 0)) return v;
  return static_cast<int>(size);
}

// How launch_persistent sets a kernel's shared-memory attributes
enum class SmemOptIn {
  kAlways,          // the dynamic limit raised to the block's bytes
  kPastDefault,     // raised only past the default 48 KB
  kAlwaysCarveout,  // raised, and the largest shared-memory carveout preferred
};

// Launch `kernel` on persistent blocks: as many of `threads` threads and
// `smem` bytes as the SMs hold at once, at most `work_items`, each block
// walking the work items.  Returns the CUDA status.
template <typename Kernel, typename... Args>
int launch_persistent(Kernel kernel, int threads, size_t smem, int64_t work_items,
                      SmemOptIn opt_in, cudaStream_t stream, const Args&... args) {
  cudaError_t err = cudaSuccess;
  if (opt_in != SmemOptIn::kPastDefault || smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess && opt_in == SmemOptIn::kAlwaysCarveout)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t blocks = min64(work_items, static_cast<int64_t>(sms) * per_sm);
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// Of the kernels that stage their input with cp.async (sptc_rows2d.cu,
// sptc_star2d.cu); sptc_fused.cu has its own ld_bf16x2 for both storage
// types.
namespace sptc {

// two staged bfloat16 elements as one register (low half first)
__device__ __forceinline__ uint32_t ld_bf16x2(const __nv_bfloat16* b, int off0,
                                              int off1) {
  const uint16_t* h = reinterpret_cast<const uint16_t*>(b);
  return static_cast<uint32_t>(h[off0]) | (static_cast<uint32_t>(h[off1]) << 16);
}

}  // namespace sptc

}  // namespace spider
