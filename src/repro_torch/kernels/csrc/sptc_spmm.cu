// v1 compressed 2:4 SpMM (simulated sparse tensor core, mma.sp semantics):
//
//   y[t, m, n] = sum_j values[m, j] * x[t, 4*(j/2) + meta[m, j], n]
//
// per output row m and 4-wide reduction segment, only the 2 RHS rows that the
// 2-bit metadata selects contribute.  The RHS is pre-swapped by the caller.
//
// Replaces the TPU kernel src/repro/kernels/sptc_spmm/kernel.py::_sptc_kernel
// (pallas_call in _sptc_spmm_jit), the v1 building block behind the public
// entries sptc_spmm and sptc_spmm_windows.
//
// Bound on the H100: bytes.  Per output element the kernel does K/2
// multiply-adds and reads each RHS element once from device memory; with
// M <= 16 rows that is at most 2*M FLOP per input element, far below the
// float32 ridge of about 20 FLOP/byte, so the floor is
// (bytes in + bytes out) / 3.35 TB/s.
//
// Design: the simple first version, on CUDA cores.  One thread per column n
// (threads of a warp on neighbouring columns, so reads of x and writes of y
// are coalesced); each thread computes all M rows of its column for one tile.
// The TPU decompresses the operand to dense with a one-hot expansion and runs
// a dense MXU dot; here the compressed values and the decoded RHS row of
// every slot (4*(j/2) + meta) are staged once per block in shared memory and
// only the selected rows are read.  The windows form (T tiles) is a grid
// axis of the same launch.  No mma.sp yet: the tensor-core redesign is a
// later performance item.
#include "common.cuh"

namespace spider {

template <typename T>
__global__ void __launch_bounds__(kThreads)
sptc_spmm_kernel(const T* __restrict__ vals, const int32_t* __restrict__ meta,
                 const T* __restrict__ x, T* __restrict__ y, int M, int kh,
                 int64_t K, int64_t N, int64_t ldx, int64_t stx,
                 int64_t tiles) {
  extern __shared__ float smem[];
  float* s_vals = smem;                                   // (M, kh)
  int* s_row = reinterpret_cast<int*>(smem + M * kh);     // (M, kh)
  for (int i = threadIdx.x; i < M * kh; i += blockDim.x) {
    const int j = i % kh;
    s_vals[i] = to_f32(vals[i]);
    s_row[i] = 4 * (j / 2) + meta[i];
  }
  __syncthreads();

  const int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (n >= N) return;
  for (int64_t t = blockIdx.y; t < tiles; t += gridDim.y) {
    const T* xt = x + t * stx + n;
    T* yt = y + t * M * N + n;
    for (int m = 0; m < M; ++m) {
      float acc = 0.f;
      for (int j = 0; j < kh; ++j) {
        const int row = s_row[m * kh + j];
        // a metadata field outside [0, 4) selects nothing (the TPU kernel's
        // one-hot matches no row) instead of reading out of bounds
        const float xv = (row >= 0 && row < K) ? to_f32(xt[row * ldx]) : 0.f;
        acc = fmaf(s_vals[m * kh + j], xv, acc);
      }
      yt[m * N] = from_f32<T>(acc);
    }
  }
}

template <typename T>
int launch_spmm(const void* vals, const void* meta, const void* x, void* y,
                int64_t M, int64_t kh, int64_t K, int64_t N, int64_t ldx,
                int64_t stx, int64_t tiles, cudaStream_t stream) {
  const dim3 grid(grid_for(N), static_cast<unsigned>(tiles < 65535 ? tiles : 65535));
  const size_t smem = static_cast<size_t>(M * kh) * (sizeof(float) + sizeof(int));
  sptc_spmm_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(vals), static_cast<const int32_t*>(meta),
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<int>(M),
      static_cast<int>(kh), K, N, ldx, stx, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace spider

// vals: (M, kh) contiguous, same dtype as x; meta: (M, kh) int32 contiguous;
// x: (tiles, K, N) with tile stride stx, row stride ldx and unit column
// stride, K = 2*kh; y: (tiles, M, N) contiguous.
extern "C" int spider_sptc_spmm(const void* vals, const void* meta,
                                const void* x, void* y, int64_t M, int64_t kh,
                                int64_t N, int64_t ldx, int64_t stx,
                                int64_t tiles, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t K = 2 * kh;
  if (dtype == spider::kFloat32)
    return spider::launch_spmm<float>(vals, meta, x, y, M, kh, K, N, ldx, stx,
                                      tiles, s);
  if (dtype == spider::kBFloat16)
    return spider::launch_spmm<__nv_bfloat16>(vals, meta, x, y, M, kh, K, N,
                                              ldx, stx, tiles, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
