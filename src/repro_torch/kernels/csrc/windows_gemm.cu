// Dense windows GEMM on Hopper's tensor cores: (T, K, C) input windows times
// the (L, K) kernel matrix gives (T, L, C), accumulated in float32
// (K = 2L on every caller):
//
//   y[t, l, c] = sum_k km[l, k] * win[t, k, c]
//
// Replaces the TPU kernel src/repro/kernels/stencil_gemm/kernel.py::_gemm_kernel
// (pallas_call in _windows_gemm_jit), an MXU dot of km with one (K, bn)
// window block per grid step: the dense baseline that the sparse kernels
// are measured against.
//
// Bound on the H100: bytes.  Per output the kernel does K multiply-adds and
// moves K/L = 2 window elements and one output element: 4L FLOP per 12
// bytes in float32, far under the tensor cores' ridge, so the floor is
// (window bytes + matrix bytes + output bytes) / 3.35 TB/s and the tensor
// cores lower nothing; they must only not raise the time.
//
// Design.  The window slab is the instruction's A operand (16 rows x K) and
// km^T its B operand (K x 8 outputs, L padded to 8; L > 8 takes several N
// blocks): at L = 8 and 16 nothing is padding, at L = 4 half of B is, and A,
// the operand that streams, is never padded (km as A would pad L to 16 rows,
// 3/4 of them zero at L = 4).  km is the same for every tile, so each block
// builds its B fragments once, in shared memory, and every warp reads them
// from there; K is padded to whole k-steps with zeros in that table and in
// the A loads, never in device memory.
//   * float32: mma.sync.m16n8k8.tf32 as 3xTF32 (each operand split into a
//     TF32 high part and a TF32 residual; hi*lo + lo*hi + hi*hi keeps
//     float32 accuracy), each k-step summed in a fresh accumulator and added
//     in float32: the tensor cores' accumulation truncates, which over 20
//     k-steps (L = 78) missed float32 accuracy;
//   * bfloat16: mma.sync.m16n8k16.bf16, float32 sums.
// A warp takes 4 m-blocks (64 rows of A) at a time and loads their A
// fragments straight from device memory into registers, every load of a
// k-step in flight before its mma: a warp's load instruction reads whole
// 32-byte sectors, and at ~60 registers a thread the SMs hold enough warps
// to keep in flight the bytes the card's bandwidth needs.  (A cp.async ring
// of runs staged in shared memory, walked by persistent blocks, was slower
// on the paper's float32 shapes on the H100 at every run length tried.)
// Three modes, by C:
//   * unit (C = 1, the 1-D path): A's rows walk tiles, and each lane reads
//     the two (tf32) or four (bf16) window elements of its registers with
//     one 8-byte load (fragment columns t, t+4 <-> positions 8s + 2t,
//     8s + 2t + 1; bf16 2t, 2t+1, 2t+8, 2t+9 <-> 16s + 4t .. 16s + 4t + 3),
//     so a warp's load covers 8 consecutive tiles; the D fragments of 8
//     consecutive tiles are one contiguous span of the output and are
//     stored as they are;
//   * narrow (1 < C < 16, or C = 1 where a tile's K elements are not 8-byte
//     aligned): A's rows walk (tile, column) pairs, element loads;
//   * columns (C >= 16): a warp takes one tile's 64 columns; rows g and g + 8
//     of m-blocks 2p and 2p + 1 are 4 adjacent columns, so one 16-byte
//     (tf32) or 8-byte (bf16) load fills four registers, and a lane stores
//     four adjacent outputs at once.
#include <type_traits>

#include "common.cuh"

namespace spider {
namespace wg {

constexpr int kUnit = 0, kNarrow = 1, kCols = 2;   // modes, by C
constexpr int kWarps = 8;
constexpr int kMB = 4;           // m-blocks a warp takes at once
constexpr int kRows = 16 * kMB;  // A rows a warp takes at once

struct Params {
  const void* km;
  const void* win;
  void* y;
  int64_t tiles, C, items, col_blocks;
  int L, K, nks, nb;
  bool vec;                      // column mode: 4-column loads and stores aligned
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The window position of fragment column j in k-step s: unit mode pairs a
// lane's positions (see the note above); the other modes keep the
// instruction's order.  B's table and the A loads use the same map, so the
// product is unchanged.
template <typename T, int kMode>
__device__ __forceinline__ int kpos(int s, int j) {
  constexpr bool tf32 = sizeof(T) == 4;
  if constexpr (kMode == kUnit) {
    if constexpr (tf32) {
      return 8 * s + 2 * (j & 3) + (j >> 2);
    } else {
      return 16 * s + 4 * ((j & 7) >> 1) + 2 * (j >> 3) + (j & 1);
    }
  } else {
    return (tf32 ? 8 : 16) * s + j;
  }
}

// the B fragment of lane `lane`, k-step s, N block nb (km^T; zero past L and K)
template <typename T, int kMode>
__device__ uint2 b_fragment(const Params& p, int s, int nb, int lane) {
  const T* km = static_cast<const T*>(p.km);
  const int g = lane >> 2, t = lane & 3, n = nb * 8 + g;
  auto at = [&](int j) -> T {
    const int k = kpos<T, kMode>(s, j);
    return n < p.L && k < p.K ? km[n * p.K + k] : from_f32<T>(0.f);
  };
  if constexpr (sizeof(T) == 4) {            // raw float32, split when read
    return make_uint2(__float_as_uint(at(t)), __float_as_uint(at(t + 4)));
  } else {
    auto pack = [&](int j) {
      const T lo = at(j), hi = at(j + 1);
      return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&lo)) |
             (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&hi)) << 16);
    };
    return make_uint2(pack(2 * t), pack(2 * t + 8));
  }
}

// bits of a window element, zero unless `in`
template <typename T>
__device__ __forceinline__ uint32_t ld_bits(const T* w, int64_t off, bool in) {
  if (!in) return 0u;
  if constexpr (sizeof(T) == 4) return __float_as_uint(w[off]);
  else return *reinterpret_cast<const uint16_t*>(w + off);
}

// A fragment of one m-block, k-step s, from device memory (unit and narrow
// modes): the element (row, k) lies at base[row half] + k * kstride; rows
// not `ok` and k >= K read zero.  Registers: a0 = (g, col c0), a1 = (g + 8,
// c0), a2 = (g, c1), a3 = (g + 8, c1) with tf32 c0 = t, c1 = t + 4; a bf16
// register holds two columns.
template <typename T, int kMode>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const T* w,
                                       const int64_t (&base)[2], const bool (&ok)[2],
                                       int64_t kstride, int s, int K, int t) {
  constexpr bool tf32 = sizeof(T) == 4;
  if constexpr (kMode == kUnit) {           // one 8-byte load per row
    const int k = kpos<T, kUnit>(s, tf32 ? t : 2 * t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint2 v = make_uint2(0u, 0u);
      if (ok[h] && k < K) v = *reinterpret_cast<const uint2*>(w + base[h] + k);
      a[h] = v.x;
      a[h + 2] = v.y;
    }
  } else if constexpr (kMode == kNarrow) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if constexpr (tf32) {
          const int k = kpos<T, kNarrow>(s, t + 4 * q);
          a[h + 2 * q] = ld_bits(w, base[h] + k * kstride, ok[h] && k < K);
        } else {
          const int k = kpos<T, kNarrow>(s, 2 * t + 8 * q);
          a[h + 2 * q] = ld_bits(w, base[h] + k * kstride, ok[h] && k < K) |
                         (ld_bits(w, base[h] + (k + 1) * kstride,
                                  ok[h] && k + 1 < K) << 16);
        }
      }
    }
  }
}

// Column mode's A fragments of m-blocks 2p and 2p + 1, k-step s: their rows
// g, g + 8 are the 4 adjacent columns from base (2p: 0, 1; 2p + 1: 2, 3),
// read with one 16-byte (tf32) or two 8-byte (bf16) loads where `vec`;
// columns not `ok` and k >= K read zero.
template <typename T>
__device__ __forceinline__ void load_a_cols(uint32_t (&a0)[4], uint32_t (&a1)[4],
                                            const T* w, int64_t base,
                                            const bool (&ok)[4], int64_t C, int s,
                                            int K, int t, bool vec) {
  const bool full = vec && ok[3];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if constexpr (sizeof(T) == 4) {
      const int k = kpos<T, kCols>(s, t + 4 * q);
      const T* src = w + base + k * C;
      uint32_t x[4];
      if (full) {
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (k < K) v = *reinterpret_cast<const uint4*>(src);
        x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = ld_bits(src, i, ok[i] && k < K);
      }
      a0[2 * q] = x[0];
      a0[2 * q + 1] = x[1];
      a1[2 * q] = x[2];
      a1[2 * q + 1] = x[3];
    } else {                                // words (k, rows g | g + 8)
      const int k = kpos<T, kCols>(s, 2 * t + 8 * q);
      const T* src = w + base + k * C;
      uint2 u0 = make_uint2(0u, 0u), u1 = make_uint2(0u, 0u);   // rows k, k + 1
      if (full) {
        if (k < K) u0 = *reinterpret_cast<const uint2*>(src);
        if (k + 1 < K) u1 = *reinterpret_cast<const uint2*>(src + C);
      } else {
        u0.x = ld_bits(src, 0, ok[0] && k < K) | (ld_bits(src, 1, ok[1] && k < K) << 16);
        u0.y = ld_bits(src, 2, ok[2] && k < K) | (ld_bits(src, 3, ok[3] && k < K) << 16);
        u1.x = ld_bits(src, C, ok[0] && k + 1 < K) |
               (ld_bits(src, C + 1, ok[1] && k + 1 < K) << 16);
        u1.y = ld_bits(src, C + 2, ok[2] && k + 1 < K) |
               (ld_bits(src, C + 3, ok[3] && k + 1 < K) << 16);
      }
      a0[2 * q] = __byte_perm(u0.x, u1.x, 0x5410);
      a0[2 * q + 1] = __byte_perm(u0.x, u1.x, 0x7632);
      a1[2 * q] = __byte_perm(u0.y, u1.y, 0x5410);
      a1[2 * q + 1] = __byte_perm(u0.y, u1.y, 0x7632);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* dst, float v0, float v1, bool pair,
                                       bool second) {
  if (pair) {
    if constexpr (std::is_same_v<T, float>) {
      *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
    }
  } else {
    dst[0] = from_f32<T>(v0);
    if (second) dst[1] = from_f32<T>(v1);
  }
}

// four adjacent outputs, one 16-byte (float32) or 8-byte (bfloat16) store
// where `full`, else those that are `ok`
template <typename T>
__device__ __forceinline__ void store4(T* dst, const float (&v)[4], bool full,
                                       const bool (&ok)[4]) {
  if (full) {
    if constexpr (std::is_same_v<T, float>) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
      *reinterpret_cast<uint2*>(dst) =
          make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                     *reinterpret_cast<const uint32_t*>(&hi));
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (ok[i]) dst[i] = from_f32<T>(v[i]);
  }
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kWarps * 32)
windows_gemm_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint2* const btab = reinterpret_cast<uint2*>(smem_raw);   // (nks, nb, 32)
  for (int e = threadIdx.x; e < p.nks * p.nb * 32; e += blockDim.x)
    btab[e] = b_fragment<T, kMode>(p, e / 32 / p.nb, e / 32 % p.nb, e % 32);
  __syncthreads();

  const T* w = static_cast<const T*>(p.win);
  T* y = static_cast<T*>(p.y);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int L = p.L, K = p.K;
  const int64_t C = p.C;
  const int64_t kstride = kMode == kUnit ? 1 : C;
  const int64_t n_rows = kMode == kNarrow ? p.tiles * C : p.tiles;
  constexpr bool tf32 = sizeof(T) == 4;

  for (int64_t it = static_cast<int64_t>(blockIdx.x) * kWarps + warp; it < p.items;
       it += static_cast<int64_t>(gridDim.x) * kWarps) {
    // this item's rows: tiles (unit), (tile, column) pairs (narrow), or
    // one tile's kRows columns from c0 (columns)
    const int64_t tile0 = kMode == kCols ? it / p.col_blocks : 0;
    const int64_t c0 = kMode == kCols ? it % p.col_blocks * kRows : 0;
    int64_t base[kMB][2];
    bool ok[kMB][2], live[kMB];
#pragma unroll
    for (int j = 0; j < kMB; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if constexpr (kMode == kCols) {     // m-blocks 2p, 2p + 1 share 32 columns
          const int64_t c = c0 + 32 * (j >> 1) + 4 * g + 2 * (j & 1) + h;
          base[j][h] = tile0 * K * C + c;
          ok[j][h] = c < C;
        } else {
          const int64_t r = it * kRows + 16 * j + g + 8 * h;
          base[j][h] = kMode == kUnit ? r * K : r / C * K * C + r % C;
          ok[j][h] = r < n_rows;
        }
      }
      live[j] = kMode == kCols ? c0 + 32 * (j >> 1) + 2 * (j & 1) < C
                               : it * kRows + 16 * j < n_rows;
    }
    for (int nb = 0; nb < p.nb; ++nb) {
      float d[kMB][4];
#pragma unroll
      for (int j = 0; j < kMB; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
      for (int ks = 0; ks < p.nks; ++ks) {
        uint32_t a[kMB][4];                 // every load of the k-step first
        if constexpr (kMode == kCols) {
#pragma unroll
          for (int j = 0; j < kMB; j += 2) {
            const bool ok4[4] = {ok[j][0], ok[j][1], ok[j + 1][0], ok[j + 1][1]};
            load_a_cols(a[j], a[j + 1], w, base[j][0], ok4, C, ks, K, t, p.vec);
          }
        } else {
#pragma unroll
          for (int j = 0; j < kMB; ++j)
            load_a<T, kMode>(a[j], w, base[j], ok[j], kstride, ks, K, t);
        }
        const uint2 b = btab[(ks * p.nb + nb) * 32 + lane];
        uint32_t bh0 = b.x, bh1 = b.y, bl0 = 0u, bl1 = 0u;
        if constexpr (tf32) {
          bh0 = tf32_cvt(__uint_as_float(b.x));
          bh1 = tf32_cvt(__uint_as_float(b.y));
          bl0 = tf32_cvt(__uint_as_float(b.x) - __uint_as_float(bh0));
          bl1 = tf32_cvt(__uint_as_float(b.y) - __uint_as_float(bh1));
        }
#pragma unroll
        for (int j = 0; j < kMB; ++j) {
          if (!live[j]) continue;
          if constexpr (tf32) {
            uint32_t ah[4], al[4];
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              ah[v] = tf32_cvt(__uint_as_float(a[j][v]));
              al[v] = tf32_cvt(__uint_as_float(a[j][v]) - __uint_as_float(ah[v]));
            }
            // this k-step's sum in a fresh accumulator, added in float32:
            // the tensor cores' own accumulation truncates
            float e[4] = {0.f, 0.f, 0.f, 0.f};
            mma_tf32(e, ah, bl0, bl1);
            mma_tf32(e, al, bh0, bh1);
            mma_tf32(e, ah, bh0, bh1);
#pragma unroll
            for (int v = 0; v < 4; ++v) d[j][v] += e[v];
          } else {
            mma_bf16(d[j], a[j], bh0, bh1);
          }
        }
      }
      // D: d0, d1 = row g, outputs l, l + 1 (l = 8 nb + 2t); d2, d3 = row g + 8
      const int l = nb * 8 + 2 * t;
      if (l >= L) continue;
      const bool second = l + 1 < L;
#pragma unroll
      for (int j = 0; j < kMB; ++j) {
        if constexpr (kMode == kCols) {     // 4 adjacent columns of outputs l, l + 1
          if (j % 2 || !ok[j][0]) continue;
          T* dst = y + (tile0 * L + l) * C + (base[j][0] - tile0 * K * C);
          const bool ok4[4] = {ok[j][0], ok[j][1], ok[j + 1][0], ok[j + 1][1]};
          const float v0[4] = {d[j][0], d[j][2], d[j + 1][0], d[j + 1][2]};
          store4(dst, v0, p.vec && ok4[3], ok4);
          if (second) {
            const float v1[4] = {d[j][1], d[j][3], d[j + 1][1], d[j + 1][3]};
            store4(dst + C, v1, p.vec && ok4[3], ok4);
          }
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (!ok[j][h]) continue;
            const int64_t r = it * kRows + 16 * j + g + 8 * h;
            const float v0 = d[j][2 * h], v1 = d[j][2 * h + 1];
            if constexpr (kMode == kUnit) {
              // (T, L) rows: a pair store where l, l + 1 share an aligned word
              store2(y + r * L + l, v0, v1, second && L % 2 == 0, second);
            } else {                        // (tile, l, c) of a narrow row
              T* dst = y + (r / C * L + l) * C + r % C;
              dst[0] = from_f32<T>(v0);
              if (second) dst[C] = from_f32<T>(v1);
            }
          }
        }
      }
    }
  }
}

template <typename T, int kMode>
int launch(const Params& p, cudaStream_t stream) {
  auto kernel = windows_gemm_kernel<T, kMode>;
  const int smem = p.nks * p.nb * 32 * static_cast<int>(sizeof(uint2));
  if (smem > 48 * 1024) {                   // opt in past the default 48 KB
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = min64((p.items + kWarps - 1) / kWarps, 1 << 30);
  kernel<<<static_cast<unsigned>(blocks), kWarps * 32, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_mode(Params p, cudaStream_t s) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p.win);
  if (p.C == 1 && p.K * sizeof(T) % 8 == 0 && addr % 8 == 0) {
    p.items = (p.tiles + kRows - 1) / kRows;
    return launch<T, kUnit>(p, s);
  }
  if (p.C < 16) {
    p.items = (p.tiles * p.C + kRows - 1) / kRows;
    return launch<T, kNarrow>(p, s);
  }
  p.col_blocks = (p.C + kRows - 1) / kRows;
  p.items = p.tiles * p.col_blocks;
  p.vec = p.C % 4 == 0 && addr % (4 * sizeof(T)) == 0;
  return launch<T, kCols>(p, s);
}

}  // namespace wg
}  // namespace spider

// km: (L, K) contiguous; win: (tiles, K, C) contiguous; y: (tiles, L, C)
// contiguous; all of one dtype.  Shared memory: the B table,
// ceil(K / k-step) * ceil(L / 8) * 256 bytes
// (kernels/stencil_gemm/kernel.py::table_bytes).
extern "C" int spider_windows_gemm(const void* km, const void* win, void* y,
                                   int64_t tiles, int64_t L, int64_t K,
                                   int64_t C, int dtype, void* stream) {
  using namespace spider;
  using namespace spider::wg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiles < 1 || L < 1 || K < 1 || C < 1 ||
      (dtype != kFloat32 && dtype != kBFloat16))
    return static_cast<int>(cudaErrorInvalidValue);
  const int k_step = dtype == kFloat32 ? 8 : 16;
  Params p{km, win, y, tiles, C, 0, 0, static_cast<int>(L), static_cast<int>(K),
           static_cast<int>((K + k_step - 1) / k_step), static_cast<int>((L + 7) / 8),
           false};
  if (dtype == kFloat32) return launch_mode<float>(p, s);
  return launch_mode<__nv_bfloat16>(p, s);
}
