// Block-level building blocks shared by the fused kernels (ffn.cu = K3,
// attention_block.cu = K4): io-dtype conversions, warp reductions, a 16x16
// warp tile product, and a global -> shared tile copy with zero fill.  The
// cp.async primitives and warp reductions also serve K5 and K2, through
// mma_sync.cuh.
//
// The tile product C += A B (depth 16, float32 accumulator) has one
// interface and two bodies:
// - bfloat16: Hopper's tensor cores through warp-level nvcuda::wmma
//   (m16n16k16, bf16 operands, float32 accumulate);
// - float32: exact float32 FMAs on the CUDA cores (no TF32), lane l owning
//   row l/2 and columns (l%2)*8 .. +8 of the tile, so float32 stays as exact
//   as the TPU kernels' Precision.HIGHEST.
// A is row-major (a[r * lda + k]); B is column-major (b[n * ldb + k]) or
// row-major (b[k * ldb + n]).  Tile pointers are 32-byte aligned and leading
// dimensions multiples of 8 elements, as wmma requires.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>
#include <type_traits>

namespace tile {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

// x as the io dtype holds it
template <typename T>
__device__ __forceinline__ float round_io(float x) { return to_f32(from_f32<T>(x)); }

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
struct Mma;

template <>
struct Mma<bf16> {
  using Acc = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;

  static __device__ __forceinline__ void zero(Acc& c) { nvcuda::wmma::fill_fragment(c, 0.f); }

  template <bool BColMajor>
  static __device__ __forceinline__ void mma(Acc& c, const bf16* a, int lda, const bf16* b,
                                             int ldb) {
    using namespace nvcuda;
    using LayoutB = typename std::conditional<BColMajor, wmma::col_major, wmma::row_major>::type;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LayoutB> fb;
    wmma::load_matrix_sync(fa, a, lda);
    wmma::load_matrix_sync(fb, b, ldb);
    wmma::mma_sync(c, fa, fb, c);
  }

  static __device__ __forceinline__ void load(Acc& c, const float* p, int ldm) {
    nvcuda::wmma::load_matrix_sync(c, p, ldm, nvcuda::wmma::mem_row_major);
  }

  // the warp's lanes may read the whole tile after this returns
  static __device__ __forceinline__ void store(float* p, const Acc& c, int ldm) {
    nvcuda::wmma::store_matrix_sync(p, c, ldm, nvcuda::wmma::mem_row_major);
    __syncwarp();
  }
};

template <>
struct Mma<float> {
  struct Acc {
    float v[8];
  };

  static __device__ __forceinline__ void zero(Acc& c) {
#pragma unroll
    for (int i = 0; i < 8; ++i) c.v[i] = 0.f;
  }

  template <bool BColMajor>
  static __device__ __forceinline__ void mma(Acc& c, const float* a, int lda, const float* b,
                                             int ldb) {
    const int lane = threadIdx.x & 31, r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float av = a[r * lda + k];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float bv = BColMajor ? b[(c0 + i) * ldb + k] : b[k * ldb + c0 + i];
        c.v[i] = fmaf(av, bv, c.v[i]);
      }
    }
  }

  static __device__ __forceinline__ void load(Acc& c, const float* p, int ldm) {
    const int lane = threadIdx.x & 31, r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) c.v[i] = p[r * ldm + c0 + i];
  }

  static __device__ __forceinline__ void store(float* p, const Acc& c, int ldm) {
    const int lane = threadIdx.x & 31, r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) p[r * ldm + c0 + i] = c.v[i];
    __syncwarp();
  }
};

// Asynchronous 16-byte copies global -> shared (sm_80+): a copy with
// valid = false reads nothing and writes zeros.  Copies issued since the
// last commit form one group; wait<N> returns when at most N groups are
// still in flight, and a __syncthreads() after it shows the data to the
// whole block.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// dst[r * lds + c] = src[r * ld + c] for r < rows_ok, c < cols_ok, else 0;
// r < rows, c < cols.  Whole block.  Where the shapes and the source's
// alignment allow 16-byte vectors the copies are asynchronous (cp.async:
// the caller commits, waits and synchronises); otherwise they are scalar
// loads and stores, done when the call returns.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int lds, const T* __restrict__ src, long long ld,
                                          int rows, int cols, int rows_ok, int cols_ok) {
  constexpr int V = 16 / sizeof(T);
  const int c_ok = cols_ok < cols ? cols_ok : cols;
  const bool vec = cols % V == 0 && lds % V == 0 && ld % V == 0 && c_ok % V == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0;
  if (vec) {
    const int vc = cols / V;
    for (int i = threadIdx.x; i < rows * vc; i += blockDim.x) {
      const int r = i / vc, c = (i % vc) * V;
      const bool ok = r < rows_ok && c < c_ok;
      cp_async16(dst + r * lds + c, ok ? src + r * ld + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int r = i / cols, c = i % cols;
      dst[r * lds + c] = (r < rows_ok && c < c_ok) ? src[r * ld + c] : from_f32<T>(0.f);
    }
  }
}

}  // namespace tile
