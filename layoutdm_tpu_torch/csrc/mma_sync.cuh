// Warp-level bf16 tensor-core building blocks for the attention kernels
// (attention_fwd.cuh = K1 and K6, attention_blockdiag.cu = K5,
// attention_qkv_bwd.cu = K2; K3 and K4 take its bf16 packing and quad
// reductions): raw mma.sync.aligned.m16n8k16 products with
// float32 accumulators, ldmatrix fragment loads from shared memory, and row
// copies between a head's column block in device memory and a shared-memory
// tile.
//
// Fragments follow the PTX ISA's m16n8k16 layouts.  With g = lane / 4 and
// t = lane % 4, a float32 accumulator tile (16 x 8) holds in c[0], c[1] the
// elements (g, 2t), (g, 2t + 1) and in c[2], c[3] the elements (g + 8, 2t),
// (g + 8, 2t + 1).  Two neighbouring accumulator tiles j = 2kk, 2kk + 1 are
// therefore, element for element, the A operand (16 x 16) of a product over
// the columns 16kk .. 16kk + 15 (`pack_a`): attention's probabilities go
// from one product into the next without passing through shared memory.
//
// Shared-memory tiles are row-major bf16 with a row pitch of (width + 8)
// elements, so the eight 16-byte rows an ldmatrix reads fall on distinct
// banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "tile_mma.cuh"

namespace mma {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

// a bf16x2 register: lo in the low half (the lower column), both rounded to
// nearest even as torch's .to(bfloat16) rounds
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a b: A 16 x 16 (row), B 16 x 8 (col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// the A operand over columns 16kk .. 16kk + 15 from accumulator tiles
// c[2kk], c[2kk + 1] (values already final: scaled, normalised, ...)
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16x2(c0[0], c0[1]);
  a[1] = pack_bf16x2(c0[2], c0[3]);
  a[2] = pack_bf16x2(c1[0], c1[1]);
  a[3] = pack_bf16x2(c1[2], c1[3]);
}

// acc[j] += A B^T over the depth 16 * KD: A is the warp's 16 rows at `a`,
// B the rows 16jj .. 16jj + 15 at `b` for jj < n16 (both row-major, `pitch`);
// acc[2jj], acc[2jj + 1] are the 8-column tiles of B-rows 16jj.., 16jj + 8..
template <int KD, int NJ>
__device__ __forceinline__ void mma_abt(float (&acc)[2 * NJ][4], const bf16* a, const bf16* b,
                                        int pitch, int n16) {
  const int lane = threadIdx.x & 31;
  const bf16* pa = a + (lane & 15) * pitch + (lane >> 4) * 8;
  const bf16* pb = b + ((lane & 7) + ((lane >> 4) << 3)) * pitch + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < KD; ++ks) {
    uint32_t fa[4];
    ldsm_x4(fa, pa + ks * 16);
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
      if (jj < n16) {
        uint32_t fb[4];
        ldsm_x4(fb, pb + jj * 16 * pitch + ks * 16);
        mma_bf16(acc[2 * jj], fa, fb[0], fb[1]);
        mma_bf16(acc[2 * jj + 1], fa, fb[2], fb[3]);
      }
    }
  }
}

// acc[n] += A B for one depth step of 16: A in registers, B the 16 rows at
// `b` (row-major, `pitch`), all DT * 8 of its columns
template <int DT>
__device__ __forceinline__ void mma_ab(float (&acc)[DT][4], const uint32_t (&a)[4], const bf16* b,
                                       int pitch) {
  const int lane = threadIdx.x & 31;
  const bf16* pb = b + ((lane & 7) + (((lane >> 3) & 1) << 3)) * pitch + ((lane >> 4) << 3);
#pragma unroll
  for (int n = 0; n < DT / 2; ++n) {
    uint32_t fb[4];
    ldsm_x4_trans(fb, pb + n * 16);
    mma_bf16(acc[2 * n], a, fb[0], fb[1]);
    mma_bf16(acc[2 * n + 1], a, fb[2], fb[3]);
  }
}

// scores s (tiles of keys k0 + 8j .., accumulator layout) times c2 (the
// softmax scale times log2 e, so exp2 gives the softmax's exp), -inf past
// the sequence end; tiles j < 2 * n16
template <int NT>
__device__ __forceinline__ void scale_mask(float (&s)[NT][4], int k0, int S, float c2, int n16) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (j < 2 * n16)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = k0 + 8 * j + 2 * t + (e & 1) < S ? s[j][e] * c2 : -INFINITY;
}

// acc's 16 x (DT * 8) tile, rounded to bf16, into the warp's rows at `dst`
template <int DT>
__device__ __forceinline__ void store_acc(bf16* dst, int pitch, const float (&acc)[DT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    *reinterpret_cast<uint32_t*>(dst + g * pitch + n * 8 + 2 * t) = pack_bf16x2(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(dst + (g + 8) * pitch + n * 8 + 2 * t) =
        pack_bf16x2(acc[n][2], acc[n][3]);
  }
}

// 16-byte asynchronous copy global -> shared of the first n bytes of gmem
// (0 <= n <= 16), zeros after them
__device__ __forceinline__ void cp_async16_n(void* smem, const void* gmem, int n) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

// How head slices of `cols` bf16 move between device memory and shared
// rows (`mode`):
// 16: 16-byte copies of the aligned window around each row.  Needs rows
//     (`ld` elements apart) and the pointers 16-byte aligned and cols even,
//     so a head slice starts 4-byte aligned, `lead` = 0, 2, 4 or 6 elements
//     into its window, and the window never reaches past its token's row.
//     The shared row holds the window: zeros (once `clear_leads` has run),
//     the slice at columns lead .. lead + cols, zeros.  Products over the
//     row's width are the slice's, and an output tile in window columns
//     goes back to the head with 16-byte stores inside it and 4-byte stores
//     at its two ends.
// 2:  element copies, slice at column 0: every layout that allows no window.
__host__ __forceinline__ int copy_mode(int cols, long long ld, const void* const* ptrs, int n) {
  bool a16 = cols % 2 == 0 && ld % 8 == 0;
  for (int i = 0; i < n; ++i) a16 = a16 && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0;
  return a16 ? 16 : 2;
}

// where a slice starting at p sits in its 16-byte window (mode 16)
__device__ __forceinline__ int window_lead(const bf16* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15) >> 1);
}

// A row of `n` 16-byte copies is walked by a group of L lanes (L = 8, 16
// or 32, the least power of two >= n up to 32), 32 / L rows per warp at a
// time, so the lanes' rows and columns come from shifts, not divisions by
// n: with a flat i / n, i % n loop K5 and K2 ran 8-12% slower at the
// flagship on an H100 (compare_kernels.py).
struct RowLanes {
  int shift, row, col;  // log2 L; this lane's row in its warp's group, first column
  __device__ __forceinline__ explicit RowLanes(int n) {
    shift = n > 16 ? 5 : n > 8 ? 4 : 3;
    const int lane = threadIdx.x & 31;
    row = lane >> shift;
    col = lane & ((1 << shift) - 1);
  }
  __device__ __forceinline__ int rows_per_warp() const { return 32 >> shift; }
  __device__ __forceinline__ int lanes() const { return 1 << shift; }
};

// Rows r < rows_ok of the slices src + r * ld (cols wide) into the shared
// rows dst + r * pitch as `mode` places them, zero rows for
// rows_ok <= r < rows.  In mode 16 all `width` columns of a row are
// written, the first `lead` with the previous head's last values until
// `clear_leads` zeroes them; in mode 2 only columns < cols.  Whole block.
// Mode 16 copies are cp.async: the caller commits, waits, runs clear_leads
// and synchronises.
__device__ __forceinline__ void load_rows(bf16* dst, int pitch, const bf16* __restrict__ src,
                                          long long ld, int rows, int rows_ok, int cols,
                                          int width, int mode) {
  if (mode == 16) {
    const int step_w = blockDim.x >> 5, warp = threadIdx.x >> 5;
    const int lead = window_lead(src);
    const char* base = reinterpret_cast<const char*>(src - lead);
    const int end = 2 * (lead + cols);  // the slice's bytes in its window: [2 lead, end)
    const RowLanes rl(width / 8);
    for (int r = warp * rl.rows_per_warp() + rl.row; r < rows; r += step_w * rl.rows_per_warp()) {
      const bool ok = r < rows_ok;
      const char* s = base + (ok ? r * ld * 2 : 0);
      char* d = reinterpret_cast<char*>(dst + r * pitch);
      for (int c = 16 * rl.col; c < 2 * width; c += 16 * rl.lanes()) {
        const int n = ok ? min(max(end - c, 0), 16) : 0;
        cp_async16_n(d + c, n > 0 ? s + c : s, n);
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int r = i / cols, c = i % cols;
    dst[r * pitch + c] = r < rows_ok ? src[r * ld + c] : __float2bfloat16(0.f);
  }
}

// Mode 2: zero columns hd .. HDP of `rows` shared rows of pitch HDP + 8
// (the element copies never write them).  Whole block.
template <int HDP>
__device__ __forceinline__ void zero_pad_cols(bf16* s, int rows, int hd) {
  const int n = HDP - hd;
  for (int i = threadIdx.x; i < rows * n; i += blockDim.x)
    s[i / n * (HDP + 8) + hd + i % n] = __float2bfloat16(0.f);
}

// Mode 16, after the caller's cp_async_wait and before its barrier: each
// thread zeroes the leading words of the windows it copied with
// load_rows(dst, pitch, src, .., rows, .., width, 16), the end of the
// previous head.
__device__ __forceinline__ void clear_leads(bf16* dst, int pitch, const bf16* src, int rows,
                                            int width, int mode) {
  if (mode != 16) return;
  const int lead = window_lead(src);
  const RowLanes rl(width / 8);
  if (lead == 0 || rl.col != 0) return;
  const int step = (blockDim.x >> 5) * rl.rows_per_warp();
  for (int r = (threadIdx.x >> 5) * rl.rows_per_warp() + rl.row; r < rows; r += step)
    for (int k = 0; k < lead / 2; ++k) reinterpret_cast<uint32_t*>(dst + r * pitch)[k] = 0u;
}

// The slices dst + r * ld (cols wide) of rows r < rows_ok (<= 16) from the
// shared rows src + r * pitch, placed as `mode` placed the loads (mode 16:
// in window columns lead .. lead + cols, lead that of dst).  One warp.
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, long long ld, const bf16* src,
                                           int pitch, int rows_ok, int cols, int mode) {
  if (mode == 16) {
    const int lead = window_lead(dst);
    char* base = reinterpret_cast<char*>(dst - lead);
    const int end = 2 * (lead + cols);
    const RowLanes rl((end + 15) / 16);
    for (int r = rl.row; r < rows_ok; r += rl.rows_per_warp()) {
      char* o = base + r * ld * 2;
      const char* i = reinterpret_cast<const char*>(src + r * pitch);
      for (int c = 16 * rl.col; c < end; c += 16 * rl.lanes()) {
        const int lo = max(2 * lead, c), hi = min(end, c + 16);
        if (lo == c && hi == c + 16) {
          *reinterpret_cast<uint4*>(o + c) = *reinterpret_cast<const uint4*>(i + c);
        } else {
          for (int b = lo; b < hi; b += 4)
            *reinterpret_cast<uint32_t*>(o + b) = *reinterpret_cast<const uint32_t*>(i + b);
        }
      }
    }
    return;
  }
  for (int i = threadIdx.x & 31; i < rows_ok * cols; i += 32) {
    const int r = i / cols, c = i % cols;
    dst[r * ld + c] = src[r * pitch + c];
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace mma
