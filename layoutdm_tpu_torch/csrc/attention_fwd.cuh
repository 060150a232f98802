// Packed-qkv self-attention forward for Hopper (sm_90a): the kernel body
// shared by K1 (attention_qkv.cu, a batch-major (B, S, 3D) slab) and K6
// (attention_smajor.cu, a sequence-major (S, B, 3D) slab with the qkv bias
// added at load).
//
// Per head h,
//   o[:, h*hd:(h+1)*hd] = softmax(q_h k_h^T * scale) v_h
// with q/k/v the column blocks [h*hd], [D + h*hd], [2D + h*hd] of a token's
// 3D-wide row; token s of batch row b starts at element
// b * batch_stride + s * token_stride.  Output (B, S, D) in the input dtype
// (float32 or bfloat16).  Scores, softmax and accumulation are float32; in
// bfloat16 mode the probabilities are rounded to bfloat16 before the p.v
// product.  With HAS_BIAS, bias (3D,) is added to every loaded q/k/v value
// and the sum rounded to the io dtype, as the TPU's S-major kernel adds it
// to the slab in VMEM.
//
// What bounds it on this card: at the flagship shape (S = 125, hd = 58) one
// (row, head) reads 3*S*hd*2 bytes (~43 KB in bf16) and does ~4*S^2*hd
// FLOPs (~3.6 MFLOP), about 83 FLOP/byte -- below the ~295 FLOP/byte at
// which the H100's bf16 tensor cores, not memory, would be the limit.  The
// products are two tiny GEMMs per head (125x58x125), so at batch 1 the
// kernel is latency-bound and at batch 1024 it is bound by instruction
// throughput on the CUDA cores and by shared-memory bandwidth.
//
// What this simple design does about it: one block per (batch row, query
// tile of 16 rows, head).  K and V of the head are streamed through shared
// memory in tiles of 32 keys with an online softmax (running max and sum per
// query row), so the (S, S) score matrix never leaves registers and any S
// fits (whole-head K+V at S = 500 in f32 would be 232 KB, over the 227 KB a
// block may have).  Each warp owns 4 query rows; lane j scores key j of the
// tile, the warp reduces max and sum with shuffles, and each lane then
// accumulates the head dims lane, lane+32, ... of the output.  hd = 58 puts
// head columns at 116-byte offsets in bf16, not 16-byte aligned, so loads are
// scalar.  Left for later: vectorised and TMA loads, wgmma tensor-core
// products, and reusing one block's K/V tile across all query tiles.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace attention_fwd {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBlockK = 32;                      // keys per shared-memory tile

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// a value as the io dtype holds it: bf16-rounded in bf16 mode
template <typename T>
__device__ __forceinline__ float round_to_io(float x) { return x; }
template <>
__device__ __forceinline__ float round_to_io<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// one element of the slab, plus the bias (rounded to the io dtype) if any
template <typename T, bool HAS_BIAS>
__device__ __forceinline__ float load_in(const T* p, const T* bias, int col) {
  if (HAS_BIAS) return round_to_io<T>(load_f32(p) + load_f32(bias + col));
  return load_f32(p);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// HDP: head dim rounded up to a multiple of 32 (hd <= HDP <= 128)
template <typename T, int HDP, bool HAS_BIAS>
__global__ void __launch_bounds__(kWarps * 32)
    attention_kernel(const T* __restrict__ qkv, const T* __restrict__ bias,
                     T* __restrict__ out, int S, int H, int hd, int n_qtiles,
                     long long batch_stride, long long token_stride,
                     float scale) {
  constexpr int kDimsPerLane = HDP / 32;
  __shared__ float q_s[kBlockQ][HDP];
  __shared__ float k_s[kBlockK][HDP + 1];  // +1: lane j reads row j, no bank conflicts
  __shared__ float v_s[kBlockK][HDP];
  __shared__ float p_s[kWarps][kRowsPerWarp][kBlockK];

  const int D = H * hd;
  const int b = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kBlockQ;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const T* base = qkv + (long long)b * batch_stride + (long long)h * hd;
  const int qc = h * hd, kc = D + h * hd, vc = 2 * D + h * hd;  // bias columns

  // columns hd..HDP-1 of v_s stay zero: the tile loads below write d < hd
  for (int i = tid; i < kBlockK * HDP; i += blockDim.x) v_s[i / HDP][i % HDP] = 0.f;
  for (int i = tid; i < kBlockQ * hd; i += blockDim.x) {
    const int r = i / hd, d = i % hd, qi = q0 + r;
    q_s[r][d] = qi < S ? load_in<T, HAS_BIAS>(base + qi * token_stride + d, bias, qc + d)
                       : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += kBlockK) {
    __syncthreads();  // q_s and the zeroed v_s are written; last tile consumed
    for (int i = tid; i < kBlockK * hd; i += blockDim.x) {
      const int j = i / hd, d = i % hd, kj = k0 + j;
      const bool ok = kj < S;
      const T* row = base + kj * token_stride;
      k_s[j][d] = ok ? load_in<T, HAS_BIAS>(row + D + d, bias, kc + d) : 0.f;
      v_s[j][d] = ok ? load_in<T, HAS_BIAS>(row + 2 * D + d, bias, vc + d) : 0.f;
    }
    __syncthreads();

    const int n_keys = min(kBlockK, S - k0);
    const bool key_ok = lane < n_keys;
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float kv = k_s[lane][d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        s[r] = fmaf(q_s[warp * kRowsPerWarp + r][d], kv, s[r]);
    }

#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float sr = key_ok ? s[r] * scale : -INFINITY;
      // lane 0 always holds a real key, so m_new is finite
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float p = key_ok ? expf(sr - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);  // 0 on the first tile
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] *= corr;
      p_s[warp][r][lane] = round_to_io<T>(p);
    }
    __syncwarp();

    for (int j = 0; j < n_keys; ++j) {
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        const float vv = v_s[j][lane + 32 * i];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          acc[r][i] = fmaf(p_s[warp][r][j], vv, acc[r][i]);
      }
    }
    __syncwarp();
  }

  T* obase = out + (long long)b * S * D + (long long)h * hd;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + warp * kRowsPerWarp + r;
    if (qi >= S) continue;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) store_f32(obase + (long long)qi * D + d, acc[r][i] * inv);
    }
  }
}

template <typename T, bool HAS_BIAS>
cudaError_t launch_typed(const void* qkv, const void* bias, void* out, int B,
                         int S, int H, int hd, long long batch_stride,
                         long long token_stride, float scale,
                         cudaStream_t stream) {
  const int n_qtiles = (S + kBlockQ - 1) / kBlockQ;
  const dim3 grid((unsigned)((long long)B * n_qtiles), (unsigned)H);
  const dim3 block(kWarps * 32);
  const T* in = static_cast<const T*>(qkv);
  const T* bs = static_cast<const T*>(bias);
  T* o = static_cast<T*>(out);
  switch ((hd + 31) / 32 * 32) {
    case 32:
      attention_kernel<T, 32, HAS_BIAS><<<grid, block, 0, stream>>>(
          in, bs, o, S, H, hd, n_qtiles, batch_stride, token_stride, scale);
      break;
    case 64:
      attention_kernel<T, 64, HAS_BIAS><<<grid, block, 0, stream>>>(
          in, bs, o, S, H, hd, n_qtiles, batch_stride, token_stride, scale);
      break;
    case 96:
      attention_kernel<T, 96, HAS_BIAS><<<grid, block, 0, stream>>>(
          in, bs, o, S, H, hd, n_qtiles, batch_stride, token_stride, scale);
      break;
    case 128:
      attention_kernel<T, 128, HAS_BIAS><<<grid, block, 0, stream>>>(
          in, bs, o, S, H, hd, n_qtiles, batch_stride, token_stride, scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// the shape checks both entry points make; 0 when the launch can go ahead
inline int check_shape(int B, int S, int H, int hd) {
  if (B < 1 || S < 1 || H < 1 || H > 65535 || hd < 1 || hd > 128)
    return (int)cudaErrorInvalidValue;
  const long long n_qtiles = (S + kBlockQ - 1) / kBlockQ;
  if ((long long)B * n_qtiles > INT_MAX) return (int)cudaErrorInvalidValue;
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16
template <bool HAS_BIAS>
int launch(const void* qkv, const void* bias, void* out, int B, int S, int H,
           int hd, long long batch_stride, long long token_stride, float scale,
           int dtype, void* stream) {
  if (int err = check_shape(B, S, H, hd)) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_typed<float, HAS_BIAS>(qkv, bias, out, B, S, H, hd,
                                              batch_stride, token_stride, scale, st);
  if (dtype == 1)
    return (int)launch_typed<__nv_bfloat16, HAS_BIAS>(
        qkv, bias, out, B, S, H, hd, batch_stride, token_stride, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace attention_fwd
