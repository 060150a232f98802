// Backward of packed-qkv self-attention for Hopper (sm_90a).
//
// Replaces: layoutdm_tpu/ops/attention.py::fused_attention_qkv_bwd, whose
// Pallas kernel body is _attn_bwd_kernel_qkv.  Same function: for the packed
// (B, S, 3D) slab (heads as the column blocks [h*hd], [D + h*hd],
// [2D + h*hd] of q, k, v) and the cotangent dO (B, S, D) of the attention
// output, per head with p = softmax(q k^T * scale):
//   dv = p^T dO,  dp = dO v^T,  ds = p * (dp - rowsum(dp * p)) * scale,
//   dq = ds k,    dk = ds^T q,
// written as one packed (B, S, 3D) d(qkv) slab in the input dtype (float32
// or bfloat16).  Rounding points follow the TPU kernel: scores, softmax and
// accumulation in float32; in bfloat16 mode p is rounded to bfloat16 before
// p^T dO and ds before ds k and ds^T q.  The residual is the qkv slab only:
// the softmax is recomputed, never stored.
//
// What bounds it on this card: the TPU kernel holds the whole (S, S) f32
// score, probability and gradient blocks of a batch group in VMEM.  On
// Hopper a block has at most 227 KB of shared memory, and at S = 500,
// hd = 58 in f32 the K, V, Q and dO of one head alone are ~464 KB, so nothing
// of size S x S or S x hd per head can stay resident.  At the flagship shape
// (S = 125, hd = 58) one (row, head) reads ~58 KB (bf16) from device memory
// and does ~9 S^2 hd multiply-adds (s and dp are formed in both sweeps of
// pass A and again in pass B), ~280 FLOP/byte: with scalar products on the
// CUDA cores (~60 TFLOP/s float32) the kernel is bound by issue rate and
// shared-memory bandwidth, not by device memory.
//
// What this simple design does about it, in the manner of FlashAttention-2,
// with no atomics and no (S, S) tensor in device memory:
//   pass A, one block per (row, query tile of 16, head): sweep 1 streams the
//     K/V tiles (32 keys) and keeps an online max, sum and unnormalised
//     rowsum(dp * p) per query row; it writes lse = m + log l and
//     delta = rowsum(dp * p) to a small (B, H, S, 2) f32 scratch.  Sweep 2
//     streams K/V again, recomputes p = exp(s - lse) and ds, and accumulates
//     dq.
//   pass B, one block per (row, key tile of 16, head): streams the Q/dO
//     tiles (32 queries) with their lse and delta, recomputes p and ds and
//     accumulates dv += p^T dO and dk += ds^T q.
// Each warp owns 4 rows of its block; lane j works on element j of the
// streamed tile, and then each lane accumulates the head dims lane,
// lane + 32, ... (as the forward kernel does).  Tiles streamed to lane j are
// stored with an odd row stride (HDP + 1) so the lanes' reads do not
// conflict.  hd = 58 puts head columns at 116-byte offsets in bf16, not
// 16-byte aligned, so loads are scalar.  Left for later: wgmma products,
// vector/TMA loads, and sharing one K/V load across all query tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query (A) or key (B) rows per block
constexpr int kTile = 32;                      // keys (A) or queries (B) per streamed tile

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// a product operand as the TPU kernel sees it: bf16-rounded in bf16 mode
template <typename T>
__device__ __forceinline__ float round_to_io(float x) { return x; }
template <>
__device__ __forceinline__ float round_to_io<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
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

// shared memory of each pass, in floats
template <int HDP>
constexpr int smem_floats_a() {
  // q, dO rows [kRows][HDP]; k, v tile [kTile][HDP + 1]; ds [kRows][kTile]
  return 2 * kRows * HDP + 2 * kTile * (HDP + 1) + kRows * kTile;
}
template <int HDP>
constexpr int smem_floats_b() {
  // k, v rows [kRows][HDP]; q, dO tile [kTile][HDP + 1]; p, ds [kRows][kTile];
  // lse, delta [kTile]
  return 2 * kRows * HDP + 2 * kTile * (HDP + 1) + 2 * kRows * kTile + 2 * kTile;
}

// Load `kRows` rows of one head (zero outside S and beyond hd) with stride HDP.
template <typename T, int HDP>
__device__ __forceinline__ void load_rows(float* dst, const T* src, long long row_stride,
                                          int r0, int S, int hd) {
  for (int i = threadIdx.x; i < kRows * HDP; i += blockDim.x) {
    const int r = i / HDP, d = i % HDP, ri = r0 + r;
    dst[i] = (ri < S && d < hd) ? load_f32(src + ri * row_stride + d) : 0.f;
  }
}

// Load a `kTile`-row tile (zero outside S) with stride HDP + 1; columns
// hd..HDP are zeroed once by the caller and never written here.
template <typename T, int HDP>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long row_stride,
                                          int t0, int S, int hd) {
  for (int i = threadIdx.x; i < kTile * hd; i += blockDim.x) {
    const int j = i / hd, d = i % hd, tj = t0 + j;
    dst[j * (HDP + 1) + d] = tj < S ? load_f32(src + tj * row_stride + d) : 0.f;
  }
}

// s and dp of the warp's query rows row0.. against key `lane` of the K/V tile
template <int HDP>
__device__ __forceinline__ void row_scores(const float* q_s, const float* do_s,
                                           const float* k_s, const float* v_s,
                                           int row0, int lane, int hd,
                                           float (&s)[kRowsPerWarp],
                                           float (&dp)[kRowsPerWarp]) {
  constexpr int KS = HDP + 1;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dp[r] = 0.f;
  for (int d = 0; d < hd; ++d) {
    const float kv = k_s[lane * KS + d];
    const float vv = v_s[lane * KS + d];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      s[r] = fmaf(q_s[(row0 + r) * HDP + d], kv, s[r]);
      dp[r] = fmaf(do_s[(row0 + r) * HDP + d], vv, dp[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// pass A: softmax statistics, delta and dq for a tile of query rows
// ---------------------------------------------------------------------------
template <typename T, int HDP>
__global__ void __launch_bounds__(kWarps * 32)
    attn_bwd_dq_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                       T* __restrict__ dqkv, float2* __restrict__ stats, int S,
                       int H, int hd, int n_tiles, float scale) {
  constexpr int kDimsPerLane = HDP / 32;
  constexpr int KS = HDP + 1;
  extern __shared__ float smem[];
  float* q_s = smem;                  // [kRows][HDP]
  float* do_s = q_s + kRows * HDP;    // [kRows][HDP]
  float* k_s = do_s + kRows * HDP;    // [kTile][KS]
  float* v_s = k_s + kTile * KS;      // [kTile][KS]
  float* ds_s = v_s + kTile * KS;     // [kRows][kTile]

  const int D = H * hd;
  const long long qkv_stride = 3LL * D;
  const int b = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x % n_tiles) * kRows;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = warp * kRowsPerWarp;
  const T* base = qkv + (long long)b * S * qkv_stride + (long long)h * hd;
  const T* dobase = dout + (long long)b * S * D + (long long)h * hd;

  load_rows<T, HDP>(q_s, base, qkv_stride, q0, S, hd);
  load_rows<T, HDP>(do_s, dobase, D, q0, S, hd);
  for (int i = tid; i < kTile * KS; i += blockDim.x) {
    k_s[i] = 0.f;
    v_s[i] = 0.f;
  }

  // sweep 1: online max m, sum l and unnormalised rowsum(dp * p)
  float m[kRowsPerWarp], l[kRowsPerWarp], dacc[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    dacc[r] = 0.f;
  }
  for (int k0 = 0; k0 < S; k0 += kTile) {
    __syncthreads();  // q/dO rows and zeroed pads written; last tile consumed
    load_tile<T, HDP>(k_s, base + D, qkv_stride, k0, S, hd);
    load_tile<T, HDP>(v_s, base + 2 * D, qkv_stride, k0, S, hd);
    __syncthreads();
    const bool key_ok = lane < min(kTile, S - k0);
    float s[kRowsPerWarp], dp[kRowsPerWarp];
    row_scores<HDP>(q_s, do_s, k_s, v_s, row0, lane, hd, s, dp);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float sr = key_ok ? s[r] * scale : -INFINITY;
      // lane 0 always holds a real key, so m_new is finite
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float p = key_ok ? expf(sr - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);  // 0 on the first tile
      l[r] = l[r] * corr + warp_sum(p);
      dacc[r] = dacc[r] * corr + warp_sum(p * dp[r]);
      m[r] = m_new;
    }
  }
  float lse[kRowsPerWarp], delta[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    lse[r] = m[r] + logf(l[r]);
    delta[r] = dacc[r] / l[r];
    const int qi = q0 + row0 + r;
    if (lane == 0 && qi < S)
      stats[((long long)b * H + h) * S + qi] = make_float2(lse[r], delta[r]);
  }

  // sweep 2: dq = ds k with ds rounded to the io dtype
  float acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] = 0.f;
  for (int k0 = 0; k0 < S; k0 += kTile) {
    __syncthreads();
    load_tile<T, HDP>(k_s, base + D, qkv_stride, k0, S, hd);
    load_tile<T, HDP>(v_s, base + 2 * D, qkv_stride, k0, S, hd);
    __syncthreads();
    const int n_keys = min(kTile, S - k0);
    const bool key_ok = lane < n_keys;
    float s[kRowsPerWarp], dp[kRowsPerWarp];
    row_scores<HDP>(q_s, do_s, k_s, v_s, row0, lane, hd, s, dp);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float p = key_ok ? expf(s[r] * scale - lse[r]) : 0.f;
      ds_s[(row0 + r) * kTile + lane] = round_to_io<T>(p * (dp[r] - delta[r]) * scale);
    }
    __syncwarp();
    for (int j = 0; j < n_keys; ++j) {
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        const float kv = k_s[j * KS + lane + 32 * i];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          acc[r][i] = fmaf(ds_s[(row0 + r) * kTile + j], kv, acc[r][i]);
      }
    }
    __syncwarp();
  }

  T* dq = dqkv + (long long)b * S * qkv_stride + (long long)h * hd;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + row0 + r;
    if (qi >= S) continue;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) store_f32(dq + qi * qkv_stride + d, acc[r][i]);
    }
  }
}

// ---------------------------------------------------------------------------
// pass B: dk and dv for a tile of key rows
// ---------------------------------------------------------------------------
template <typename T, int HDP>
__global__ void __launch_bounds__(kWarps * 32)
    attn_bwd_dkdv_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                         T* __restrict__ dqkv, const float2* __restrict__ stats,
                         int S, int H, int hd, int n_tiles, float scale) {
  constexpr int kDimsPerLane = HDP / 32;
  constexpr int KS = HDP + 1;
  extern __shared__ float smem[];
  float* k_s = smem;                  // [kRows][HDP]
  float* v_s = k_s + kRows * HDP;     // [kRows][HDP]
  float* q_s = v_s + kRows * HDP;     // [kTile][KS]
  float* do_s = q_s + kTile * KS;     // [kTile][KS]
  float* p_s = do_s + kTile * KS;     // [kRows][kTile]
  float* ds_s = p_s + kRows * kTile;  // [kRows][kTile]
  float* lse_s = ds_s + kRows * kTile;  // [kTile]
  float* dl_s = lse_s + kTile;          // [kTile]

  const int D = H * hd;
  const long long qkv_stride = 3LL * D;
  const int b = blockIdx.x / n_tiles;
  const int k0 = (blockIdx.x % n_tiles) * kRows;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = warp * kRowsPerWarp;
  const T* base = qkv + (long long)b * S * qkv_stride + (long long)h * hd;
  const T* dobase = dout + (long long)b * S * D + (long long)h * hd;
  const float2* st = stats + ((long long)b * H + h) * S;

  load_rows<T, HDP>(k_s, base + D, qkv_stride, k0, S, hd);
  load_rows<T, HDP>(v_s, base + 2 * D, qkv_stride, k0, S, hd);
  for (int i = tid; i < kTile * KS; i += blockDim.x) {
    q_s[i] = 0.f;
    do_s[i] = 0.f;
  }

  float dk[kRowsPerWarp][kDimsPerLane], dv[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) dk[r][i] = dv[r][i] = 0.f;

  for (int q0 = 0; q0 < S; q0 += kTile) {
    __syncthreads();  // key rows and zeroed pads written; last tile consumed
    load_tile<T, HDP>(q_s, base, qkv_stride, q0, S, hd);
    load_tile<T, HDP>(do_s, dobase, D, q0, S, hd);
    for (int i = tid; i < kTile; i += blockDim.x) {
      const float2 v = q0 + i < S ? st[q0 + i] : make_float2(0.f, 0.f);
      lse_s[i] = v.x;
      dl_s[i] = v.y;
    }
    __syncthreads();
    const int n_q = min(kTile, S - q0);
    const bool q_ok = lane < n_q;
    // s and dp of query `lane` against this warp's keys
    float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = dp[r] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float qv = q_s[lane * KS + d];
      const float gv = do_s[lane * KS + d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        s[r] = fmaf(qv, k_s[(row0 + r) * HDP + d], s[r]);
        dp[r] = fmaf(gv, v_s[(row0 + r) * HDP + d], dp[r]);
      }
    }
    const float lse = lse_s[lane], delta = dl_s[lane];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float p = q_ok ? expf(s[r] * scale - lse) : 0.f;
      p_s[(row0 + r) * kTile + lane] = round_to_io<T>(p);
      ds_s[(row0 + r) * kTile + lane] = round_to_io<T>(p * (dp[r] - delta) * scale);
    }
    __syncwarp();
    for (int j = 0; j < n_q; ++j) {
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        const float qv = q_s[j * KS + lane + 32 * i];
        const float gv = do_s[j * KS + lane + 32 * i];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          dv[r][i] = fmaf(p_s[(row0 + r) * kTile + j], gv, dv[r][i]);
          dk[r][i] = fmaf(ds_s[(row0 + r) * kTile + j], qv, dk[r][i]);
        }
      }
    }
    __syncwarp();
  }

  T* out = dqkv + (long long)b * S * qkv_stride + (long long)h * hd;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int kj = k0 + row0 + r;
    if (kj >= S) continue;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) {
        store_f32(out + kj * qkv_stride + D + d, dk[r][i]);
        store_f32(out + kj * qkv_stride + 2 * D + d, dv[r][i]);
      }
    }
  }
}

template <typename T, int HDP>
cudaError_t launch_hdp(const T* qkv, const T* dout, T* dqkv, float2* stats,
                       int B, int S, int H, int hd, float scale,
                       cudaStream_t stream) {
  const int n_tiles = (S + kRows - 1) / kRows;
  const dim3 grid((unsigned)((long long)B * n_tiles), (unsigned)H);
  const dim3 block(kWarps * 32);
  const size_t bytes_a = smem_floats_a<HDP>() * sizeof(float);
  const size_t bytes_b = smem_floats_b<HDP>() * sizeof(float);
  cudaError_t err;
  // above 48 KB a block's dynamic shared memory must be allowed explicitly
  if (bytes_a > 48 * 1024 &&
      (err = cudaFuncSetAttribute(attn_bwd_dq_kernel<T, HDP>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)bytes_a)) != cudaSuccess)
    return err;
  if (bytes_b > 48 * 1024 &&
      (err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<T, HDP>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)bytes_b)) != cudaSuccess)
    return err;
  attn_bwd_dq_kernel<T, HDP><<<grid, block, bytes_a, stream>>>(
      qkv, dout, dqkv, stats, S, H, hd, n_tiles, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  attn_bwd_dkdv_kernel<T, HDP><<<grid, block, bytes_b, stream>>>(
      qkv, dout, dqkv, stats, S, H, hd, n_tiles, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* qkv, const void* dout, void* dqkv,
                         void* stats, int B, int S, int H, int hd, float scale,
                         cudaStream_t stream) {
  const T* in = static_cast<const T*>(qkv);
  const T* g = static_cast<const T*>(dout);
  T* o = static_cast<T*>(dqkv);
  float2* st = static_cast<float2*>(stats);
  switch ((hd + 31) / 32 * 32) {
    case 32:
      return launch_hdp<T, 32>(in, g, o, st, B, S, H, hd, scale, stream);
    case 64:
      return launch_hdp<T, 64>(in, g, o, st, B, S, H, hd, scale, stream);
    case 96:
      return launch_hdp<T, 96>(in, g, o, st, B, S, H, hd, scale, stream);
    case 128:
      return launch_hdp<T, 128>(in, g, o, st, B, S, H, hd, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// qkv: contiguous (B, S, 3*H*hd); dout: contiguous (B, S, H*hd); dqkv:
// contiguous (B, S, 3*H*hd), all of one dtype (0 = float32, 1 = bfloat16);
// stats: float32 scratch of B*H*S*2 floats.  Launches pass A then pass B on
// `stream`; returns the first cudaError_t.
extern "C" int attention_qkv_bwd_launch(const void* qkv, const void* dout,
                                        void* dqkv, void* stats, int B, int S,
                                        int H, int hd, float scale, int dtype,
                                        void* stream) {
  if (B < 1 || S < 1 || H < 1 || H > 65535 || hd < 1 || hd > 128)
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = (S + kRows - 1) / kRows;
  if ((long long)B * n_tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_typed<float>(qkv, dout, dqkv, stats, B, S, H, hd, scale, st);
  if (dtype == 1)
    return (int)launch_typed<__nv_bfloat16>(qkv, dout, dqkv, stats, B, S, H, hd,
                                            scale, st);
  return (int)cudaErrorInvalidValue;
}
