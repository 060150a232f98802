// Padded-head self-attention for Hopper (sm_90a): K5.
//
// Replaces: layoutdm_tpu/ops/attention_blockdiag.py::blockdiag_attention,
// whose Pallas kernel body is _bd_kernel.  Same function: on the padded-head
// (B, S, 3*H*hp) slab (each head's q, k and v zero-padded from hd to hp
// lanes by the weight scatter), per head h
//   o[:, h*hp:(h+1)*hp] = softmax(q_h k_h^T * scale) v_h
// over the S real keys, scale = 1/sqrt(true hd); output (B, S, H*hp) in the
// io dtype, padded lanes included (exactly 0 when v's padded lanes are 0).
// Rounding as the TPU kernel: float32 scores from io-dtype operands, a
// float32 softmax, the NORMALISED probabilities rounded to the io dtype,
// p.v accumulated in float32, one rounding of the output.
//
// The TPU kernel computes this as two GEMMs per batch row against
// block-diagonal k^T and v, about 9x the attention's FLOPs, to feed the
// 128x128 MXU.  That layout exists only for the MXU and is not carried over:
// this kernel computes the per-head attention directly.
//
// What bounds it on this card: at the flagship (B = 1024, S = 125, H = 8,
// hp = 64, bf16) it reads the 393 MB slab and writes 131 MB, ~0.16 ms at
// 3.35 TB/s, against 33 GFLOP, ~0.03 ms on the tensor cores: memory.
//
// What this simple design does about it: one block per (batch row, 32-query
// tile, head), 4 warps of 8 query rows.  hp = 64 puts heads at 128-byte
// offsets, so q, k and v rows are staged into shared memory with 16-byte
// vector loads.  The block keeps its whole (32, S) score tile in shared
// memory (64 KB at S = 500), so the softmax is exact and p is normalised
// before its rounding, as the TPU kernel rounds it; K and V are streamed in
// 32-key chunks, each read once per block, so any S up to the tile's limit
// fits (K+V of one head at S = 500 in f32 would be 256 KB, over a block's
// 227 KB).  Lane j scores key j of a chunk; each lane accumulates the output
// dims lane, lane+32, ... on the CUDA cores.  Left for later: tensor-core
// products, and one K/V load per (row, head) for all query tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 8;
constexpr int kBlockQ = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kBlockK = 32;                      // keys per staged chunk
constexpr int kMaxSeq = 1024;                    // the score tile's limit

__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__device__ __forceinline__ float round_to_io(float x) { return x; }
template <>
__device__ __forceinline__ float round_to_io<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// 16 bytes of the slab -> 16 / sizeof(T) floats
__device__ __forceinline__ void load_vec(const float* p, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
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

// rows [r0, r0 + n) of one head's hp-wide column block into dst (row pitch
// `pitch` floats), zeros past the sequence end
template <typename T, int HP>
__device__ __forceinline__ void stage_rows(const T* col, long long token_stride,
                                           int r0, int n, int S, float* dst,
                                           int pitch) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecsPerRow = HP / kVec;
  for (int i = threadIdx.x; i < n * kVecsPerRow; i += blockDim.x) {
    const int r = i / kVecsPerRow, c = (i % kVecsPerRow) * kVec;
    float v[kVec];
    if (r0 + r < S) {
      load_vec(col + (r0 + r) * token_stride + c, v);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) dst[r * pitch + c + e] = v[e];
  }
}

template <typename T, int HP>
__global__ void __launch_bounds__(kWarps * 32)
    blockdiag_kernel(const T* __restrict__ qkv, T* __restrict__ out, int S,
                     int H, int n_qtiles, int s_pitch, float scale) {
  constexpr int kDimsPerLane = HP / 32;
  extern __shared__ float smem[];
  float* q_s = smem;                          // [kBlockQ][HP]
  float* kv_s = q_s + kBlockQ * HP;           // [kBlockK][HP + 1], K then V
  float* s_s = kv_s + kBlockK * (HP + 1);     // [kBlockQ][s_pitch] scores, then p

  const int Hp = H * HP;
  const long long token_stride = 3LL * Hp;
  const int b = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kBlockQ;
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* row0 = qkv + (long long)b * S * token_stride + (long long)h * HP;

  stage_rows<T, HP>(row0, token_stride, q0, kBlockQ, S, q_s, HP);

  // scores of this warp's rows against every key, scaled; -inf past S
  for (int k0 = 0; k0 < S; k0 += kBlockK) {
    __syncthreads();  // q_s written; the last chunk consumed
    stage_rows<T, HP>(row0 + Hp, token_stride, k0, kBlockK, S, kv_s, HP + 1);
    __syncthreads();
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HP; ++d) {
      const float kd = kv_s[lane * (HP + 1) + d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
        s[r] = fmaf(q_s[(warp * kRowsPerWarp + r) * HP + d], kd, s[r]);
    }
    const bool key_ok = k0 + lane < S;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
      s_s[(warp * kRowsPerWarp + r) * s_pitch + k0 + lane] =
          key_ok ? s[r] * scale : -INFINITY;
  }
  __syncwarp();

  // exact softmax per row, the normalised p rounded to the io dtype
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float* sr = s_s + (warp * kRowsPerWarp + r) * s_pitch;
    float m = -INFINITY;
    for (int j = lane; j < S; j += 32) m = fmaxf(m, sr[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(sr[j] - m);
      sr[j] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int j = lane; j < S; j += 32) sr[j] = round_to_io<T>(sr[j] / l);
  }
  __syncwarp();

  float acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] = 0.f;
  for (int k0 = 0; k0 < S; k0 += kBlockK) {
    __syncthreads();  // every warp is done with kv_s (the K chunk or last V chunk)
    stage_rows<T, HP>(row0 + 2 * Hp, token_stride, k0, kBlockK, S, kv_s, HP + 1);
    __syncthreads();
    const int n_keys = min(kBlockK, S - k0);
    for (int j = 0; j < n_keys; ++j) {
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        const float vv = kv_s[j * (HP + 1) + lane + 32 * i];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          acc[r][i] = fmaf(s_s[(warp * kRowsPerWarp + r) * s_pitch + k0 + j], vv,
                           acc[r][i]);
      }
    }
  }

  T* obase = out + (long long)b * S * Hp + (long long)h * HP;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + warp * kRowsPerWarp + r;
    if (qi >= S) continue;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i)
      store_f32(obase + (long long)qi * Hp + lane + 32 * i, acc[r][i]);
  }
}

template <typename T, int HP>
cudaError_t launch_typed(const void* qkv, void* out, int B, int S, int H,
                         float scale, cudaStream_t stream) {
  const int n_qtiles = (S + kBlockQ - 1) / kBlockQ;
  const int s_pitch = (S + kBlockK - 1) / kBlockK * kBlockK;
  const size_t smem = sizeof(float) *
      ((size_t)kBlockQ * HP + (size_t)kBlockK * (HP + 1) + (size_t)kBlockQ * s_pitch);
  auto kernel = blockdiag_kernel<T, HP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((long long)B * n_qtiles), (unsigned)H);
  kernel<<<grid, kWarps * 32, smem, stream>>>(static_cast<const T*>(qkv),
                                              static_cast<T*>(out), S, H, n_qtiles,
                                              s_pitch, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hp(const void* qkv, void* out, int B, int S, int H, int hp,
                      float scale, cudaStream_t stream) {
  if (hp == 64) return launch_typed<T, 64>(qkv, out, B, S, H, scale, stream);
  if (hp == 128) return launch_typed<T, 128>(qkv, out, B, S, H, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// qkv_pad: contiguous (B, S, 3*H*hp), 16-byte aligned; out: contiguous
// (B, S, H*hp), same dtype; hp = 64 or 128; S <= 1024.
// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int attention_blockdiag_launch(const void* qkv_pad, void* out, int B,
                                          int S, int H, int hp, float scale,
                                          int dtype, void* stream) {
  if (B < 1 || S < 1 || S > kMaxSeq || H < 1 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long n_qtiles = (S + kBlockQ - 1) / kBlockQ;
  if ((long long)B * n_qtiles > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_hp<float>(qkv_pad, out, B, S, H, hp, scale, st);
  if (dtype == 1)
    return (int)launch_hp<__nv_bfloat16>(qkv_pad, out, B, S, H, hp, scale, st);
  return (int)cudaErrorInvalidValue;
}
