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
// 3.35 TB/s, against 33 GFLOP, ~0.03 ms on the tensor cores: memory.  So
// every byte of q, k and v should leave device memory once, and the products
// must not be what limits the kernel.
//
// What this design does about it (bfloat16):
// - One block per (batch row, head, 128 query rows): at S <= 128 that is one
//   block per (row, head), so K_h and V_h are read from device memory once.
//   8 warps; each warp owns 16 query rows.  Q, K and V rows are staged with
//   16-byte cp.async copies (hp = 64 puts heads at 128-byte offsets) into
//   shared tiles of pitch hp + 8, which keeps ldmatrix free of bank
//   conflicts: 3 x 18 KB at hp = 64.
// - Both products run on the tensor cores as raw mma.sync m16n8k16 (bf16 in,
//   float32 accumulate), operands from shared memory by ldmatrix.  The score
//   accumulators of two neighbouring 8-key tiles are, register for register,
//   the A operand of the next product, so p is normalised, rounded to bf16
//   and fed to p.v without leaving registers.
// - Softmax: K is taken in chunks of 128 keys.  At S <= 128, the flagship,
//   a warp's whole (16, S) score row is one chunk in registers (16 tiles x 4
//   floats a lane), and the softmax is exact in one sweep: quad shuffles for
//   the max and the sum, then p.v.  For 128 < S <= 1024 the kernel sweeps K
//   twice: first the row max and sum (each chunk's scores folded in as they
//   come), then the scores again, each p normalised by the final statistics
//   and rounded before its p.v.  A second sweep costs one more q.k^T on the
//   tensor cores and one more read of K from L2; keeping the f32 scores in
//   shared memory instead would take 128 rows x 1024 x 4 B = 512 KB.  An
//   online rescale of an unnormalised p is not used: the TPU kernel rounds
//   the normalised p.
// - The output tile goes through the warp's own Q rows in shared memory and
//   leaves in 16-byte stores.
// float32 keeps exact float32 FMAs on the CUDA cores (no TF32, which keeps
// ~3 decimal digits): one block per (row, 32-query tile, head), the whole
// (32, S) score tile in shared memory, K and V streamed in 32-key chunks.

#include <climits>
#include <cmath>

#include "mma_sync.cuh"

namespace {

constexpr int kMaxSeq = 1024;

using mma::bf16;

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------
constexpr int kWarps = 8;
constexpr int kBlockQ = kWarps * 16;  // query rows per block
constexpr int kChunk = 128;           // keys per K/V chunk

template <int HP>
constexpr size_t smem_bytes_bf16() {
  return sizeof(bf16) * (size_t)(kBlockQ + 2 * kChunk) * (HP + 8);
}

template <int HP>
__global__ void __launch_bounds__(kWarps * 32, HP == 64 ? 2 : 1)
    blockdiag_bf16_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int S, int H,
                          int n_qblocks, float c2) {
  constexpr int P = HP + 8;  // shared row pitch
  constexpr int NT = kChunk / 8;
  constexpr int KD = HP / 16;
  constexpr int DT = HP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kBlockQ][P]
  bf16* k_s = q_s + kBlockQ * P;                   // [kChunk][P]
  bf16* v_s = k_s + kChunk * P;                    // [kChunk][P]

  const int Hp = H * HP;
  const long long ts = 3LL * Hp;  // token stride
  const int b = blockIdx.x / n_qblocks;
  const int q0 = (blockIdx.x % n_qblocks) * kBlockQ;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const bf16* head = qkv + (long long)b * S * ts + (long long)h * HP;
  const int n_chunks = (S + kChunk - 1) / kChunk;
  const int wq = q0 + warp * 16;  // the warp's first query row
  const bool live = wq < S;
  bf16* qw = q_s + warp * 16 * P;

  mma::load_rows(q_s, P, head + q0 * ts, ts, kBlockQ, S - q0, HP, HP, 16);

  // sweep 1: row max m and sum l (per lane: rows g and g + 8 of the warp)
  float s[NT][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int c = 0; c < n_chunks; ++c) {
    const int k0 = c * kChunk;
    if (c > 0) __syncthreads();  // every warp is done with the last chunk
    mma::load_rows(k_s, P, head + Hp + k0 * ts, ts, kChunk, S - k0, HP, HP, 16);
    if (n_chunks == 1) mma::load_rows(v_s, P, head + 2 * Hp, ts, kChunk, S, HP, HP, 16);
    tile::cp_async_commit();
    tile::cp_async_wait<0>();
    __syncthreads();
    if (!live) continue;
    const int n16 = (min(kChunk, S - k0) + 15) >> 4;
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma::mma_abt<KD, NT / 2>(s, qw, k_s, P, n16);
    mma::scale_mask(s, k0, S, c2, n16);
    float mc[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j < 2 * n16)
#pragma unroll
        for (int e = 0; e < 4; ++e) mc[e >> 1] = fmaxf(mc[e >> 1], s[j][e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mc[r] = mma::quad_max(mc[r]);
      l[r] *= exp2f(m[r] - mc[r]);  // 0 on the first chunk
      m[r] = mc[r];
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j < 2 * n16)
#pragma unroll
        for (int e = 0; e < 4; ++e) l[e >> 1] += exp2f(s[j][e] - m[e >> 1]);
  }
  const float inv_l[2] = {1.f / mma::quad_sum(l[0]), 1.f / mma::quad_sum(l[1])};

  // sweep 2 (the scores of a single chunk are still in registers): p
  // normalised, rounded to bf16, p.v
  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const int k0 = c * kChunk;
    const int n16 = (min(kChunk, S - k0) + 15) >> 4;
    if (n_chunks > 1) {
      __syncthreads();
      mma::load_rows(k_s, P, head + Hp + k0 * ts, ts, kChunk, S - k0, HP, HP, 16);
      mma::load_rows(v_s, P, head + 2 * Hp + k0 * ts, ts, kChunk, S - k0, HP, HP, 16);
      tile::cp_async_commit();
      tile::cp_async_wait<0>();
      __syncthreads();
      if (live) {
#pragma unroll
        for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        mma::mma_abt<KD, NT / 2>(s, qw, k_s, P, n16);
        mma::scale_mask(s, k0, S, c2, n16);
      }
    }
    if (!live) continue;
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      if (kk < n16) {
        float p0[4], p1[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p0[e] = exp2f(s[2 * kk][e] - m[e >> 1]) * inv_l[e >> 1];
          p1[e] = exp2f(s[2 * kk + 1][e] - m[e >> 1]) * inv_l[e >> 1];
        }
        uint32_t a[4];
        mma::pack_a(a, p0, p1);
        mma::mma_ab<DT>(o, a, v_s + kk * 16 * P, P);
      }
    }
  }
  if (!live) return;

  // the output through the warp's own Q rows, out in 16-byte stores
  __syncwarp();
  mma::store_acc<DT>(qw, P, o);
  __syncwarp();
  mma::store_rows(out + ((long long)b * S + wq) * Hp + (long long)h * HP, Hp, qw, P,
                  min(16, S - wq), HP, 16);
}

template <int HP>
cudaError_t launch_bf16(const void* qkv, void* out, int B, int S, int H, float scale,
                        cudaStream_t stream) {
  const int n_qblocks = (S + kBlockQ - 1) / kBlockQ;
  const size_t smem = smem_bytes_bf16<HP>();
  auto kernel = blockdiag_bf16_kernel<HP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((long long)B * n_qblocks), (unsigned)H);
  kernel<<<grid, kWarps * 32, smem, stream>>>(static_cast<const bf16*>(qkv),
                                              static_cast<bf16*>(out), S, H, n_qblocks,
                                              scale * mma::kLog2e);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: exact FMAs on the CUDA cores
// ---------------------------------------------------------------------------
constexpr int kF32Warps = 4;
constexpr int kF32RowsPerWarp = 8;
constexpr int kF32BlockQ = kF32Warps * kF32RowsPerWarp;  // query rows per block
constexpr int kF32BlockK = 32;                           // keys per staged chunk

// rows [r0, r0 + n) of one head's hp-wide column block into dst (row pitch
// `pitch` floats), zeros past the sequence end; 16-byte loads
template <int HP>
__device__ __forceinline__ void stage_rows(const float* col, long long token_stride, int r0, int n,
                                           int S, float* dst, int pitch) {
  constexpr int kVecsPerRow = HP / 4;
  for (int i = threadIdx.x; i < n * kVecsPerRow; i += blockDim.x) {
    const int r = i / kVecsPerRow, c = (i % kVecsPerRow) * 4;
    const float4 v = r0 + r < S
                         ? *reinterpret_cast<const float4*>(col + (r0 + r) * token_stride + c)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    dst[r * pitch + c] = v.x;
    dst[r * pitch + c + 1] = v.y;
    dst[r * pitch + c + 2] = v.z;
    dst[r * pitch + c + 3] = v.w;
  }
}

template <int HP>
__global__ void __launch_bounds__(kF32Warps * 32)
    blockdiag_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out, int S, int H,
                         int n_qtiles, int s_pitch, float scale) {
  constexpr int kDimsPerLane = HP / 32;
  constexpr int R = kF32RowsPerWarp;
  extern __shared__ float smem[];
  float* q_s = smem;                            // [kF32BlockQ][HP]
  float* kv_s = q_s + kF32BlockQ * HP;          // [kF32BlockK][HP + 1], K then V
  float* s_s = kv_s + kF32BlockK * (HP + 1);    // [kF32BlockQ][s_pitch] scores, then p

  const int Hp = H * HP;
  const long long token_stride = 3LL * Hp;
  const int b = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kF32BlockQ;
  const int h = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const float* row0 = qkv + (long long)b * S * token_stride + (long long)h * HP;

  stage_rows<HP>(row0, token_stride, q0, kF32BlockQ, S, q_s, HP);

  // scores of this warp's rows against every key, scaled; -inf past S
  for (int k0 = 0; k0 < S; k0 += kF32BlockK) {
    __syncthreads();  // q_s written; the last chunk consumed
    stage_rows<HP>(row0 + Hp, token_stride, k0, kF32BlockK, S, kv_s, HP + 1);
    __syncthreads();
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HP; ++d) {
      const float kd = kv_s[lane * (HP + 1) + d];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = fmaf(q_s[(warp * R + r) * HP + d], kd, s[r]);
    }
    const bool key_ok = k0 + lane < S;
#pragma unroll
    for (int r = 0; r < R; ++r)
      s_s[(warp * R + r) * s_pitch + k0 + lane] = key_ok ? s[r] * scale : -INFINITY;
  }
  __syncwarp();

  // exact softmax per row
  for (int r = 0; r < R; ++r) {
    float* sr = s_s + (warp * R + r) * s_pitch;
    float m = -INFINITY;
    for (int j = lane; j < S; j += 32) m = fmaxf(m, sr[j]);
    m = tile::warp_max(m);
    float l = 0.f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(sr[j] - m);
      sr[j] = e;
      l += e;
    }
    l = tile::warp_sum(l);
    for (int j = lane; j < S; j += 32) sr[j] /= l;
  }
  __syncwarp();

  float acc[R][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] = 0.f;
  for (int k0 = 0; k0 < S; k0 += kF32BlockK) {
    __syncthreads();  // every warp is done with kv_s (the K chunk or last V chunk)
    stage_rows<HP>(row0 + 2 * Hp, token_stride, k0, kF32BlockK, S, kv_s, HP + 1);
    __syncthreads();
    const int n_keys = min(kF32BlockK, S - k0);
    for (int j = 0; j < n_keys; ++j) {
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        const float vv = kv_s[j * (HP + 1) + lane + 32 * i];
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[r][i] = fmaf(s_s[(warp * R + r) * s_pitch + k0 + j], vv, acc[r][i]);
      }
    }
  }

  float* obase = out + (long long)b * S * Hp + (long long)h * HP;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + warp * R + r;
    if (qi >= S) continue;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) obase[(long long)qi * Hp + lane + 32 * i] = acc[r][i];
  }
}

template <int HP>
cudaError_t launch_f32(const void* qkv, void* out, int B, int S, int H, float scale,
                       cudaStream_t stream) {
  const int n_qtiles = (S + kF32BlockQ - 1) / kF32BlockQ;
  const int s_pitch = (S + kF32BlockK - 1) / kF32BlockK * kF32BlockK;
  const size_t smem = sizeof(float) * ((size_t)kF32BlockQ * HP + (size_t)kF32BlockK * (HP + 1) +
                                       (size_t)kF32BlockQ * s_pitch);
  auto kernel = blockdiag_f32_kernel<HP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((long long)B * n_qtiles), (unsigned)H);
  kernel<<<grid, kF32Warps * 32, smem, stream>>>(static_cast<const float*>(qkv),
                                                 static_cast<float*>(out), S, H, n_qtiles,
                                                 s_pitch, scale);
  return cudaGetLastError();
}

}  // namespace

// qkv_pad: contiguous (B, S, 3*H*hp), 16-byte aligned; out: contiguous
// (B, S, H*hp), same dtype; hp = 64 or 128; S <= 1024.
// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int attention_blockdiag_launch(const void* qkv_pad, void* out, int B, int S, int H,
                                          int hp, float scale, int dtype, void* stream) {
  if (B < 1 || S < 1 || S > kMaxSeq || H < 1 || H > 65535 || (hp != 64 && hp != 128))
    return (int)cudaErrorInvalidValue;
  const long long n_qtiles = (S + kF32BlockQ - 1) / kF32BlockQ;  // the finer of the two tilings
  if ((long long)B * n_qtiles > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)(hp == 64 ? launch_f32<64>(qkv_pad, out, B, S, H, scale, st)
                          : launch_f32<128>(qkv_pad, out, B, S, H, scale, st));
  if (dtype == 1)
    return (int)(hp == 64 ? launch_bf16<64>(qkv_pad, out, B, S, H, scale, st)
                          : launch_bf16<128>(qkv_pad, out, B, S, H, scale, st));
  return (int)cudaErrorInvalidValue;
}
