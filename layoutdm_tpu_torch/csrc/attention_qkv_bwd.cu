// Backward of packed-qkv self-attention for Hopper (sm_90a): K2.
//
// Replaces: layoutdm_tpu/ops/attention.py::fused_attention_qkv_bwd, whose
// Pallas kernel body is _attn_bwd_kernel_qkv.  Same function: for the packed
// (B, S, 3D) slab (heads as the column blocks [h*hd], [D + h*hd],
// [2D + h*hd] of q, k, v) and the cotangent dO (B, S, D) of the attention
// output, per head with p = softmax(q k^T * scale):
//   dv = p^T dO,  dp = dO v^T,  ds = p * (dp - rowsum(dp * p)) * scale,
//   dq = ds k,    dk = ds^T q,
// written as one packed (B, S, 3D) d(qkv) slab in the input dtype (float32
// or bfloat16).  Rounding points follow the TPU kernel: scores, softmax,
// delta = rowsum(dp * p) and accumulation in float32; in bfloat16 mode p is
// rounded to bfloat16 only as the operand of p^T dO, and ds only as the
// operand of ds k and ds^T q.  The residual is the qkv slab only: the
// softmax is recomputed, never stored.
//
// What bounds it on this card: at the flagship (B = 1024, S = 125, H = 8,
// hd = 58, bf16) it reads the slab and dO and writes d(qkv), 831 MB, ~0.25
// ms at 3.35 TB/s; the five products are ~75 GFLOP, ~0.08 ms on the tensor
// cores.  Memory, as long as the products run on the tensor cores and the
// recomputed softmax does not re-read K/V or Q/dO from device memory more
// than a few times.
//
// What this design does about it (bfloat16), in the manner of
// FlashAttention-2, with no atomics, no (S, S) tensor in device memory, and
// the same result on every run:
// - Every product (s, dp, dv, dq, dk, and s, dp again where a pass
//   recomputes them) is a raw mma.sync m16n8k16 (bf16 in, float32
//   accumulate), operands from shared memory by ldmatrix.  The accumulators
//   of two neighbouring 8-column tiles are, register for register, the A
//   operand of the next product: p and ds are rounded to bf16 exactly where
//   the TPU kernel rounds them, in registers.
// - Loads are 16-byte cp.async copies although hd = 58 puts heads at
//   116-byte offsets: a token's row starts 16-byte aligned, so a head slice
//   starts 4-byte aligned, 0, 2, 4 or 6 elements into the aligned 16-byte
//   window around it.  A shared row holds that window, HDP = 64 columns at
//   hd = 58 (a multiple of 32 >= hd + 6, so a multiple of 16 as the depth
//   of k and the width of n), zero outside the slice: the copy zero-fills
//   past it and the copying thread zeroes the previous head's leading words
//   (mma_sync.cuh, mode 16).  Products over the window's columns are the
//   slice's products, and d(qkv) tiles in window columns go back in 16-byte
//   stores inside the slice and 4-byte stores at its two ends.  Rows have a
//   pitch of HDP + 8, so ldmatrix is free of bank conflicts.  Where the
//   layout allows no window (d_model not a multiple of 8, an odd hd, hd >
//   122) rows are copied element by element to column 0, hd zero-padded to
//   a multiple of 32.
// - The grid walks the heads of one row tile side by side, so the 32-byte
//   sectors that two neighbouring heads' slices share are read and written
//   while they are in L2.
// - Tiles of 64 rows, 4 warps of 16.  Pass A, one block per (row, head, 64
//   query rows): K and V come in chunks of 128 keys.  Each warp's scores
//   against a chunk stay in registers (16 tiles x 4 floats a lane); the
//   first sweep folds them into the row max, sum and rowsum(dp * p) (dp
//   recomputed per 16 keys), writes lse (base 2, the scores' domain) and
//   delta to a (B, H, S, 2) f32 scratch, and the second sweep forms ds and dq += ds k.  At S <= 128 K
//   and V are one chunk: loaded once and the scores never recomputed, so
//   the two sweeps are one pass over K/V.  Past 128 keys both sweeps
//   stream the chunks.  Pass B, one block per (row, head, 64 key rows):
//   streams Q/dO in chunks of 64 queries with their lse and delta, forms
//   s^T and dp^T 16 queries at a time, and accumulates dv += p^T dO and
//   dk += ds^T q.  K/V are read once per query tile, Q/dO once per key
//   tile: twice each at S = 125.
// - d(qkv) tiles go through the warp's own rows in shared memory on their
//   way out.
// float32 keeps exact float32 FMAs on the CUDA cores (no TF32): the same two
// passes with 16-row tiles, lane j working on element j of a 32-wide
// streamed tile.

#include <climits>
#include <cmath>
#include <type_traits>

#include "mma_sync.cuh"

namespace {

using mma::bf16;

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------
constexpr int kWarps = 4;
constexpr int kTile = kWarps * 16;  // query (pass A) or key (pass B) rows per block
constexpr int kChunkA = 128;        // keys per K/V chunk, pass A
constexpr int kChunkB = 64;         // queries per Q/dO chunk, pass B

template <int HDP>
constexpr size_t smem_bytes_a() {
  return sizeof(bf16) * (size_t)(2 * kTile + 2 * kChunkA) * (HDP + 8);
}
template <int HDP>
constexpr size_t smem_bytes_b() {
  return sizeof(bf16) * (size_t)(2 * kTile + 2 * kChunkB) * (HDP + 8) +
         sizeof(float) * 2 * kChunkB;
}

// pass A: softmax statistics, delta and dq for 64 query rows
template <int HDP>
__global__ void __launch_bounds__(kWarps * 32)
    dq_bf16_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                   bf16* __restrict__ dqkv, float2* __restrict__ stats, int S, int H, int hd,
                   int n_tiles, float scale, int mode) {
  constexpr int P = HDP + 8;
  constexpr int NT = kChunkA / 8;
  constexpr int KD = HDP / 16;
  constexpr int DT = HDP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kTile][P]
  bf16* do_s = q_s + kTile * P;                    // [kTile][P]
  bf16* k_s = do_s + kTile * P;                    // [kChunkA][P]
  bf16* v_s = k_s + kChunkA * P;                   // [kChunkA][P]

  const int D = H * hd;
  const long long ld = 3LL * D;
  // the heads of one row tile are neighbours in the grid, so the 32-byte
  // sectors that two heads' slices share are read and written close in time
  const int h = blockIdx.x % H, rt = blockIdx.x / H;
  const int b = rt / n_tiles;
  const int q0 = (rt % n_tiles) * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  const bf16* head = qkv + (long long)b * S * ld + (long long)h * hd;
  const bf16* dhead = dout + (long long)b * S * D + (long long)h * hd;
  const int n_chunks = (S + kChunkA - 1) / kChunkA;
  const int wq = q0 + warp * 16;
  const bool live = wq < S;
  bf16* qw = q_s + warp * 16 * P;
  const bf16* dow = do_s + warp * 16 * P;
  const float c2 = scale * mma::kLog2e;

  if (mode != 16 && hd < HDP) mma::zero_pad_cols<HDP>(q_s, 2 * kTile + 2 * kChunkA, hd);
  mma::load_rows(q_s, P, head + q0 * ld, ld, kTile, S - q0, hd, HDP, mode);
  mma::load_rows(do_s, P, dhead + (long long)q0 * D, D, kTile, S - q0, hd, HDP, mode);

  // the K/V chunk at key k0 (with the Q/dO rows on the first call)
  auto load_kv = [&](int k0, bool first) {
    mma::load_rows(k_s, P, head + D + k0 * ld, ld, kChunkA, S - k0, hd, HDP, mode);
    mma::load_rows(v_s, P, head + 2 * D + k0 * ld, ld, kChunkA, S - k0, hd, HDP, mode);
    tile::cp_async_commit();
    tile::cp_async_wait<0>();
    if (first) {
      mma::clear_leads(q_s, P, head, kTile, HDP, mode);
      mma::clear_leads(do_s, P, dhead, kTile, HDP, mode);
    }
    mma::clear_leads(k_s, P, head, kChunkA, HDP, mode);
    mma::clear_leads(v_s, P, head, kChunkA, HDP, mode);
    __syncthreads();
  };
  auto scores = [&](float (&s)[NT][4], int k0, int n16) {
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma::mma_abt<KD, NT / 2>(s, qw, k_s, P, n16);
    mma::scale_mask(s, k0, S, c2, n16);
  };
  // dp of the warp's rows against keys 16kk .. 16kk + 15 of the chunk
  auto dp16 = [&](float (&dp)[2][4], int kk) {
#pragma unroll
    for (int j = 0; j < 2; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    mma::mma_abt<KD, 1>(dp, dow, v_s + kk * 16 * P, P, 1);
  };

  // sweep 1: row max m, sum l and unnormalised rowsum(dp * p), per lane for
  // rows g and g + 8 of the warp
  float s[NT][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dacc[2] = {0.f, 0.f};
  for (int c = 0; c < n_chunks; ++c) {
    const int k0 = c * kChunkA;
    if (c > 0) __syncthreads();  // every warp is done with the last chunk
    load_kv(k0, c == 0);
    if (!live) continue;
    const int n16 = (min(kChunkA, S - k0) + 15) >> 4;
    scores(s, k0, n16);
    float mc[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j < 2 * n16)
#pragma unroll
        for (int e = 0; e < 4; ++e) mc[e >> 1] = fmaxf(mc[e >> 1], s[j][e]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mc[r] = mma::quad_max(mc[r]);
      const float corr = exp2f(m[r] - mc[r]);  // 0 on the first chunk
      l[r] *= corr;
      dacc[r] *= corr;
      m[r] = mc[r];
    }
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      if (kk < n16) {
        float dp[2][4];
        dp16(dp, kk);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2f(s[2 * kk + jj][e] - m[e >> 1]);
            l[e >> 1] += p;
            dacc[e >> 1] += p * dp[jj][e];
          }
      }
    }
  }
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = mma::quad_sum(l[r]);
    lse[r] = m[r] + log2f(lr);  // log2 domain, as the scores
    delta[r] = mma::quad_sum(dacc[r]) / lr;
    const int qi = wq + g + 8 * r;
    if (live && (lane & 3) == 0 && qi < S)
      stats[((long long)b * H + h) * S + qi] = make_float2(lse[r], delta[r]);
  }

  // sweep 2: ds rounded to bf16, dq = ds k (a single chunk's scores are
  // still in registers)
  float dq[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const int k0 = c * kChunkA;
    const int n16 = (min(kChunkA, S - k0) + 15) >> 4;
    if (n_chunks > 1) {
      __syncthreads();
      load_kv(k0, false);
      if (live) scores(s, k0, n16);
    }
    if (!live) continue;
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      if (kk < n16) {
        float dp[2][4], ds[2][4];
        dp16(dp, kk);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2f(s[2 * kk + jj][e] - lse[e >> 1]);
            ds[jj][e] = p * (dp[jj][e] - delta[e >> 1]) * scale;
          }
        uint32_t a[4];
        mma::pack_a(a, ds[0], ds[1]);
        mma::mma_ab<DT>(dq, a, k_s + kk * 16 * P, P);
      }
    }
  }
  if (!live) return;
  __syncwarp();
  mma::store_acc<DT>(qw, P, dq);
  __syncwarp();
  mma::store_rows(dqkv + ((long long)b * S + wq) * ld + (long long)h * hd, ld, qw, P,
                  min(16, S - wq), hd, mode);
}

// pass B: dk and dv for 64 key rows
template <int HDP>
__global__ void __launch_bounds__(kWarps * 32)
    dkdv_bf16_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                     bf16* __restrict__ dqkv, const float2* __restrict__ stats, int S, int H,
                     int hd, int n_tiles, float scale, int mode) {
  constexpr int P = HDP + 8;
  constexpr int KD = HDP / 16;
  constexpr int DT = HDP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [kTile][P]
  bf16* v_s = k_s + kTile * P;                     // [kTile][P]
  bf16* q_s = v_s + kTile * P;                     // [kChunkB][P]
  bf16* do_s = q_s + kChunkB * P;                  // [kChunkB][P]
  float* lse_s = reinterpret_cast<float*>(do_s + kChunkB * P);  // [kChunkB]
  float* dl_s = lse_s + kChunkB;                                 // [kChunkB]

  const int D = H * hd;
  const long long ld = 3LL * D;
  const int h = blockIdx.x % H, rt = blockIdx.x / H;  // as in pass A
  const int b = rt / n_tiles;
  const int k0 = (rt % n_tiles) * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const bf16* head = qkv + (long long)b * S * ld + (long long)h * hd;
  const bf16* dhead = dout + (long long)b * S * D + (long long)h * hd;
  const float2* st = stats + ((long long)b * H + h) * S;
  const int wk = k0 + warp * 16;
  const bool live = wk < S;
  bf16* kw = k_s + warp * 16 * P;
  bf16* vw = v_s + warp * 16 * P;
  const float c2 = scale * mma::kLog2e;

  if (mode != 16 && hd < HDP) mma::zero_pad_cols<HDP>(k_s, 2 * kTile + 2 * kChunkB, hd);
  mma::load_rows(k_s, P, head + D + k0 * ld, ld, kTile, S - k0, hd, HDP, mode);
  mma::load_rows(v_s, P, head + 2 * D + k0 * ld, ld, kTile, S - k0, hd, HDP, mode);

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int q0 = 0; q0 < S; q0 += kChunkB) {
    __syncthreads();  // key rows and zeroed pads written; the last chunk consumed
    mma::load_rows(q_s, P, head + q0 * ld, ld, kChunkB, S - q0, hd, HDP, mode);
    mma::load_rows(do_s, P, dhead + (long long)q0 * D, D, kChunkB, S - q0, hd, HDP, mode);
    for (int i = threadIdx.x; i < kChunkB; i += blockDim.x) {
      const float2 v = q0 + i < S ? st[q0 + i] : make_float2(0.f, 0.f);
      lse_s[i] = v.x;
      dl_s[i] = v.y;
    }
    tile::cp_async_commit();
    tile::cp_async_wait<0>();
    if (q0 == 0) {
      mma::clear_leads(k_s, P, head, kTile, HDP, mode);
      mma::clear_leads(v_s, P, head, kTile, HDP, mode);
    }
    mma::clear_leads(q_s, P, head, kChunkB, HDP, mode);
    mma::clear_leads(do_s, P, dhead, kChunkB, HDP, mode);
    __syncthreads();
    if (!live) continue;
    const int n16 = (min(kChunkB, S - q0) + 15) >> 4;
#pragma unroll
    for (int kk = 0; kk < kChunkB / 16; ++kk) {
      if (kk < n16) {
        // s^T and dp^T of the warp's 16 keys against queries 16kk .. 16kk + 15
        float sT[2][4], dpT[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
        mma::mma_abt<KD, 1>(sT, kw, q_s + kk * 16 * P, P, 1);
        mma::mma_abt<KD, 1>(dpT, vw, do_s + kk * 16 * P, P, 1);
        float p[2][4], ds[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = kk * 16 + jj * 8 + 2 * t + (e & 1);
            p[jj][e] = q0 + qi < S ? exp2f(sT[jj][e] * c2 - lse_s[qi]) : 0.f;
            ds[jj][e] = p[jj][e] * (dpT[jj][e] - dl_s[qi]) * scale;
          }
        uint32_t ap[4], ads[4];
        mma::pack_a(ap, p[0], p[1]);
        mma::pack_a(ads, ds[0], ds[1]);
        mma::mma_ab<DT>(dv, ap, do_s + kk * 16 * P, P);
        mma::mma_ab<DT>(dk, ads, q_s + kk * 16 * P, P);
      }
    }
  }
  if (!live) return;
  __syncwarp();
  mma::store_acc<DT>(kw, P, dk);
  mma::store_acc<DT>(vw, P, dv);
  __syncwarp();
  bf16* out = dqkv + ((long long)b * S + wk) * ld + (long long)h * hd;
  mma::store_rows(out + D, ld, kw, P, min(16, S - wk), hd, mode);
  mma::store_rows(out + 2 * D, ld, vw, P, min(16, S - wk), hd, mode);
}

template <int HDP>
cudaError_t launch_bf16(const bf16* qkv, const bf16* dout, bf16* dqkv, float2* stats, int B,
                        int S, int H, int hd, float scale, int mode, cudaStream_t stream) {
  const int n_tiles = (S + kTile - 1) / kTile;
  const dim3 grid((unsigned)((long long)B * n_tiles * H));
  const size_t bytes_a = smem_bytes_a<HDP>(), bytes_b = smem_bytes_b<HDP>();
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(dq_bf16_kernel<HDP>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes_a)) !=
          cudaSuccess ||
      (err = cudaFuncSetAttribute(dkdv_bf16_kernel<HDP>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes_b)) !=
          cudaSuccess)
    return err;
  dq_bf16_kernel<HDP><<<grid, kWarps * 32, bytes_a, stream>>>(qkv, dout, dqkv, stats, S, H, hd,
                                                              n_tiles, scale, mode);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkdv_bf16_kernel<HDP><<<grid, kWarps * 32, bytes_b, stream>>>(qkv, dout, dqkv, stats, S, H,
                                                                hd, n_tiles, scale, mode);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: exact FMAs on the CUDA cores
// ---------------------------------------------------------------------------
constexpr int kF32Warps = 4;
constexpr int kF32RowsPerWarp = 4;
constexpr int kF32Rows = kF32Warps * kF32RowsPerWarp;  // query (A) or key (B) rows per block
constexpr int kF32Tile = 32;  // keys (A) or queries (B) per streamed tile

// shared memory of each pass, in floats
template <int HDP>
constexpr int smem_floats_a() {
  // q, dO rows [kF32Rows][HDP]; k, v tile [kF32Tile][HDP + 1]; ds [kF32Rows][kF32Tile]
  return 2 * kF32Rows * HDP + 2 * kF32Tile * (HDP + 1) + kF32Rows * kF32Tile;
}
template <int HDP>
constexpr int smem_floats_b() {
  // k, v rows [kF32Rows][HDP]; q, dO tile [kF32Tile][HDP + 1]; p, ds
  // [kF32Rows][kF32Tile]; lse, delta [kF32Tile]
  return 2 * kF32Rows * HDP + 2 * kF32Tile * (HDP + 1) + 2 * kF32Rows * kF32Tile + 2 * kF32Tile;
}

// Load `kF32Rows` rows of one head (zero outside S and beyond hd) with stride HDP.
template <int HDP>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src, long long row_stride,
                                              int r0, int S, int hd) {
  for (int i = threadIdx.x; i < kF32Rows * HDP; i += blockDim.x) {
    const int r = i / HDP, d = i % HDP, ri = r0 + r;
    dst[i] = (ri < S && d < hd) ? src[ri * row_stride + d] : 0.f;
  }
}

// Load a `kF32Tile`-row tile (zero outside S) with stride HDP + 1; columns
// hd..HDP are zeroed once by the caller and never written here.
template <int HDP>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src, long long row_stride,
                                              int t0, int S, int hd) {
  for (int i = threadIdx.x; i < kF32Tile * hd; i += blockDim.x) {
    const int j = i / hd, d = i % hd, tj = t0 + j;
    dst[j * (HDP + 1) + d] = tj < S ? src[tj * row_stride + d] : 0.f;
  }
}

// s and dp of the warp's query rows row0.. against key `lane` of the K/V tile
template <int HDP>
__device__ __forceinline__ void row_scores(const float* q_s, const float* do_s, const float* k_s,
                                           const float* v_s, int row0, int lane, int hd,
                                           float (&s)[kF32RowsPerWarp],
                                           float (&dp)[kF32RowsPerWarp]) {
  constexpr int KS = HDP + 1;
#pragma unroll
  for (int r = 0; r < kF32RowsPerWarp; ++r) s[r] = dp[r] = 0.f;
  for (int d = 0; d < hd; ++d) {
    const float kv = k_s[lane * KS + d];
    const float vv = v_s[lane * KS + d];
#pragma unroll
    for (int r = 0; r < kF32RowsPerWarp; ++r) {
      s[r] = fmaf(q_s[(row0 + r) * HDP + d], kv, s[r]);
      dp[r] = fmaf(do_s[(row0 + r) * HDP + d], vv, dp[r]);
    }
  }
}

// pass A: softmax statistics, delta and dq for a tile of query rows
template <int HDP>
__global__ void __launch_bounds__(kF32Warps * 32)
    dq_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                  float* __restrict__ dqkv, float2* __restrict__ stats, int S, int H, int hd,
                  int n_tiles, float scale) {
  constexpr int R = kF32RowsPerWarp;
  constexpr int kDimsPerLane = HDP / 32;
  constexpr int KS = HDP + 1;
  extern __shared__ float smem[];
  float* q_s = smem;                      // [kF32Rows][HDP]
  float* do_s = q_s + kF32Rows * HDP;     // [kF32Rows][HDP]
  float* k_s = do_s + kF32Rows * HDP;     // [kF32Tile][KS]
  float* v_s = k_s + kF32Tile * KS;       // [kF32Tile][KS]
  float* ds_s = v_s + kF32Tile * KS;      // [kF32Rows][kF32Tile]

  const int D = H * hd;
  const long long qkv_stride = 3LL * D;
  const int b = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x % n_tiles) * kF32Rows;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = warp * R;
  const float* base = qkv + (long long)b * S * qkv_stride + (long long)h * hd;
  const float* dobase = dout + (long long)b * S * D + (long long)h * hd;

  load_rows_f32<HDP>(q_s, base, qkv_stride, q0, S, hd);
  load_rows_f32<HDP>(do_s, dobase, D, q0, S, hd);
  for (int i = tid; i < kF32Tile * KS; i += blockDim.x) {
    k_s[i] = 0.f;
    v_s[i] = 0.f;
  }

  // sweep 1: online max m, sum l and unnormalised rowsum(dp * p)
  float m[R], l[R], dacc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    dacc[r] = 0.f;
  }
  for (int k0 = 0; k0 < S; k0 += kF32Tile) {
    __syncthreads();  // q/dO rows and zeroed pads written; last tile consumed
    load_tile_f32<HDP>(k_s, base + D, qkv_stride, k0, S, hd);
    load_tile_f32<HDP>(v_s, base + 2 * D, qkv_stride, k0, S, hd);
    __syncthreads();
    const bool key_ok = lane < min(kF32Tile, S - k0);
    float s[R], dp[R];
    row_scores<HDP>(q_s, do_s, k_s, v_s, row0, lane, hd, s, dp);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float sr = key_ok ? s[r] * scale : -INFINITY;
      // lane 0 always holds a real key, so m_new is finite
      const float m_new = fmaxf(m[r], tile::warp_max(sr));
      const float p = key_ok ? expf(sr - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);  // 0 on the first tile
      l[r] = l[r] * corr + tile::warp_sum(p);
      dacc[r] = dacc[r] * corr + tile::warp_sum(p * dp[r]);
      m[r] = m_new;
    }
  }
  float lse[R], delta[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    lse[r] = m[r] + logf(l[r]);
    delta[r] = dacc[r] / l[r];
    const int qi = q0 + row0 + r;
    if (lane == 0 && qi < S) stats[((long long)b * H + h) * S + qi] = make_float2(lse[r], delta[r]);
  }

  // sweep 2: dq = ds k
  float acc[R][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] = 0.f;
  for (int k0 = 0; k0 < S; k0 += kF32Tile) {
    __syncthreads();
    load_tile_f32<HDP>(k_s, base + D, qkv_stride, k0, S, hd);
    load_tile_f32<HDP>(v_s, base + 2 * D, qkv_stride, k0, S, hd);
    __syncthreads();
    const int n_keys = min(kF32Tile, S - k0);
    const bool key_ok = lane < n_keys;
    float s[R], dp[R];
    row_scores<HDP>(q_s, do_s, k_s, v_s, row0, lane, hd, s, dp);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float p = key_ok ? expf(s[r] * scale - lse[r]) : 0.f;
      ds_s[(row0 + r) * kF32Tile + lane] = p * (dp[r] - delta[r]) * scale;
    }
    __syncwarp();
    for (int j = 0; j < n_keys; ++j) {
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        const float kv = k_s[j * KS + lane + 32 * i];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][i] = fmaf(ds_s[(row0 + r) * kF32Tile + j], kv, acc[r][i]);
      }
    }
    __syncwarp();
  }

  float* dq = dqkv + (long long)b * S * qkv_stride + (long long)h * hd;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + row0 + r;
    if (qi >= S) continue;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) dq[qi * qkv_stride + d] = acc[r][i];
    }
  }
}

// pass B: dk and dv for a tile of key rows
template <int HDP>
__global__ void __launch_bounds__(kF32Warps * 32)
    dkdv_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                    float* __restrict__ dqkv, const float2* __restrict__ stats, int S, int H,
                    int hd, int n_tiles, float scale) {
  constexpr int R = kF32RowsPerWarp;
  constexpr int kDimsPerLane = HDP / 32;
  constexpr int KS = HDP + 1;
  extern __shared__ float smem[];
  float* k_s = smem;                       // [kF32Rows][HDP]
  float* v_s = k_s + kF32Rows * HDP;       // [kF32Rows][HDP]
  float* q_s = v_s + kF32Rows * HDP;       // [kF32Tile][KS]
  float* do_s = q_s + kF32Tile * KS;       // [kF32Tile][KS]
  float* p_s = do_s + kF32Tile * KS;       // [kF32Rows][kF32Tile]
  float* ds_s = p_s + kF32Rows * kF32Tile; // [kF32Rows][kF32Tile]
  float* lse_s = ds_s + kF32Rows * kF32Tile;  // [kF32Tile]
  float* dl_s = lse_s + kF32Tile;             // [kF32Tile]

  const int D = H * hd;
  const long long qkv_stride = 3LL * D;
  const int b = blockIdx.x / n_tiles;
  const int k0 = (blockIdx.x % n_tiles) * kF32Rows;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int row0 = warp * R;
  const float* base = qkv + (long long)b * S * qkv_stride + (long long)h * hd;
  const float* dobase = dout + (long long)b * S * D + (long long)h * hd;
  const float2* st = stats + ((long long)b * H + h) * S;

  load_rows_f32<HDP>(k_s, base + D, qkv_stride, k0, S, hd);
  load_rows_f32<HDP>(v_s, base + 2 * D, qkv_stride, k0, S, hd);
  for (int i = tid; i < kF32Tile * KS; i += blockDim.x) {
    q_s[i] = 0.f;
    do_s[i] = 0.f;
  }

  float dk[R][kDimsPerLane], dv[R][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) dk[r][i] = dv[r][i] = 0.f;

  for (int q0 = 0; q0 < S; q0 += kF32Tile) {
    __syncthreads();  // key rows and zeroed pads written; last tile consumed
    load_tile_f32<HDP>(q_s, base, qkv_stride, q0, S, hd);
    load_tile_f32<HDP>(do_s, dobase, D, q0, S, hd);
    for (int i = tid; i < kF32Tile; i += blockDim.x) {
      const float2 v = q0 + i < S ? st[q0 + i] : make_float2(0.f, 0.f);
      lse_s[i] = v.x;
      dl_s[i] = v.y;
    }
    __syncthreads();
    const int n_q = min(kF32Tile, S - q0);
    const bool q_ok = lane < n_q;
    // s and dp of query `lane` against this warp's keys
    float s[R], dp[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = dp[r] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float qv = q_s[lane * KS + d];
      const float gv = do_s[lane * KS + d];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s[r] = fmaf(qv, k_s[(row0 + r) * HDP + d], s[r]);
        dp[r] = fmaf(gv, v_s[(row0 + r) * HDP + d], dp[r]);
      }
    }
    const float lse = lse_s[lane], delta = dl_s[lane];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float p = q_ok ? expf(s[r] * scale - lse) : 0.f;
      p_s[(row0 + r) * kF32Tile + lane] = p;
      ds_s[(row0 + r) * kF32Tile + lane] = p * (dp[r] - delta) * scale;
    }
    __syncwarp();
    for (int j = 0; j < n_q; ++j) {
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        const float qv = q_s[j * KS + lane + 32 * i];
        const float gv = do_s[j * KS + lane + 32 * i];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          dv[r][i] = fmaf(p_s[(row0 + r) * kF32Tile + j], gv, dv[r][i]);
          dk[r][i] = fmaf(ds_s[(row0 + r) * kF32Tile + j], qv, dk[r][i]);
        }
      }
    }
    __syncwarp();
  }

  float* out = dqkv + (long long)b * S * qkv_stride + (long long)h * hd;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int kj = k0 + row0 + r;
    if (kj >= S) continue;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) {
        out[kj * qkv_stride + D + d] = dk[r][i];
        out[kj * qkv_stride + 2 * D + d] = dv[r][i];
      }
    }
  }
}

template <int HDP>
cudaError_t launch_f32(const float* qkv, const float* dout, float* dqkv, float2* stats, int B,
                       int S, int H, int hd, float scale, cudaStream_t stream) {
  const int n_tiles = (S + kF32Rows - 1) / kF32Rows;
  const dim3 grid((unsigned)((long long)B * n_tiles), (unsigned)H);
  const dim3 block(kF32Warps * 32);
  const size_t bytes_a = smem_floats_a<HDP>() * sizeof(float);
  const size_t bytes_b = smem_floats_b<HDP>() * sizeof(float);
  cudaError_t err;
  // above 48 KB a block's dynamic shared memory must be allowed explicitly
  if (bytes_a > 48 * 1024 &&
      (err = cudaFuncSetAttribute(dq_f32_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)bytes_a)) != cudaSuccess)
    return err;
  if (bytes_b > 48 * 1024 &&
      (err = cudaFuncSetAttribute(dkdv_f32_kernel<HDP>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes_b)) !=
          cudaSuccess)
    return err;
  dq_f32_kernel<HDP><<<grid, block, bytes_a, stream>>>(qkv, dout, dqkv, stats, S, H, hd, n_tiles,
                                                       scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dkdv_f32_kernel<HDP><<<grid, block, bytes_b, stream>>>(qkv, dout, dqkv, stats, S, H, hd,
                                                         n_tiles, scale);
  return cudaGetLastError();
}

// the kernels' head widths, multiples of 32
#define BWD_DISPATCH(LAUNCH, WIDTH, ...)       \
  switch (WIDTH) {                             \
    case 32: return LAUNCH<32>(__VA_ARGS__);   \
    case 64: return LAUNCH<64>(__VA_ARGS__);   \
    case 96: return LAUNCH<96>(__VA_ARGS__);   \
    case 128: return LAUNCH<128>(__VA_ARGS__); \
    default: return cudaErrorInvalidValue;     \
  }

template <typename T>
cudaError_t launch_typed(const void* qkv, const void* dout, void* dqkv, void* stats, int B,
                         int S, int H, int hd, float scale, cudaStream_t stream) {
  const T* in = static_cast<const T*>(qkv);
  const T* g = static_cast<const T*>(dout);
  T* o = static_cast<T*>(dqkv);
  float2* st = static_cast<float2*>(stats);
  if constexpr (std::is_same<T, float>::value) {
    BWD_DISPATCH(launch_f32, (hd + 31) / 32 * 32, in, g, o, st, B, S, H, hd, scale, stream)
  } else {
    const void* ptrs[3] = {qkv, dout, dqkv};
    int mode = mma::copy_mode(hd, (long long)H * hd, ptrs, 3);
    // in mode 16 a head starts up to 6 elements into its window, unless
    // hd % 8 == 0 puts every head at the window's start
    int width = (hd + (mode == 16 && hd % 8 ? 6 : 0) + 31) / 32 * 32;
    if (width > 128) {
      mode = 2;
      width = 128;
    }
    BWD_DISPATCH(launch_bf16, width, in, g, o, st, B, S, H, hd, scale, mode, stream)
  }
}

#undef BWD_DISPATCH

}  // namespace

// qkv: contiguous (B, S, 3*H*hd); dout: contiguous (B, S, H*hd); dqkv:
// contiguous (B, S, 3*H*hd), all of one dtype (0 = float32, 1 = bfloat16);
// stats: float32 scratch of B*H*S*2 floats.  Launches pass A then pass B on
// `stream`; returns the first cudaError_t.
extern "C" int attention_qkv_bwd_launch(const void* qkv, const void* dout, void* dqkv,
                                        void* stats, int B, int S, int H, int hd, float scale,
                                        int dtype, void* stream) {
  if (B < 1 || S < 1 || H < 1 || H > 65535 || hd < 1 || hd > 128)
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = (S + kF32Rows - 1) / kF32Rows;  // the finer of the two tilings
  if ((long long)B * n_tiles * H > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_typed<float>(qkv, dout, dqkv, stats, B, S, H, hd, scale, st);
  if (dtype == 1) return (int)launch_typed<bf16>(qkv, dout, dqkv, stats, B, S, H, hd, scale, st);
  return (int)cudaErrorInvalidValue;
}
