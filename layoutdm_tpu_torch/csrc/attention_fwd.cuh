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
// (float32 or bfloat16).  Rounding as the TPU kernels (_attn_kernel_qkv,
// _attn_kernel_qkv_smajor): float32 scores from io-dtype operands, a float32
// softmax, the NORMALISED probabilities rounded to the io dtype, p.v
// accumulated in float32, one rounding of the output.  With HAS_BIAS,
// bias (3D,) is added to every loaded q/k/v value and the sum rounded to the
// io dtype, as the TPU's S-major kernel adds it to the slab in VMEM.
//
// What bounds it on this card: at the flagship (B = 1024, S = 125, H = 8,
// hd = 58, bf16) it reads the 357 MB slab and writes 119 MB, ~0.14 ms at
// 3.35 TB/s, against 30 GFLOP, ~0.03 ms on the tensor cores: memory.  So
// every byte of q, k and v should leave device memory once, and the
// products must not be what limits the kernel.
//
// What this design does about it (bfloat16), K5's design on the native
// head width:
// - One block per (batch row, 128 query rows, head), 8 warps of 16 query
//   rows; the heads of one row's query block are neighbours in the grid,
//   so the 32-byte sectors two heads' slices share are read while they sit
//   in L2.  At S <= 128 K_h and V_h leave device memory once per (row,
//   head).
// - hd = 58 puts heads at 116-byte offsets.  Rows are staged with 16-byte
//   cp.async copies of the aligned window around each head slice
//   (mma_sync.cuh, mode 16): HDP = 64 columns at hd = 58, zero outside the
//   slice, pitch HDP + 8 so ldmatrix is free of bank conflicts.  Products
//   over the window's columns are the slice's.  Where the layout allows no
//   window (an odd hd, d_model not a multiple of 8, hd > 122) rows are
//   copied element by element to column 0 (mode 2).
// - K6's bias is added by the thread that copied each 16 bytes, after its
//   copies land and before the barrier, from a shared row that holds the
//   head's bias where the window holds its slice and zeros around it: real
//   rows only, and the window's other columns stay exactly 0.
// - q.k^T and p.v run on the tensor cores as raw mma.sync m16n8k16 (bf16
//   in, float32 accumulate).  The score accumulators of two neighbouring
//   8-key tiles are, register for register, the A operand of p.v, so p is
//   normalised, rounded to bf16 and fed on without leaving registers.
// - Softmax: K is taken in chunks of 128 keys.  At S <= 128 a warp's whole
//   (16, S) score row is one chunk in registers and the softmax is exact in
//   one sweep.  Past 128 keys K is swept twice: first the row max and sum,
//   then the scores again, each p normalised and rounded before its p.v.
//   No online rescale of an unnormalised p: the TPU kernel rounds the
//   normalised p.
// - The output tile goes out through the warp's own Q rows in shared
//   memory, in 16-byte stores inside the slice and 4-byte stores at its
//   ends, into (B, S, D) batch-major for both K1 and K6.
// float32 keeps exact float32 FMAs on the CUDA cores (no TF32, which keeps
// ~3 decimal digits): one block per (row, 16 queries, head), K and V
// streamed in 32-key tiles with an online softmax (in float32 nothing is
// rounded between the exp and p.v, so it is the same function).

#pragma once

#include <climits>
#include <cmath>

#include "mma_sync.cuh"

namespace attention_fwd {

using mma::bf16;

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------
constexpr int kWarps = 8;
constexpr int kBlockQ = kWarps * 16;  // query rows per block
constexpr int kChunk = 128;           // keys per K/V chunk

// q, k and v rows, and (K6) the bias of q, k and v in the rows' columns
template <int HDP>
constexpr size_t smem_bytes_bf16() {
  return sizeof(bf16) * ((size_t)(kBlockQ + 2 * kChunk) * (HDP + 8) + 3 * HDP);
}

// a + b of two bf16x2 registers, each sum rounded once to bf16
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  const float2 fa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a));
  const float2 fb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b));
  return mma::pack_bf16x2(fa.x + fb.x, fa.y + fb.y);
}

// The bias row b_row (width columns, placed as the slices are, zero around
// them) added to the shared rows r < min(rows, rows_ok) that this thread
// copied with load_rows(dst, pitch, .., rows, rows_ok, cols, width, mode) --
// the same rows and columns load_rows gave it -- once its copies have
// landed; each sum rounded once to bf16.  Outside the slice the window's
// zeros gain +0 and stay 0.
__device__ __forceinline__ void add_bias(bf16* dst, int pitch, const bf16* b_row, int rows,
                                         int rows_ok, int cols, int width, int mode) {
  const int n_rows = min(rows, rows_ok);
  if (mode == 16) {
    const mma::RowLanes rl(width / 8);
    const int step = (blockDim.x >> 5) * rl.rows_per_warp();
    for (int r = (threadIdx.x >> 5) * rl.rows_per_warp() + rl.row; r < n_rows; r += step)
      for (int c = 8 * rl.col; c < width; c += 8 * rl.lanes()) {
        uint4& x = *reinterpret_cast<uint4*>(dst + r * pitch + c);
        const uint4 b = *reinterpret_cast<const uint4*>(b_row + c);
        x = make_uint4(add_bf16x2(x.x, b.x), add_bf16x2(x.y, b.y), add_bf16x2(x.z, b.z),
                       add_bf16x2(x.w, b.w));
      }
    return;
  }
  for (int i = threadIdx.x; i < n_rows * cols; i += blockDim.x) {
    bf16& x = dst[i / cols * pitch + i % cols];
    x = __float2bfloat16(__bfloat162float(x) + __bfloat162float(b_row[i % cols]));
  }
}

// HDP: the shared rows' width, a multiple of 32 (mode 16: >= hd + lead)
template <int HDP, bool HAS_BIAS>
__global__ void __launch_bounds__(kWarps * 32, HDP <= 64 ? 2 : 1)
    attention_bf16_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
                          bf16* __restrict__ out, int S, int H, int hd, int n_qblocks,
                          long long batch_stride, long long token_stride, float c2, int mode) {
  constexpr int P = HDP + 8;  // shared row pitch
  constexpr int NT = kChunk / 8;
  constexpr int KD = HDP / 16;
  constexpr int DT = HDP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kBlockQ][P]
  bf16* k_s = q_s + kBlockQ * P;                   // [kChunk][P]
  bf16* v_s = k_s + kChunk * P;                    // [kChunk][P]
  bf16* b_s = v_s + kChunk * P;                    // [3][HDP] (K6)

  const int D = H * hd;
  const long long ts = token_stride;
  const int h = blockIdx.x % H, rq = blockIdx.x / H;  // heads side by side
  const int b = rq / n_qblocks;
  const int q0 = (rq % n_qblocks) * kBlockQ;
  const int warp = threadIdx.x >> 5;
  const bf16* head = qkv + (long long)b * batch_stride + (long long)h * hd;
  const bf16* q_src = head + q0 * ts;
  const int n_chunks = (S + kChunk - 1) / kChunk;
  const int wq = q0 + warp * 16;  // the warp's first query row
  const bool live = wq < S;
  bf16* qw = q_s + warp * 16 * P;

  if (mode != 16 && hd < HDP) mma::zero_pad_cols<HDP>(q_s, kBlockQ + 2 * kChunk, hd);
  mma::load_rows(q_s, P, q_src, ts, kBlockQ, S - q0, hd, HDP, mode);
  if (HAS_BIAS) {  // the head's q, k and v bias where the rows hold its slice
    const int lead = mode == 16 ? mma::window_lead(head) : 0;
    for (int i = threadIdx.x; i < 3 * HDP; i += blockDim.x) {
      const int t = i / HDP, c = i % HDP - lead;
      b_s[i] = c >= 0 && c < hd ? bias[t * D + h * hd + c] : __float2bfloat16(0.f);
    }
    __syncthreads();
  }

  // after the copies of `rows` rows from src land: the previous head's
  // leading words cleared, K6's bias (row t of b_s: q, k, v) added
  auto land = [&](bf16* dst, const bf16* src, int rows, int rows_ok, int t) {
    mma::clear_leads(dst, P, src, rows, HDP, mode);
    if (HAS_BIAS) add_bias(dst, P, b_s + t * HDP, rows, rows_ok, hd, HDP, mode);
  };
  // the K (and V) chunk at key k0, with the Q rows on the first call
  auto load_kv = [&](int k0, bool first, bool with_v) {
    const bf16* k_src = head + D + k0 * ts;
    const bf16* v_src = head + 2 * D + k0 * ts;
    mma::load_rows(k_s, P, k_src, ts, kChunk, S - k0, hd, HDP, mode);
    if (with_v) mma::load_rows(v_s, P, v_src, ts, kChunk, S - k0, hd, HDP, mode);
    tile::cp_async_commit();
    tile::cp_async_wait<0>();
    if (first) land(q_s, q_src, kBlockQ, S - q0, 0);
    land(k_s, k_src, kChunk, S - k0, 1);
    if (with_v) land(v_s, v_src, kChunk, S - k0, 2);
    __syncthreads();
  };
  auto scores = [&](float (&s)[NT][4], int k0, int n16) {
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma::mma_abt<KD, NT / 2>(s, qw, k_s, P, n16);
    mma::scale_mask(s, k0, S, c2, n16);
  };

  // sweep 1: row max m and sum l (per lane: rows g and g + 8 of the warp)
  float s[NT][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int c = 0; c < n_chunks; ++c) {
    const int k0 = c * kChunk;
    if (c > 0) __syncthreads();  // every warp is done with the last chunk
    load_kv(k0, c == 0, n_chunks == 1);
    if (!live) continue;
    const int n16 = (min(kChunk, S - k0) + 15) >> 4;
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
      load_kv(k0, false, true);
      if (live) scores(s, k0, n16);
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

  // the output through the warp's own Q rows, out into (B, S, D)
  __syncwarp();
  mma::store_acc<DT>(qw, P, o);
  __syncwarp();
  mma::store_rows(out + ((long long)b * S + wq) * D + (long long)h * hd, D, qw, P,
                  min(16, S - wq), hd, mode);
}

template <int HDP, bool HAS_BIAS>
cudaError_t launch_bf16(const bf16* qkv, const bf16* bias, bf16* out, int B, int S, int H, int hd,
                        long long batch_stride, long long token_stride, float scale, int mode,
                        cudaStream_t stream) {
  const int n_qblocks = (S + kBlockQ - 1) / kBlockQ;
  const size_t smem = smem_bytes_bf16<HDP>();
  auto kernel = attention_bf16_kernel<HDP, HAS_BIAS>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((long long)B * n_qblocks * H);
  kernel<<<grid, kWarps * 32, smem, stream>>>(qkv, bias, out, S, H, hd, n_qblocks, batch_stride,
                                              token_stride, scale * mma::kLog2e, mode);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: exact FMAs on the CUDA cores
// ---------------------------------------------------------------------------
constexpr int kF32Warps = 4;
constexpr int kF32RowsPerWarp = 4;
constexpr int kF32BlockQ = kF32Warps * kF32RowsPerWarp;  // query rows per block
constexpr int kF32BlockK = 32;                           // keys per shared-memory tile

// one element of the slab, plus the bias if any
template <bool HAS_BIAS>
__device__ __forceinline__ float load_in(const float* p, const float* bias, int col) {
  return HAS_BIAS ? *p + bias[col] : *p;
}

// HDP: head dim rounded up to a multiple of 32 (hd <= HDP <= 128).  Each
// warp owns 4 query rows; lane j scores key j of the tile, the warp reduces
// max and sum with shuffles, and each lane accumulates the head dims lane,
// lane + 32, ... of the output.
template <int HDP, bool HAS_BIAS>
__global__ void __launch_bounds__(kF32Warps * 32)
    attention_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ bias,
                         float* __restrict__ out, int S, int H, int hd, int n_qtiles,
                         long long batch_stride, long long token_stride, float scale) {
  constexpr int kDimsPerLane = HDP / 32;
  constexpr int R = kF32RowsPerWarp;
  __shared__ float q_s[kF32BlockQ][HDP];
  __shared__ float k_s[kF32BlockK][HDP + 1];  // +1: lane j reads row j, no bank conflicts
  __shared__ float v_s[kF32BlockK][HDP];
  __shared__ float p_s[kF32Warps][R][kF32BlockK];

  const int D = H * hd;
  const int b = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kF32BlockQ;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const float* base = qkv + (long long)b * batch_stride + (long long)h * hd;
  const int qc = h * hd, kc = D + h * hd, vc = 2 * D + h * hd;  // bias columns

  // columns hd..HDP-1 of v_s stay zero: the tile loads below write d < hd
  for (int i = tid; i < kF32BlockK * HDP; i += blockDim.x) v_s[i / HDP][i % HDP] = 0.f;
  for (int i = tid; i < kF32BlockQ * hd; i += blockDim.x) {
    const int r = i / hd, d = i % hd, qi = q0 + r;
    q_s[r][d] = qi < S ? load_in<HAS_BIAS>(base + qi * token_stride + d, bias, qc + d) : 0.f;
  }

  float m[R], l[R], acc[R][kDimsPerLane];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += kF32BlockK) {
    __syncthreads();  // q_s and the zeroed v_s are written; last tile consumed
    for (int i = tid; i < kF32BlockK * hd; i += blockDim.x) {
      const int j = i / hd, d = i % hd, kj = k0 + j;
      const bool ok = kj < S;
      const float* row = base + kj * token_stride;
      k_s[j][d] = ok ? load_in<HAS_BIAS>(row + D + d, bias, kc + d) : 0.f;
      v_s[j][d] = ok ? load_in<HAS_BIAS>(row + 2 * D + d, bias, vc + d) : 0.f;
    }
    __syncthreads();

    const int n_keys = min(kF32BlockK, S - k0);
    const bool key_ok = lane < n_keys;
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] = 0.f;
    for (int d = 0; d < hd; ++d) {
      const float kv = k_s[lane][d];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = fmaf(q_s[warp * R + r][d], kv, s[r]);
    }

#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float sr = key_ok ? s[r] * scale : -INFINITY;
      // lane 0 always holds a real key, so m_new is finite
      const float m_new = fmaxf(m[r], tile::warp_max(sr));
      const float p = key_ok ? expf(sr - m_new) : 0.f;
      const float corr = expf(m[r] - m_new);  // 0 on the first tile
      l[r] = l[r] * corr + tile::warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) acc[r][i] *= corr;
      p_s[warp][r][lane] = p;
    }
    __syncwarp();

    for (int j = 0; j < n_keys; ++j) {
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) {
        const float vv = v_s[j][lane + 32 * i];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][i] = fmaf(p_s[warp][r][j], vv, acc[r][i]);
      }
    }
    __syncwarp();
  }

  float* obase = out + (long long)b * S * D + (long long)h * hd;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qi = q0 + warp * R + r;
    if (qi >= S) continue;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) obase[(long long)qi * D + d] = acc[r][i] * inv;
    }
  }
}

template <int HDP, bool HAS_BIAS>
cudaError_t launch_f32(const float* qkv, const float* bias, float* out, int B, int S, int H,
                       int hd, long long batch_stride, long long token_stride, float scale,
                       cudaStream_t stream) {
  const int n_qtiles = (S + kF32BlockQ - 1) / kF32BlockQ;
  const dim3 grid((unsigned)((long long)B * n_qtiles), (unsigned)H);
  attention_f32_kernel<HDP, HAS_BIAS><<<grid, kF32Warps * 32, 0, stream>>>(
      qkv, bias, out, S, H, hd, n_qtiles, batch_stride, token_stride, scale);
  return cudaGetLastError();
}

// the bodies' row widths, multiples of 32
#define FWD_DISPATCH(LAUNCH, WIDTH, ...)                 \
  switch (WIDTH) {                                       \
    case 32: return LAUNCH<32, HAS_BIAS>(__VA_ARGS__);   \
    case 64: return LAUNCH<64, HAS_BIAS>(__VA_ARGS__);   \
    case 96: return LAUNCH<96, HAS_BIAS>(__VA_ARGS__);   \
    case 128: return LAUNCH<128, HAS_BIAS>(__VA_ARGS__); \
    default: return cudaErrorInvalidValue;               \
  }

// the shape checks both entry points make; 0 when the launch can go ahead
inline int check_shape(int B, int S, int H, int hd, int dtype) {
  if (B < 1 || S < 1 || H < 1 || H > 65535 || hd < 1 || hd > 128)
    return (int)cudaErrorInvalidValue;
  const long long blocks = dtype == 0 ? (long long)B * ((S + kF32BlockQ - 1) / kF32BlockQ)
                                      : (long long)B * ((S + kBlockQ - 1) / kBlockQ) * H;
  return blocks > INT_MAX ? (int)cudaErrorInvalidValue : 0;
}

// dtype: 0 = float32, 1 = bfloat16
template <bool HAS_BIAS>
cudaError_t launch_typed(const void* qkv, const void* bias, void* out, int B, int S, int H,
                         int hd, long long batch_stride, long long token_stride, float scale,
                         int dtype, cudaStream_t st) {
  if (dtype == 0) {
    FWD_DISPATCH(launch_f32, (hd + 31) / 32 * 32, static_cast<const float*>(qkv),
                 static_cast<const float*>(bias), static_cast<float*>(out), B, S, H, hd,
                 batch_stride, token_stride, scale, st)
  }
  const void* ptrs[2] = {qkv, out};
  int mode = mma::copy_mode(hd, (long long)H * hd, ptrs, 2);
  // in mode 16 a head starts up to 6 elements into its window, unless
  // hd % 8 == 0 puts every head at the window's start
  int width = (hd + (mode == 16 && hd % 8 ? 6 : 0) + 31) / 32 * 32;
  if (width > 128) {
    mode = 2;
    width = 128;
  }
  FWD_DISPATCH(launch_bf16, width, static_cast<const bf16*>(qkv), static_cast<const bf16*>(bias),
               static_cast<bf16*>(out), B, S, H, hd, batch_stride, token_stride, scale, mode, st)
}

#undef FWD_DISPATCH

template <bool HAS_BIAS>
int launch(const void* qkv, const void* bias, void* out, int B, int S, int H, int hd,
           long long batch_stride, long long token_stride, float scale, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (int err = check_shape(B, S, H, hd, dtype)) return err;
  return (int)launch_typed<HAS_BIAS>(qkv, bias, out, B, S, H, hd, batch_stride, token_stride,
                                     scale, dtype, static_cast<cudaStream_t>(stream));
}

}  // namespace attention_fwd
