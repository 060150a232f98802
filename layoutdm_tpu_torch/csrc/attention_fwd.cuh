// Packed-qkv self-attention forward for Hopper (sm_90a): the kernel bodies
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
// softmax with the exact row max and sum, the NORMALISED probabilities
// rounded once to the io dtype (no online rescale of an unnormalised p),
// p.v accumulated in float32, one rounding of the output.  With HAS_BIAS,
// bias (3D,) is added to every loaded q/k/v value and the sum rounded to the
// io dtype, as the TPU's S-major kernel adds it to the slab in VMEM.
//
// Three bodies; launch_typed picks one from what it sees (dtype, S, hd):
// - bfloat16, 128 < S <= 512, a head that fits a row of 64 (hd <= 64 with
//   hd % 8 == 0, else hd <= 58): the long body (long_body(), exported by
//   attention_qkv.cu to the wrappers of K1 and K6, which count its calls in
//   LAUNCHES_LONG), below;
// - every other bfloat16 call: the short body, below (S <= 128: one sweep;
//   past 128 keys: two sweeps);
// - float32: exact FMAs on the CUDA cores (no TF32, which keeps ~3 decimal
//   digits): one block per (row, 16 queries, head), K and V streamed in
//   32-key tiles with an online softmax (in float32 nothing is rounded
//   between the exp and p.v, so it is the same function).
//
// What bounds them on this card.  At B = 1024, S = 125, H = 8, hd = 58, bf16
// a call reads the 357 MB slab and writes 119 MB, ~0.14 ms at 3.35 TB/s,
// against 30 GFLOP, ~0.03 ms on the tensor cores: memory.  At B = 256,
// S = 500 the bytes are the same (0.142 ms), and so, nearly, are the two
// other units: q.k^T and p.v are 2 x 2 S^2 x 64 per (row, head) over the
// padded 64-wide rows, 137 GFLOP (~0.14 ms at 989 TFLOP/s), and the softmax
// takes 2,048 x 500 x 512 exponentials, ~0.5 G (~0.14 ms at 16 a cycle an
// SM).  No unit dominates there; what a design can spend is the sum of
// what it cannot overlap.
//
// The short body (bfloat16), K5's design on the native head width:
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
//   then the scores again, each p normalised and rounded before its p.v, so
//   each (row, head) reads K 8 times and V 4 times at S = 500 (4 query
//   blocks, 2 sweeps), computes q.k^T and its exponentials twice, and
//   stalls every warp on each chunk's copy: 1.5 ms a call there on an
//   H100, 9% of the bound.
// - The output tile goes out through the warp's own Q rows in shared
//   memory, in 16-byte stores inside the slice and 4-byte stores at its
//   ends, into (B, S, D) batch-major for both K1 and K6.
//
// The long body (bfloat16, 128 < S <= 512, rows of 64), for Hopper's
// warpgroup products:
// - One block per (batch row, head), two warpgroups, 186 KB of shared
//   memory at S > 256 (one block an SM).  K_h and V_h (zero rows up to 512
//   keys, or 256 at S <= 256) are copied in once by cp.async into tiles
//   laid out as TMA's SW128 and stay: each (row, head)'s q, k and v leave
//   device memory once.  V lands under the first tile's q.k^T and softmax,
//   each 64-query tile's Q rows during the tile before it.  (K in two
//   halves, the second under the first half's products, ran 2% slower.)
// - Warpgroup w holds the scores of keys [NK w, NK (w + 1)) of the tile's 64
//   rows: q.k^T by wgmma m64n(NK / 2)k16 over the rows of K (K-major B), in
//   two commit groups, the row max of the first half taken while the second
//   runs; NK / 2 = 128 float registers a thread at S > 256.
// - F1's rounding: the two warpgroups exchange each row's max, then each
//   row's sum of exp2(s c2 - m) (c2 = scale log2 e), through shared memory,
//   so every p = exp2(s c2 - m) / l holds the exact row max and sum before
//   its one rounding to bf16; p.v then runs from registers (p as wgmma's A
//   operand, the accumulator layout of q.k^T) over the rows of V as an
//   MN-major B, wgmma m64n64k16.
// - Each warpgroup leaves its float32 partial output in shared memory; the
//   next tile, between its row max and its exponentials, adds the two,
//   rounds once and writes each row's slice with one predicated store
//   instruction of a warp (a branch around each store made a tile's stores
//   wait on one another).
// What bounds it now (clock64 by phase on an H100, B = 256, S = 512): a
// 64-query tile takes ~8,000 cycles, its phases in turn (both warpgroups
// work on one tile): q.k^T with the row max ~1,500, the exponentials
// ~2,800, p.v ~1,600, the rest barriers, exchanges, loads and stores; the
// block's first K ~4,000 more.  So no unit is busy more than a third of the
// time: the products and the softmax of a tile cannot overlap, because a
// row's scores (512 float32, half the register file for 64 rows) leave no
// room for a second tile in flight.

#pragma once

#include <climits>
#include <cmath>

#include "hopper.cuh"
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
// bfloat16, 128 < S <= 512, rows of 64: K_h and V_h held in shared memory
// ---------------------------------------------------------------------------
constexpr int kLongThreads = 256;  // two warpgroups
constexpr int kLongMaxKeys = 512;
constexpr int kLongQ = 64;  // query rows a tile

// shared memory of the long body with NK keys a warpgroup, from a base
// aligned to 1024 bytes: K_h and V_h (2 NK rows of 128 bytes each), two Q
// tiles, each warpgroup's float32 partial output (pitch 72), the row max
// and sum of both warpgroups, K6's bias
__host__ __device__ constexpr size_t long_smem_bytes(int nk) {
  return 2 * (size_t)(2 * nk) * 128 + 2 * kLongQ * 128 + sizeof(float) * 2 * kLongQ * 72 +
         sizeof(float) * 2 * 2 * kLongQ + sizeof(bf16) * 3 * 64 + 1024;
}

// 2^x on the special-function unit, results below 2^-126 flushed to 0
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// *p = v where ok, as a predicated store (no branch: a branch around each
// store made the stores of a tile wait on one another)
__device__ __forceinline__ void st_global_if(uint32_t* p, uint32_t v, bool ok) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n@q st.global.u32 [%0], %1;\n}\n" ::"l"(p),
      "r"(v), "r"((int)ok)
      : "memory");
}

// The rule between the two bf16 bodies: the long body takes 128 < S <= 512
// where a head fits a row of 64 (hd <= 64 with hd % 8 == 0, hd <= 58
// otherwise: a 16-byte window puts a slice up to 6 elements in); every
// other bf16 call, and float32, keeps its body.
inline bool long_body(int S, int hd, int dtype) {
  return dtype == 1 && S > kChunk && S <= kLongMaxKeys && hd >= 1 &&
         hd + (hd % 8 ? 6 : 0) <= 64;
}

// byte offset of 16-byte chunk c of row r in a tile of 128-byte rows laid
// out as TMA's SW128 (8-row atoms, chunk c of row r at chunk c ^ r % 8)
__device__ __forceinline__ int sw128_chunk(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// Rows r < ROWS of the head slices src + r * ld (cols wide; zero rows from
// rows_ok) into a SW128 tile of 64-column rows at dst, placed as `mode`
// places them (16: the 16-byte-aligned window around each slice, by
// cp.async, the leading words cleared by land_sw128; 2: element copies at
// column 0, zeros to column 64).  Thread tid of kLongThreads.
template <int ROWS>
__device__ __forceinline__ void load_sw128(unsigned char* dst, const bf16* __restrict__ src,
                                           long long ld, int rows_ok, int cols, int mode,
                                           int tid) {
  if (mode == 16) {
    const char* base = reinterpret_cast<const char*>(src - mma::window_lead(src));
    const int end = 2 * (mma::window_lead(src) + cols);  // the slice's bytes: [2 lead, end)
#pragma unroll
    for (int k = 0; k < ROWS * 8 / kLongThreads; ++k) {
      const int i = tid + k * kLongThreads, r = i >> 3, c = i & 7;
      const int nb = r < rows_ok ? min(max(end - 16 * c, 0), 16) : 0;
      mma::cp_async16_n(dst + sw128_chunk(r, c), nb > 0 ? base + r * ld * 2 + 16 * c : base, nb);
    }
    return;
  }
  for (int i = tid; i < ROWS * 64; i += kLongThreads) {
    const int r = i >> 6, c = i & 63;
    *reinterpret_cast<bf16*>(dst + sw128_chunk(r, c >> 3) + 2 * (c & 7)) =
        r < rows_ok && c < cols ? src[r * ld + c] : __float2bfloat16(0.f);
  }
}

// After load_sw128<ROWS>(dst, src, .., rows_ok, cols, mode, tid) has landed
// (mode 16: this thread's cp.async wait), the same thread: the previous
// head's leading words of each window cleared and, with b_row (64 columns
// placed as the slices are, zero around them), the bias added to the real
// rows, each sum rounded once to bf16.
template <int ROWS>
__device__ __forceinline__ void land_sw128(unsigned char* dst, const bf16* src, int rows_ok,
                                           int cols, int mode, const bf16* b_row, int tid) {
  if (mode == 16) {
    const int lead = mma::window_lead(src);
#pragma unroll
    for (int k = 0; k < ROWS * 8 / kLongThreads; ++k) {
      const int i = tid + k * kLongThreads, r = i >> 3, c = i & 7;
      uint32_t* x = reinterpret_cast<uint32_t*>(dst + sw128_chunk(r, c));
      if (c == 0)
        for (int q = 0; q < lead / 2; ++q) x[q] = 0u;
      if (b_row != nullptr && r < rows_ok) {
        const uint32_t* bb = reinterpret_cast<const uint32_t*>(b_row + 8 * c);
#pragma unroll
        for (int q = 0; q < 4; ++q) x[q] = add_bf16x2(x[q], bb[q]);
      }
    }
    return;
  }
  if (b_row == nullptr) return;
  for (int i = tid; i < ROWS * 64; i += kLongThreads) {
    const int r = i >> 6, c = i & 63;
    if (r < rows_ok && c < cols) {
      bf16& x = *reinterpret_cast<bf16*>(dst + sw128_chunk(r, c >> 3) + 2 * (c & 7));
      x = __float2bfloat16(__bfloat162float(x) + __bfloat162float(b_row[c]));
    }
  }
}

// The long body (the header says why): one block per (batch row, head),
// two warpgroups.  K_h and V_h (2 NK rows, zero past S) are copied in once,
// K as the first cp.async group and V as the second, and stay, in SW128
// tiles: rows of K are wgmma's K-major B for q kᵀ, rows of V its MN-major B
// for p v.  The block walks the 64-query tiles, the next tile's Q rows in
// flight while the current one computes.  Warpgroup w holds the scores of
// keys [NK w, NK (w + 1)) of the tile's rows (keys past S masked); the two
// exchange each row's max and sum through shared memory, so every p is
// exp2(s c2 - m) / l with the exact row max and sum before its one rounding
// to bf16, fed from registers as the A operand of p v.  Each leaves its
// float32 partial output; the next tile (or the block's end) adds the two,
// rounds once and writes the tile.  Takes NK < S <= 2 NK (each warpgroup
// holds a key of the sequence); HDP is 64.
template <int HDP, bool HAS_BIAS, int NK>
__global__ void __launch_bounds__(kLongThreads, 1)
    attention_bf16_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
                          bf16* __restrict__ out, int S, int H, int hd, long long batch_stride,
                          long long token_stride, float c2, int mode) {
  using namespace hopper;
  static_assert(HDP == 64, "rows of 128 bytes: one SW128 atom wide");
  constexpr int PO = 72;  // pitch of the partial outputs
  extern __shared__ unsigned char smem_raw[];
  unsigned char* k_s = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));  // [2 NK][128 B]
  unsigned char* v_s = k_s + 2 * NK * 128;                                 // [2 NK][128 B]
  unsigned char* q_s = v_s + 2 * NK * 128;                                 // [2][64][128 B]
  float* o_x = reinterpret_cast<float*>(q_s + 2 * kLongQ * 128);          // [w][64][PO]
  float* st = o_x + 2 * kLongQ * PO;                                      // [w][max, sum][64]
  bf16* b_s = reinterpret_cast<bf16*>(st + 2 * 2 * kLongQ);               // [3][64] (K6)

  const int D = H * hd;
  const long long ts = token_stride;
  const int h = blockIdx.x % H, b = blockIdx.x / H;  // heads side by side
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int w = warp >> 2, g = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * (warp & 3) + g;  // this thread's rows r0, r0 + 8 of a tile
  const int kbase = NK * w;
  const bf16* head = qkv + (long long)b * batch_stride + (long long)h * hd;
  const bf16* k_src = head + D;
  const bf16* v_src = head + 2 * D;
  const int n_tiles = (S + kLongQ - 1) / kLongQ;

  if (HAS_BIAS) {  // the head's q, k and v bias where the rows hold its slice
    const int lead = mode == 16 ? mma::window_lead(head) : 0;
    for (int i = tid; i < 3 * 64; i += kLongThreads) {
      const int r = i / 64, c = i % 64 - lead;
      b_s[i] = c >= 0 && c < hd ? bias[r * D + h * hd + c] : __float2bfloat16(0.f);
    }
    __syncthreads();
  }
  const bf16* no_bias = nullptr;
  auto q_tile = [&](int i) { return q_s + (i & 1) * kLongQ * 128; };
  auto q_src = [&](int i) { return head + (long long)i * kLongQ * ts; };
  auto load_q = [&](int i) {
    if (i < n_tiles)
      load_sw128<kLongQ>(q_tile(i), q_src(i), ts, S - kLongQ * i, hd, mode, tid);
  };

  // cp.async groups, in order: {the first Q tile, K}, {V}, {the second Q
  // tile}, then one a tile: the Q rows of the tile after it
  load_q(0);
  load_sw128<2 * NK>(k_s, k_src, ts, S, hd, mode, tid);
  tile::cp_async_commit();
  load_sw128<2 * NK>(v_s, v_src, ts, S, hd, mode, tid);
  tile::cp_async_commit();
  load_q(1);
  tile::cp_async_commit();

  // tile i out into (B, S, D): the two warpgroups' partial outputs added,
  // rounded once, a row's slice by one store instruction of a warp (mode
  // 16: hd even, words from the window's column lead on), the loads all
  // issued first
  const float* o_x1 = o_x + kLongQ * PO;
  auto store_tile = [&](int i) {
    constexpr int kRows = kLongQ / (kLongThreads / 32);  // rows a warp
    const int n_rows = min(kLongQ, S - kLongQ * i);
    bf16* dst0 = out + ((long long)b * S + kLongQ * i) * D + (long long)h * hd;
    if (mode == 16) {  // every load in range (c + 1 < PO), so none waits on a branch
      const int c = mma::window_lead(dst0) + 2 * lane;
      float2 x[kRows], y[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        x[k] = *reinterpret_cast<const float2*>(o_x + (warp + 8 * k) * PO + c);
        y[k] = *reinterpret_cast<const float2*>(o_x1 + (warp + 8 * k) * PO + c);
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int r = warp + 8 * k;
        st_global_if(reinterpret_cast<uint32_t*>(dst0 + r * D) + lane,
                     mma::pack_bf16x2(x[k].x + y[k].x, x[k].y + y[k].y),
                     (r < n_rows) & (2 * lane < hd));
      }
      return;
    }
    for (int r = warp; r < n_rows; r += kLongThreads / 32)
      for (int c = lane; c < hd; c += 32)
        dst0[r * D + c] = __float2bfloat16(o_x[r * PO + c] + o_x1[r * PO + c]);
  };

  for (int i = 0; i < n_tiles; ++i) {
    const int q0 = kLongQ * i;
    if (i == 0) {
      tile::cp_async_wait<2>();
      land_sw128<2 * NK>(k_s, k_src, S, hd, mode, HAS_BIAS ? b_s + 64 : no_bias, tid);
    } else {
      tile::cp_async_wait<0>();
    }
    land_sw128<kLongQ>(q_tile(i), q_src(i), S - q0, hd, mode, HAS_BIAS ? b_s : no_bias, tid);
    fence_proxy_async();  // the copies and stores above, before wgmma reads them
    __syncthreads();

    // this warpgroup's scores, q kᵀ over its NK keys in two halves (a
    // commit group each).  sa[4j + e] / sb[4j + e]: row r0 + 8 (e / 2), key
    // kbase + 8 j + 2 t4 + e % 2 (+ NK / 2 in sb)
    float sa[NK / 4], sb[NK / 4];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_ss<NK / 2>(sa, desc<1>(q_tile(i)) + 2 * kk, desc<1>(k_s + kbase * 128) + 2 * kk, kk);
    wg_commit();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_ss<NK / 2>(sb, desc<1>(q_tile(i)) + 2 * kk,
                     desc<1>(k_s + (kbase + NK / 2) * 128) + 2 * kk, kk);
    wg_commit();
    // the row max of s c2 (c2: the softmax scale times log2 e) over both
    // warpgroups, keys before S (a partial a register slot j % 4), each
    // half as it lands
    float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    auto row_max = [&](float (&x)[NK / 4], int k0) {
      if (k0 + NK / 2 > S) {  // this half holds the sequence's end
#pragma unroll
        for (int j = 0; j < NK / 4; ++j)
          mx[j & 3] = fmaxf(mx[j & 3], k0 + 8 * (j >> 2) + 2 * t4 + (j & 1) < S ? x[j] * c2
                                                                              : -INFINITY);
      } else {
#pragma unroll
        for (int j = 0; j < NK / 4; ++j) mx[j & 3] = fmaxf(mx[j & 3], x[j] * c2);
      }
    };
    wg_wait<1>();
    fence_regs(sa);
    row_max(sa, kbase);
    wg_wait<0>();
    fence_regs(sb);
    row_max(sb, kbase + NK / 2);
    mx[0] = mma::quad_max(fmaxf(mx[0], mx[1]));
    mx[2] = mma::quad_max(fmaxf(mx[2], mx[3]));
    if (t4 == 0) {
      st[w * 128 + r0] = mx[0];
      st[w * 128 + r0 + 8] = mx[2];
    }
    __syncthreads();
    const float m[2] = {fmaxf(st[r0], st[128 + r0]), fmaxf(st[r0 + 8], st[136 + r0])};

    // the last tile out and the next tile's Q rows into the buffer of tile
    // i - 1 (no wgmma reads it any more)
    if (i > 0) {
      store_tile(i - 1);
      load_q(i + 1);
      tile::cp_async_commit();
    }

    // exp(s c2 - m) in place (0 past S), and the row sum over both
    // warpgroups, the first's part first
    float l[4] = {0.f, 0.f, 0.f, 0.f};
    auto exps = [&](float (&x)[NK / 4], int k0) {
      if (k0 + NK / 2 > S) {
#pragma unroll
        for (int j = 0; j < NK / 4; ++j) {
          x[j] = k0 + 8 * (j >> 2) + 2 * t4 + (j & 1) < S
                     ? exp2_ftz(fmaf(x[j], c2, -m[(j >> 1) & 1]))
                     : 0.f;
          l[j & 3] += x[j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < NK / 4; ++j) {
          x[j] = exp2_ftz(fmaf(x[j], c2, -m[(j >> 1) & 1]));
          l[j & 3] += x[j];
        }
      }
    };
    exps(sa, kbase);
    exps(sb, kbase + NK / 2);
    l[0] = mma::quad_sum(l[0] + l[1]);
    l[2] = mma::quad_sum(l[2] + l[3]);
    if (t4 == 0) {
      st[w * 128 + 64 + r0] = l[0];
      st[w * 128 + 72 + r0] = l[2];
    }
    if (i == 0) {  // V has landed
      tile::cp_async_wait<1>();
      land_sw128<2 * NK>(v_s, v_src, S, hd, mode, HAS_BIAS ? b_s + 128 : no_bias, tid);
      fence_proxy_async();
    }
    __syncthreads();
    const float inv_l[2] = {1.f / (st[64 + r0] + st[192 + r0]),
                            1.f / (st[72 + r0] + st[200 + r0])};

    // p normalised and rounded to bf16, each half packed before the
    // wgmma.fence of its products (a wgmma's A registers are not written
    // while it may read them), then p v over this warpgroup's keys into two
    // accumulators (even and odd 16-key steps), added at the end.  V's
    // descriptor: SW128 rows, 8-row groups 1024 bytes apart (SBO, and LBO
    // too: which of the two an MN-major operand reads, this one holds)
    uint32_t pa[NK / 16][4];
    float o[32], o2[32];
    auto v_desc = [&](int key) { return desc<1>(v_s + key * 128) + ((uint64_t)63 << 16); };
    auto pack = [&](float (&x)[NK / 4], int kk0) {  // the A fragments of sa or sb
#pragma unroll
      for (int kk = 0; kk < NK / 32; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          pa[kk0 + kk][q] = mma::pack_bf16x2(x[8 * kk + 2 * q] * inv_l[q & 1],
                                             x[8 * kk + 2 * q + 1] * inv_l[q & 1]);
    };
    auto issue = [&](int kk0) {  // p v over the 16-key steps kk0 .. kk0 + NK / 32
      wg_fence();
#pragma unroll
      for (int kk = kk0; kk < kk0 + NK / 32; kk += 2) {
        mma_rs_mn64(o, pa[kk], v_desc(kbase + 16 * kk), kk);
        mma_rs_mn64(o2, pa[kk + 1], v_desc(kbase + 16 * kk + 16), kk);
      }
    };
    pack(sa, 0);
    issue(0);
    pack(sb, NK / 32);  // while the first half's products run
    issue(NK / 32);
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    fence_regs(o2);
#pragma unroll
    for (int k = 0; k < 32; ++k) o[k] += o2[k];

    // this warpgroup's partial output (float32) into o_x, added, rounded
    // and written out during the next tile
    float* ow = o_x + w * kLongQ * PO;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float2*>(ow + r0 * PO + 8 * j + 2 * t4) = make_float2(o[4 * j], o[4 * j + 1]);
      *reinterpret_cast<float2*>(ow + (r0 + 8) * PO + 8 * j + 2 * t4) =
          make_float2(o[4 * j + 2], o[4 * j + 3]);
    }
  }
  __syncthreads();
  store_tile(n_tiles - 1);
}

template <bool HAS_BIAS, int NK>
cudaError_t launch_bf16_long_nk(const bf16* qkv, const bf16* bias, bf16* out, int B, int S, int H,
                                int hd, long long batch_stride, long long token_stride,
                                float scale, int mode, cudaStream_t stream) {
  constexpr size_t smem = long_smem_bytes(NK);
  auto kernel = attention_bf16_kernel<64, HAS_BIAS, NK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((long long)B * H);
  kernel<<<grid, kLongThreads, smem, stream>>>(qkv, bias, out, S, H, hd, batch_stride,
                                               token_stride, scale * mma::kLog2e, mode);
  return cudaGetLastError();
}

// the long body: 128 keys a warpgroup up to S = 256, 256 up to 512
template <bool HAS_BIAS>
cudaError_t launch_bf16_long(const void* qkv, const void* bias, void* out, int B, int S, int H,
                             int hd, long long batch_stride, long long token_stride, float scale,
                             int mode, cudaStream_t stream) {
  auto launch = S <= 256 ? launch_bf16_long_nk<HAS_BIAS, 128> : launch_bf16_long_nk<HAS_BIAS, 256>;
  return launch(static_cast<const bf16*>(qkv), static_cast<const bf16*>(bias),
                static_cast<bf16*>(out), B, S, H, hd, batch_stride, token_stride, scale, mode,
                stream);
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
  if (long_body(S, hd, dtype))
    return launch_bf16_long<HAS_BIAS>(qkv, bias, out, B, S, H, hd, batch_stride, token_stride,
                                      scale, mode, st);
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
