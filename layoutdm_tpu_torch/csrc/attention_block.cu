// The whole self-attention block for Hopper (sm_90a):
//   out = x + attn(x Wqkvᵀ + bqkv) Woᵀ + bo
//
// Replaces: layoutdm_tpu/ops/attention.py::fused_attention_block, whose
// Pallas kernel body is _attn_block_kernel.  x is (B, S, D) in float32 or
// bfloat16; Wqkv (3D, D) and Wo (D, D) in the nn.Linear layout and the
// biases are in the io dtype; heads are the native hd = D / H columns (the
// TPU package's scatter of the weights to 64-lane heads is a layout trick
// with no counterpart here).  Rounding points as the TPU kernel:
// projections accumulate in float32 and qkv (bias added) is rounded to the
// io dtype; scores and softmax in float32, the NORMALISED p =
// softmax(s * scale) over all S keys rounded to the io dtype; p.v
// accumulates in float32 and o is rounded to the io dtype; the out
// projection accumulates in float32, then bo and the residual x are added in
// float32 before the one final rounding.
//
// What bounds it on this card: at the flagship (B = 1024, S = 125, D = 464,
// 8 heads of 58, bf16) the projections are ~220 GFLOP and the attention
// ~30 GFLOP, 0.25 ms at the dense bf16 tensor-core peak, against ~240 MB of
// x, out and weights (0.07 ms): it is bound by operations.
//
// What this simple design does about it: the TPU kernel holds a whole
// (Gb, S, D) block, both weight matrices and the (Gb S, 3D) qkv slab in
// VMEM; none of that fits a Hopper block's 227 KB, and the out projection
// sums over all heads, so a block that owns one head cannot finish a row.
// One block takes one batch row and a tile of queries (64 in bf16, 32 in
// float32) and loops over the heads.  For head h it projects Q_h for its
// tile, then walks the keys twice in chunks (64 / 32).  Sweep 1 projects
// K_h of each chunk and folds its scores into the row max and sum; sweep 2
// projects V_h and forms p normalised by those, rounded, for p.v.  At
// S <= 128 sweep 1 keeps the block's (tile, S) float32 scores in shared
// memory, so sweep 2 projects only V_h; past 128 keys sweep 2 projects K_h
// again and recomputes the scores (no online rescale of an unnormalised p:
// the TPU kernel rounds the normalised p).  x and the weight
// rows are staged through shared memory 64 (32) columns at a time, in two
// stages, so that the next slice's asynchronous copies (cp.async) run under
// this slice's products.  o_h, rounded, goes into a (tile, D) shared
// buffer; after the last head the block runs the out projection from it,
// streaming Wo 32 (16) output columns at a time in the same two stages,
// and adds bo and x.  The (B, S, 3D) slab never reaches
// device memory.  The price: every query tile of a row projects K and V of
// all S keys again, ⌈S / tile⌉ times (2 at S = 125, 8 at S = 500 in bf16),
// so the kernel does (2 + 4 ⌈S / tile⌉) / 6 of the projection FLOPs of a
// single pass at S <= 128 (1.67x at S = 125) and (2 + 6 ⌈S / tile⌉) / 6
// past it, K projected in both sweeps.  The products are wmma tensor-core tiles
// in bf16 and float32 FMAs in float32; hd = 58 heads sit at 116-byte
// offsets, so heads are staged at a padded width of 64.  Left for later:
// one K/V projection per row shared by its query tiles (a cluster or a
// per-row pass), more blocks per SM, wgmma and TMA.

#include "tile_mma.cuh"

#include <climits>
#include <cmath>

namespace {

using tile::bf16;
using tile::from_f32;
using tile::round_io;
using tile::to_f32;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kHdp = 64;  // head width staged in shared memory (hd <= 64)
constexpr int kMaxD = 512;
constexpr int kKeep = 128;  // at S <= kKeep the block keeps its scores over all keys

template <typename T>
struct Cfg;
template <>
struct Cfg<bf16> {
  static constexpr int QT = 64;  // queries per block
  static constexpr int KC = 64;  // keys per chunk
  static constexpr int XK = 64;  // depth of a staged x / weight slice
  static constexpr int NC = 32;  // out-projection columns per pass
};
template <>
struct Cfg<float> {
  static constexpr int QT = 32;
  static constexpr int KC = 32;
  static constexpr int XK = 32;
  static constexpr int NC = 16;
};

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// shared memory, in order: o_s, then one region used first by the
// attention buffers and then by the staged Wo columns, then the softmax
// statistics and the warps' scratch tiles.  The staged x / weight slices
// and Wo columns have two stages each: the next one's copies (cp.async)
// run under this one's products.
template <typename T>
struct Layout {
  static constexpr int QT = Cfg<T>::QT, KC = Cfg<T>::KC, XK = Cfg<T>::XK, NC = Cfg<T>::NC;
  static constexpr int LDH = kHdp + 8;  // q_s, k_s, v_s rows
  static constexpr int LDS = kKeep + 4;  // s_s rows (float32)
  static constexpr int LDP = KC + 8;    // p_s rows
  static constexpr int LDA = kHdp + 4;  // oacc rows (float32)
  static constexpr int LDX = XK + 8;    // xs, ws rows
  static constexpr int XS = (QT > KC ? QT : KC) * LDX;  // one x stage, elements
  static constexpr int WS = 2 * kHdp * LDX;             // one weight stage
  int ldo;                              // o_s and wo_s rows: round16(D) + 8
  size_t o_s, q_s, k_s, v_s, p_s, xs, ws, s_s, oacc, wo_s, m_s, l_s, scratch, total;

  __host__ __device__ explicit Layout(int D) {
    ldo = round16(D) + 8;
    size_t at = 0;
    o_s = at;
    at += (size_t)QT * ldo * sizeof(T);
    const size_t region = at;
    q_s = at;
    at += (size_t)QT * LDH * sizeof(T);
    k_s = at;
    at += (size_t)KC * LDH * sizeof(T);
    v_s = at;  // directly after k_s: the projection writes K then V
    at += (size_t)KC * LDH * sizeof(T);
    p_s = at;
    at += (size_t)QT * LDP * sizeof(T);
    xs = at;
    at += (size_t)2 * XS * sizeof(T);
    ws = at;
    at += (size_t)2 * WS * sizeof(T);
    s_s = at;
    at += (size_t)QT * LDS * 4;
    oacc = at;
    at += (size_t)QT * LDA * 4;
    wo_s = region;
    const size_t wo_end = region + (size_t)2 * NC * ldo * sizeof(T);
    if (wo_end > at) at = wo_end;
    m_s = at;
    at += (size_t)QT * 4;
    l_s = at;
    at += (size_t)QT * 4;
    scratch = at;
    at += (size_t)kWarps * 256 * 4;
    total = at;
  }
};

// Project x rows [row0, row0 + R) of one batch row (zero past S) onto NG
// groups of head columns: group g, column j < hd is weight row
// wrow + g * D + j.  The result plus bias, rounded to the io dtype, goes to
// dst + g * R * LDH as (R, kHdp) row-major, columns hd.. zero.
template <typename T, int R, int NG>
__device__ __forceinline__ void project(const T* __restrict__ xb, const T* __restrict__ w,
                                        const T* __restrict__ bias, int S, int D, int hd,
                                        int row0, int wrow, T* xs, T* ws, float* scratch,
                                        T* dst) {
  using MM = tile::Mma<T>;
  using L = Layout<T>;
  constexpr int XK = L::XK, LDX = L::LDX, LDH = L::LDH;
  constexpr int kColTiles = NG * kHdp / 16;
  constexpr int kTiles = (R / 16) * kColTiles;
  constexpr int kPerWarp = (kTiles + kWarps - 1) / kWarps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  typename MM::Acc acc[kPerWarp];
#pragma unroll
  for (int j = 0; j < kPerWarp; ++j) MM::zero(acc[j]);
  // x columns [k0, k0 + XK) of the rows and of the weight rows, into stage s
  auto stage = [&](int kc, int s) {
    const int k0 = kc * XK;
    tile::load_tile(xs + s * L::XS, LDX, xb + (long long)row0 * D + k0, D, R, XK, S - row0,
                    D - k0);
#pragma unroll
    for (int g = 0; g < NG; ++g)
      tile::load_tile(ws + s * L::WS + g * kHdp * LDX, LDX,
                      w + (long long)(wrow + g * D) * D + k0, D, kHdp, XK, hd, D - k0);
    tile::cp_async_commit();
  };
  const int nk = (D + XK - 1) / XK;
  __syncthreads();  // the last users of xs and ws are done
  stage(0, 0);
  for (int kc = 0; kc < nk; ++kc) {
    const int s = kc & 1;
    if (kc + 1 < nk) stage(kc + 1, s ^ 1);
    else tile::cp_async_commit();  // an empty group keeps the count
    tile::cp_async_wait<1>();      // stage s has landed
    __syncthreads();
    const T* xsc = xs + s * L::XS;
    const T* wsc = ws + s * L::WS;
#pragma unroll
    for (int j = 0; j < kPerWarp; ++j) {
      const int t = warp + kWarps * j;
      if (t < kTiles) {
        const int rt = t / kColTiles, ct = t % kColTiles;
#pragma unroll
        for (int kk = 0; kk < XK; kk += 16)
          MM::template mma<true>(acc[j], xsc + rt * 16 * LDX + kk, LDX,
                                 wsc + ct * 16 * LDX + kk, LDX);
      }
    }
    __syncthreads();  // stage s is consumed before it is filled again
  }
  float* sc = scratch + warp * 256;
#pragma unroll
  for (int j = 0; j < kPerWarp; ++j) {
    const int t = warp + kWarps * j;
    if (t < kTiles) {
      const int rt = t / kColTiles, ct = t % kColTiles;
      MM::store(sc, acc[j], 16);
      for (int e = lane; e < 256; e += 32) {
        const int col = ct * 16 + e % 16, g = col / kHdp, jj = col % kHdp;
        float v = 0.f;
        if (jj < hd) v = round_io<T>(sc[e] + to_f32(bias[wrow + g * D + jj]));
        dst[g * R * LDH + (rt * 16 + e / 16) * LDH + jj] = from_f32<T>(v);
      }
      __syncwarp();
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    attention_block_kernel(const T* __restrict__ x, const T* __restrict__ wqkv,
                           const T* __restrict__ bqkv, const T* __restrict__ wo,
                           const T* __restrict__ bo, T* __restrict__ out, int S, int H, int hd,
                           int n_qtiles, float scale) {
  using MM = tile::Mma<T>;
  using L = Layout<T>;
  constexpr int QT = L::QT, KC = L::KC, NC = L::NC;
  constexpr int LDH = L::LDH, LDS = L::LDS, LDP = L::LDP, LDA = L::LDA;
  extern __shared__ __align__(128) unsigned char smem[];
  const int D = H * hd, Dp = round16(D);
  const L lay(D);
  const int LDO = lay.ldo;
  T* o_s = reinterpret_cast<T*>(smem + lay.o_s);
  T* q_s = reinterpret_cast<T*>(smem + lay.q_s);
  T* k_s = reinterpret_cast<T*>(smem + lay.k_s);
  T* v_s = reinterpret_cast<T*>(smem + lay.v_s);
  T* p_s = reinterpret_cast<T*>(smem + lay.p_s);
  T* xs = reinterpret_cast<T*>(smem + lay.xs);
  T* ws = reinterpret_cast<T*>(smem + lay.ws);
  float* s_s = reinterpret_cast<float*>(smem + lay.s_s);
  float* oacc = reinterpret_cast<float*>(smem + lay.oacc);
  T* wo_s = reinterpret_cast<T*>(smem + lay.wo_s);
  float* m_s = reinterpret_cast<float*>(smem + lay.m_s);
  float* l_s = reinterpret_cast<float*>(smem + lay.l_s);
  float* scratch = reinterpret_cast<float*>(smem + lay.scratch);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * QT;
  const T* xb = x + (long long)b * S * D;

  // o_s columns past D stay zero for the out projection
  for (int i = tid; i < QT * LDO; i += kThreads) o_s[i] = from_f32<T>(0.f);
  for (int i = tid; i < QT * LDA; i += kThreads) oacc[i] = 0.f;
  for (int r = tid; r < QT; r += kThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  // scores of the chunk at key k0, s = q kᵀ, into s_s columns col0 ..
  auto scores = [&](int col0) {
    for (int t = warp; t < (QT / 16) * (KC / 16); t += kWarps) {
      const int rt = t / (KC / 16), ct = t % (KC / 16);
      typename MM::Acc a;
      MM::zero(a);
#pragma unroll
      for (int kk = 0; kk < kHdp; kk += 16)
        MM::template mma<true>(a, q_s + rt * 16 * LDH + kk, LDH, k_s + ct * 16 * LDH + kk, LDH);
      MM::store(s_s + rt * 16 * LDS + col0 + ct * 16, a, LDS);
    }
  };
  const bool keep = S <= kKeep;

  for (int h = 0; h < H; ++h) {
    project<T, QT, 1>(xb, wqkv, bqkv, S, D, hd, q0, h * hd, xs, ws, scratch, q_s);

    // sweep 1: each chunk's scores folded into the row max m and sum l,
    // one query row per warp at a time
    for (int k0 = 0; k0 < S; k0 += KC) {
      project<T, KC, 1>(xb, wqkv, bqkv, S, D, hd, k0, D + h * hd, xs, ws, scratch, k_s);
      __syncthreads();  // q_s and k_s are written
      scores(keep ? k0 : 0);
      __syncthreads();
      for (int r = warp; r < QT; r += kWarps) {
        const float* sr = s_s + r * LDS + (keep ? k0 : 0);
        float sv[KC / 32];
        float mx = -INFINITY;
#pragma unroll
        for (int i = 0; i < KC / 32; ++i) {
          const int c = lane + 32 * i;
          sv[i] = k0 + c < S ? sr[c] * scale : -INFINITY;
          mx = fmaxf(mx, sv[i]);
        }
        mx = tile::warp_max(mx);
        const float m_old = m_s[r];
        const float m_new = fmaxf(m_old, mx);  // key k0 < S is real: finite
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < KC / 32; ++i) sum += expf(sv[i] - m_new);  // 0 past S
        sum = tile::warp_sum(sum);
        if (lane == 0) {
          m_s[r] = m_new;
          l_s[r] = l_s[r] * expf(m_old - m_new) + sum;  // 0 * l on the first chunk
        }
      }
    }

    // sweep 2: p = softmax(s * scale) rounded to the io dtype, oacc += p v
    for (int k0 = 0; k0 < S; k0 += KC) {
      if (keep) {
        project<T, KC, 1>(xb, wqkv, bqkv, S, D, hd, k0, 2 * D + h * hd, xs, ws, scratch, v_s);
        __syncthreads();  // v_s is written; the row statistics are final
      } else {
        project<T, KC, 2>(xb, wqkv, bqkv, S, D, hd, k0, D + h * hd, xs, ws, scratch, k_s);
        __syncthreads();  // k_s and v_s are written
        scores(0);
        __syncthreads();
      }
      for (int r = warp; r < QT; r += kWarps) {
        const float* sr = s_s + r * LDS + (keep ? k0 : 0);
        const float m = m_s[r], inv_l = 1.f / l_s[r];
#pragma unroll
        for (int i = 0; i < KC / 32; ++i) {
          const int c = lane + 32 * i;
          const float p = k0 + c < S ? expf(sr[c] * scale - m) * inv_l : 0.f;
          p_s[r * LDP + c] = from_f32<T>(p);
        }
      }
      __syncthreads();

      for (int t = warp; t < (QT / 16) * (kHdp / 16); t += kWarps) {
        const int rt = t / (kHdp / 16), ct = t % (kHdp / 16);
        typename MM::Acc a;
        MM::load(a, oacc + rt * 16 * LDA + ct * 16, LDA);
#pragma unroll
        for (int kk = 0; kk < KC; kk += 16)
          MM::template mma<false>(a, p_s + rt * 16 * LDP + kk, LDP, v_s + kk * LDH + ct * 16, LDH);
        MM::store(oacc + rt * 16 * LDA + ct * 16, a, LDA);
      }
    }
    __syncthreads();
    // o_h, rounded to the io dtype, into its head's columns
    for (int i = tid; i < QT * hd; i += kThreads) {
      const int r = i / hd, j = i % hd;
      o_s[r * LDO + h * hd + j] = from_f32<T>(oacc[r * LDA + j]);
    }
    __syncthreads();
    for (int i = tid; i < QT * LDA; i += kThreads) oacc[i] = 0.f;
    for (int r = tid; r < QT; r += kThreads) {
      m_s[r] = -INFINITY;
      l_s[r] = 0.f;
    }
  }
  __syncthreads();

  // out = round(o Woᵀ + bo + x), Wo staged NC output columns at a time
  auto stage_wo = [&](int i, int s) {
    const int n0 = i * NC;
    tile::load_tile(wo_s + s * NC * LDO, LDO, wo + (long long)n0 * D, D, NC, Dp, D - n0, D);
    tile::cp_async_commit();
  };
  const int nn = (D + NC - 1) / NC;
  stage_wo(0, 0);
  for (int i = 0; i < nn; ++i) {
    const int n0 = i * NC, s = i & 1;
    if (i + 1 < nn) stage_wo(i + 1, s ^ 1);
    else tile::cp_async_commit();
    tile::cp_async_wait<1>();
    __syncthreads();
    const T* woc = wo_s + s * NC * LDO;
    for (int t = warp; t < (QT / 16) * (NC / 16); t += kWarps) {
      const int rt = t / (NC / 16), ct = t % (NC / 16);
      typename MM::Acc a;
      MM::zero(a);
      for (int kk = 0; kk < Dp; kk += 16)
        MM::template mma<true>(a, o_s + rt * 16 * LDO + kk, LDO, woc + ct * 16 * LDO + kk, LDO);
      float* sc = scratch + warp * 256;
      MM::store(sc, a, 16);
      for (int e = lane; e < 256; e += 32) {
        const int q = q0 + rt * 16 + e / 16, n = n0 + ct * 16 + e % 16;
        if (q < S && n < D) {
          const long long idx = ((long long)b * S + q) * D + n;
          out[idx] = from_f32<T>(sc[e] + to_f32(bo[n]) + to_f32(x[idx]));
        }
      }
      __syncwarp();
    }
    __syncthreads();  // stage s is consumed before it is filled again
  }
}

template <typename T>
cudaError_t launch_typed(const void* x, const void* wqkv, const void* bqkv, const void* wo,
                         const void* bo, void* out, int B, int S, int H, int hd, float scale,
                         cudaStream_t stream) {
  const int n_qtiles = (S + Cfg<T>::QT - 1) / Cfg<T>::QT;
  if ((long long)B * n_qtiles > INT_MAX) return cudaErrorInvalidValue;
  const size_t smem = Layout<T>(H * hd).total;
  cudaError_t err = cudaFuncSetAttribute(
      attention_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  attention_block_kernel<T><<<(unsigned)(B * n_qtiles), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv), static_cast<const T*>(bqkv),
      static_cast<const T*>(wo), static_cast<const T*>(bo), static_cast<T*>(out), S, H, hd,
      n_qtiles, scale);
  return cudaGetLastError();
}

}  // namespace

// x, out: contiguous (B, S, H*hd); w_qkv (3D, D), b_qkv (3D,), w_out (D, D),
// b_out (D,), all in the io dtype.  dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch.
extern "C" int attention_block_launch(const void* x, const void* w_qkv, const void* b_qkv,
                                      const void* w_out, const void* b_out, void* out, int B,
                                      int S, int H, int hd, float scale, int dtype,
                                      void* stream) {
  if (B < 1 || S < 1 || H < 1 || hd < 1 || hd > kHdp || (long long)H * hd > kMaxD)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_typed<float>(x, w_qkv, b_qkv, w_out, b_out, out, B, S, H, hd, scale, st);
  if (dtype == 1)
    return (int)launch_typed<bf16>(x, w_qkv, b_qkv, w_out, b_out, out, B, S, H, hd, scale, st);
  return (int)cudaErrorInvalidValue;
}
