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
// What the bfloat16 design does about it (attention_block_cluster_kernel;
// S <= 128, H <= 8, hd <= 64, D a multiple of 8): the TPU kernel holds a
// whole (Gb, S, D) block, both weight matrices and the (Gb S, 3D) qkv slab
// in VMEM; a Hopper block has 227 KB, and the out projection sums over all
// heads, so the heads of one row must meet.  They meet in a thread-block
// cluster: one cluster per batch row, one block per head, two warpgroups of
// 64 rows and a producer warp that issues every TMA load.
// - The row's x (128 rows, zero past S, SW128 atoms of 64 columns, 128 KB)
//   arrives once by TMA, each block loading its share of the atoms
//   multicast to the whole cluster, so L2 serves the row once, not H times.
// - Each block projects its head's Q, K and V exactly once: wgmma m64n192
//   (q, k and v each 64 columns, zero past hd), the head's W rows streaming
//   in atom by atom through a 3-stage ring (24 KB a stage).  The bias is
//   added in float32 and q, k and vᵀ are rounded into SW128 tiles.  So each
//   row's K and V are projected once (the tiled body below projects them
//   once per query tile of 64).
// - Attention per warpgroup: s = q kᵀ over all 128 keys (wgmma m64n128),
//   the softmax of each row in registers (a row lies in the four threads of
//   a quad), the normalised p rounded and fed from registers as the A
//   operand of p v (wgmma m64n64).  K1's warp-level body (mma_sync.cuh) ran
//   this step 1.7x slower here: with one block per SM its 8 warps cannot
//   hide their latencies.
// - o_h, rounded, goes into x's atom h (dead by then), at columns lead ..
//   lead + hd where lead = h hd % 8, zero around them; once every block is
//   done with its x (a cluster barrier), the producer copies the 16 KB atom
//   into every peer (cp.async.bulk into distributed shared memory, each
//   peer receiving from one block at a time) and each block waits for H - 1
//   copies on one mbarrier.
// - Block h then projects output columns [h hd, (h + 1) hd) for all rows:
//   per head j, wgmma m64n64 of o_j's atom by Wo's 64 rows of head h from
//   column j hd - lead (TMA boxes start 16-byte aligned; o_j is zero where
//   the box holds a neighbour's columns), every Wo box loaded ahead into its
//   own slot; bo and x are added in float32 and rounded once.
// What bounds this design (clock64 per phase on an H100, PERF.md): one
// block per SM (201 KB), so its phases do not overlap another block's; each
// block takes in ~380 KB from L2 (x, its head's W_qkv and Wo rows) and 112
// KB of o from its peers (distributed shared memory, ~17 bytes a cycle);
// the projection, its operands streaming in, reaches ~60% of the tensor
// cores' peak; and 8-block clusters leave 12 of the 132 SMs idle.
//
// float32, and bf16 past S = 128, 8 heads, a multiple of 8 in D or a head
// window of 64 (lead + hd), keep the tiled body
// (attention_block_kernel below): one block per (batch row, 64 queries in
// bf16 / 32 in float32) loops over the heads, projecting Q_h for its tile
// and K_h, V_h of all S keys in chunks (64 / 32), x and the weights staged
// through shared memory by cp.async, wmma tiles in bf16 and float32 FMAs
// in float32.  It sweeps the keys twice: sweep 1 projects K_h and folds
// the scores into the row max and sum; sweep 2 projects V_h (and, past 128
// keys, K_h again) and forms p normalised by those, rounded, for p.v.  So
// it projects K and V ⌈S / 64⌉ times per row in bf16.

#include "hopper.cuh"
#include "mma_sync.cuh"
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


// ---------------------------------------------------------------------------
// bfloat16, S <= 128: one cluster per batch row, one block per head
// ---------------------------------------------------------------------------
namespace cl {

constexpr int kRows = 128;                 // the row's tokens: two warpgroups of 64
constexpr int kMaxS = kRows;
constexpr int kMaxHeads = 8;               // the portable cluster size
constexpr int kConsumers = 256;            // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kMaxAtoms = kMaxD / 64;      // SW128 column atoms of a row
constexpr int kXAtom = kRows * 128;        // 16 KB
constexpr int kWBox = 64 * 128;            // 64 weight rows of one atom, 8 KB
constexpr int kWStage = 3 * kWBox;         // q, k and v rows of one atom
constexpr int kWStages = 3;
constexpr int kQkvTile = kRows * 128;      // q, k (SW128, 128 rows) and vᵀ (two 64-row atoms)
constexpr int kROff = kMaxAtoms * kXAtom;  // the ring: weight stages, then q, k, v and Wo
constexpr int kRBytes = kWStages * kWStage;
constexpr int kWoOff = kROff + 56 * 1024;  // Wo's first two atoms, past q, k, v
constexpr int kBiasOff = kROff + kRBytes;  // the head's q, k, v bias, float32
constexpr int kBarOff = kBiasOff + 3 * kHdp * 4;
constexpr int kNumBars = kMaxAtoms + 2 * kWStages + kMaxHeads + 3;
constexpr int kSmem = kBarOff + kNumBars * 8 + 1024;  // + the base's alignment to 1024
static_assert(3 * kQkvTile <= kWoOff - kROff && kWoOff + 2 * kWBox <= kBiasOff &&
                  (kMaxHeads - 2) * kWBox <= 3 * kQkvTile,
              "q, k, v and Wo's atoms share the ring");

// where head j's columns start in their 16-byte window of Wo's rows: TMA
// boxes start 16-byte aligned, so o_j sits at columns lead .. lead + hd of
// its atom and Wo's box starts at column j hd - lead
__host__ __device__ constexpr int lead(int j, int hd) { return (j * hd) % 8; }

__global__ void __launch_bounds__(kThreads, 1)
    attention_block_cluster_kernel(const __grid_constant__ CUtensorMap x_map,
                                   const __grid_constant__ CUtensorMap wqkv_map,
                                   const __grid_constant__ CUtensorMap wo_map,
                                   const bf16* __restrict__ x, const bf16* __restrict__ bqkv,
                                   const bf16* __restrict__ bo, bf16* __restrict__ out, int S,
                                   int H, int hd, float c2) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* xs = smem;  // the row's x; then atom h' holds o of head h'
  unsigned char* ring = smem + kROff;
  // q, k: (128 rows, 64 columns) SW128; vᵀ: (64 columns, 128 rows) as two
  // SW128 atoms of 64 rows, the K-major B operand of p v
  unsigned char* q_s = ring;
  unsigned char* k_s = ring + kQkvTile;
  unsigned char* vt_s = ring + 2 * kQkvTile;
  auto wo_slot = [&](int j) { return j < 2 ? smem + kWoOff + j * kWBox : ring + (j - 2) * kWBox; };
  float* bias_s = reinterpret_cast<float*>(smem + kBiasOff);  // [3][kHdp]
  uint64_t* bar_x = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* full_w = bar_x + kMaxAtoms;
  uint64_t* empty_w = full_w + kWStages;
  uint64_t* full_o = empty_w + kWStages;    // Wo's atom j landed
  uint64_t* qkv_free = full_o + kMaxHeads;  // every warp's attention is done
  uint64_t* o_ready = qkv_free + 1;         // o_h is in its atom, for the copies
  uint64_t* bar_heads = o_ready + 1;        // every peer's o has landed here

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int D = H * hd, natoms = (D + 63) / 64;
  const int h = (int)cluster_rank(), b = blockIdx.x / H;
  if (tid == 0) {
    for (int j = 0; j < kMaxAtoms; ++j) mbar_init(&bar_x[j], 1);
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(&full_w[s], 1);
      mbar_init(&empty_w[s], kConsumers / 32);  // lane 0 of each consumer warp
    }
    for (int j = 0; j < kMaxHeads; ++j) mbar_init(&full_o[j], 1);
    mbar_init(qkv_free, kConsumers / 32);  // lane 0 of each consumer warp
    mbar_init(o_ready, kConsumers / 32);
    mbar_init(bar_heads, 1);
    mbar_init_fence();
    mbar_expect_tx(bar_heads, (H - 1) * kXAtom);
  }
  for (int i = tid; i < 3 * kHdp; i += kThreads) {
    const int t = i / kHdp, c = i % kHdp;
    bias_s[i] = c < hd ? __bfloat162float(bqkv[t * D + h * hd + c]) : 0.f;
  }
  // every block's barriers are set before any multicast or copy lands on them
  cluster_arrive();
  cluster_wait();

  if (warp == kConsumers / 32) {  // the producer warp
    // Wo's rows of head h, columns of head j from its window: atoms 0, 1
    // past q, k, v in the ring, the rest over q, k, v once attention is done
    auto load_wo = [&](int j) {
      mbar_expect_tx(&full_o[j], kWBox);
      tma_load(wo_slot(j), &wo_map, &full_o[j], j * hd - lead(j, hd), h * hd);
    };
    if (lane == 0) {
      // x: every atom expected here, this block's share loaded for all
      for (int j = 0; j < natoms; ++j) mbar_expect_tx(&bar_x[j], kXAtom);
      for (int j = h; j < natoms; j += H) {
        if (H > 1)
          tma_load_multicast(xs + j * kXAtom, &x_map, &bar_x[j], (uint16_t)((1u << H) - 1),
                             64 * j, 0, b);
        else
          tma_load(xs + j * kXAtom, &x_map, &bar_x[j], 64 * j, 0, b);
      }
      // W_q, W_k, W_v rows of head h, one column atom per stage
      for (int j = 0; j < natoms; ++j) {
        const int s = j % kWStages;
        if (j >= kWStages) mbar_wait(&empty_w[s], (j / kWStages - 1) & 1);
        mbar_expect_tx(&full_w[s], kWStage);
        for (int t = 0; t < 3; ++t)
          tma_load(ring + s * kWStage + t * kWBox, &wqkv_map, &full_w[s], 64 * j, 0, t * H + h);
      }
      // Wo's stages lie in the ring: wait until it is drained
      for (int j = natoms > kWStages ? natoms - kWStages : 0; j < natoms; ++j)
        mbar_wait(&empty_w[j % kWStages], (j / kWStages) & 1);
      for (int j = 0; j < H && j < 2; ++j) load_wo(j);
      mbar_wait(qkv_free, 0);
      for (int j = 2; j < H; ++j) load_wo(j);
    }
    __syncwarp();
    cluster_arrive();  // A (see the consumers)
    cluster_wait();
    if (lane == 0) {  // o_h to every peer, one 16 KB copy each, each peer receiving
                      // from one block at a time
      mbar_wait(o_ready, 0);
      const uint32_t src = smem_u32(xs + h * kXAtom), bar = smem_u32(bar_heads);
      for (int i = 1; i < H; ++i) {
        const int p = (h + i) % H;
        bulk_copy_cluster(map_rank(src, p), xs + h * kXAtom, kXAtom, map_rank(bar, p));
      }
    }
    __syncwarp();
    cluster_arrive();  // C
    cluster_wait();
    return;
  }

  const int w = warp >> 2, g = lane >> 2, t4 = lane & 3;
  const int r0 = 64 * w + 16 * (warp & 3) + g;  // rows r0, r0 + 8 of the accumulators

  // 1. q, k, v of head h for this warpgroup's 64 rows, one atom (4 k-steps,
  //    x and W zero past D) at a time
  {
    float acc[96];
    const uint64_t da0 = desc<1>(xs + w * 64 * 128), db0 = desc<1>(ring);
    auto issue = [&](int j, int first) {
      const int s = j % kWStages;
      mbar_wait(&bar_x[j], 0);
      mbar_wait(&full_w[s], (j / kWStages) & 1);
      const uint64_t da = da0 + ((j * kXAtom) >> 4), db = db0 + ((s * kWStage) >> 4);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) mma_ss<192>(acc, da + 2 * kk, db + 2 * kk, first ? kk : 1);
      wg_commit();
      fence_regs(acc);
    };
    issue(0, 1);
    for (int j = 1; j < natoms; ++j) {
      issue(j, 0);
      wg_wait<1>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty_w[(j - 1) % kWStages]);
    }
    wg_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty_w[(natoms - 1) % kWStages]);
    bar_sync(1, kConsumers);  // both warpgroups are done with the ring's weights
    // bias added in float32, rounded; columns hd .. 64 zero
#pragma unroll
    for (int jb = 0; jb < 24; ++jb) {
      const int which = jb >> 3, col = (jb & 7) * 8 + 2 * t4;
      const bool ok0 = col < hd, ok1 = col + 1 < hd;
      const float c0 = bias_s[which * kHdp + col], c1 = bias_s[which * kHdp + col + 1];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = r0 + 8 * hh;
        const float v0 = ok0 ? acc[4 * jb + 2 * hh] + c0 : 0.f;
        const float v1 = ok1 ? acc[4 * jb + 2 * hh + 1] + c1 : 0.f;
        if (which < 2) {
          *reinterpret_cast<uint32_t*>((which ? k_s : q_s) + swz128(r * 128 + col * 2)) =
              mma::pack_bf16x2(v0, v1);
        } else {  // vᵀ: row = column of v, column = token
          unsigned char* at = vt_s + (r >> 6) * (64 * 128);
          const bf16 e0 = __float2bfloat16(v0), e1 = __float2bfloat16(v1);
          *reinterpret_cast<bf16*>(at + swz128(col * 128 + (r & 63) * 2)) = e0;
          *reinterpret_cast<bf16*>(at + swz128((col + 1) * 128 + (r & 63) * 2)) = e1;
        }
      }
    }
    fence_proxy_async();
  }
  cluster_arrive();  // A: this block reads its x no more
  bar_sync(1, kConsumers);

  // 2. attention for this warpgroup's 64 query rows: s = q kᵀ over the
  //    128 keys (wgmma m64n128), the softmax of each row in registers (a
  //    row lies in the four threads of a quad), the normalised p rounded
  //    and fed as the A operand of p v (wgmma m64n64 from registers); o
  //    rounded into x's atom h, which is o_h's place in every block
  {
    float sc[kRows / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kHdp / 16; ++kk)
      mma_ss<kRows>(sc, desc<1>(q_s + w * 64 * 128) + 2 * kk, desc<1>(k_s) + 2 * kk, kk);
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kRows / 2; ++i) {  // key 8 (i / 4) + 2 t4 + i % 2
      const int key = 8 * (i >> 2) + 2 * t4 + (i & 1);
      sc[i] = key < S ? sc[i] * c2 : -INFINITY;
      m[(i >> 1) & 1] = fmaxf(m[(i >> 1) & 1], sc[i]);
    }
    m[0] = mma::quad_max(m[0]);
    m[1] = mma::quad_max(m[1]);
#pragma unroll
    for (int i = 0; i < kRows / 2; ++i) {
      sc[i] = exp2f(sc[i] - m[(i >> 1) & 1]);  // 0 past S
      l[(i >> 1) & 1] += sc[i];
    }
    const float inv_l[2] = {1.f / mma::quad_sum(l[0]), 1.f / mma::quad_sum(l[1])};
    float o[kHdp / 2];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      uint32_t a[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        a[q] = mma::pack_bf16x2(sc[8 * kk + 2 * q] * inv_l[q & 1],
                                sc[8 * kk + 2 * q + 1] * inv_l[q & 1]);
      mma_rs<kHdp>(o, a, desc<1>(vt_s + (kk >> 2) * (64 * 128)) + 2 * (kk & 3), kk);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(o);
    // columns lead .. lead + hd of the atom (zero around them): the window
    // in which the out projection's Wo box starts 16-byte aligned
    unsigned char* oh = xs + h * kXAtom;
    const int ld = lead(h, hd);
    auto put = [&](int r, int c, float v) {
      const bf16 e = __float2bfloat16(v);
      *reinterpret_cast<uint16_t*>(oh + swz128(r * 128 + c * 2)) =
          *reinterpret_cast<const uint16_t*>(&e);
    };
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 8 * hh;
      for (int c = t4; c < ld; c += 4) put(r, c, 0.f);
#pragma unroll
      for (int n = 0; n < kHdp / 8; ++n) {
        const int c = 8 * n + 2 * t4 + ld;  // o's columns past hd are 0
        if (ld % 2 == 0) {
          if (c < 64)
            *reinterpret_cast<uint32_t*>(oh + swz128(r * 128 + c * 2)) =
                mma::pack_bf16x2(o[4 * n + 2 * hh], o[4 * n + 2 * hh + 1]);
        } else {
          if (c < 64) put(r, c, o[4 * n + 2 * hh]);
          if (c + 1 < 64) put(r, c + 1, o[4 * n + 2 * hh + 1]);
        }
      }
    }
  }
  fence_proxy_async();  // o_h's stores, before the copies read them
  __syncwarp();
  if (lane == 0) {
    mbar_arrive(qkv_free);  // this warp reads q, k, v no more
    mbar_arrive(o_ready);   // and its rows of o_h are in place
  }

  // 3. the producer copies o_h to every peer once no block reads its x
  //    (A); meanwhile the residual x and bo of this thread's outputs
  uint32_t xr[kHdp / 8][2];
  float2 bor[kHdp / 8];
  const bool pairs = hd % 2 == 0;
#pragma unroll
  for (int n = 0; n < kHdp / 8; ++n) {
    const int col = 8 * n + 2 * t4;
    bor[n] = make_float2(col < hd ? __bfloat162float(bo[h * hd + col]) : 0.f,
                         col + 1 < hd ? __bfloat162float(bo[h * hd + col + 1]) : 0.f);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 8 * hh;
      const long long at = ((long long)b * S + r) * D + h * hd + col;
      xr[n][hh] = 0u;
      if (pairs && r < S && col < hd) xr[n][hh] = *reinterpret_cast<const uint32_t*>(x + at);
    }
  }
  cluster_wait();  // A
  mbar_wait(bar_heads, 0);
  cluster_arrive();  // C: every copy into this block has landed

  // 4. out[:, h hd ..] = round(o Wo[h rows]ᵀ + bo + x), this warpgroup's
  //    rows: one atom (64 columns of o_h', Wo's 64 columns from h' hd) per
  //    head, zero past hd in o
  float acc[32];
  const uint64_t da0 = desc<1>(xs + w * 64 * 128);
  auto issue_o = [&](int j, int first) {
    mbar_wait(&full_o[j], 0);
    const uint64_t da = da0 + ((j * kXAtom) >> 4), db = desc<1>(wo_slot(j));
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_ss<64>(acc, da + 2 * kk, db + 2 * kk, first ? kk : 1);
    wg_commit();
    fence_regs(acc);
  };
  issue_o(0, 1);
  for (int j = 1; j < H; ++j) {
    issue_o(j, 0);
    wg_wait<1>();
    fence_regs(acc);
  }
  wg_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int n = 0; n < kHdp / 8; ++n) {
    const int col = 8 * n + 2 * t4;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + 8 * hh;
      if (r >= S || col >= hd) continue;
      const long long at = ((long long)b * S + r) * D + h * hd + col;
      const float a0 = acc[4 * n + 2 * hh] + bor[n].x, a1 = acc[4 * n + 2 * hh + 1] + bor[n].y;
      if (pairs) {
        const float2 xf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&xr[n][hh]));
        *reinterpret_cast<uint32_t*>(out + at) = mma::pack_bf16x2(a0 + xf.x, a1 + xf.y);
      } else {
        out[at] = __float2bfloat16(a0 + __bfloat162float(x[at]));
        if (col + 1 < hd) out[at + 1] = __float2bfloat16(a1 + __bfloat162float(x[at + 1]));
      }
    }
  }
  cluster_wait();  // C: no block leaves while a copy may still read it
}

// whether the cluster body takes the shape (and, with ptrs, the pointers)
inline bool takes(int S, int H, int hd, const void* const* ptrs, int n) {
  bool ok = S <= kMaxS && H <= kMaxHeads && hd <= kHdp && (H * hd) % 8 == 0;
  for (int j = 0; j < H; ++j) ok = ok && lead(j, hd) + hd <= kHdp;  // every window fits an atom
  for (int i = 0; i < n; ++i) ok = ok && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0;
  return ok;
}

inline cudaLaunchConfig_t config(int B, int H, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * H));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)H;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

inline cudaError_t launch(const void* x, const void* wqkv, const void* bqkv, const void* wo,
                          const void* bo, void* out, int B, int S, int H, int hd, float scale,
                          cudaStream_t stream) {
  if ((long long)B * H > INT_MAX) return cudaErrorInvalidValue;
  const int D = H * hd;
  CUtensorMap x_map, wqkv_map, wo_map;
  // x (B, S, D): one batch row's 128 tokens (zero past S) x 64 columns;
  // Wqkv as (3H, hd, D): one head's 64 rows (zero past hd) x 64 columns;
  // Wo (D, D): 64 rows x 64 columns from a 16-byte-aligned column
  const uint64_t dx[3] = {(uint64_t)D, (uint64_t)S, (uint64_t)B};
  const uint64_t sx[2] = {(uint64_t)D, (uint64_t)S * D};
  const uint32_t bx[3] = {64, kRows, 1};
  const uint64_t dq[3] = {(uint64_t)D, (uint64_t)hd, (uint64_t)3 * H};
  const uint64_t sq[2] = {(uint64_t)D, (uint64_t)hd * D};
  const uint32_t bq[3] = {64, 64, 1};
  const uint64_t dw[2] = {(uint64_t)D, (uint64_t)D}, sw[1] = {(uint64_t)D};
  const uint32_t bw[2] = {64, 64};
  if (!hopper::make_map(&x_map, x, 3, dx, sx, bx, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper::make_map(&wqkv_map, wqkv, 3, dq, sq, bq, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper::make_map(&wo_map, wo, 2, dw, sw, bw, CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_block_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(B, H, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, attention_block_cluster_kernel, x_map, wqkv_map, wo_map,
                           static_cast<const bf16*>(x), static_cast<const bf16*>(bqkv),
                           static_cast<const bf16*>(bo), static_cast<bf16*>(out), S, H, hd,
                           scale * mma::kLog2e);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace cl

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
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {x, w_qkv, w_out, out};
  if (cl::takes(S, H, hd, ptrs, 4))
    return (int)cl::launch(x, w_qkv, b_qkv, w_out, b_out, out, B, S, H, hd, scale, st);
  return (int)launch_typed<bf16>(x, w_qkv, b_qkv, w_out, b_out, out, B, S, H, hd, scale, st);
}

// Times each row's K and V are projected in a bfloat16 launch of this
// shape (16-byte aligned tensors): 1 in the cluster body, one per query
// tile of 64 in the tiled one.
extern "C" int attention_block_kv_passes(int S, int H, int hd) {
  return cl::takes(S, H, hd, nullptr, 0) ? 1 : (S + Cfg<bf16>::QT - 1) / Cfg<bf16>::QT;
}

// How many clusters of the bfloat16 body (H blocks each) the card holds at
// once, or minus a cudaError_t.
extern "C" int attention_block_max_clusters(int H) {
  if (H < 1 || H > cl::kMaxHeads) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      cl::attention_block_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, cl::kSmem);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cl::config(132, H, nullptr, &attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, cl::attention_block_cluster_kernel, &cfg);
  return err == cudaSuccess ? n : -(int)err;
}
