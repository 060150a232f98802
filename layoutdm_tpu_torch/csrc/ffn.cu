// LayerNorm -> linear1 -> activation -> linear2 -> residual for Hopper
// (sm_90a):
//   out = x + (act(LN(x) W1ᵀ + b1) W2ᵀ + b2)
//
// Replaces: layoutdm_tpu/ops/ffn.py::fused_ln_ffn_residual, whose Pallas
// kernel body is _ffn_kernel.  x is (M, D) in float32 or bfloat16; W1 is
// (F, D) and W2 (D, F) in the nn.Linear layout, in the io dtype; LayerNorm
// scale and bias are float32.  Rounding points as the TPU kernel: LayerNorm
// in float32 (eps given), its output rounded to the io dtype before the
// first product; b1 and b2 in the io dtype, added in float32; activation in
// float32 (relu, tanh-approximate gelu, gelu2 = h sigmoid(1.702 h)); the
// hidden rounded to the io dtype before the second product; product plus b2
// rounded to the io dtype, then the residual added in the io dtype.
//
// What bounds it on this card: at the flagship (M = 1024 * 125, D = 464,
// F = 1856, bf16) the two products are 441 GFLOP, 0.45 ms at the dense bf16
// tensor-core peak, against ~240 MB of x, out and weights (0.07 ms): it is
// bound by operations.  The unfused path also writes and reads the (M, F)
// hidden (475 MB in bf16) to and from device memory.
//
// What the bfloat16 design does about it (ffn_wgmma_kernel; D and F
// multiples of 8, the 16-byte row strides TMA needs): the TPU kernel keeps
// both weight matrices and an (R, F) float32 hidden in VMEM; a Hopper block
// has 227 KB of shared memory, so neither fits, and the weights stream.
// - One block of two warpgroups per 64 rows (wgmma's M).  The (64, D)
//   float32 output stays in registers for the whole of F: warpgroup w owns
//   output columns [NW w, NW (w + 1)), NW = 232 at D = 464 (116 registers
//   a thread; 256 up to D = 512).  No producer warp: a wgmma kernel's
//   registers are allotted per warpgroup, and a third (one-warp) group
//   would cap every thread at 168, below what the accumulators need.
// - The rows are normalised in float32 and rounded into shared memory once
//   (SW128, 64 KB).
// - F is walked in chunks of 32.  Thread 0 keeps W1[c] (32 rows, SW128
//   boxes of 64 columns) and W2[:, c] (two SW64 boxes of NW rows) arriving
//   by TMA in a two-stage ring (64 KB a stage), each part on its own
//   mbarrier and requested as soon as the products of chunk c - 2 are done
//   with it, so each part has a whole chunk's products to land in.  Each
//   warpgroup forms its 16 columns of the hidden chunk with wgmma m64n16,
//   adds b1, applies the activation in float32 and writes bf16 into a
//   shared SW64 hidden tile (double-buffered); a block barrier joins the
//   two; then each runs wgmma m64nNW of the hidden tile by its W2 rows into
//   its accumulators.  Chunk c + 1's first product is issued before chunk
//   c's second, so the activation of c + 1 runs while the tensor cores work
//   on c.  The (M, F) hidden never leaves the chip.
// - Epilogue: b2 added in float32 and rounded, staged through shared memory,
//   and x + o written in 16-byte rows.
// What bounds this design (clock64 per phase on an H100, PERF.md): a chunk
// takes ~2.8k cycles against ~0.9k for its products at the tensor-core
// peak, ~2.3k of them issuing the products; the weight waits are ~6% of
// the loop.  Every block streams both weight matrices from L2 (3.4 MB a
// block, 6.8 GB a flagship call), ~10% of the time.
// The float32 body and shapes TMA cannot describe (D or F not a multiple of
// 8) keep the exact body of ffn_kernel below: 64 (bf16) or 32 (float32) rows
// per block, F streamed in chunks of 32 through cp.async stages, wmma tiles
// in bf16 and float32 FMAs in float32.

#include "hopper.cuh"
#include "mma_sync.cuh"
#include "tile_mma.cuh"

#include <climits>

namespace {

using tile::bf16;
using tile::from_f32;
using tile::to_f32;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 512;     // d_model the kernel takes
constexpr int kPad = 8;        // row padding of the shared tiles, in elements

// ROWS: rows of x per block; FC: width of an F chunk; STAGES: weight chunks
// in shared memory at once (2: the next chunk's copies run under this
// chunk's products)
template <typename T>
struct Cfg;
template <>
struct Cfg<bf16> {
  static constexpr int ROWS = 64, FC = 32, STAGES = 2;
};
template <>
struct Cfg<float> {
  static constexpr int ROWS = 32, FC = 32, STAGES = 1;
};
// accumulator tiles per warp: the (ROWS, kMaxD) output over the warps
template <typename T>
constexpr int kAccTiles = (Cfg<T>::ROWS / 16) * (kMaxD / 16) / kWarps;
// the first product's (ROWS, FC) tiles, and how many warps share the depth
// of each
template <typename T>
constexpr int kTilesA = (Cfg<T>::ROWS / 16) * (Cfg<T>::FC / 16);
template <typename T>
constexpr int kSplitA = kWarps / kTilesA<T>;

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

template <typename T>
size_t smem_bytes(int D) {
  const int Dp = round16(D), R = Cfg<T>::ROWS, FC = Cfg<T>::FC, ST = Cfg<T>::STAGES;
  const size_t lda = Dp + kPad, ldh = FC + kPad, ldf = FC + 4;
  return (R * lda + ST * (FC * lda + Dp * ldh) + R * ldh) * sizeof(T) +
         kSplitA<T> * R * ldf * 4;
}

__device__ __forceinline__ float activate(int act, float h) {
  if (act == 0) return fmaxf(h, 0.f);
  if (act == 1) {  // tanh approximation (jax.nn.gelu's default)
    const float k = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * h * (1.f + tanhf(k * (h + 0.044715f * h * h * h)));
  }
  return h / (1.f + expf(-1.702f * h));  // gelu2 = h sigmoid(1.702 h)
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    ffn_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, const T* __restrict__ w1,
               const T* __restrict__ b1, const T* __restrict__ w2, const T* __restrict__ b2,
               T* __restrict__ out, int M, int D, int F, int act, float eps) {
  using MM = tile::Mma<T>;
  constexpr int kRows = Cfg<T>::ROWS, FC = Cfg<T>::FC, STAGES = Cfg<T>::STAGES;
  constexpr int kTiles = kTilesA<T>, kSplit = kSplitA<T>, kAcc = kAccTiles<T>;
  static_assert(kSplit >= 1 && kTiles * kSplit == kWarps, "phase A covers the warps");
  extern __shared__ __align__(128) unsigned char smem[];
  const int Dp = round16(D);
  const int lda = Dp + kPad;  // a_s and w1_s rows
  const int ldh = FC + kPad;  // w2_s and hb_s rows
  const int ldf = FC + 4;     // h_s rows (float32)
  T* a_s = reinterpret_cast<T*>(smem);   // [kRows][lda] LN(x), io dtype
  T* w1_s = a_s + kRows * lda;           // [STAGES][FC][lda] W1 rows of a chunk
  T* w2_s = w1_s + STAGES * FC * lda;    // [STAGES][Dp][ldh] W2 columns of a chunk
  T* hb_s = w2_s + STAGES * Dp * ldh;    // [kRows][ldh] hidden chunk, io dtype
  // [kSplit][kRows][ldf] partial sums of the hidden chunk over the depth
  float* h_s = reinterpret_cast<float*>(hb_s + kRows * ldh);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int n_chunks = (F + FC - 1) / FC;

  // W1 rows [c0, c0 + FC) and W2 columns [c0, c0 + FC) into stage s, zero
  // past F and D
  auto stage = [&](int chunk, int s) {
    const int c0 = chunk * FC;
    tile::load_tile(w1_s + s * FC * lda, lda, w1 + (long long)c0 * D, D, FC, Dp, F - c0, D);
    tile::load_tile(w2_s + s * Dp * ldh, ldh, w2 + c0, F, Dp, FC, D, F - c0);
    tile::cp_async_commit();
  };
  stage(0, 0);  // in flight while the rows are normalised

  // 1. LayerNorm of the row tile in float32, rounded to the io dtype; zero
  //    columns past D and rows past M
  for (int r = warp; r < kRows; r += kWarps) {
    const long long row = row0 + r;
    T* dst = a_s + r * lda;
    if (row >= M) {
      for (int d = lane; d < Dp; d += 32) dst[d] = from_f32<T>(0.f);
      continue;
    }
    const T* src = x + row * D;
    float v[kMaxD / 32];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxD / 32; ++i) {
      const int d = lane + 32 * i;
      v[i] = d < D ? to_f32(src[d]) : 0.f;
      s += v[i];
    }
    const float mean = tile::warp_sum(s) / D;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxD / 32; ++i) {
      const float c = v[i] - mean;
      if (lane + 32 * i < D) q += c * c;
    }
    const float rs = rsqrtf(tile::warp_sum(q) / D + eps);
#pragma unroll
    for (int i = 0; i < kMaxD / 32; ++i) {
      const int d = lane + 32 * i;
      if (d < D)
        dst[d] = from_f32<T>((v[i] - mean) * rs * gamma[d] + beta[d]);
      else if (d < Dp)
        dst[d] = from_f32<T>(0.f);
    }
  }

  typename MM::Acc acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) MM::zero(acc[j]);
  const int n_dtiles = Dp / 16;
  const int n_acc = (kRows / 16) * n_dtiles;

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int c0 = chunk * FC;
    const int s = STAGES == 2 ? chunk & 1 : 0;
    if (STAGES == 2) {
      // the next chunk's copies go into the other stage, read last chunk
      if (chunk + 1 < n_chunks) stage(chunk + 1, s ^ 1);
      else tile::cp_async_commit();  // an empty group keeps the count
      tile::cp_async_wait<1>();      // this chunk's group has landed
    } else {
      tile::cp_async_wait<0>();
    }
    __syncthreads();  // the chunk (and, first, a_s) is visible to all
    const T* w1c = w1_s + s * FC * lda;
    const T* w2c = w2_s + s * Dp * ldh;

    // 2. h_c = LN(x) W1[c]ᵀ, (kRows, FC) in 16x16 tiles; kSplit warps
    //    share each tile's depth and leave partial sums
    {
      const int t = warp % kTiles, part = warp / kTiles;
      const int rt = t / (FC / 16), ct = t % (FC / 16);
      const int nk = Dp / 16;
      typename MM::Acc h;
      MM::zero(h);
      for (int k = part * nk / kSplit * 16; k < (part + 1) * nk / kSplit * 16; k += 16)
        MM::template mma<true>(h, a_s + rt * 16 * lda + k, lda, w1c + ct * 16 * lda + k, lda);
      MM::store(h_s + part * kRows * ldf + rt * 16 * ldf + ct * 16, h, ldf);
    }
    __syncthreads();
    // bias and activation in float32, the hidden rounded to the io dtype
    for (int i = tid; i < kRows * FC; i += kThreads) {
      const int r = i / FC, f = i % FC;
      float v = 0.f;
      if (c0 + f < F) {
        float h = 0.f;
#pragma unroll
        for (int p = 0; p < kSplit; ++p) h += h_s[p * kRows * ldf + r * ldf + f];
        v = activate(act, h + to_f32(b1[c0 + f]));
      }
      hb_s[r * ldh + f] = from_f32<T>(v);
    }
    __syncthreads();

    // 3. acc += h_c W2[:, c]ᵀ
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int t = warp + kWarps * j;
      if (t < n_acc) {
        const int rt = t / n_dtiles, ct = t % n_dtiles;
#pragma unroll
        for (int k = 0; k < FC; k += 16)
          MM::template mma<true>(acc[j], hb_s + rt * 16 * ldh + k, ldh,
                                 w2c + ct * 16 * ldh + k, ldh);
      }
    }
    __syncthreads();  // stage s, hb_s and h_s are consumed
    if (STAGES == 1 && chunk + 1 < n_chunks) stage(chunk + 1, 0);
  }

  // 4. out = x + round(acc + b2), the sum in the io dtype; the float32
  //    accumulator tile goes through shared memory (over w1_s and w2_s,
  //    which together hold at least kRows * (Dp + 4) floats; no copy is
  //    in flight after the last chunk)
  float* o_s = reinterpret_cast<float*>(w1_s);
  const int ldo = Dp + 4;
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int t = warp + kWarps * j;
    if (t < n_acc) {
      const int rt = t / n_dtiles, ct = t % n_dtiles;
      MM::store(o_s + rt * 16 * ldo + ct * 16, acc[j], ldo);
    }
  }
  __syncthreads();
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const long long row = row0 + r;
    if (row < M) {
      const float o = tile::round_io<T>(o_s[r * ldo + d] + to_f32(b2[d]));
      out[row * D + d] = from_f32<T>(to_f32(x[row * D + d]) + o);
    }
  }
}

template <typename T>
cudaError_t launch_typed(const void* x, const float* g, const float* b, const void* w1,
                         const void* b1, const void* w2, const void* b2, void* out, int M,
                         int D, int F, int act, float eps, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(D);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((M + Cfg<T>::ROWS - 1) / Cfg<T>::ROWS);
  ffn_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), g, b, static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<T*>(out), M, D, F,
      act, eps);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bfloat16: wgmma, TMA, the hidden in shared memory
// ---------------------------------------------------------------------------
namespace wg {

constexpr int kRows = 64;                   // rows per block: wgmma's M
constexpr int FC = 32;                      // F columns per chunk
constexpr int kThreads = 256;               // two warpgroups
constexpr int kMaxAtoms = kMaxD / 64;       // SW128 column atoms of a row
constexpr int kLnBytes = kMaxAtoms * kRows * 128;      // 64 KB
constexpr int kW1Bytes = kMaxAtoms * FC * 128;         // 32 KB
constexpr int kStageBytes = kW1Bytes + 2 * 256 * 64;   // + two W2 boxes
constexpr int kHidBytes = kRows * FC * 2;              // 4 KB
constexpr int kStageOff = kLnBytes;
constexpr int kHidOff = kStageOff + 2 * kStageBytes;
constexpr int kBarOff = kHidOff + 2 * kHidBytes;
constexpr int kSmem = kBarOff + 32 + 1024;  // + the base's alignment to 1024

__device__ __forceinline__ float bf(const bf16* p) { return __bfloat162float(*p); }

// (x + o) of 8 bf16 pairs, each sum rounded once
__device__ __forceinline__ uint4 add8(uint4 a, uint4 b) {
  const uint32_t* pa = reinterpret_cast<const uint32_t*>(&a);
  const uint32_t* pb = reinterpret_cast<const uint32_t*>(&b);
  uint4 r;
  uint32_t* pr = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(pa + i));
    const float2 fb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(pb + i));
    pr[i] = mma::pack_bf16x2(fa.x + fb.x, fa.y + fb.y);
  }
  return r;
}

// NW: output columns per warpgroup (a multiple of 8, <= 256); NK: k-steps
// of 16 over D (D <= 16 NK; LN(x) and W1 are zero past D)
template <int NW, int NK>
__global__ void __launch_bounds__(kThreads, 1)
    ffn_wgmma_kernel(const __grid_constant__ CUtensorMap w1_map,
                     const __grid_constant__ CUtensorMap w2_map, const bf16* __restrict__ x,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     const bf16* __restrict__ b1, const bf16* __restrict__ b2,
                     bf16* __restrict__ out, int M, int D, int F, int act, float eps) {
  using namespace hopper;
  static_assert(NK * 16 <= kMaxD && NW <= 256, "tiles fit the shared layout");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* ln = smem;  // (64, D) LN(x), SW128 atoms of 64 columns
  auto stage = [&](int s) { return smem + kStageOff + s * kStageBytes; };
  auto hid = [&](int b) { return smem + kHidOff + b * kHidBytes; };
  uint64_t* full1 = reinterpret_cast<uint64_t*>(smem + kBarOff);  // W1 part of stage s landed
  uint64_t* full2 = full1 + 2;                                       // W2 part

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_chunks = (F + FC - 1) / FC;
  const int n_w1 = (D + 63) / 64;   // W1 atoms holding columns < D
  const int n_w2 = D > NW ? 2 : 1;  // W2 boxes holding rows < D
  const long long row0 = (long long)blockIdx.x * kRows;
  // thread 0: W1[c] (W2[:, c]) into stage c % 2 by TMA, each part as soon
  // as the products of chunk c - 2 are done with it
  auto load1 = [&](int c) {
    if (c >= n_chunks) return;
    uint64_t* bar = &full1[c & 1];
    mbar_expect_tx(bar, n_w1 * FC * 128);
    for (int a = 0; a < n_w1; ++a)
      tma_load(stage(c & 1) + a * FC * 128, &w1_map, bar, a * 64, c * FC);
  };
  auto load2 = [&](int c) {
    if (c >= n_chunks) return;
    uint64_t* bar = &full2[c & 1];
    mbar_expect_tx(bar, n_w2 * NW * 64);
    for (int i = 0; i < n_w2; ++i)
      tma_load(stage(c & 1) + kW1Bytes + i * NW * 64, &w2_map, bar, c * FC, i * NW);
  };
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) mbar_init(&full1[i], 1);
    mbar_init_fence();
    for (int c = 0; c < 2; ++c) {  // in flight while the rows are normalised
      load1(c);
      load2(c);
    }
  }

  // 1. LayerNorm in float32, rounded to bf16 into `ln`; columns D .. 16 NK
  //    and rows past M zero.  A lane holds the 16-byte chunks lane and
  //    lane + 32 of a row.  W1 atoms no box fills (past D) are zeroed once.
  const int nch = D / 8;
  for (int i = tid; i < ((NK * 16 + 63) / 64 - n_w1) * FC * 8; i += kThreads)
    for (int s = 0; s < 2; ++s)  // 16-byte words of the atoms past n_w1
      reinterpret_cast<uint4*>(stage(s) + n_w1 * FC * 128)[i] = make_uint4(0, 0, 0, 0);
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const long long row = row0 + r;
    const bool live = row < M;
    float v[16];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ch = lane + 32 * i;
      uint4 u = make_uint4(0, 0, 0, 0);
      if (live && ch < nch) u = *reinterpret_cast<const uint4*>(x + row * D + ch * 8);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(p[e]);
        v[8 * i + 2 * e] = f.x;
        v[8 * i + 2 * e + 1] = f.y;
        s += f.x + f.y;
      }
    }
    const float mean = tile::warp_sum(s) / D;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (lane + 32 * i < nch)
#pragma unroll
        for (int e = 0; e < 8; ++e) q += (v[8 * i + e] - mean) * (v[8 * i + e] - mean);
    const float rs = rsqrtf(tile::warp_sum(q) / D + eps);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ch = lane + 32 * i;
      if (ch >= 2 * NK) continue;
      uint4 u = make_uint4(0, 0, 0, 0);
      if (live && ch < nch) {
        uint32_t* pu = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = ch * 8 + 2 * e;
          pu[e] = mma::pack_bf16x2((v[8 * i + 2 * e] - mean) * rs * gamma[d] + beta[d],
                                   (v[8 * i + 2 * e + 1] - mean) * rs * gamma[d + 1] + beta[d + 1]);
        }
      }
      *reinterpret_cast<uint4*>(ln + (ch >> 3) * (kRows * 128) + swz128(r * 128 + (ch & 7) * 16)) = u;
    }
  }
  fence_proxy_async();
  __syncthreads();  // also: the barriers are set

  const int w = warp >> 2;             // this warpgroup
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = 16 * (warp & 3) + g;  // rows r0, r0 + 8 of the accumulators
  const uint64_t da_ln = desc<1>(ln);
  // h = LN(x) W1[c]ᵀ, this warpgroup's 16 columns, from stage s (issued)
#define FFN_GEMM1(s)                                                                      \
  {                                                                                       \
    const uint64_t db = desc<1>(stage(s) + w * 16 * 128);                                 \
    wg_fence();                                                                           \
    _Pragma("unroll") for (int kk = 0; kk < NK; ++kk)                                     \
        mma_ss<16>(h, da_ln + ((((kk >> 2) * kRows * 128) + (kk & 3) * 32) >> 4),         \
                   db + ((((kk >> 2) * FC * 128) + (kk & 3) * 32) >> 4), kk > 0);         \
    wg_commit();                                                                          \
    fence_regs(h);                                                                        \
  }
  // acc += hidden(b) W2[:, c]ᵀ from stage s (issued)
#define FFN_GEMM2(s, b)                                                                   \
  {                                                                                       \
    const uint64_t da = desc<2>(hid(b));                                                  \
    const uint64_t db = desc<2>(stage(s) + kW1Bytes + w * NW * 64);                       \
    wg_fence();                                                                           \
    mma_ss<NW>(acc, da, db, 1);                                                           \
    mma_ss<NW>(acc, da + 2, db + 2, 1);                                                   \
    wg_commit();                                                                          \
    fence_regs(acc);                                                                      \
  }
  // bb = b1 of this thread's hidden columns of chunk c (0 past F)
#define FFN_BIAS1(c)                                                                      \
  _Pragma("unroll") for (int e = 0; e < 4; ++e) {                                         \
    const int f = (c) * FC + 16 * w + 8 * (e >> 1) + 2 * t4 + (e & 1);                    \
    bb[e] = f < F ? bf(b1 + f) : 0.f;                                                     \
  }
  // act(h + b1), rounded, into hidden tile b: columns 16 w .. of chunk c
#define FFN_HIDDEN(c, b)                                                                  \
  {                                                                                       \
    unsigned char* hs = hid(b);                                                           \
    _Pragma("unroll") for (int j = 0; j < 2; ++j) {                                       \
      const int col = 16 * w + 8 * j + 2 * t4, f = (c) * FC + col;                        \
      _Pragma("unroll") for (int hh = 0; hh < 2; ++hh) {                                  \
        const float v0 = f < F ? activate(act, h[4 * j + 2 * hh] + bb[2 * j]) : 0.f;      \
        const float v1 = f + 1 < F ? activate(act, h[4 * j + 2 * hh + 1] + bb[2 * j + 1]) \
                                   : 0.f;                                                 \
        *reinterpret_cast<uint32_t*>(hs + swz64((r0 + 8 * hh) * 64 + col * 2)) =          \
            mma::pack_bf16x2(v0, v1);                                                     \
      }                                                                                   \
    }                                                                                     \
    fence_proxy_async();                                                                  \
  }
  float acc[NW / 2];
#pragma unroll
  for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  float h[8], bb[4];
  FFN_BIAS1(0)
  mbar_wait(&full1[0], 0);
  FFN_GEMM1(0)
  wg_wait<0>();
  fence_regs(h);
  FFN_HIDDEN(0, 0)
  __syncthreads();
  if (tid == 0) load1(2);
  for (int c = 0; c + 1 < n_chunks; ++c) {
    const int s = c & 1;
    FFN_BIAS1(c + 1)
    mbar_wait(&full1[s ^ 1], ((c + 1) >> 1) & 1);
    FFN_GEMM1(s ^ 1)  // chunk c + 1's first product ahead of
    mbar_wait(&full2[s], (c >> 1) & 1);
    FFN_GEMM2(s, s)   // chunk c's second
    wg_wait<1>();        // chunk c + 1's first product is done
    fence_regs(h);
    FFN_HIDDEN(c + 1, s ^ 1)
    wg_wait<0>();
    fence_regs(acc);
    __syncthreads();  // hidden(c + 1) complete; W2[:, c], W1[c + 1] read by both
    if (tid == 0) {
      load2(c + 2);
      load1(c + 3);
    }
  }
  mbar_wait(&full2[(n_chunks - 1) & 1], ((n_chunks - 1) >> 1) & 1);
  FFN_GEMM2((n_chunks - 1) & 1, (n_chunks - 1) & 1)
  wg_wait<0>();
  fence_regs(acc);
  __syncthreads();  // both warpgroups are done with the stages

  // 2. o = round(acc + b2) staged over the weight stages (every copy into
  //    them has landed), then out = x + o in 16-byte rows
  bf16* o_s = reinterpret_cast<bf16*>(stage(0));
  const int ldo = D + 8;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j) {
    const int col = w * NW + 8 * j + 2 * t4;
    if (col < D) {
      const float c0 = bf(b2 + col), c1 = bf(b2 + col + 1);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(o_s + (r0 + 8 * hh) * ldo + col) =
            mma::pack_bf16x2(acc[4 * j + 2 * hh] + c0, acc[4 * j + 2 * hh + 1] + c1);
    }
  }
  __syncthreads();
  for (int i = tid; i < kRows * nch; i += kThreads) {
    const int r = i / nch, ch = i % nch;
    const long long row = row0 + r;
    if (row >= M) break;  // rows only grow with i
    const long long at = row * D + ch * 8;
    *reinterpret_cast<uint4*>(out + at) =
        add8(*reinterpret_cast<const uint4*>(x + at),
             *reinterpret_cast<const uint4*>(o_s + r * ldo + ch * 8));
  }
#undef FFN_GEMM1
#undef FFN_GEMM2
#undef FFN_BIAS1
#undef FFN_HIDDEN
}

// whether the wgmma body takes the shape and pointers
inline bool takes(int D, int F, const void* const* ptrs, int n) {
  bool ok = D % 8 == 0 && F % 8 == 0;
  for (int i = 0; i < n; ++i) ok = ok && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0;
  return ok;
}

template <int NW, int NK>
cudaError_t launch(const void* x, const float* g, const float* b, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* out, int M, int D, int F, int act,
                   float eps, cudaStream_t stream) {
  CUtensorMap w1_map, w2_map;
  // W1 (F, D): boxes of 32 rows x 64 columns; W2 (D, F): NW rows x 32 columns
  const uint64_t d1[2] = {(uint64_t)D, (uint64_t)F}, s1[1] = {(uint64_t)D};
  const uint32_t box1[2] = {64, FC};
  const uint64_t d2[2] = {(uint64_t)F, (uint64_t)D}, s2[1] = {(uint64_t)F};
  const uint32_t box2[2] = {FC, NW};
  if (!hopper::make_map(&w1_map, w1, 2, d1, s1, box1, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper::make_map(&w2_map, w2, 2, d2, s2, box2, CU_TENSOR_MAP_SWIZZLE_64B))
    return cudaErrorInvalidValue;
  auto kernel = ffn_wgmma_kernel<NW, NK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((M + kRows - 1) / kRows);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      w1_map, w2_map, static_cast<const bf16*>(x), g, b, static_cast<const bf16*>(b1),
      static_cast<const bf16*>(b2), static_cast<bf16*>(out), M, D, F, act, eps);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// x, out: contiguous (M, D); ln_scale, ln_bias: float32 (D,); w1 (F, D),
// b1 (F,), w2 (D, F), b2 (D,) in the io dtype.  activation: 0 = relu,
// 1 = gelu (tanh), 2 = gelu2; dtype: 0 = float32, 1 = bfloat16.  Returns
// the cudaError_t of the launch.
extern "C" int ln_ffn_residual_launch(const void* x, const void* ln_scale, const void* ln_bias,
                                      const void* w1, const void* b1, const void* w2,
                                      const void* b2, void* out, int M, int D, int F,
                                      int activation, float eps, int dtype, void* stream) {
  if (M < 1 || D < 1 || D > kMaxD || F < 1 || activation < 0 || activation > 2)
    return (int)cudaErrorInvalidValue;
  if ((long long)F * D > INT_MAX) return (int)cudaErrorInvalidValue;
  const float* g = static_cast<const float*>(ln_scale);
  const float* bb = static_cast<const float*>(ln_bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_typed<float>(x, g, bb, w1, b1, w2, b2, out, M, D, F, activation, eps, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const void* ptrs[4] = {x, w1, w2, out};
  if (!wg::takes(D, F, ptrs, 4))
    return (int)launch_typed<bf16>(x, g, bb, w1, b1, w2, b2, out, M, D, F, activation, eps, st);
  // the flagship's D = 464 exactly (29 k-steps, 232 columns a warpgroup);
  // every other D on 32 k-steps and 256 columns, zero past D
  if (D == 464)
    return (int)wg::launch<232, 29>(x, g, bb, w1, b1, w2, b2, out, M, D, F, activation, eps, st);
  return (int)wg::launch<256, 32>(x, g, bb, w1, b1, w2, b2, out, M, D, F, activation, eps, st);
}
