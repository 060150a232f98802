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
// What this simple design does about it: the TPU kernel keeps both weight
// matrices (3.4 MB in bf16) and an (R, F) float32 hidden in VMEM; a Hopper
// block has 227 KB of shared memory, so neither fits.  One block takes 64
// rows in bf16 (32 in float32) and normalises them into shared memory.  It
// then streams F in chunks of 32: the chunk of W1 rows and W2 columns is
// staged in shared memory from L2, which holds both matrices (in bf16 in
// two stages, the next chunk's asynchronous copies (cp.async) running
// under this chunk's products); the hidden chunk h_c = act(LN(x) W1[c]ᵀ +
// b1[c]) is formed in shared memory; and acc += h_c W2[:, c]ᵀ grows in
// registers (16 accumulator tiles per warp in bf16, 8 in float32).  The
// (M, F) hidden never reaches device memory.  The products are wmma
// tensor-core tiles in bf16 and float32 FMAs in float32.  The tail of M is
// masked (the TPU shrinks its row block to a divisor of M instead).  Every
// block streams both weight matrices once from L2, 3.4 MB per 64 rows:
// that traffic (6.8 GB per flagship call) is what the row tile trades
// against registers and shared memory.  Register reuse of fragments across
// tiles, more blocks per SM, TMA and wgmma are left for later.

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
  if (dtype == 1)
    return (int)launch_typed<bf16>(x, g, bb, w1, b1, w2, b2, out, M, D, F, activation, eps, st);
  return (int)cudaErrorInvalidValue;
}
