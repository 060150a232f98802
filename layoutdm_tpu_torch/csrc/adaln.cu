// The denoiser's LayerNorms for Hopper (sm_90a), one pass over the (rows, D)
// stream each, on the inference path:
//   adaLN norm1:    out = RN(RN(LN(x)) * (1 + scale) + shift)
//   affine LN:      out = RN(LN(x) * w + b)
// The affine mode takes every affine LayerNorm of models/nn.py: each
// Block's norm2 (and the plain norm1 of a Block without timestep), the
// heads' norms and DecoderBlock's three.
//
// Replaces no TPU kernel: on the TPU, XLA fused the LayerNorms, their casts
// and the modulation of layoutdm_tpu/models/nn.py into the ops around them.
// Eager PyTorch ran adaLN as six passes over the (B, S, D) stream (x to
// float32, the float32 LayerNorm, its cast back, the product, the sum, the
// Block's cast), ~2.4 GB a layer at 128,000 x 464 bf16, and an affine norm
// as three (x to float32, the float32 LayerNorm, the cast of its output).
//
// x is (rows, D) in float32 or bfloat16.  Rounding points as the port's
// plain versions (ops/adaln.py): statistics in float32 (mean, then the mean
// squared deviation; biased) in both modes.
//   adaLN: cond is (B, 2D) float32, a row's scale then its shift, row r
//   taking cond[r / S]; the normalised value rounded to the io dtype, then
//   1 + scale, the product and + shift as three separately rounded float32
//   operations (no FMA contraction), rounded to nearest even into the io
//   dtype.
//   affine: w and b are (D,) float32; (x - mean) * rstd in float32, not
//   rounded, then w * y + b as one float32 FMA (the contraction PyTorch's
//   CUDA LayerNorm compiles to), rounded to the output dtype: x's, or
//   float32 from bfloat16 (the vocab heads' float32 GEMMs read it).
//
// What bounds it on this card: bytes.  A row reads D values and writes D
// (bf16 at the flagship: 238 MB a call at 128,000 rows, 0.071 ms at 3.35
// TB/s; 357 MB and 0.107 ms with a float32 output); the arithmetic is ~10
// operations an element, and cond (3.8 MB at B = 1024) or w and b (3.7 KB)
// stay in L2.
//
// What the design does about it: a warp per row, each lane holding its
// 16-byte vectors of the row in registers (D = 464 bf16 is 58 vectors: two a
// lane), so x is read from device memory once and out written once, both as
// 16-byte accesses by neighbouring lanes.  The mean and then the squared
// deviations are reduced over the registers with warp shuffles: no shared
// memory, no block barrier.  Neighbouring warps take neighbouring rows, so
// a block's loads of cond hit the same row.  x is loaded with the streaming
// hint (read once), cond, w and b through the read-only path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // warps a block, a row each
constexpr int kMaxD = 1024;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the io dtype's 16-byte vector: kVec values, unpacked to float32 and back
template <typename T>
struct Io;

template <>
struct Io<float> {
  static constexpr int kVec = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  // the LayerNorm's output in the io dtype: float32 is not rounded
  __device__ static float round(float f) { return f; }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

template <>
struct Io<bf16> {
  static constexpr int kVec = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static float round(float f) { return __bfloat162float(__float2bfloat16_rn(f)); }
  __device__ static unsigned pair(float lo, float hi) {
    return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
           ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(pair(f[0], f[1]), pair(f[2], f[3]), pair(f[4], f[5]), pair(f[6], f[7]));
  }
};

// how a row's normalised value is finished
enum Mode { kAda, kAffine };

// a row's 16-byte vectors, lane l holding vectors l, l + 32, ...
template <int NV>
__device__ __forceinline__ void load_row(uint4* dst, const uint4* __restrict__ src, int nvec,
                                         int lane) {
#pragma unroll
  for (int k = 0; k < NV; ++k)
    if (lane + 32 * k < nvec) dst[k] = __ldcs(src + lane + 32 * k);
}

// TI: x's dtype; TO: out's (TI, or float32 from bfloat16 in the affine
// mode).  kAda: p = cond; kAffine: p = w, q = b.  NV: 16-byte vectors of x a
// lane holds, ceil(D / kVec / 32).
template <Mode M, typename TI, typename TO, int NV>
__device__ __forceinline__ void norm_row(const TI* __restrict__ x, const float* __restrict__ p,
                                         const float* __restrict__ q, TO* __restrict__ out,
                                         long long rows, int S, int D, float eps) {
  using IO = Io<TI>;
  constexpr int V = IO::kVec;
  constexpr int VO = Io<TO>::kVec;  // an x vector is V / VO vectors of out
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps leave: no shuffle sees a missing lane
  const int nvec = D / V;
  uint4 v[NV];
  load_row<NV>(v, reinterpret_cast<const uint4*>(x + row * D), nvec, lane);
  float f[V];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (lane + 32 * k < nvec) {
      IO::unpack(v[k], f);
#pragma unroll
      for (int j = 0; j < V; ++j) sum += f[j];
    }
  }
  const float mean = warp_sum(sum) / (float)D;
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if (lane + 32 * k < nvec) {
      IO::unpack(v[k], f);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = f[j] - mean;
        sq = __fmaf_rn(d, d, sq);
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / (float)D + eps);

  // adaLN: the row's scale and shift; affine: the weight and bias
  const float* a = M == kAda ? p + (row / S) * 2LL * D : p;
  const float* c = M == kAda ? a + D : q;
  uint4* orow = reinterpret_cast<uint4*>(out + row * D);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = lane + 32 * k;
    if (i < nvec) {
      IO::unpack(v[k], f);
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        const float4 a4 = __ldg(reinterpret_cast<const float4*>(a + i * V + j));
        const float4 c4 = __ldg(reinterpret_cast<const float4*>(c + i * V + j));
        const float s[4] = {a4.x, a4.y, a4.z, a4.w};
        const float b[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (M == kAda) {
            const float y = IO::round(__fmul_rn(f[j + e] - mean, rstd));
            f[j + e] = __fadd_rn(__fmul_rn(y, __fadd_rn(1.f, s[e])), b[e]);
          } else {
            f[j + e] = __fmaf_rn(s[e], __fmul_rn(f[j + e] - mean, rstd), b[e]);
          }
        }
      }
#pragma unroll
      for (int o = 0; o < V / VO; ++o) orow[i * (V / VO) + o] = Io<TO>::pack(f + o * VO);
    }
  }
}

// one name a mode and dtype pair, so a trace tells them apart
template <int NV>
__global__ void __launch_bounds__(kWarps * 32)
    adaln_fwd_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ cond,
                          bf16* __restrict__ out, long long rows, int S, int D, float eps) {
  norm_row<kAda, bf16, bf16, NV>(x, cond, nullptr, out, rows, S, D, eps);
}

template <int NV>
__global__ void __launch_bounds__(kWarps * 32)
    adaln_fwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ cond,
                         float* __restrict__ out, long long rows, int S, int D, float eps) {
  norm_row<kAda, float, float, NV>(x, cond, nullptr, out, rows, S, D, eps);
}

template <int NV>
__global__ void __launch_bounds__(kWarps * 32)
    ln_fwd_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ b, bf16* __restrict__ out, long long rows,
                       int D, float eps) {
  norm_row<kAffine, bf16, bf16, NV>(x, w, b, out, rows, 1, D, eps);
}

template <int NV>
__global__ void __launch_bounds__(kWarps * 32)
    ln_fwd_bf16_f32_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                           const float* __restrict__ b, float* __restrict__ out,
                           long long rows, int D, float eps) {
  norm_row<kAffine, bf16, float, NV>(x, w, b, out, rows, 1, D, eps);
}

template <int NV>
__global__ void __launch_bounds__(kWarps * 32)
    ln_fwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, float* __restrict__ out, long long rows,
                      int D, float eps) {
  norm_row<kAffine, float, float, NV>(x, w, b, out, rows, 1, D, eps);
}

unsigned blocks_for(long long rows) { return (unsigned)((rows + kWarps - 1) / kWarps); }

template <int NV>
cudaError_t ada_nv(const void* x, const float* cond, void* out, long long rows, int S, int D,
                   float eps, int dtype, cudaStream_t st) {
  if (dtype == 1)
    adaln_fwd_bf16_kernel<NV><<<blocks_for(rows), kWarps * 32, 0, st>>>(
        static_cast<const bf16*>(x), cond, static_cast<bf16*>(out), rows, S, D, eps);
  else
    adaln_fwd_f32_kernel<NV><<<blocks_for(rows), kWarps * 32, 0, st>>>(
        static_cast<const float*>(x), cond, static_cast<float*>(out), rows, S, D, eps);
  return cudaGetLastError();
}

// mode: 0 = float32 -> float32, 1 = bfloat16 -> bfloat16, 2 = bfloat16 -> float32
template <int NV>
cudaError_t ln_nv(const void* x, const float* w, const float* b, void* out, long long rows,
                  int D, float eps, int mode, cudaStream_t st) {
  const unsigned g = blocks_for(rows);
  if (mode == 1)
    ln_fwd_bf16_kernel<NV><<<g, kWarps * 32, 0, st>>>(static_cast<const bf16*>(x), w, b,
                                                      static_cast<bf16*>(out), rows, D, eps);
  else if (mode == 2)
    ln_fwd_bf16_f32_kernel<NV><<<g, kWarps * 32, 0, st>>>(static_cast<const bf16*>(x), w, b,
                                                          static_cast<float*>(out), rows, D,
                                                          eps);
  else
    ln_fwd_f32_kernel<NV><<<g, kWarps * 32, 0, st>>>(static_cast<const float*>(x), w, b,
                                                     static_cast<float*>(out), rows, D, eps);
  return cudaGetLastError();
}

// 16-byte vectors a lane holds for D values of x: 1..4 (bf16), 1..8 (float32);
// 0 where the kernel does not take D
int vectors_a_lane(int D, bool bf16_in) {
  const int V = bf16_in ? Io<bf16>::kVec : Io<float>::kVec;
  if (D < 1 || D > kMaxD || D % V) return 0;
  return (D / V + 31) / 32;
}

}  // namespace

// x, out: contiguous (B, S, D), 16-byte aligned; cond: contiguous (B, 2D)
// float32, 16-byte aligned.  dtype: 0 = float32, 1 = bfloat16; D a multiple
// of the 16-byte vector (4 float32, 8 bfloat16) and at most kMaxD.  Returns
// the cudaError_t of the launch.
extern "C" int ada_layer_norm_launch(const void* x, const void* cond, void* out, int B, int S,
                                     int D, float eps, int dtype, void* stream) {
  const int nv = vectors_a_lane(D, dtype == 1);
  if (B < 1 || S < 1 || nv == 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * S;
  const float* c = static_cast<const float*>(cond);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nv) {
    case 1: return (int)ada_nv<1>(x, c, out, rows, S, D, eps, dtype, st);
    case 2: return (int)ada_nv<2>(x, c, out, rows, S, D, eps, dtype, st);
    case 3: return (int)ada_nv<3>(x, c, out, rows, S, D, eps, dtype, st);
    case 4: return (int)ada_nv<4>(x, c, out, rows, S, D, eps, dtype, st);
    case 5: return (int)ada_nv<5>(x, c, out, rows, S, D, eps, dtype, st);
    case 6: return (int)ada_nv<6>(x, c, out, rows, S, D, eps, dtype, st);
    case 7: return (int)ada_nv<7>(x, c, out, rows, S, D, eps, dtype, st);
    default: return (int)ada_nv<8>(x, c, out, rows, S, D, eps, dtype, st);
  }
}

// x, out: contiguous (rows, D), 16-byte aligned; w, b: contiguous (D,)
// float32, 16-byte aligned.  mode: 0 = float32 -> float32, 1 = bfloat16 ->
// bfloat16, 2 = bfloat16 -> float32; D as for ada_layer_norm_launch, by x's
// dtype.  Returns the cudaError_t of the launch.
extern "C" int layer_norm_launch(const void* x, const void* w, const void* b, void* out,
                                 long long rows, int D, float eps, int mode, void* stream) {
  const int nv = vectors_a_lane(D, mode != 0);
  if (rows < 1 || nv == 0 || mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nv) {
    case 1: return (int)ln_nv<1>(x, wf, bf, out, rows, D, eps, mode, st);
    case 2: return (int)ln_nv<2>(x, wf, bf, out, rows, D, eps, mode, st);
    case 3: return (int)ln_nv<3>(x, wf, bf, out, rows, D, eps, mode, st);
    case 4: return (int)ln_nv<4>(x, wf, bf, out, rows, D, eps, mode, st);
    case 5: return (int)ln_nv<5>(x, wf, bf, out, rows, D, eps, mode, st);
    case 6: return (int)ln_nv<6>(x, wf, bf, out, rows, D, eps, mode, st);
    case 7: return (int)ln_nv<7>(x, wf, bf, out, rows, D, eps, mode, st);
    default: return (int)ln_nv<8>(x, wf, bf, out, rows, D, eps, mode, st);
  }
}
