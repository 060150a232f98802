// adaLN norm1 for Hopper (sm_90a): the denoiser Block's timestep-modulated
// LayerNorm in one pass over the residual stream,
//   out = RN(RN(LN(x)) * (1 + scale) + shift)
//
// Replaces no TPU kernel: on the TPU, XLA fused the LayerNorm, the casts and
// the modulation of layoutdm_tpu/models/nn.py::AdaLayerNorm into the ops
// around them.  Eager PyTorch ran them as six passes over the (B, S, D)
// stream (x to float32, the float32 LayerNorm, its cast back, the product,
// the sum, the Block's cast), ~2.4 GB a layer at 128,000 x 464 bf16.
//
// x is (B * S, D) in float32 or bfloat16; cond is (B, 2D) float32, a row's
// scale then its shift, row r taking cond[r / S].  Rounding points as the
// port's plain version (ops/adaln.py): statistics in float32 (mean, then
// the mean squared deviation; biased, no affine), the normalised value
// rounded to the io dtype, then 1 + scale, the product and + shift as three
// separately rounded float32 operations (no FMA contraction), rounded to
// nearest even into the io dtype.
//
// What bounds it on this card: bytes.  A row reads D values and writes D
// (bf16 at the flagship: 238 MB a call at 128,000 rows, 0.071 ms at 3.35
// TB/s); the arithmetic is ~10 operations an element, and cond (3.8 MB at
// B = 1024) stays in L2.
//
// What the design does about it: a warp per row, each lane holding its
// 16-byte vectors of the row in registers (D = 464 bf16 is 58 vectors: two a
// lane), so x is read from device memory once and out written once, both as
// 16-byte accesses by neighbouring lanes.  The mean and then the squared
// deviations are reduced over the registers with warp shuffles: no shared
// memory, no block barrier.  Neighbouring warps take neighbouring rows, so
// a block's loads of cond hit the same row.  x is loaded with the streaming
// hint (read once), cond through the read-only path.

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

// a row's 16-byte vectors, lane l holding vectors l, l + 32, ...
template <int NV>
__device__ __forceinline__ void load_row(uint4* dst, const uint4* __restrict__ src, int nvec,
                                         int lane) {
#pragma unroll
  for (int k = 0; k < NV; ++k)
    if (lane + 32 * k < nvec) dst[k] = __ldcs(src + lane + 32 * k);
}

// NV: 16-byte vectors a lane holds, ceil(D / kVec / 32)
template <typename T, int NV>
__device__ __forceinline__ void adaln_row(const T* __restrict__ x, const float* __restrict__ cond,
                                          T* __restrict__ out, long long rows, int S, int D,
                                          float eps) {
  using IO = Io<T>;
  constexpr int V = IO::kVec;
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

  const float* scale = cond + (row / S) * 2LL * D;
  const float* shift = scale + D;
  uint4* orow = reinterpret_cast<uint4*>(out + row * D);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int i = lane + 32 * k;
    if (i < nvec) {
      IO::unpack(v[k], f);
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        const float4 sc = __ldg(reinterpret_cast<const float4*>(scale + i * V + j));
        const float4 sh = __ldg(reinterpret_cast<const float4*>(shift + i * V + j));
        const float s[4] = {sc.x, sc.y, sc.z, sc.w};
        const float b[4] = {sh.x, sh.y, sh.z, sh.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float y = IO::round(__fmul_rn(f[j + q] - mean, rstd));
          f[j + q] = __fadd_rn(__fmul_rn(y, __fadd_rn(1.f, s[q])), b[q]);
        }
      }
      orow[i] = IO::pack(f);
    }
  }
}

template <int NV>
__global__ void __launch_bounds__(kWarps * 32)
    adaln_fwd_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ cond,
                          bf16* __restrict__ out, long long rows, int S, int D, float eps) {
  adaln_row<bf16, NV>(x, cond, out, rows, S, D, eps);
}

template <int NV>
__global__ void __launch_bounds__(kWarps * 32)
    adaln_fwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ cond,
                         float* __restrict__ out, long long rows, int S, int D, float eps) {
  adaln_row<float, NV>(x, cond, out, rows, S, D, eps);
}

template <int NV>
cudaError_t launch_nv(const void* x, const float* cond, void* out, long long rows, int S, int D,
                      float eps, int dtype, cudaStream_t st) {
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  if (dtype == 1)
    adaln_fwd_bf16_kernel<NV><<<blocks, kWarps * 32, 0, st>>>(
        static_cast<const bf16*>(x), cond, static_cast<bf16*>(out), rows, S, D, eps);
  else
    adaln_fwd_f32_kernel<NV><<<blocks, kWarps * 32, 0, st>>>(
        static_cast<const float*>(x), cond, static_cast<float*>(out), rows, S, D, eps);
  return cudaGetLastError();
}

}  // namespace

// x, out: contiguous (B, S, D), 16-byte aligned; cond: contiguous (B, 2D)
// float32, 16-byte aligned.  dtype: 0 = float32, 1 = bfloat16; D a multiple
// of the 16-byte vector (4 float32, 8 bfloat16) and at most kMaxD.  Returns
// the cudaError_t of the launch.
extern "C" int ada_layer_norm_launch(const void* x, const void* cond, void* out, int B, int S,
                                     int D, float eps, int dtype, void* stream) {
  if (B < 1 || S < 1 || D < 1 || D > kMaxD || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int V = dtype == 1 ? Io<bf16>::kVec : Io<float>::kVec;
  if (D % V) return (int)cudaErrorInvalidValue;
  const int nv = (D / V + 31) / 32;  // 1..4 (bf16), 1..8 (float32)
  const long long rows = (long long)B * S;
  const float* c = static_cast<const float*>(cond);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nv) {
    case 1: return (int)launch_nv<1>(x, c, out, rows, S, D, eps, dtype, st);
    case 2: return (int)launch_nv<2>(x, c, out, rows, S, D, eps, dtype, st);
    case 3: return (int)launch_nv<3>(x, c, out, rows, S, D, eps, dtype, st);
    case 4: return (int)launch_nv<4>(x, c, out, rows, S, D, eps, dtype, st);
    case 5: return (int)launch_nv<5>(x, c, out, rows, S, D, eps, dtype, st);
    case 6: return (int)launch_nv<6>(x, c, out, rows, S, D, eps, dtype, st);
    case 7: return (int)launch_nv<7>(x, c, out, rows, S, D, eps, dtype, st);
    default: return (int)launch_nv<8>(x, c, out, rows, S, D, eps, dtype, st);
  }
}
