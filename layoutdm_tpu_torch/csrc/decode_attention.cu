// Single-query attention over cached keys and values for Hopper (sm_90a):
// one token a row against the first n positions of its caches, the cached
// decode of the decoders (models/nn.py: SelfAttention.decode_step, and
// CrossAttention with its keys and values projected once).
//
//   self:  k_cache[b, n-1] = k_new[b]; v_cache[b, n-1] = v_new[b]
//   both:  out[b, h] = softmax(q[b, h] k[b, :n, h]^T / sqrt(hd)) v[b, :n, h]
//
// Replaces no TPU kernel: the JAX package left both to XLA
// (layoutdm_tpu/models/nn.py: SelfAttention._decode_step, CrossAttention).
// Eager PyTorch ran each as two einsums that copied every cache slice into
// bmm's layout before each product (the (b, h) batch of a (B, L, H, hd)
// cache has no single stride), two gemv reads of the copies, a softmax, two
// casts and, for self-attention, two cache writes.
//
// Rounding points as the eager arithmetic (ops/decode_attention.py, the
// plain version): each score accumulated in float32 and rounded to the io
// dtype, times the float32 reciprocal of sqrt(hd) (what PyTorch's CUDA true
// division by a Python scalar computes) and rounded again; the softmax in
// float32 (exp(s - max) / sum), its probabilities rounded to the io dtype;
// p.v accumulated in float32 and rounded once.  In float32 nothing is
// rounded in between.
//
// What bounds it on this card: bytes.  Each position's keys and values are
// read once (at BART's cell, B = 4,096, 8 heads of 42, bf16: 693 MB a
// cross-attention call over 126 positions, 0.21 ms at 3.35 TB/s); q, the
// new row and the output are a thousandth of that, and the arithmetic is
// ~1 FMA a cache byte.
//
// What the design does about it: a block per row b, 256 threads.  A
// position's H.hd row is contiguous (672 B at BART's widths, 16-byte
// aligned, though one head's 84 B is not), so the block streams whole rows
// with 16-byte cp.async copies, keys then values, through two
// shared-memory stages of up to 32 rows (21.5 KB at BART's widths: one
// stage in flight while the other is read, four blocks an SM; fewer rows,
// and more blocks, for a prefix shorter than 32).  From a
// stage each thread takes (position, head) dot products, q held in shared
// memory as float32; the row's H x n scores stay in shared memory (4 KB at
// n = 126), so the softmax (a warp a head) normalises and rounds the
// probabilities before the first value stage is read, and nothing but the
// output goes back to device memory.  For values each thread accumulates
// four neighbouring output elements over a slice of the positions, and the
// slices are summed through shared memory at the end.  In self mode the
// block reads this step's k and v rows from the qkv projection into
// registers, writes them to the caches at position n - 1 and into the
// ring, so the new position is never read back from device memory.  Where a
// head's width is a multiple of 128 bytes, the dot products start at a
// rotated offset so that neighbouring threads read other banks.
// Allocates nothing; the launch's cudaGetLastError is returned.  The
// dynamic shared memory attribute is set to the most a launch takes once a
// device and dtype, not on each launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;
constexpr int kMaxChunk = 32;            // rows a ring stage holds at most
constexpr int kStageBytes = 24 * 1024;   // and its bytes at most
constexpr int kGroup = 4;                // output elements a thread accumulates
// the limits, MAX_HEADS, MAX_D_MODEL and MAX_LEN in ops/decode_attention.py
constexpr int kMaxHeads = 16;
constexpr int kMaxD = 1024;              // kGroup x kThreads
constexpr int kMaxLen = 1024;
constexpr int kMaxDevices = 64;

template <typename T>
struct Io;

template <>
struct Io<bf16> {
  __device__ static float round(float x) { return __bfloat162float(__float2bfloat16(x)); }
  __device__ static float to_f32(bf16 x) { return __bfloat162float(x); }
  __device__ static float2 load2(const bf16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ static void load4(const bf16* p, float* f) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    f[0] = a.x, f[1] = a.y, f[2] = b.x, f[3] = b.y;
  }
  __device__ static void store2(bf16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

template <>
struct Io<float> {
  __device__ static float round(float x) { return x; }
  __device__ static float to_f32(float x) { return x; }
  __device__ static float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
  __device__ static void load4(const float* p, float* f) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x, f[1] = u.y, f[2] = u.z, f[3] = u.w;
  }
  __device__ static void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

struct Args {
  const void* q;  // row b at q + b * q_b: H.hd values
  void* k;        // position l of row b at k + b * k_b + l * k_l
  void* v;
  const void* k_new;  // self mode: this step's k and v rows (else null)
  const void* v_new;
  void* out;  // (B, H.hd), contiguous
  long long q_b, k_b, k_l, v_b, v_l, new_b;  // strides in elements
  int H, hd, n, chunk;
  float scale;  // float32 reciprocal of sqrt(hd)
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the score rows' pitch (odd, so that heads fall in other banks) and the
// shared memory a launch takes: the ring, the scores, q, the slices' sums
__host__ __device__ constexpr int score_pitch(int n) { return ((n + 31) & ~31) + 1; }
__host__ __device__ constexpr int score_floats(int H, int n) {
  return (H * score_pitch(n) + 3) & ~3;
}
inline int slices(int D) { return kThreads / (D / kGroup); }
inline size_t smem_bytes(int H, int hd, int n, int chunk, int esize) {
  const int D = H * hd;
  return (size_t)kStages * chunk * D * esize +
         4 * ((size_t)score_floats(H, n) + D + (size_t)slices(D) * D);
}
// the most any launch takes: full stages, kMaxHeads rows of kMaxLen scores,
// and q and the slices' sums at kMaxD (slices(D) x D <= kThreads x kGroup)
constexpr size_t kMaxSmem =
    (size_t)kStages * kStageBytes + 4 * ((size_t)score_floats(kMaxHeads, kMaxLen) + kMaxD +
                                         (size_t)kThreads * kGroup);

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = a.H, hd = a.hd, n = a.n, P = a.chunk;
  const int D = H * hd;
  const int row_bytes = D * (int)sizeof(T);
  const int rv = row_bytes / 16;  // 16-byte vectors a row
  const int nc = (n + P - 1) / P;  // ring stages of keys, and of values
  const int pitch = score_pitch(n);
  unsigned char* ring = smem;
  float* sc = reinterpret_cast<float*>(smem + (size_t)kStages * P * row_bytes);
  float* qf = sc + score_floats(H, n);
  float* red = qf + D;
  const long long b = blockIdx.x;
  const bool self = a.k_new != nullptr;
  const int tid = threadIdx.x;

  // stage c of the stream (keys' 0 .. nc-1, then values'), one cp.async group
  // a thread whether or not it copies
  auto issue = [&](int c) {
    if (c < 2 * nc) {
      const bool is_v = c >= nc;
      const int p0 = (is_v ? c - nc : c) * P;
      const int rows = min(P, n - p0);
      unsigned char* dst = ring + (size_t)(c % kStages) * P * row_bytes;
      unsigned char* src = static_cast<unsigned char*>(is_v ? a.v : a.k) +
                           (b * (is_v ? a.v_b : a.k_b) + p0 * (is_v ? a.v_l : a.k_l)) * sizeof(T);
      const long long src_pitch = (is_v ? a.v_l : a.k_l) * (long long)sizeof(T);
      for (int i = tid; i < rows * rv; i += kThreads) {
        const int r = i / rv, j = i - r * rv;
        unsigned char* at = src + r * src_pitch + j * 16;
        if (self && p0 + r == n - 1) {
          // this step's row: from the projection into the cache and the ring
          const uint4 x = *reinterpret_cast<const uint4*>(
              static_cast<const unsigned char*>(is_v ? a.v_new : a.k_new) +
              b * a.new_b * (long long)sizeof(T) + j * 16);
          *reinterpret_cast<uint4*>(at) = x;
          *reinterpret_cast<uint4*>(dst + i * 16) = x;
        } else {
          cp_async16(dst + i * 16, at);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  const T* qrow = static_cast<const T*>(a.q) + b * a.q_b;
  for (int e = tid; e < D; e += kThreads) qf[e] = Io<T>::to_f32(qrow[e]);

  // keys: (position, head) items; where a head is a multiple of 128 bytes
  // the threads start their sums at rotated offsets
  const bool rotate = (hd * (int)sizeof(T)) % 128 == 0;
  // values: four neighbouring output elements over a slice of the positions;
  // their heads, at most two (hd is even and the group starts at a multiple
  // of 4): h0 for the first `split` elements, h0 + 1 for the rest
  const int groups = D / kGroup, n_slices = kThreads / groups;
  const int slice = tid / groups, e0 = (tid - slice * groups) * kGroup;
  const int h0 = e0 / hd, split = min(kGroup, (h0 + 1) * hd - e0);
  float acc[kGroup] = {0.f, 0.f, 0.f, 0.f};

  for (int c = 0; c < 2 * nc; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(c + kStages - 1);
    const unsigned char* tile = ring + (size_t)(c % kStages) * P * row_bytes;
    if (c < nc) {
      const int p0 = c * P, rows = min(P, n - p0);
      for (int i = tid; i < rows * H; i += kThreads) {
        const int r = i / H, h = i - r * H;
        const T* krow = reinterpret_cast<const T*>(tile + r * row_bytes) + h * hd;
        const float* qh = qf + h * hd;
        int d = rotate ? (2 * (tid & 31)) % hd : 0;
        float s = 0.f;
        for (int t = 0; t < hd; t += 2) {
          const float2 kk = Io<T>::load2(krow + d);
          const float2 qq = *reinterpret_cast<const float2*>(qh + d);
          s = fmaf(qq.x, kk.x, s);
          s = fmaf(qq.y, kk.y, s);
          d += 2;
          if (d == hd) d = 0;
        }
        sc[h * pitch + p0 + r] = Io<T>::round(Io<T>::round(s) * a.scale);
      }
      if (c == nc - 1) {
        __syncthreads();
        // softmax over the n scores of each head, a warp a head
        const int warp = tid >> 5, lane = tid & 31;
        for (int h = warp; h < H; h += kWarps) {
          float* row = sc + h * pitch;
          float m = -INFINITY;
          for (int j = lane; j < n; j += 32) m = fmaxf(m, row[j]);
          m = warp_max(m);
          float sum = 0.f;
          for (int j = lane; j < n; j += 32) {
            const float e = expf(row[j] - m);
            row[j] = e;
            sum += e;
          }
          sum = warp_sum(sum);
          for (int j = lane; j < n; j += 32) row[j] = Io<T>::round(row[j] / sum);
        }
      }
    } else if (slice < n_slices) {
      const int p0 = (c - nc) * P, rows = min(P, n - p0);
      const float* pa = sc + h0 * pitch + p0;
      const float* pb = split < kGroup ? pa + pitch : pa;
      for (int r = slice; r < rows; r += n_slices) {
        float x[kGroup];
        Io<T>::load4(reinterpret_cast<const T*>(tile + r * row_bytes) + e0, x);
        const float wa = pa[r], wb = pb[r];
#pragma unroll
        for (int k = 0; k < kGroup; ++k) acc[k] = fmaf(k < split ? wa : wb, x[k], acc[k]);
      }
    }
  }

  if (slice < n_slices) {
#pragma unroll
    for (int k = 0; k < kGroup; ++k) red[slice * D + e0 + k] = acc[k];
  }
  __syncthreads();
  T* orow = static_cast<T*>(a.out) + b * D;
  for (int e = 2 * tid; e < D; e += 2 * kThreads) {
    float o0 = 0.f, o1 = 0.f;
    for (int s = 0; s < n_slices; ++s) {
      o0 += red[s * D + e];
      o1 += red[s * D + e + 1];
    }
    Io<T>::store2(orow + e, o0, o1);
  }
}

template <typename T>
cudaError_t launch(Args a, int B, cudaStream_t st) {
  const int esize = (int)sizeof(T);
  const int row_bytes = a.H * a.hd * esize;
  // rows a stage: as many as fit, at most kMaxChunk, and no more than n (a
  // short prefix takes less shared memory, so more blocks share an SM)
  int fit = kStageBytes / row_bytes;
  fit = fit > kMaxChunk ? kMaxChunk : fit;
  fit = fit > a.n ? a.n : fit;
  a.chunk = fit < 1 ? 1 : fit;
  const size_t smem = smem_bytes(a.H, a.hd, a.n, a.chunk, esize);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // the kernel may take up to kMaxSmem: allowed once a device, on its first launch there
  static std::atomic<bool> allowed[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices || !allowed[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(decode_attention_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err != cudaSuccess) return err;
    if (dev < kMaxDevices) allowed[dev].store(true, std::memory_order_relaxed);
  }
  decode_attention_kernel<T><<<B, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// q: B rows of H.hd values, row b at q + b * q_b (elements), read as
// values.  k, v: position l of row b at k + b * k_b + l * k_l (likewise v);
// each position's H.hd values contiguous, every row start 16-byte aligned.
// k_new, v_new: null for cross-attention; for self-attention this step's
// rows (row b at k_new + b * new_b), written to position n - 1 of k and v and
// attended there.  out: contiguous (B, H.hd).  dtype: 0 = float32, 1 =
// bfloat16.  hd even, 1 <= H <= 16, H.hd <= 1024 in whole 16-byte rows,
// 1 <= n <= 1024.  Returns the cudaError_t of the launch.
extern "C" int decode_attention_launch(const void* q, long long q_b, void* k, long long k_b,
                                       long long k_l, void* v, long long v_b, long long v_l,
                                       const void* k_new, const void* v_new, long long new_b,
                                       void* out, int B, int H, int hd, int n, float scale,
                                       int dtype, void* stream) {
  const int esize = dtype == 1 ? 2 : 4;
  const int D = H * hd;
  const long long vec = 16 / esize;
  if (B < 1 || H < 1 || H > kMaxHeads || hd < 2 || hd % 2 || D > kMaxD || (D * esize) % 16 ||
      n < 1 || n > kMaxLen || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(k) || !aligned16(v) || k_b % vec || k_l % vec || v_b % vec || v_l % vec)
    return (int)cudaErrorInvalidValue;
  if ((k_new == nullptr) != (v_new == nullptr) ||
      (k_new != nullptr && (!aligned16(k_new) || !aligned16(v_new) || new_b % vec)))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, k_new, v_new, out, q_b, k_b, k_l, v_b, v_l, new_b, H, hd, n, 0, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)launch<bf16>(a, B, st);
  return (int)launch<float>(a, B, st);
}
