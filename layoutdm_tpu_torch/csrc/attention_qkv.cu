// Packed-qkv self-attention for Hopper (sm_90a): K1.
//
// Replaces: layoutdm_tpu/ops/attention.py::fused_attention_qkv, whose Pallas
// kernel body is _attn_kernel_qkv.  Same function: per head h,
//   o[:, h*hd:(h+1)*hd] = softmax(q_h k_h^T * scale) v_h
// on the packed (B, S, 3D) projection output, with q/k/v the column blocks
// [h*hd], [D + h*hd], [2D + h*hd]; no mask; output (B, S, D) in the input
// dtype (float32 or bfloat16).  Scores, softmax and accumulation are float32;
// in bfloat16 mode the normalised probabilities are rounded to bfloat16
// before the p.v product, as the TPU kernel does.
//
// The kernel bodies (bfloat16 at S <= 128, bfloat16 at 128 < S <= 512 with
// each (row, head)'s K and V held in shared memory, float32), the rule
// between them, what bounds each and what its design does about that are in
// attention_fwd.cuh, shared with K6 (the sequence-major slab).

#include "attention_fwd.cuh"

// qkv: contiguous (B, S, 3*H*hd); out: contiguous (B, S, H*hd), same dtype.
// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int attention_qkv_launch(const void* qkv, void* out, int B, int S,
                                    int H, int hd, float scale, int dtype,
                                    void* stream) {
  const long long row = 3LL * H * hd;  // one token's q, k and v
  return attention_fwd::launch<false>(qkv, nullptr, out, B, S, H, hd, S * row,
                                      row, scale, dtype, stream);
}

// 1 where a call of S keys at head size hd in `dtype` takes the long bf16
// body (attention_fwd::long_body, the rule launch_typed follows), else 0
extern "C" int attention_qkv_long_body(int S, int hd, int dtype) {
  return attention_fwd::long_body(S, hd, dtype) ? 1 : 0;
}
