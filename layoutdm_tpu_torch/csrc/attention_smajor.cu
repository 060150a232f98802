// Sequence-major packed-qkv self-attention for Hopper (sm_90a): K6.
//
// Replaces: layoutdm_tpu/ops/attention.py::fused_attention_qkv_smajor, whose
// Pallas kernel body is _attn_kernel_qkv_smajor.  Same function: K1's
// attention on an (S, B, 3D) slab -- token s of batch row b at element
// (s*B + b)*3D -- with the qkv projection bias (3D,) added to the slab in
// the io dtype (one rounding), as the TPU kernel adds it in VMEM.  Output
// (B, S, D) in the io dtype, batch-major like K1's.
//
// On the TPU the sequence-major slab made the projection GEMM's transpose a
// free bitcast and moved the bias add into the kernel.  Here it is K1 with
// another token stride and a bias add at load (attention_fwd.cuh, which
// says what bounds the kernel and what its design does about that): at the
// flagship width it runs the native head width (hd = 58), no 64-lane pad.
// The strided token rows change no access pattern that matters: K1 already
// copies one 16-byte window per head and token, B * 3D elements apart here
// instead of 3D.

#include "attention_fwd.cuh"

// qkv_sb: contiguous (S, B, 3*H*hd); bias: contiguous (3*H*hd,); out:
// contiguous (B, S, H*hd); all one dtype, 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch.
extern "C" int attention_smajor_launch(const void* qkv_sb, const void* bias,
                                       void* out, int B, int S, int H, int hd,
                                       float scale, int dtype, void* stream) {
  const long long row = 3LL * H * hd;
  return attention_fwd::launch<true>(qkv_sb, bias, out, B, S, H, hd, row,
                                     B * row, scale, dtype, stream);
}
