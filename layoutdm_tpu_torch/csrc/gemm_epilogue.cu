// The denoiser's bf16 GEMMs with their elementwise tail in cuBLASLt's
// epilogue, on the inference path (models/nn.py Block and SelfAttention):
//   relu:     D = relu(x W^T + b)       linear1, CUBLASLT_EPILOGUE_RELU_BIAS
//   residual: D = r + x W^T + b         linear2 and the attention's out
//                                       projection, CUBLASLT_EPILOGUE_BIAS
//                                       with C = r and beta = 1
// The bias and the residual are added to the float32 accumulator and the
// sum is rounded to bf16 once.  D is a new buffer, never C.
//
// Replaces no TPU kernel: on the TPU, XLA fused the activation and the
// residual adds of layoutdm_tpu/models/nn.py into the products.  Eager
// PyTorch ran each as a pass of its own over the output: the ReLU over the
// (128,000 x 1,856) bf16 hidden (~0.95 GB a layer at the flagship), each
// residual add over the (128,000 x 464) stream (~0.36 GB).
//
// What bounds it on this card: linear1 and linear2 are bound by their
// products (4.4e11 operations a layer pair at 128,000 x 464 x 1,856); the
// out projection (464 x 464) by its bytes.  Nothing here is a kernel of the
// repo's own: this is a thin shim that asks cuBLASLt for one.
//
// What it holds: one cuBLASLt handle a device, and for each (device, M, N,
// K, epilogue, alignment) the matmul descriptor, the three matrix layouts
// and the first algorithm cublasLtMatmulAlgoGetHeuristic returns, built at
// the first call.  A call sets the bias pointer on its descriptor and
// launches on the caller's stream with the caller's workspace.
//
// cuBLASLt's entry points are bound at run time (gemm_epilogue_bind) to the
// libcublasLt that the process has already loaded through torch, so the
// process holds one copy of it; this file links nothing of cuBLAS.
//
// Layouts: x (M, K), W (N, K) as nn.Linear stores it, b (N,), r and D (M,
// N), all bf16, contiguous and row-major.  cuBLASLt is column-major: it
// sees D as an (N x M) matrix, W as (K x N) and x as (K x M), each with
// leading dimension its row length, and computes D = W^T x (transa = T,
// transb = N) with the bias a value per row of its D: the "TNN" layout of
// PyTorch's own F.linear.

#include <cublasLt.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

namespace {

struct Api {
  decltype(&cublasLtCreate) create;
  decltype(&cublasLtMatmulDescCreate) desc_create;
  decltype(&cublasLtMatmulDescSetAttribute) desc_set;
  decltype(&cublasLtMatrixLayoutCreate) layout_create;
  decltype(&cublasLtMatmulPreferenceCreate) pref_create;
  decltype(&cublasLtMatmulPreferenceSetAttribute) pref_set;
  decltype(&cublasLtMatmulPreferenceDestroy) pref_destroy;
  decltype(&cublasLtMatmulAlgoGetHeuristic) heuristic;
  decltype(&cublasLtMatmul) matmul;
};
constexpr int kApiEntries = 9;  // in the order of gemm_epilogue.py's CUBLASLT_ENTRIES

struct Plan {
  cublasLtMatmulDesc_t op;
  cublasLtMatrixLayout_t w, x, out;  // out: C and D
  cublasLtMatmulAlgo_t algo;
};

// device, M, N, K, epilogue, alignment
using Key = std::tuple<int, long long, int, int, int, int>;

std::mutex mu;
Api api{};
bool bound = false;
std::map<int, cublasLtHandle_t> handles;
std::map<Key, Plan> plans;

constexpr int kNoAlgorithm = -3;

#define CHECK_LT(call)                         \
  do {                                         \
    cublasStatus_t s_ = (call);                \
    if (s_ != CUBLAS_STATUS_SUCCESS) return s_; \
  } while (0)

int make_plan(cublasLtHandle_t handle, long long M, int N, int K, int epilogue, int alignment,
              const void* bias, unsigned long long workspace_bytes, Plan* p) {
  CHECK_LT(api.desc_create(&p->op, CUBLAS_COMPUTE_32F, CUDA_R_32F));
  const int32_t ta = CUBLAS_OP_T, tb = CUBLAS_OP_N;
  CHECK_LT(api.desc_set(p->op, CUBLASLT_MATMUL_DESC_TRANSA, &ta, sizeof(ta)));
  CHECK_LT(api.desc_set(p->op, CUBLASLT_MATMUL_DESC_TRANSB, &tb, sizeof(tb)));
  const uint32_t ep = epilogue == 0 ? CUBLASLT_EPILOGUE_RELU_BIAS : CUBLASLT_EPILOGUE_BIAS;
  CHECK_LT(api.desc_set(p->op, CUBLASLT_MATMUL_DESC_EPILOGUE, &ep, sizeof(ep)));
  CHECK_LT(api.desc_set(p->op, CUBLASLT_MATMUL_DESC_BIAS_POINTER, &bias, sizeof(bias)));
  CHECK_LT(api.layout_create(&p->w, CUDA_R_16BF, K, N, K));
  CHECK_LT(api.layout_create(&p->x, CUDA_R_16BF, K, M, K));
  CHECK_LT(api.layout_create(&p->out, CUDA_R_16BF, N, M, N));
  cublasLtMatmulPreference_t pref;
  CHECK_LT(api.pref_create(&pref));
  const uint64_t ws = workspace_bytes;
  const uint32_t align = alignment;
  cublasStatus_t s = api.pref_set(pref, CUBLASLT_MATMUL_PREF_MAX_WORKSPACE_BYTES, &ws, sizeof(ws));
  for (auto attr : {CUBLASLT_MATMUL_PREF_MIN_ALIGNMENT_A_BYTES,
                    CUBLASLT_MATMUL_PREF_MIN_ALIGNMENT_B_BYTES,
                    CUBLASLT_MATMUL_PREF_MIN_ALIGNMENT_C_BYTES,
                    CUBLASLT_MATMUL_PREF_MIN_ALIGNMENT_D_BYTES})
    if (s == CUBLAS_STATUS_SUCCESS) s = api.pref_set(pref, attr, &align, sizeof(align));
  cublasLtMatmulHeuristicResult_t result;
  int found = 0;
  if (s == CUBLAS_STATUS_SUCCESS)
    s = api.heuristic(handle, p->op, p->w, p->x, p->out, p->out, pref, 1, &result, &found);
  api.pref_destroy(pref);
  if (s != CUBLAS_STATUS_SUCCESS) return s;
  if (found < 1) return kNoAlgorithm;
  p->algo = result.algo;
  return 0;
}

}  // namespace

// fns: the kApiEntries cuBLASLt entry points, resolved from the loaded
// libcublasLt.  Returns 0, or -1 for a missing entry.
extern "C" int gemm_epilogue_bind(void* const* fns, int n) {
  if (n != kApiEntries) return -1;
  for (int i = 0; i < n; ++i)
    if (fns[i] == nullptr) return -1;
  std::lock_guard<std::mutex> lock(mu);
  api.create = reinterpret_cast<decltype(api.create)>(fns[0]);
  api.desc_create = reinterpret_cast<decltype(api.desc_create)>(fns[1]);
  api.desc_set = reinterpret_cast<decltype(api.desc_set)>(fns[2]);
  api.layout_create = reinterpret_cast<decltype(api.layout_create)>(fns[3]);
  api.pref_create = reinterpret_cast<decltype(api.pref_create)>(fns[4]);
  api.pref_set = reinterpret_cast<decltype(api.pref_set)>(fns[5]);
  api.pref_destroy = reinterpret_cast<decltype(api.pref_destroy)>(fns[6]);
  api.heuristic = reinterpret_cast<decltype(api.heuristic)>(fns[7]);
  api.matmul = reinterpret_cast<decltype(api.matmul)>(fns[8]);
  bound = true;
  return 0;
}

// x (M, K), w (N, K), bias (N,), residual and out (M, N): bf16, contiguous,
// every address a multiple of `alignment` bytes; K and N multiples of 8.
// epilogue: 0 = relu (residual unread), 1 = residual.  workspace: device
// memory of workspace_bytes, on `stream`'s order.  Returns 0; a
// cublasStatus_t; 1000 + a cudaError_t; -1 before gemm_epilogue_bind; -2 for
// bad arguments; -3 where the heuristic offers no algorithm.
extern "C" int gemm_epilogue_launch(const void* x, const void* w, const void* bias,
                                    const void* residual, void* out, long long M, int N, int K,
                                    int epilogue, int alignment, void* workspace,
                                    unsigned long long workspace_bytes, void* stream) {
  if (M < 1 || N < 1 || K < 1 || N % 8 || K % 8 || (epilogue != 0 && epilogue != 1) ||
      alignment < 16 || (epilogue == 1 && residual == nullptr))
    return -2;
  int device;
  const cudaError_t ce = cudaGetDevice(&device);
  if (ce != cudaSuccess) return 1000 + (int)ce;
  std::lock_guard<std::mutex> lock(mu);
  if (!bound) return -1;
  auto h = handles.find(device);
  if (h == handles.end()) {
    cublasLtHandle_t handle;
    CHECK_LT(api.create(&handle));
    h = handles.emplace(device, handle).first;
  }
  const Key key{device, M, N, K, epilogue, alignment};
  auto p = plans.find(key);
  if (p == plans.end()) {
    Plan plan;
    const int s = make_plan(h->second, M, N, K, epilogue, alignment, bias, workspace_bytes, &plan);
    if (s != 0) return s;
    p = plans.emplace(key, plan).first;
  }
  const Plan& plan = p->second;
  CHECK_LT(api.desc_set(plan.op, CUBLASLT_MATMUL_DESC_BIAS_POINTER, &bias, sizeof(bias)));
  const float alpha = 1.0f, beta = epilogue == 1 ? 1.0f : 0.0f;
  return api.matmul(h->second, plan.op, &alpha, w, plan.w, x, plan.x, &beta,
                    epilogue == 1 ? residual : out, plan.out, out, plan.out, &plan.algo,
                    workspace, workspace_bytes, static_cast<cudaStream_t>(stream));
}
