// K4: the fused LSTM cell update for NVIDIA Hopper (sm_90a).
//
// Replaces mxnet_tpu/ops/pallas_kernels.py:_lstm_gate_kernel (driven by
// lstm_gates).  It computes what that kernel computes, in fp32 math
// whatever the input types:
//
//   gates [B, 4H] = i | f | g | o (pre-activations), c [B, H]
//   c' = sigmoid(f) * c + sigmoid(i) * tanh(g)
//   h' = sigmoid(o) * tanh(c')
//
// with sigmoid(x) = 1 / (1 + exp(-x)), and both outputs in c's dtype.  The
// gates and c are each fp32 or bf16, independently, as the TPU kernel
// upcasts each input on its own.
//
// Design.  The TPU kernel reads the whole [B, 4H] block into VMEM in one
// grid step.  Here there is nothing to stage: each output element needs
// five inputs that no other element needs, so one thread owns one (b, j),
// j < H, reads g[b, j], g[b, H+j], g[b, 2H+j], g[b, 3H+j] and c[b, j], and
// writes c'[b, j] and h'[b, j].  Neighbouring threads take neighbouring j,
// so every load and store of a warp is one coalesced run per gate.  H is
// any width (200 on the LSTM LM's path, 13 in a test); a grid-stride loop
// over B*H covers the tail.  A 16-byte vector path for widths that allow
// it read 80 % of the bytes bound at [4096, 4096], a size no path runs,
// and made the LM's [32, 800] launch slower, so it is not kept (PERF.md).
// expf and tanhf are the accurate ones: the build takes no fast-math flag.
//
// What bounds it on the H100.  Per element it moves 4 gate values in and
// c in, c' and h' out, for about fifteen operations: it is bound by bytes.
// At the LSTM LM's [32, 800] call that is 179 KB, about 0.05 us at 3.35
// TB/s, far below one launch, so on that path the launch latency and the
// host's call are its time (ops/hopper_kernels.py keeps that call lean).
// Only at widths like [4096, 4096] (117 MB) does the share of the
// memory bound mean anything.
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;           // threads per block
constexpr int MAX_BLOCKS = 4096;  // 132 SMs x 31; the loop strides past it

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

template <typename TG, typename TC>
__global__ void __launch_bounds__(NT)
lstm_gates_kernel(const TG* __restrict__ gates, const TC* __restrict__ c,
                  TC* __restrict__ c_out, TC* __restrict__ h_out, int b,
                  int h) {
  const long long n = (long long)b * h;
  const long long stride = (long long)gridDim.x * NT;
  for (long long e = (long long)blockIdx.x * NT + threadIdx.x; e < n;
       e += stride) {
    const long long row = e / h;
    const int j = (int)(e - row * h);
    const TG* g = gates + row * 4 * h + j;
    const float ig = sigmoid_f(load_f(g));
    const float fg = sigmoid_f(load_f(g + h));
    const float gg = tanhf(load_f(g + 2 * h));
    const float og = sigmoid_f(load_f(g + 3 * h));
    const float cn = fg * load_f(c + e) + ig * gg;
    store_f(c_out + e, cn);
    store_f(h_out + e, og * tanhf(cn));
  }
}

template <typename TG, typename TC>
cudaError_t launch(const void* gates, const void* c, void* c_out, void* h_out,
                   int b, int h, cudaStream_t stream) {
  const long long n = (long long)b * h;
  if (b <= 0 || h <= 0) return cudaErrorInvalidValue;
  const long long want = (n + NT - 1) / NT;
  const int blocks = (int)(want < MAX_BLOCKS ? want : MAX_BLOCKS);
  lstm_gates_kernel<TG, TC><<<blocks, NT, 0, stream>>>(
      static_cast<const TG*>(gates), static_cast<const TC*>(c),
      static_cast<TC*>(c_out), static_cast<TC*>(h_out), b, h);
  return cudaGetLastError();
}

template <typename TG>
cudaError_t dispatch_c(int c_dtype, const void* gates, const void* c,
                       void* c_out, void* h_out, int b, int h,
                       cudaStream_t stream) {
  switch (c_dtype) {
    case 0:
      return launch<TG, float>(gates, c, c_out, h_out, b, h, stream);
    case 1:
      return launch<TG, __nv_bfloat16>(gates, c, c_out, h_out, b, h, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// gates_dtype, c_dtype: 0 = float32, 1 = bfloat16; c_out and h_out are in
// c's dtype.  Returns a cudaError_t value.
extern "C" int mxtt_lstm_gates(const void* gates, const void* c, void* c_out,
                               void* h_out, int b, int h, int gates_dtype,
                               int c_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (gates_dtype == 0) {
    err = dispatch_c<float>(c_dtype, gates, c, c_out, h_out, b, h, s);
  } else if (gates_dtype == 1) {
    err = dispatch_c<__nv_bfloat16>(c_dtype, gates, c, c_out, h_out, b, h, s);
  }
  return static_cast<int>(err);
}

extern "C" const char* mxtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
