// K1: flash-attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces mxnet_tpu/ops/pallas_kernels.py:_attn_fwd_kernel (driven by
// _pallas_attention_fwd).  It computes what that kernel computes:
// online-softmax attention over contiguous [B, H, L, D] inputs with the
// running (acc, m, l) state in fp32, masked scores set to -1e30, key tiles
// above the causal diagonal skipped (top-left aligned, so Lq != Lk keeps
// the TPU kernel's row >= col rule), l clamped at 1e-30, and two outputs:
// O in the input dtype and lse = m + log(l) in fp32.
//
// Design.  The TPU kernel walks K/V blocks on a sequential grid axis and
// carries its state in VMEM scratch from one grid step to the next.  CUDA
// blocks run in parallel and in no order, so here one block owns one
// (b*h, tile of 64 query rows) for its whole life: a loop inside the block
// walks the key tiles, each K/V tile is staged in shared memory, the
// running max and sum live in shared memory and the output accumulator in
// registers.  256 threads form a 16 x 16 grid; each owns a 4 x 4 tile of
// the 64 x 64 score block and a 4 x D/16 tile of the 64 x D accumulator,
// with rows and columns strided by 16 so that shared-memory reads are
// broadcasts or conflict-free.  Scores never leave the SM: device memory
// sees each of Q, K, V read once per query tile and O, lse written once.
//
// What bounds it on the H100.  Per (b, h) the work is 4*Lq*Lk*D operations
// against (2*Lq + 2*Lk)*D elements moved; at BERT's L = 512, D = 64 in fp32
// that is about 128 operations per byte, far above the card's fp32 ridge
// (67 TFLOP/s over 3.35 TB/s, about 20), so the kernel is bound by
// arithmetic.  This version does that arithmetic as fp32 FMAs fed from
// shared memory, which keeps it exact to fp32 and simple; moving the two
// products onto the tensor cores (wgmma on bf16 tiles fed by TMA) is where
// the remaining factor lies, and is later work.
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;    // query rows per block
constexpr int BN = 64;    // key rows per tile
constexpr int NT = 256;   // threads per block: a 16 x 16 grid
constexpr float MASKED = -1e30f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// shared memory, in floats: Q tile, K tile (rows padded by one), V tile,
// score tile (padded), and the per-row max, sum and rescale factor
template <int D>
constexpr int smem_floats() {
  return BM * (D + 1) + BN * (D + 1) + BN * D + BM * (BN + 1) + 3 * BM;
}

template <int D, typename T, bool CAUSAL>
__global__ void __launch_bounds__(NT)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, int lq, int lk, int n_qt,
                      float scale) {
  constexpr int DP = D + 1;
  constexpr int SP = BN + 1;
  constexpr int TN = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + BM * DP;
  float* vs = ks + BN * DP;
  float* ss = vs + BN * D;
  float* m_s = ss + BM * SP;
  float* l_s = m_s + BM;
  float* a_s = l_s + BM;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * BM;
  const T* qb = q + (size_t)bh * lq * D;
  const T* kb = k + (size_t)bh * lk * D;
  const T* vb = v + (size_t)bh * lk * D;

  // the Q tile, pre-scaled as the TPU kernel scales q before the product
  for (int e = tid; e < BM * D; e += NT) {
    const int r = e / D, c = e % D;
    qs[r * DP + c] =
        (q0 + r < lq) ? load_f(qb + (size_t)(q0 + r) * D + c) * scale : 0.f;
  }
  if (tid < BM) {
    m_s[tid] = MASKED;
    l_s[tid] = 0.f;
  }

  float acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // causal: keys past this tile's last query row contribute nothing
  const int k_end = CAUSAL ? min(lk, min(q0 + BM, lq)) : lk;
  for (int k0 = 0; k0 < k_end; k0 += BN) {
    __syncthreads();  // the previous tile is consumed; Q, m, l are written
    for (int e = tid; e < BN * D; e += NT) {
      const int r = e / D, c = e % D;
      const bool live = k0 + r < lk;
      const size_t off = (size_t)(k0 + r) * D + c;
      ks[r * DP + c] = live ? load_f(kb + off) : 0.f;
      vs[r * D + c] = live ? load_f(vb + off) : 0.f;
    }
    __syncthreads();

    // S = (scale * Q) K^T for this tile
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(i * 16 + ty) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[(j * 16 + tx) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = i * 16 + ty, c = j * 16 + tx;
        float x = s[i][j];
        if (CAUSAL && k0 + c > q0 + r) x = MASKED;
        if (k0 + c >= lk) x = -INFINITY;  // past the last key: weight 0
        ss[r * SP + c] = x;
      }
    __syncthreads();

    // online softmax: four neighbouring lanes per row, 16 columns each
    {
      const int r = tid / 4, part = tid % 4;
      float* row = ss + r * SP + part * 16;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();  // all four lanes have read m_s[r] before it changes
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = alpha * acc + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[i * 16 + ty];
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int n = 0; n < BN; ++n) {
      float p[4], w[TN];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ss[(i * 16 + ty) * SP + n];
#pragma unroll
      for (int j = 0; j < TN; ++j) w[j] = vs[n * D + j * 16 + tx];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(p[i], w[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = i * 16 + ty;
    if (q0 + r < lq) {
      const float l = fmaxf(l_s[r], 1e-30f);
      T* orow = o + ((size_t)bh * lq + q0 + r) * D;
#pragma unroll
      for (int j = 0; j < TN; ++j) store_f(orow + j * 16 + tx, acc[i][j] / l);
    }
  }
  if (tid < BM && q0 + tid < lq)
    lse[(size_t)bh * lq + q0 + tid] =
        m_s[tid] + logf(fmaxf(l_s[tid], 1e-30f));
}

template <int D, typename T, bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int lq, int lk, float scale,
                   cudaStream_t stream) {
  auto kernel = flash_attn_fwd_kernel<D, T, CAUSAL>;
  const int smem = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (lq + BM - 1) / BM;
  const long long blocks = (long long)bh * n_qt;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)blocks), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      lq, lk, n_qt, scale);
  return cudaGetLastError();
}

template <typename T, bool CAUSAL>
cudaError_t dispatch_head_dim(int d, const void* q, const void* k,
                              const void* v, void* o, void* lse, int bh,
                              int lq, int lk, float scale,
                              cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<16, T, CAUSAL>(q, k, v, o, lse, bh, lq, lk, scale, stream);
    case 32:
      return launch<32, T, CAUSAL>(q, k, v, o, lse, bh, lq, lk, scale, stream);
    case 64:
      return launch<64, T, CAUSAL>(q, k, v, o, lse, bh, lq, lk, scale, stream);
    case 128:
      return launch<128, T, CAUSAL>(q, k, v, o, lse, bh, lq, lk, scale,
                                    stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t value.
extern "C" int mxtt_flash_attn_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int bh, int lq, int lk,
                                   int d, int dtype, int causal, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = causal ? dispatch_head_dim<float, true>(d, q, k, v, o, lse, bh, lq,
                                                  lk, scale, s)
                 : dispatch_head_dim<float, false>(d, q, k, v, o, lse, bh, lq,
                                                   lk, scale, s);
  } else if (dtype == 1) {
    err = causal ? dispatch_head_dim<__nv_bfloat16, true>(
                       d, q, k, v, o, lse, bh, lq, lk, scale, s)
                 : dispatch_head_dim<__nv_bfloat16, false>(
                       d, q, k, v, o, lse, bh, lq, lk, scale, s);
  }
  return static_cast<int>(err);
}

extern "C" const char* mxtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
