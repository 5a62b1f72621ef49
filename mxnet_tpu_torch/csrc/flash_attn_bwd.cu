// K2 and K3: the flash-attention backward for NVIDIA Hopper (sm_90a).
//
// Replaces mxnet_tpu/ops/pallas_kernels.py:_attn_dq_kernel (K2) and
// _attn_dkv_kernel (K3), both driven by _pallas_attention_bwd.  They
// compute what those kernels compute, over contiguous [B, H, L, D] inputs
// flattened to [B*H, L, D], with the probabilities recomputed from the
// forward's saved row logsumexp instead of being read back:
//
//   s  = (q k^T) * scale          (scale after the product, as the TPU
//                                  kernels apply it)
//   p  = exp(s - lse)             (masked scores are -1e30, so p is 0)
//   dp = dO v^T
//   ds = p * (dp - delta + dlse) * scale
//   K2: dq = ds k                 K3: dv = p^T dO,  dk = ds^T q
//
// delta = rowsum(dO * O) and dlse (the cotangent of the lse output) come
// in as fp32 rows; every sum is taken in fp32 whatever the input type, and
// each output is cast to its input's type on the store.
//
// Design.  The TPU kernels walk one operand's blocks on a sequential grid
// axis and carry the accumulator in VMEM scratch.  CUDA blocks run in
// parallel and in no order, so here one block owns one output tile for its
// whole life and a loop inside the block walks the streamed operand:
//   K2: a block owns (b*h, 64 query rows); K/V tiles stream through shared
//       memory; dq accumulates in registers.
//   K3: a block owns (b*h, 64 key rows); Q/dO tiles and their lse, delta
//       and dlse rows stream through shared memory; dk and dv accumulate in
//       registers.
// This is the Pallas split: each output is written once, by one block, and
// no atomics are needed.  256 threads form a 16 x 16 grid; each thread owns
// a 4 x 4 piece of the 64 x 64 score tile and a 4 x D/16 piece of each
// accumulator, with rows and columns strided by 16 so that shared-memory
// reads are broadcasts or conflict-free (tile rows are padded by one
// float).  Shared memory holds four 64 x D fp32 tiles and one or two
// 64 x 64 tiles: up to 166 KB at D = 128, so it is dynamic shared memory,
// raised above the 48 KB default with cudaFuncSetAttribute.
//
// Causal tiles: K2 skips key tiles past its last query row; K3 starts at
// the first query tile that reaches its first key (the TPU kernels' skips
// at pallas_kernels.py:156 and :198, on this kernel's 64-row tiles).
// Inside a tile the mask is top-left aligned (key j > query i is masked),
// so Lq != Lk keeps the TPU kernels' row >= col rule.
//
// What bounds them on the H100.  Per (b, h), K2 does 6*Lq*Lk*D operations
// (s, dp, dq) and K3 8*Lq*Lk*D (s, dv, dp, dk) against 4*L*D elements read
// and 1-2*L*D written; at BERT's L = 512, D = 64 in fp32 that is well above
// the card's fp32 ridge (67 TFLOP/s over 3.35 TB/s, about 20 operations
// per byte), so both are bound by arithmetic.  They do that arithmetic as
// fp32 FMAs from shared memory, which keeps them exact to fp32 and simple;
// the products belong on the tensor cores (wgmma on bf16 tiles fed by TMA),
// which is later work.
//
// The C entry points launch on the caller's stream, allocate nothing, do
// not synchronise, and return cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BM = 64;   // rows of the owned tile
constexpr int BN = 64;   // rows of the streamed tile
constexpr int NT = 256;  // threads per block: a 16 x 16 grid
constexpr int SP = BN + 1;
constexpr float MASKED = -1e30f;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// rows [row0, row0 + 64) of a [rows, D] matrix into a padded fp32 tile;
// rows past the end read as zeros
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int rows) {
  constexpr int DP = D + 1;
  for (int e = threadIdx.x; e < BM * D; e += NT) {
    const int r = e / D, c = e % D;
    dst[r * DP + c] =
        (row0 + r < rows) ? load_f(src + (size_t)(row0 + r) * D + c) : 0.f;
  }
}

// shared memory, in floats
template <int D>
constexpr int dq_smem_floats() {
  return 4 * BM * (D + 1) + BM * SP + 2 * BM;
}
template <int D>
constexpr int dkv_smem_floats() {
  return 4 * BM * (D + 1) + 2 * BM * SP + 2 * BM;
}

// ---------------------------------------------------------------------------
// K2: dq for one (b*h, 64-query) tile, key/value tiles streamed
// ---------------------------------------------------------------------------
template <int D, typename T, bool CAUSAL>
__global__ void __launch_bounds__(NT)
flash_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ dlse, T* __restrict__ dq,
                         int lq, int lk, int n_qt, float scale) {
  constexpr int DP = D + 1;
  constexpr int TN = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + BM * DP;
  float* ks = dos + BM * DP;
  float* vs = ks + BM * DP;
  float* ss = vs + BM * DP;        // ds tile [query][key]
  float* lse_s = ss + BM * SP;     // per query row: lse
  float* c_s = lse_s + BM;         // per query row: dlse - delta

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * BM;
  const T* kb = k + (size_t)bh * lk * D;
  const T* vb = v + (size_t)bh * lk * D;

  load_tile<D>(qs, q + (size_t)bh * lq * D, q0, lq);
  load_tile<D>(dos, dout + (size_t)bh * lq * D, q0, lq);
  if (tid < BM) {
    const bool live = q0 + tid < lq;
    const size_t row = (size_t)bh * lq + q0 + tid;
    lse_s[tid] = live ? lse[row] : 0.f;
    c_s[tid] = live ? dlse[row] - delta[row] : 0.f;
  }

  float acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // causal: keys past this tile's last query row contribute nothing
  const int k_end = CAUSAL ? min(lk, min(q0 + BM, lq)) : lk;
  for (int k0 = 0; k0 < k_end; k0 += BN) {
    __syncthreads();  // the previous ds tile is consumed
    load_tile<D>(ks, kb, k0, lk);
    load_tile<D>(vs, vb, k0, lk);
    __syncthreads();

    // s = q k^T and dp = dO v^T for this tile, side by side
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], o[4], b[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qs[(i * 16 + ty) * DP + d];
        o[i] = dos[(i * 16 + ty) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = ks[(j * 16 + tx) * DP + d];
        w[j] = vs[(j * 16 + tx) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(o[i], w[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i * 16 + ty;
      const float l = lse_s[r], c = c_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = j * 16 + tx;
        float x = s[i][j] * scale;
        if (CAUSAL && k0 + col > q0 + r) x = MASKED;
        float p = expf(x - l);
        if (k0 + col >= lk || q0 + r >= lq) p = 0.f;
        ss[r * SP + col] = p * (dp[i][j] + c) * scale;
      }
    }
    __syncthreads();

    // dq += ds k
#pragma unroll 4
    for (int n = 0; n < BN; ++n) {
      float g[4], w[TN];
#pragma unroll
      for (int i = 0; i < 4; ++i) g[i] = ss[(i * 16 + ty) * SP + n];
#pragma unroll
      for (int j = 0; j < TN; ++j) w[j] = ks[n * DP + j * 16 + tx];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(g[i], w[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = i * 16 + ty;
    if (q0 + r < lq) {
      T* row = dq + ((size_t)bh * lq + q0 + r) * D;
#pragma unroll
      for (int j = 0; j < TN; ++j) store_f(row + j * 16 + tx, acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// K3: dk and dv for one (b*h, 64-key) tile, query/dO tiles streamed
// ---------------------------------------------------------------------------
template <int D, typename T, bool CAUSAL>
__global__ void __launch_bounds__(NT)
flash_attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const float* __restrict__ dlse, T* __restrict__ dk,
                          T* __restrict__ dv, int lq, int lk, int n_kt,
                          float scale) {
  constexpr int DP = D + 1;
  constexpr int TN = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + BM * DP;
  float* qs = vs + BM * DP;
  float* dos = qs + BM * DP;
  float* ps = dos + BM * DP;       // p tile [key][query]
  float* dss = ps + BM * SP;       // ds tile [key][query]
  float* lse_s = dss + BM * SP;    // per query row of the current tile
  float* c_s = lse_s + BN;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int bh = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x % n_kt) * BM;
  const T* qb = q + (size_t)bh * lq * D;
  const T* dob = dout + (size_t)bh * lq * D;
  const float* lse_b = lse + (size_t)bh * lq;
  const float* delta_b = delta + (size_t)bh * lq;
  const float* dlse_b = dlse + (size_t)bh * lq;

  load_tile<D>(ks, k + (size_t)bh * lk * D, k0, lk);
  load_tile<D>(vs, v + (size_t)bh * lk * D, k0, lk);

  float adk[4][TN], adv[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) adk[i][j] = adv[i][j] = 0.f;

  // causal: query tiles wholly before this tile's first key see none of it
  const int q_begin = CAUSAL ? (k0 / BN) * BN : 0;
  for (int q0 = q_begin; q0 < lq; q0 += BN) {
    __syncthreads();  // the previous p and ds tiles are consumed
    load_tile<D>(qs, qb, q0, lq);
    load_tile<D>(dos, dob, q0, lq);
    if (tid < BN) {
      const bool live = q0 + tid < lq;
      lse_s[tid] = live ? lse_b[q0 + tid] : 0.f;
      c_s[tid] = live ? dlse_b[q0 + tid] - delta_b[q0 + tid] : 0.f;
    }
    __syncthreads();

    // s^T = k q^T and dp^T = v dO^T: rows are keys, columns queries
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], w[4], b[4], o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = ks[(i * 16 + ty) * DP + d];
        w[i] = vs[(i * 16 + ty) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = qs[(j * 16 + tx) * DP + d];
        o[j] = dos[(j * 16 + tx) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(w[i], o[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = i * 16 + ty;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = j * 16 + tx;
        float x = s[i][j] * scale;
        if (CAUSAL && k0 + kr > q0 + qr) x = MASKED;
        float p = expf(x - lse_s[qr]);
        if (k0 + kr >= lk || q0 + qr >= lq) p = 0.f;
        ps[kr * SP + qr] = p;
        dss[kr * SP + qr] = p * (dp[i][j] + c_s[qr]) * scale;
      }
    }
    __syncthreads();

    // dv += p^T dO and dk += ds^T q
#pragma unroll 4
    for (int r = 0; r < BN; ++r) {
      float pk[4], gk[4], o[TN], x[TN];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pk[i] = ps[(i * 16 + ty) * SP + r];
        gk[i] = dss[(i * 16 + ty) * SP + r];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        o[j] = dos[r * DP + j * 16 + tx];
        x[j] = qs[r * DP + j * 16 + tx];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          adv[i][j] = fmaf(pk[i], o[j], adv[i][j]);
          adk[i][j] = fmaf(gk[i], x[j], adk[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = i * 16 + ty;
    if (k0 + r < lk) {
      const size_t off = ((size_t)bh * lk + k0 + r) * D;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        store_f(dk + off + j * 16 + tx, adk[i][j]);
        store_f(dv + off + j * 16 + tx, adv[i][j]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta, *dlse;
  void *out0, *out1;  // dq (K2), or dk and dv (K3)
  int bh, lq, lk;
  float scale;
  cudaStream_t stream;
};

template <int D, typename T, bool CAUSAL>
cudaError_t launch_dq(const Args& a) {
  auto kernel = flash_attn_bwd_dq_kernel<D, T, CAUSAL>;
  const int smem = dq_smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (a.lq + BM - 1) / BM;
  const long long blocks = (long long)a.bh * n_qt;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)blocks), NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.dlse, static_cast<T*>(a.out0), a.lq, a.lk, n_qt, a.scale);
  return cudaGetLastError();
}

template <int D, typename T, bool CAUSAL>
cudaError_t launch_dkv(const Args& a) {
  auto kernel = flash_attn_bwd_dkv_kernel<D, T, CAUSAL>;
  const int smem = dkv_smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_kt = (a.lk + BM - 1) / BM;
  const long long blocks = (long long)a.bh * n_kt;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)blocks), NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.dlse, static_cast<T*>(a.out0), static_cast<T*>(a.out1),
      a.lq, a.lk, n_kt, a.scale);
  return cudaGetLastError();
}

template <bool DKV, int D, typename T, bool CAUSAL>
cudaError_t launch(const Args& a) {
  if constexpr (DKV) {
    return launch_dkv<D, T, CAUSAL>(a);
  } else {
    return launch_dq<D, T, CAUSAL>(a);
  }
}

// one of the 16 instantiations (head dim x dtype x causal) of K2 or K3
template <bool DKV, typename T, bool CAUSAL>
cudaError_t dispatch_head_dim(int d, const Args& a) {
  switch (d) {
    case 16:
      return launch<DKV, 16, T, CAUSAL>(a);
    case 32:
      return launch<DKV, 32, T, CAUSAL>(a);
    case 64:
      return launch<DKV, 64, T, CAUSAL>(a);
    case 128:
      return launch<DKV, 128, T, CAUSAL>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool DKV>
int dispatch(int d, int dtype, int causal, const Args& a) {
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = causal ? dispatch_head_dim<DKV, float, true>(d, a)
                 : dispatch_head_dim<DKV, float, false>(d, a);
  } else if (dtype == 1) {
    err = causal ? dispatch_head_dim<DKV, __nv_bfloat16, true>(d, a)
                 : dispatch_head_dim<DKV, __nv_bfloat16, false>(d, a);
  }
  return static_cast<int>(err);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, dout, dq are [bh, lq, d]; k, v are
// [bh, lk, d]; lse, delta, dlse are fp32 [bh, lq].  Returns a cudaError_t.
extern "C" int mxtt_flash_attn_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      const void* dlse, void* dq, int bh,
                                      int lq, int lk, int d, int dtype,
                                      int causal, float scale, void* stream) {
  const Args a{q, k, v, dout,
               static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               static_cast<const float*>(dlse), dq, nullptr, bh, lq, lk,
               scale, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(d, dtype, causal, a);
}

// as mxtt_flash_attn_bwd_dq; dk and dv are [bh, lk, d]
extern "C" int mxtt_flash_attn_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       const void* dlse, void* dk, void* dv,
                                       int bh, int lq, int lk, int d,
                                       int dtype, int causal, float scale,
                                       void* stream) {
  const Args a{q, k, v, dout,
               static_cast<const float*>(lse),
               static_cast<const float*>(delta),
               static_cast<const float*>(dlse), dk, dv, bh, lq, lk, scale,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(d, dtype, causal, a);
}

extern "C" const char* mxtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
