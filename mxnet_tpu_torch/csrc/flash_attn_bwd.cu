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
// Split.  The TPU kernels walk one operand's blocks on a sequential grid
// axis and carry the accumulator in VMEM scratch.  CUDA blocks run in
// parallel and in no order, so one block owns one output tile for its
// whole life and a loop inside the block walks the streamed operand:
//   K2: a block owns (b*h, 64 query rows); K/V tiles stream in; dq
//       accumulates in registers and is written once.
//   K3: a block owns (b*h, 64 key rows); Q/dO tiles and their lse, delta
//       and dlse rows stream in; dk and dv accumulate in registers and are
//       written once.
// No atomics, so the gradients are deterministic.  Causal tiles: K2 skips
// key tiles past its last query row; K3 starts at the first query tile
// that reaches its first key (the TPU kernels' skips at
// pallas_kernels.py:156 and :198).  Inside a tile the mask is top-left
// aligned (key j > query i is masked), so Lq != Lk keeps the TPU kernels'
// row >= col rule; rows past a ragged end load as zeros and get p = 0.
//
// What bounds them on the H100.  Per (b, h), K2 does 6*Lq*Lk*D operations
// (s, dp, dq) and K3 8*Lq*Lk*D (s, dv, dp, dk) against 4*L*D elements read
// and 1-2*L*D written; at BERT's L = 512, D = 64 that is well above the
// card's ridge, so both are bound by the product rate.  The design puts
// every product on the tensor cores (hopper_mma.cuh): mma.sync m16n8k8 in
// three TF32 passes for fp32 inputs, which keeps fp32-level accuracy at up
// to 495/3 TFLOP/s, and m16n8k16 bf16 for bf16 inputs.  In bf16, s and dp
// are exact products of bf16 values summed in fp32, and p and ds are
// rounded to bf16 before they feed dv, dk and dq, as FlashAttention does:
// one rounding of a value in [0, 1] or of a gradient term, 2^-9 relative,
// well inside the 2e-2 (of the largest magnitude) that bf16 is held to.
//
// Each block is four warps; each warp owns 16 rows of the block's tile,
// so its s, dp, p and ds stay in registers, and the accumulator layout is
// reused as the A operand of the next product (see hopper_mma.cuh).
// Fragments of row-major operands come by ldmatrix, four registers an
// instruction; the transposed B operands of dq, dv and dk by scalar
// loads.  In fp32 every fragment is split into its TF32 parts in
// registers as it is loaded.  The streamed tiles arrive by cp.async in a
// two-stage shared-memory ring: the next tile copies in while this one
// computes.  Streamed tiles are 64 rows
// for D <= 64 and 32 at D = 128, which keeps K3's dk and dv accumulators
// (2 * 16 * D floats a warp) and its scores in registers.  Shared memory
// is above 48 KB for fp32 at D >= 64, so it is dynamic shared memory,
// raised with cudaFuncSetAttribute.
//
// The C entry points launch on the caller's stream, allocate nothing, do
// not synchronise, and return cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper_mma.cuh"

namespace {

using hmma::bf16;

constexpr int BM = 64;      // rows of the owned tile: 16 per warp
constexpr int NW = 4;       // warps per block
constexpr int NT = 32 * NW;
// Both kernels declare one block an SM as their minimum: with no minimum,
// ptxas capped some instantiations at 96 or 128 registers and spilled.
constexpr float MASKED = -1e30f;

// rows of a streamed tile
template <int D>
__host__ __device__ constexpr int stream_rows() {
  return D <= 64 ? 64 : 32;
}

// shared memory: the owned pair of tiles, two stages of the streamed pair,
// and (K3) two stages of the streamed lse, delta and dlse rows
template <int D, typename T, bool DKV>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int ST = D + hmma::row_pad<T>();
  return (2 * BM + 4 * stream_rows<D>()) * ST * (int)sizeof(T) +
         (DKV ? 2 * 3 * stream_rows<D>() * (int)sizeof(float) : 0);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// write a warp's 16 x D accumulator (rows r0.. of a [rows, D] output)
template <int D, typename T>
__device__ __forceinline__ void store_rows(T* out, const float (&acc)[D / 8][4],
                                           int r0, int rows) {
  const int g = hmma::lane_g(), t = hmma::lane_t();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + g + 8 * h;
    if (r < rows) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        store2(out + (size_t)r * D + n * 8 + 2 * t, acc[n][2 * h],
               acc[n][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// K2: dq for one (b*h, 64-query) tile, key/value tiles streamed
// ---------------------------------------------------------------------------
template <int D, typename T, bool CAUSAL>
__global__ void __launch_bounds__(NT, 1)
flash_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ dlse, T* __restrict__ dq,
                         int lq, int lk, int n_qt, float scale) {
  using A = typename hmma::Frag<T>::A;
  using B = typename hmma::Frag<T>::B;
  constexpr int KS = hmma::Frag<T>::K;
  constexpr int BN = stream_rows<D>();
  constexpr int ST = D + hmma::row_pad<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = qs + BM * ST;
  T* ring = dos + BM * ST;  // stage i: K at ring + 2*i*BN*ST, then V

  const int warp = threadIdx.x / 32;
  const int g = hmma::lane_g(), t = hmma::lane_t();
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * BM;
  const T* kb = k + (size_t)bh * lk * D;
  const T* vb = v + (size_t)bh * lk * D;
  // causal: keys past this tile's last query row contribute nothing
  const int k_end = CAUSAL ? min(lk, min(q0 + BM, lq)) : lk;
  const int n_kt = (k_end + BN - 1) / BN;

  hmma::load_tile_async<BM, D, NT>(qs, q + (size_t)bh * lq * D, q0, lq);
  hmma::load_tile_async<BM, D, NT>(dos, dout + (size_t)bh * lq * D, q0, lq);
  if (n_kt > 0) {
    hmma::load_tile_async<BN, D, NT>(ring, kb, 0, lk);
    hmma::load_tile_async<BN, D, NT>(ring + BN * ST, vb, 0, lk);
  }
  hmma::cp_async_commit();

  // this lane's two query rows: lse and dlse - delta
  float l_row[2], c_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + warp * 16 + g + 8 * h;
    const size_t i = (size_t)bh * lq + r;
    l_row[h] = r < lq ? lse[i] : 0.f;
    c_row[h] = r < lq ? dlse[i] - delta[i] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0; it < n_kt; ++it) {
    const int k0 = it * BN;
    if (it + 1 < n_kt) {
      T* nxt = ring + ((it + 1) & 1) * 2 * BN * ST;
      hmma::load_tile_async<BN, D, NT>(nxt, kb, k0 + BN, lk);
      hmma::load_tile_async<BN, D, NT>(nxt + BN * ST, vb, k0 + BN, lk);
    }
    hmma::cp_async_commit();
    hmma::cp_async_wait<1>();
    __syncthreads();
    const T* ks = ring + (it & 1) * 2 * BN * ST;
    const T* vs = ks + BN * ST;

    // s = q k^T and dp = dO v^T for this warp's 16 rows
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += KS) {
      A aq, ado;
      hmma::load_a(aq, qs, ST, warp * 16, kk);
      hmma::load_a(ado, dos, ST, warp * 16, kk);
#pragma unroll
      for (int j = 0; j < BN / 8; j += 2) {
        B bk0, bk1, bv0, bv1;
        hmma::load_bt2(bk0, bk1, ks, ST, j * 8, kk);
        hmma::load_bt2(bv0, bv1, vs, ST, j * 8, kk);
        hmma::mma(s[j], aq, bk0);
        hmma::mma(dp[j], ado, bv0);
        hmma::mma(s[j + 1], aq, bk1);
        hmma::mma(dp[j + 1], ado, bv1);
      }
    }

    // ds, in place of s
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = warp * 16 + g + 8 * (e >> 1);
        const int col = j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * scale;
        if (CAUSAL && k0 + col > q0 + row) x = MASKED;
        float p = expf(x - l_row[e >> 1]);
        if (k0 + col >= lk || q0 + row >= lq) p = 0.f;
        s[j][e] = p * (dp[j][e] + c_row[e >> 1]) * scale;
      }

    // dq += ds k
#pragma unroll
    for (int kc = 0; kc < BN / KS; ++kc) {
      A a;
      hmma::a_from_c(a, s, kc);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        B b;
        hmma::load_b(b, ks, ST, kc * KS, n * 8);
        hmma::mma(acc[n], a, b);
      }
    }
    __syncthreads();  // this stage is free for the tile after next
  }
  hmma::cp_async_wait<0>();

  store_rows<D>(dq + (size_t)bh * lq * D, acc, q0 + warp * 16, lq);
}

// ---------------------------------------------------------------------------
// K3: dk and dv for one (b*h, 64-key) tile, query/dO tiles streamed
// ---------------------------------------------------------------------------
template <int D, typename T, bool CAUSAL>
__global__ void __launch_bounds__(NT, 1)
flash_attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const float* __restrict__ dlse, T* __restrict__ dk,
                          T* __restrict__ dv, int lq, int lk, int n_kt,
                          float scale) {
  using A = typename hmma::Frag<T>::A;
  using B = typename hmma::Frag<T>::B;
  constexpr int KS = hmma::Frag<T>::K;
  constexpr int BN = stream_rows<D>();
  constexpr int ST = D + hmma::row_pad<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + BM * ST;
  T* ring = vs + BM * ST;  // stage i: Q at ring + 2*i*BN*ST, then dO
  // stage i: lse, delta, dlse rows at rows + 3*i*BN
  float* rows = reinterpret_cast<float*>(ring + 4 * BN * ST);

  const int warp = threadIdx.x / 32;
  const int g = hmma::lane_g(), t = hmma::lane_t();
  const int bh = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x % n_kt) * BM;
  const T* qb = q + (size_t)bh * lq * D;
  const T* dob = dout + (size_t)bh * lq * D;
  // causal: query tiles wholly before this tile's first key see none of it
  const int q_begin = CAUSAL ? (k0 / BN) * BN : 0;
  const int n_it = q_begin < lq ? (lq - q_begin + BN - 1) / BN : 0;

  auto load_stage = [&](int stage, int qt0) {
    T* dst = ring + stage * 2 * BN * ST;
    hmma::load_tile_async<BN, D, NT>(dst, qb, qt0, lq);
    hmma::load_tile_async<BN, D, NT>(dst + BN * ST, dob, qt0, lq);
    float* rdst = rows + stage * 3 * BN;
    for (int e = threadIdx.x; e < 3 * BN; e += NT) {
      const int a = e / BN, r = e % BN;
      const bool valid = qt0 + r < lq;
      const float* src = a == 0 ? lse : a == 1 ? delta : dlse;
      hmma::cp_async4(rdst + e, src + (size_t)bh * lq + (valid ? qt0 + r : 0),
                      valid);
    }
  };

  hmma::load_tile_async<BM, D, NT>(ks, k + (size_t)bh * lk * D, k0, lk);
  hmma::load_tile_async<BM, D, NT>(vs, v + (size_t)bh * lk * D, k0, lk);
  if (n_it > 0) load_stage(0, q_begin);
  hmma::cp_async_commit();

  float adk[D / 8][4], adv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int q0 = q_begin + it * BN;
    if (it + 1 < n_it) load_stage((it + 1) & 1, q0 + BN);
    hmma::cp_async_commit();
    hmma::cp_async_wait<1>();
    __syncthreads();
    const T* qs = ring + (it & 1) * 2 * BN * ST;
    const T* dos = qs + BN * ST;
    const float* lse_s = rows + (it & 1) * 3 * BN;
    const float* delta_s = lse_s + BN;
    const float* dlse_s = delta_s + BN;

    // s^T = k q^T and dp^T = v dO^T: rows are this warp's 16 keys,
    // columns the tile's queries
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += KS) {
      A ak, av;
      hmma::load_a(ak, ks, ST, warp * 16, kk);
      hmma::load_a(av, vs, ST, warp * 16, kk);
#pragma unroll
      for (int j = 0; j < BN / 8; j += 2) {
        B bq0, bq1, bdo0, bdo1;
        hmma::load_bt2(bq0, bq1, qs, ST, j * 8, kk);
        hmma::load_bt2(bdo0, bdo1, dos, ST, j * 8, kk);
        hmma::mma(s[j], ak, bq0);
        hmma::mma(dp[j], av, bdo0);
        hmma::mma(s[j + 1], ak, bq1);
        hmma::mma(dp[j + 1], av, bdo1);
      }
    }

    // p^T in place of s^T, ds^T in place of dp^T
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kr = warp * 16 + g + 8 * (e >> 1);
        const int qc = j * 8 + 2 * t + (e & 1);
        float x = s[j][e] * scale;
        if (CAUSAL && k0 + kr > q0 + qc) x = MASKED;
        float p = expf(x - lse_s[qc]);
        if (k0 + kr >= lk || q0 + qc >= lq) p = 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] + (dlse_s[qc] - delta_s[qc])) * scale;
      }

    // dv += p^T dO and dk += ds^T q
#pragma unroll
    for (int kc = 0; kc < BN / KS; ++kc) {
      A ap, ads;
      hmma::a_from_c(ap, s, kc);
      hmma::a_from_c(ads, dp, kc);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        B bdo, bq;
        hmma::load_b(bdo, dos, ST, kc * KS, n * 8);
        hmma::load_b(bq, qs, ST, kc * KS, n * 8);
        hmma::mma(adv[n], ap, bdo);
        hmma::mma(adk[n], ads, bq);
      }
    }
    __syncthreads();  // this stage is free for the tile after next
  }
  hmma::cp_async_wait<0>();

  const size_t off = (size_t)bh * lk * D;
  store_rows<D>(dk + off, adk, k0 + warp * 16, lk);
  store_rows<D>(dv + off, adv, k0 + warp * 16, lk);
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
  constexpr int smem = smem_bytes<D, T, false>();
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
  constexpr int smem = smem_bytes<D, T, true>();
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
    err = causal ? dispatch_head_dim<DKV, bf16, true>(d, a)
                 : dispatch_head_dim<DKV, bf16, false>(d, a);
  }
  return static_cast<int>(err);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, dout, dq are [bh, lq, d]; k, v are
// [bh, lk, d]; lse, delta, dlse are fp32 [bh, lq].  q, k, v, dout and the
// outputs must be 16-byte aligned (cp.async).  Returns a cudaError_t.
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
