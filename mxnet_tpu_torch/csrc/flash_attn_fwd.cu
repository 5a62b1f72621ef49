// K1: flash-attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces mxnet_tpu/ops/pallas_kernels.py:_attn_fwd_kernel (driven by
// _pallas_attention_fwd).  It computes what that kernel computes:
// online-softmax attention over contiguous [B, H, L, D] inputs flattened
// to [B*H, L, D], with the running (acc, m, l) state in fp32, masked
// scores set to -1e30, key tiles above the causal diagonal skipped
// (top-left aligned, so Lq != Lk keeps the TPU kernel's row >= col rule),
// l clamped at 1e-30, and two outputs: O in the input dtype and
// lse = m + log(l) in fp32.
//
// Split.  The TPU kernel walks K/V blocks on a sequential grid axis and
// carries its state in VMEM scratch from one grid step to the next.  CUDA
// blocks run in parallel and in no order, so one block owns one (b*h, 64
// query rows) tile for its whole life and a loop inside the block walks
// the key tiles.  Scores never leave the SM: device memory sees Q, K and V
// read once per query tile and O and lse written once.
//
// What bounds it on the H100.  Per (b, h) the work is 4*Lq*Lk*D operations
// (s = q k^T and p v) against (2*Lq + 2*Lk)*D elements moved; at BERT's
// L = 512, D = 64 that is far above the card's ridge, so it is bound by
// the product rate.  Both products run on the tensor cores
// (hopper_mma.cuh): mma.sync m16n8k8 in three TF32 passes over split
// operands for fp32 inputs, which keeps fp32-level accuracy at up to 495/3
// TFLOP/s, and m16n8k16 bf16 for bf16 inputs.
//
// Design, as K2's dq kernel (flash_attn_bwd.cu), which does most of this
// work too.  Each block is four warps and each warp owns 16 query rows,
// so its scores, its row max and sum, and its 16 x D output accumulator
// stay in registers:
//   * Q.  The tile is read once.  In fp32 it is multiplied by the scale
//     before the product, as the TPU kernel scales q, and split into its
//     TF32 big and small parts once for the block, not once per key tile;
//     the fragments stay in registers, except at D = 128, where they would
//     crowd out the accumulator and are read again from shared memory for
//     each key tile.  In bf16 the product is exact in fp32 and the scale is
//     applied to s after it (rounding q * scale to bf16 would add an error).
//   * K and V stream through a two-stage cp.async ring (64-row tiles, 32
//     at D = 128) with rows padded by 16 bytes; each warp splits the
//     fragments it loads in registers, as K2 does.
//   * s = q k^T by mma.sync; the causal mask (-1e30) and keys past lk
//     (-inf) are applied in registers.  Lanes 4g..4g+3 hold rows g and g+8
//     of the warp's 16, so a row's max takes two quad shuffles; each lane
//     keeps its own part of the row sum, added up once at the end.
//   * acc = alpha * acc + p v, with p's accumulator taken as the A operand
//     of the product (k permuted inside each 8-wide chunk in fp32, V loaded
//     to match; in bf16 p is rounded to bf16, as FlashAttention-2 does).
//     In fp32 every SUM_CHUNKS 8-key chunks of p v are summed in an
//     accumulator of their own and added to acc in fp32: the tensor cores
//     truncate as they accumulate, and an O summed inside them over the
//     whole sequence drifts toward zero, which the training step's
//     gradients showed (PERF.md).
// Rows past a ragged end load as zeros and are not stored.
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper_mma.cuh"

namespace {

using hmma::bf16;

constexpr int BM = 64;  // query rows of a block: 16 per warp
constexpr int NW = 4;   // warps per block
constexpr int NT = 32 * NW;
constexpr float MASKED = -1e30f;
// fp32: 8-key chunks of p v summed in the tensor cores before each fp32
// add into O (see the acc = alpha acc + p v step).  On the H100, 4 kept the
// training gradients as close to the unfused graph's as 1 did, without
// 1's and 2's register spills, and 8 let them drift (PERF.md).
constexpr int SUM_CHUNKS = 4;

// rows of a streamed K/V tile
template <int D>
__host__ __device__ constexpr int key_rows() {
  return D <= 64 ? 64 : 32;
}

// whether Q's fragments stay in registers for the whole block: fp32 at
// D = 128 would hold 128 registers of them beside a 64-register accumulator
template <int D, typename T>
__host__ __device__ constexpr bool q_in_registers() {
  return sizeof(T) == 2 || D <= 64;
}

// shared memory: the Q tile (fp32: its big parts, then its small parts)
// and two stages of the K and V tiles
template <int D, typename T>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int ST = D + hmma::row_pad<T>();
  constexpr int q_tiles = sizeof(T) == 4 ? 2 : 1;
  return (q_tiles * BM + 4 * key_rows<D>()) * ST * (int)sizeof(T);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// the fp32 Q tile in place: x * scale split into its big part (kept in
// qs) and its small part (written to qlo)
template <int D>
__device__ __forceinline__ void scale_and_split_q(float* qs, float* qlo,
                                                  float scale) {
  constexpr int ST = D + hmma::row_pad<float>();
  for (int e = threadIdx.x; e < BM * D; e += NT) {
    const int i = (e / D) * ST + e % D;
    uint32_t hi, lo;
    hmma::split(qs[i] * scale, hi, lo);
    qs[i] = __uint_as_float(hi);
    qlo[i] = __uint_as_float(lo);
  }
}

template <int D, typename T, bool CAUSAL>
__global__ void __launch_bounds__(NT, 2)
flash_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, int lq, int lk, int n_qt,
                      float scale) {
  using A = typename hmma::Frag<T>::A;
  using B = typename hmma::Frag<T>::B;
  constexpr bool FP32 = sizeof(T) == 4;
  constexpr bool Q_REGS = q_in_registers<D, T>();
  constexpr int KS = hmma::Frag<T>::K;
  constexpr int BN = key_rows<D>();
  constexpr int ST = D + hmma::row_pad<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ring = qs + (FP32 ? 2 : 1) * BM * ST;  // stage i: K at 2*i*BN*ST, V

  const int warp = threadIdx.x / 32;
  const int g = hmma::lane_g(), t = hmma::lane_t();
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * BM;
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  const T* kb = k + (size_t)bh * lk * D;
  const T* vb = v + (size_t)bh * lk * D;
  // causal: keys past this tile's last query row contribute nothing
  const int k_end = CAUSAL ? min(lk, min(q0 + BM, lq)) : lk;
  const int n_kt = (k_end + BN - 1) / BN;

  // Q and the first two key tiles in flight: groups 0 and 1
  hmma::load_tile_async<BM, D, NT>(qs, q + (size_t)bh * lq * D, q0, lq);
  if (n_kt > 0) {
    hmma::load_tile_async<BN, D, NT>(ring, kb, 0, lk);
    hmma::load_tile_async<BN, D, NT>(ring + BN * ST, vb, 0, lk);
  }
  hmma::cp_async_commit();
  if (n_kt > 1) {
    hmma::load_tile_async<BN, D, NT>(ring + 2 * BN * ST, kb, BN, lk);
    hmma::load_tile_async<BN, D, NT>(ring + 3 * BN * ST, vb, BN, lk);
  }
  hmma::cp_async_commit();
  hmma::cp_async_wait<1>();
  __syncthreads();

  // Q's A fragments: fp32 scaled and split once, in place
  float* qlo = nullptr;
  if constexpr (FP32) {
    qlo = reinterpret_cast<float*>(qs) + BM * ST;
    scale_and_split_q<D>(reinterpret_cast<float*>(qs), qlo, scale);
    __syncthreads();
  }
  A qf[Q_REGS ? D / KS : 1];
  auto q_frag = [&](A& a, int kk) {
    if constexpr (FP32) {
      hmma::load_a(a, reinterpret_cast<const float*>(qs), qlo, ST,
                   warp * 16, kk);
    } else {
      hmma::load_a(a, qs, ST, warp * 16, kk);
    }
  };
  if constexpr (Q_REGS) {
#pragma unroll
    for (int kk = 0; kk < D; kk += KS) q_frag(qf[kk / KS], kk);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // per row h of this lane's two: the running max and this lane's share
  // of the running sum
  float m_row[2] = {MASKED, MASKED}, l_row[2] = {0.f, 0.f};

  for (int it = 0; it < n_kt; ++it) {
    const int k0 = it * BN;
    hmma::cp_async_wait<1>();
    __syncthreads();
    const T* ks = ring + (it & 1) * 2 * BN * ST;
    const T* vs = ks + BN * ST;

    // s = (scale q) k^T for this warp's 16 rows
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    auto qk_chunk = [&](const A& aq, int kk) {
#pragma unroll
      for (int j = 0; j < BN / 8; j += 2) {
        B bk0, bk1;
        hmma::load_bt2(bk0, bk1, ks, ST, j * 8, kk);
        hmma::mma(s[j], aq, bk0);
        hmma::mma(s[j + 1], aq, bk1);
      }
    };
#pragma unroll
    for (int kk = 0; kk < D; kk += KS) {
      if constexpr (Q_REGS) {
        qk_chunk(qf[kk / KS], kk);
      } else {
        A aq;
        q_frag(aq, kk);
        qk_chunk(aq, kk);
      }
    }

    // masks and the tile's row max
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (e >> 1);
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        float x = FP32 ? s[j][e] : s[j][e] * scale;
        if (CAUSAL && col > row) x = MASKED;
        if (col >= lk) x = -INFINITY;  // past the last key: weight 0
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_row[h], mx[h]);
      alpha[h] = expf(m_row[h] - m_new);
      m_row[h] = m_new;
    }

    // p in place of s; l = alpha l + rowsum(p)
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m_row[e >> 1]);
        s[j][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_row[h] = l_row[h] * alpha[h] + sum[h];

    // acc = alpha acc + p v.  In fp32 every SUM_CHUNKS chunks of p v are
    // summed alone (started by hmma::mma_alone) and added in fp32, so that
    // O carries no drift toward zero: the backward's delta = rowsum(dO * O)
    // must match its own sum of p * dp.  In bf16 acc accumulates in place.
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    if constexpr (FP32) {
      float pv[D / 8][4];
#pragma unroll
      for (int kc = 0; kc < BN / KS; ++kc) {
        A a;
        hmma::a_from_c(a, s, kc);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          B b;
          hmma::load_b(b, vs, ST, kc * KS, n * 8);
          if (kc % SUM_CHUNKS == 0) {
            hmma::mma_alone(pv[n], a, b);
          } else {
            hmma::mma(pv[n], a, b);
          }
          if (kc % SUM_CHUNKS == SUM_CHUNKS - 1) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][e] += pv[n][e];
          }
        }
      }
    } else {
#pragma unroll
      for (int kc = 0; kc < BN / KS; ++kc) {
        A a;
        hmma::a_from_c(a, s, kc);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          B b;
          hmma::load_b(b, vs, ST, kc * KS, n * 8);
          hmma::mma(acc[n], a, b);
        }
      }
    }
    __syncthreads();  // this stage is free for the tile after next
    if (it + 2 < n_kt) {
      T* nxt = ring + (it & 1) * 2 * BN * ST;
      hmma::load_tile_async<BN, D, NT>(nxt, kb, k0 + 2 * BN, lk);
      hmma::load_tile_async<BN, D, NT>(nxt + BN * ST, vb, k0 + 2 * BN, lk);
    }
    hmma::cp_async_commit();
  }
  hmma::cp_async_wait<0>();

  // O = acc / l and lse = m + log(l), l the quad's sum of its lanes' shares
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_row[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    const int r = row0 + 8 * h;
    if (r < lq) {
      T* orow = o + ((size_t)bh * lq + r) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        store2(orow + n * 8 + 2 * t, acc[n][2 * h] / l,
               acc[n][2 * h + 1] / l);
      if (t == 0) lse[(size_t)bh * lq + r] = m_row[h] + logf(l);
    }
  }
}

template <int D, typename T, bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int lq, int lk, float scale,
                   cudaStream_t stream) {
  auto kernel = flash_attn_fwd_kernel<D, T, CAUSAL>;
  constexpr int smem = smem_bytes<D, T>();
  // the shared-memory limit is raised once per device: at BERT's seq 128
  // the call's host time is the kernel's time
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64 || !raised[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev >= 0 && dev < 64) raised[dev] = true;
  }
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

// dtype: 0 = float32, 1 = bfloat16.  q and o are [bh, lq, d], k and v
// [bh, lk, d], lse fp32 [bh, lq]; q, k and v must be 16-byte aligned
// (cp.async).  Returns a cudaError_t value.
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
    err = causal ? dispatch_head_dim<bf16, true>(d, q, k, v, o, lse, bh, lq,
                                                 lk, scale, s)
                 : dispatch_head_dim<bf16, false>(d, q, k, v, o, lse, bh, lq,
                                                  lk, scale, s);
  }
  return static_cast<int>(err);
}

extern "C" const char* mxtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
