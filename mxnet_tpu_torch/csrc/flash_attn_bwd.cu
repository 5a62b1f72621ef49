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
// card's ridge, so both are bound by the product rate.  Each input type
// has kernels of its own:
//   * fp32: mma.sync m16n8k8 in three TF32 passes (hopper_mma.cuh), which
//     keeps fp32-level accuracy at up to 495/3 TFLOP/s.
//   * bf16: the products run at 989 TFLOP/s, which mma.sync does not reach
//     on Hopper, so these kernels run on wgmma fed by TMA through an
//     mbarrier ring (hopper_wgmma.cuh), as K1's bf16 kernel does.  s and dp
//     are exact products of bf16 values summed in fp32, and p and ds are
//     rounded to bf16 before they feed dv, dk and dq, as FlashAttention
//     does: one rounding of a value in [0, 1] or of a gradient term, 2^-9
//     relative, well inside the 2e-2 (of the largest magnitude) that bf16
//     is held to.
//
// fp32 design.  Each block is four warps; each warp owns 16 rows of the
// block's tile, so its s, dp, p and ds stay in registers, and the
// accumulator layout is reused as the A operand of the next product (see
// hopper_mma.cuh).  Fragments of row-major operands come by ldmatrix, four
// registers an instruction; the transposed B operands of dq, dv and dk by
// scalar loads; every fragment is split into its TF32 parts in registers
// as it is loaded.  The streamed tiles arrive by cp.async in a two-stage
// shared-memory ring: the next tile copies in while this one computes.
// Streamed tiles are 64 rows for D <= 64 and 32 at D = 128, which keeps
// K3's dk and dv accumulators (2 * 16 * D floats a warp) and its scores in
// registers.  Shared memory is above 48 KB at D >= 64, so it is dynamic
// shared memory, raised with cudaFuncSetAttribute.
//
// bf16 design.  A block is one consumer warpgroup (4 warps, 64 owned rows:
// one wgmma's M) and one producer warp, K1's layout:
//   * The producer's lane 0 loads the owned pair of tiles once (K2: Q and
//     dO; K3: K and V) and then streams the other pair (K2: the K and V
//     tiles of 64 keys; K3: the Q and dO tiles of a query tile, with that
//     tile's lse, delta and dlse rows) by TMA into a WG_STAGES-deep ring,
//     each stage with a full barrier (the producer's arrival and the
//     bytes) and an empty one (the consumers' 128 arrivals).  The tensor
//     maps are built on the host for each call and passed by value, so a
//     CUDA graph keeps them.  Tiles are rank 3, [b*h][L][D], so a box past
//     one (b, h)'s last row arrives as TMA's zeros; tiles lie as TMA
//     swizzles them (128-byte rows at D = 64, two 64-column blocks of
//     128-byte rows at D = 128, 64- and 32-byte rows at D = 32 and 16).
//   * Scores: K2's s = q k^T and dp = dO v^T, K3's s^T = k q^T and
//     dp^T = v dO^T, each D / 16 wgmma products with both operands in
//     shared memory, both K-major.  The accumulator gives each warp 16 rows
//     in mma.sync's quad layout.
//   * p = exp2(fma(s, c, -lse * log2e)) with c = scale * log2e: no row max
//     is taken, so the fold holds for any sign of the scale.  Masked
//     entries take -1e30 * log2e - lse * log2e before the exponent (the
//     TPU kernels' -1e30), and entries past the last key (K2) or query
//     (K3) get p = 0.  Then ds / scale = p * (dp - delta + dlse): the
//     scale multiplies dq and dk once, on the store, not every element
//     (at D = 16 and 64 it is a power of two, so the bits are the same).
//     K2 keeps each row's lse and dlse - delta in registers; K3 reads
//     each query's from the stage's rows, two at a time.
//   * p and ds / scale are rounded to bf16 into the register A operand of
//     the accumulating products (two neighbouring 8-wide chunks make one
//     16-deep fragment), and the tile that fed the scores is their B
//     operand, read MN-major with the transpose bit: K2's dq += ds k reads
//     the K tile, K3's dv += p^T dO and dk += ds^T q the dO and Q tiles.
//     At D = 128 each column block is one N = 64 product.  No scalar loads.
//   * The warpgroup runs the scores, the elementwise step and the
//     accumulating products of a tile in turn and frees the stage; the
//     elementwise step of one block overlaps the products of the other
//     blocks on the SM.  Inside K2's warpgroup p is taken while dp's
//     products run (two commit groups; 3 % faster on the H100).  K3 keeps
//     the plain order: the same split, with dv's products issued before ds
//     is taken, made ptxas serialize its wgmma at D = 64, and it ran
//     10-25 % slower (PERF.md).
//   * Sizes.  K2 streams 64-key tiles (one wgmma's N) at every head dim and
//     asks for K1's blocks an SM (3 at D <= 64, 2 at D = 128).  K3 streams
//     64-query tiles at D <= 64 and 32-query tiles at D = 128, where dk and
//     dv alone take 128 registers a thread; it asks for 2 blocks an SM at
//     D <= 64 and 1 at D = 128 (dk, dv, s^T, dp^T and the fragments).
//     Shared memory: WgBwdSmem, checked against the blocks an SM by
//     tests/test_torch_k23_wgmma.py.
//
// The C entry points launch on the caller's stream, allocate nothing, do
// not synchronise, and return cudaGetLastError() after the launch (or the
// CUDA driver API's CUresult when a tensor map cannot be encoded).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper_host.cuh"
#include "hopper_mma.cuh"
#include "hopper_wgmma.cuh"

namespace {

using hmma::bf16;

constexpr int BM = 64;      // rows of the owned tile: 16 per warp
constexpr int NW = 4;       // warps per block
constexpr int NT = 32 * NW;
// Both fp32 kernels declare one block an SM as their minimum: with no
// minimum, ptxas capped some instantiations at 96 or 128 registers and
// spilled.
constexpr float MASKED = -1e30f;

// rows of a streamed tile
template <int D>
__host__ __device__ constexpr int stream_rows() {
  return D <= 64 ? 64 : 32;
}

// shared memory: the owned pair of tiles, two stages of the streamed pair,
// and (K3) two stages of the streamed lse, delta and dlse rows
template <int D, bool DKV>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int ST = D + hmma::row_pad<float>();
  return (2 * BM + 4 * stream_rows<D>()) * ST * (int)sizeof(float) +
         (DKV ? 2 * 3 * stream_rows<D>() * (int)sizeof(float) : 0);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// write a warp's 16 x D accumulator (rows r0.. of a [rows, D] output)
template <int D>
__device__ __forceinline__ void store_rows(float* out,
                                           const float (&acc)[D / 8][4],
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
// fp32 K2: dq for one (b*h, 64-query) tile, key/value tiles streamed
// ---------------------------------------------------------------------------
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NT, 1)
flash_attn_bwd_dq_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ dlse,
                         float* __restrict__ dq, int lq, int lk, int n_qt,
                         float scale) {
  using A = hmma::FragA32;
  using B = hmma::FragB32;
  constexpr int KS = hmma::Frag<float>::K;
  constexpr int BN = stream_rows<D>();
  constexpr int ST = D + hmma::row_pad<float>();
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = qs + BM * ST;
  float* ring = dos + BM * ST;  // stage i: K at ring + 2*i*BN*ST, then V

  const int warp = threadIdx.x / 32;
  const int g = hmma::lane_g(), t = hmma::lane_t();
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * BM;
  const float* kb = k + (size_t)bh * lk * D;
  const float* vb = v + (size_t)bh * lk * D;
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
      float* nxt = ring + ((it + 1) & 1) * 2 * BN * ST;
      hmma::load_tile_async<BN, D, NT>(nxt, kb, k0 + BN, lk);
      hmma::load_tile_async<BN, D, NT>(nxt + BN * ST, vb, k0 + BN, lk);
    }
    hmma::cp_async_commit();
    hmma::cp_async_wait<1>();
    __syncthreads();
    const float* ks = ring + (it & 1) * 2 * BN * ST;
    const float* vs = ks + BN * ST;

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
// fp32 K3: dk and dv for one (b*h, 64-key) tile, query/dO tiles streamed
// ---------------------------------------------------------------------------
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NT, 1)
flash_attn_bwd_dkv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const float* __restrict__ dlse,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int lq, int lk, int n_kt, float scale) {
  using A = hmma::FragA32;
  using B = hmma::FragB32;
  constexpr int KS = hmma::Frag<float>::K;
  constexpr int BN = stream_rows<D>();
  constexpr int ST = D + hmma::row_pad<float>();
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + BM * ST;
  float* ring = vs + BM * ST;  // stage i: Q at ring + 2*i*BN*ST, then dO
  // stage i: lse, delta, dlse rows at rows + 3*i*BN
  float* rows = ring + 4 * BN * ST;

  const int warp = threadIdx.x / 32;
  const int g = hmma::lane_g(), t = hmma::lane_t();
  const int bh = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x % n_kt) * BM;
  const float* qb = q + (size_t)bh * lq * D;
  const float* dob = dout + (size_t)bh * lq * D;
  // causal: query tiles wholly before this tile's first key see none of it
  const int q_begin = CAUSAL ? (k0 / BN) * BN : 0;
  const int n_it = q_begin < lq ? (lq - q_begin + BN - 1) / BN : 0;

  auto load_stage = [&](int stage, int qt0) {
    float* dst = ring + stage * 2 * BN * ST;
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
    const float* qs = ring + (it & 1) * 2 * BN * ST;
    const float* dos = qs + BN * ST;
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

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA through an mbarrier ring
// ---------------------------------------------------------------------------

constexpr int WG_BM = 64;          // owned rows of a block: one wgmma's M
constexpr int WG_KEYS = 64;        // K2's streamed key tile: one wgmma's N
constexpr int WG_STAGES = 2;       // stages in the ring
constexpr int WG_CONSUMERS = 128;  // the consumer warpgroup's threads
constexpr int WG_NT = WG_CONSUMERS + 32;  // and the producer warp
constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASKED2 = MASKED * LOG2E;

// K3's streamed query tile: 64 rows at D <= 64, 32 at D = 128
template <int D>
__host__ __device__ constexpr int wg_query_rows() {
  return D <= 64 ? 64 : 32;
}

// blocks an SM the kernels' __launch_bounds__ ask for: K2 as K1; K3 two
// at D <= 64 (ptxas took 141-168 registers) and one at D = 128, where two
// capped it at 168 registers, spilled and serialized its wgmma (C7512)
template <int D>
__host__ __device__ constexpr int wg_dq_blocks() {
  return D == 128 ? 2 : 3;
}
template <int D>
__host__ __device__ constexpr int wg_dkv_blocks() {
  return D == 128 ? 1 : 2;
}

// a block's shared memory at head dim D with streamed tiles of BN rows:
// the owned pair of tiles (K2: Q, dO; K3: K, V), WG_STAGES stages of the
// streamed pair, K3's WG_STAGES stages of the lse, delta and dlse rows,
// then the barriers; the tiles at 1024-byte boundaries (the swizzle's
// atom), the rows at 128-byte ones (TMA's)
template <int D, int BN, bool DKV>
struct WgBwdSmem {
  static constexpr int ROW = D >= 64 ? 128 : 2 * D;  // bytes of a tile row
  static constexpr int HALVES = D == 128 ? 2 : 1;    // column blocks
  static constexpr int DH = D / HALVES;              // columns of a block
  static constexpr int OWN_BYTES = WG_BM * D * 2;    // one owned tile
  static constexpr int TILE_BYTES = BN * D * 2;      // one streamed tile
  static constexpr int ROW_BYTES = DKV ? BN * 4 : 0;  // one row of a stage
  static constexpr int RING = 2 * OWN_BYTES;  // stage i: 2 streamed tiles
  static constexpr int ROWS = RING + 2 * WG_STAGES * TILE_BYTES;
  static constexpr int BARS = ROWS + 3 * WG_STAGES * ROW_BYTES;
  static constexpr int ALLOC = BARS + (1 + 2 * WG_STAGES) * 8 + 1024;
};

// ---------------------------------------------------------------------------
// bf16 K2: dq for one (b*h, 64-query) tile, 64-key K/V tiles streamed
// ---------------------------------------------------------------------------
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(WG_NT, wg_dq_blocks<D>())
flash_attn_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tdo,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               const float* __restrict__ dlse,
                               bf16* __restrict__ dq, int lq, int lk,
                               int n_qt, float scale) {
  constexpr int BN = WG_KEYS;
  using S = WgBwdSmem<D, BN, false>;
  constexpr int ROW = S::ROW, HALVES = S::HALVES, DH = S::DH;
  constexpr int LAYOUT = hwg::swizzle_layout(ROW);
  constexpr uint32_t SBO = 8 * ROW;  // from one 8-row group to the next
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = hwg::align_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + WG_STAGES;
  const unsigned char* qs = smem;
  const unsigned char* dos = smem + S::OWN_BYTES;
  auto k_tile = [&](int st) {
    return smem + S::RING + 2 * st * S::TILE_BYTES;
  };

  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * WG_BM;
  // causal: keys past this tile's last query row contribute nothing
  const int k_end = CAUSAL ? min(lk, min(q0 + WG_BM, lq)) : lk;
  const int n_kt = (k_end + BN - 1) / BN;

  hwg::init_ring_barriers(q_full, WG_STAGES, WG_CONSUMERS);

  if (hwg::producer_warp(WG_CONSUMERS)) {
    // Q and dO once, then each key tile's K and V into its stage once the
    // consumers have freed the stage's previous tile (completion
    // it / WG_STAGES - 1 of its empty barrier)
    if (threadIdx.x == WG_CONSUMERS) {
      hwg::mbar_arrive_expect_tx(q_full, 2 * S::OWN_BYTES);
      for (int h = 0; h < HALVES; ++h) {
        hwg::tma_load_3d(smem + h * WG_BM * ROW, &tq, q_full, h * DH, q0, bh);
        hwg::tma_load_3d(smem + S::OWN_BYTES + h * WG_BM * ROW, &tdo, q_full,
                         h * DH, q0, bh);
      }
      for (int it = 0; it < n_kt; ++it) {
        const int st = it % WG_STAGES;
        if (it >= WG_STAGES)
          hwg::mbar_wait(&empty[st], (it / WG_STAGES + 1) & 1);
        hwg::mbar_arrive_expect_tx(&full[st], 2 * S::TILE_BYTES);
        unsigned char* kt = k_tile(st);
        for (int h = 0; h < HALVES; ++h) {
          hwg::tma_load_3d(kt + h * BN * ROW, &tk, &full[st], h * DH,
                           it * BN, bh);
          hwg::tma_load_3d(kt + S::TILE_BYTES + h * BN * ROW, &tv, &full[st],
                           h * DH, it * BN, bh);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: warp w owns rows q0 + 16w + (g, g + 8)
  const int warp = threadIdx.x / 32;
  const int g = hmma::lane_g(), t = hmma::lane_t();
  const int row0 = q0 + warp * 16 + g;
  const float c = scale * LOG2E;
  // this lane's two rows: lse * log2e and dlse - delta
  float l2_row[2], c_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + 8 * h;
    const size_t i = (size_t)bh * lq + r;
    l2_row[h] = r < lq ? lse[i] * LOG2E : 0.f;
    c_row[h] = r < lq ? dlse[i] - delta[i] : 0.f;
  }

  float s[BN / 2], dp[BN / 2];
  float acc[HALVES][DH / 2];
  uint32_t ds[BN / 16][4];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int h = 0; h < HALVES; ++h)
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[h][i] = 0.f;

  // issue s = q k^T and then dp = dO v^T on stage st, D / 16 products
  // each, as two groups
  auto scores = [&](int st) {
    const unsigned char* kt = k_tile(st);
    const unsigned char* vt = kt + S::TILE_BYTES;
    hwg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int h = kk * 16 / DH, off = (kk * 16 % DH) * 2;
      hwg::wgmma_ss<BN>(
          s, hwg::make_desc(qs + h * WG_BM * ROW + off, 16, SBO, LAYOUT),
          hwg::make_desc(kt + h * BN * ROW + off, 16, SBO, LAYOUT), kk > 0);
    }
    hwg::commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int h = kk * 16 / DH, off = (kk * 16 % DH) * 2;
      hwg::wgmma_ss<BN>(
          dp, hwg::make_desc(dos + h * WG_BM * ROW + off, 16, SBO, LAYOUT),
          hwg::make_desc(vt + h * BN * ROW + off, 16, SBO, LAYOUT), kk > 0);
    }
    hwg::commit();
  };
  // issue dq += ds k on stage st: per 16 keys, one product per column
  // block, the K tile read MN-major
  auto grad = [&](int st) {
    const unsigned char* kt = k_tile(st);
    hwg::fence();
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc)
#pragma unroll
      for (int h = 0; h < HALVES; ++h)
        hwg::wgmma_rs<DH>(acc[h], ds[kc],
                          hwg::make_desc(kt + h * BN * ROW + kc * 16 * ROW,
                                         BN * ROW, SBO, LAYOUT));
    hwg::commit();
  };

  hwg::mbar_wait(q_full, 0);
  for (int it = 0; it < n_kt; ++it) {
    const int st = it % WG_STAGES;
    const int k0 = it * BN;
    hwg::mbar_wait(&full[st], (it / WG_STAGES) & 1);
    scores(st);
    // p in place of s while dp's products run; masks only where this
    // warp's rows meet the diagonal or the tile passes lk
    hwg::wait<1>();
    hwg::fence_regs(s);
    const bool edge =
        (CAUSAL && k0 + BN - 1 > q0 + warp * 16) || k0 + BN > lk;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e, h = e >> 1;
        float x = fmaf(s[i], c, -l2_row[h]);
        if (edge) {
          const int col = k0 + j * 8 + 2 * t + (e & 1);
          if (CAUSAL && col > row0 + 8 * h) x = MASKED2 - l2_row[h];
          s[i] = col < lk ? hwg::exp2_approx(x) : 0.f;
        } else {
          s[i] = hwg::exp2_approx(x);
        }
      }
    // ds / scale = p (dp - delta + dlse) in place of p (the scale is
    // applied to dq on the store)
    hwg::wait<0>();
    hwg::fence_regs(dp);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] *= dp[i] + c_row[(i >> 1) & 1];
    // ds / scale rounded to bf16 into the A fragments of ds k (8-key
    // chunks 2kc and 2kc + 1: keys 16kc..)
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        ds[kc][r] = hmma::pack_bf16(s[8 * kc + 2 * r], s[8 * kc + 2 * r + 1]);
    grad(st);
    hwg::wait<0>();
#pragma unroll
    for (int h = 0; h < HALVES; ++h) hwg::fence_regs(acc[h]);
    hwg::mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = row0 + 8 * h2;
    if (r < lq) {
      bf16* out = dq + ((size_t)bh * lq + r) * D;
#pragma unroll
      for (int h = 0; h < HALVES; ++h)
#pragma unroll
        for (int j = 0; j < DH / 8; ++j)
          store2(out + h * DH + j * 8 + 2 * t, acc[h][4 * j + 2 * h2] * scale,
                 acc[h][4 * j + 2 * h2 + 1] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 K3: dk and dv for one (b*h, 64-key) tile, Q/dO tiles and their
// rows streamed
// ---------------------------------------------------------------------------
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(WG_NT, wg_dkv_blocks<D>())
flash_attn_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const __grid_constant__ CUtensorMap tdo,
                                const __grid_constant__ CUtensorMap tlse,
                                const __grid_constant__ CUtensorMap tdelta,
                                const __grid_constant__ CUtensorMap tdlse,
                                bf16* __restrict__ dk, bf16* __restrict__ dv,
                                int lq, int lk, int n_kt, float scale) {
  constexpr int BN = wg_query_rows<D>();
  using S = WgBwdSmem<D, BN, true>;
  constexpr int ROW = S::ROW, HALVES = S::HALVES, DH = S::DH;
  constexpr int LAYOUT = hwg::swizzle_layout(ROW);
  constexpr uint32_t SBO = 8 * ROW;  // from one 8-row group to the next
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = hwg::align_1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + WG_STAGES;
  const unsigned char* ks = smem;
  const unsigned char* vs = smem + S::OWN_BYTES;
  auto q_tile = [&](int st) {
    return smem + S::RING + 2 * st * S::TILE_BYTES;
  };
  // stage st's lse, delta and dlse rows, BN values each
  auto stage_rows = [&](int st) {
    return reinterpret_cast<float*>(smem + S::ROWS + 3 * st * S::ROW_BYTES);
  };

  const int bh = blockIdx.x / n_kt;
  const int k0 = (blockIdx.x % n_kt) * WG_BM;
  // causal: query tiles wholly before this tile's first key see none of it
  const int q_begin = CAUSAL ? (k0 / BN) * BN : 0;
  const int n_it = q_begin < lq ? (lq - q_begin + BN - 1) / BN : 0;

  hwg::init_ring_barriers(kv_full, WG_STAGES, WG_CONSUMERS);

  if (hwg::producer_warp(WG_CONSUMERS)) {
    // K and V once, then each query tile's Q, dO and rows into its stage
    // once the consumers have freed the stage's previous tile
    if (threadIdx.x == WG_CONSUMERS && n_it > 0) {
      hwg::mbar_arrive_expect_tx(kv_full, 2 * S::OWN_BYTES);
      for (int h = 0; h < HALVES; ++h) {
        hwg::tma_load_3d(smem + h * WG_BM * ROW, &tk, kv_full, h * DH, k0,
                         bh);
        hwg::tma_load_3d(smem + S::OWN_BYTES + h * WG_BM * ROW, &tv, kv_full,
                         h * DH, k0, bh);
      }
      for (int it = 0; it < n_it; ++it) {
        const int st = it % WG_STAGES;
        const int q0 = q_begin + it * BN;
        if (it >= WG_STAGES)
          hwg::mbar_wait(&empty[st], (it / WG_STAGES + 1) & 1);
        hwg::mbar_arrive_expect_tx(&full[st],
                                   2 * S::TILE_BYTES + 3 * S::ROW_BYTES);
        unsigned char* qt = q_tile(st);
        for (int h = 0; h < HALVES; ++h) {
          hwg::tma_load_3d(qt + h * BN * ROW, &tq, &full[st], h * DH, q0, bh);
          hwg::tma_load_3d(qt + S::TILE_BYTES + h * BN * ROW, &tdo,
                           &full[st], h * DH, q0, bh);
        }
        float* rows = stage_rows(st);
        const int r0 = bh * lq + q0;
        hwg::tma_load_1d(rows, &tlse, &full[st], r0);
        hwg::tma_load_1d(rows + BN, &tdelta, &full[st], r0);
        hwg::tma_load_1d(rows + 2 * BN, &tdlse, &full[st], r0);
      }
    }
    return;
  }

  // the consumer warpgroup: warp w owns keys k0 + 16w + (g, g + 8)
  const int warp = threadIdx.x / 32;
  const int g = hmma::lane_g(), t = hmma::lane_t();
  const int kr0 = k0 + warp * 16 + g;
  const float c = scale * LOG2E;

  float sc[BN / 2], dps[BN / 2];  // s^T and dp^T, then p^T and ds^T
  float adk[HALVES][DH / 2], adv[HALVES][DH / 2];
  uint32_t pf[BN / 16][4], dsf[BN / 16][4];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) sc[i] = dps[i] = 0.f;
#pragma unroll
  for (int h = 0; h < HALVES; ++h)
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) adk[h][i] = adv[h][i] = 0.f;

  // issue s^T = k q^T and dp^T = v dO^T on stage st: D / 16 products each
  auto scores = [&](int st) {
    const unsigned char* qt = q_tile(st);
    const unsigned char* dot = qt + S::TILE_BYTES;
    hwg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int h = kk * 16 / DH, off = (kk * 16 % DH) * 2;
      hwg::wgmma_ss<BN>(
          sc, hwg::make_desc(ks + h * WG_BM * ROW + off, 16, SBO, LAYOUT),
          hwg::make_desc(qt + h * BN * ROW + off, 16, SBO, LAYOUT), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int h = kk * 16 / DH, off = (kk * 16 % DH) * 2;
      hwg::wgmma_ss<BN>(
          dps, hwg::make_desc(vs + h * WG_BM * ROW + off, 16, SBO, LAYOUT),
          hwg::make_desc(dot + h * BN * ROW + off, 16, SBO, LAYOUT), kk > 0);
    }
    hwg::commit();
  };
  // issue dv += p^T dO and dk += ds^T q on stage st: per 16 queries, one
  // product per column block of each, dO and Q read MN-major
  auto grads = [&](int st) {
    const unsigned char* qt = q_tile(st);
    const unsigned char* dot = qt + S::TILE_BYTES;
    hwg::fence();
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc)
#pragma unroll
      for (int h = 0; h < HALVES; ++h) {
        const int at = h * BN * ROW + kc * 16 * ROW;
        hwg::wgmma_rs<DH>(adv[h], pf[kc],
                          hwg::make_desc(dot + at, BN * ROW, SBO, LAYOUT));
        hwg::wgmma_rs<DH>(adk[h], dsf[kc],
                          hwg::make_desc(qt + at, BN * ROW, SBO, LAYOUT));
      }
    hwg::commit();
  };

  if (n_it > 0) hwg::mbar_wait(kv_full, 0);
  for (int it = 0; it < n_it; ++it) {
    const int st = it % WG_STAGES;
    const int q0 = q_begin + it * BN;
    hwg::mbar_wait(&full[st], (it / WG_STAGES) & 1);
    scores(st);
    hwg::wait<0>();
    hwg::fence_regs(sc);
    hwg::fence_regs(dps);
    // p^T in place of s^T and ds^T / scale in place of dp^T (the scale is
    // applied to dk on the store); masks only where this warp's keys meet
    // the diagonal or the tile passes lq
    const float* lse_s = stage_rows(st);
    const float* delta_s = lse_s + BN;
    const float* dlse_s = delta_s + BN;
    const bool edge =
        (CAUSAL && k0 + warp * 16 + 15 > q0) || q0 + BN > lq;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      // this lane's two queries of chunk j: qc and qc + 1
      const int qc = j * 8 + 2 * t;
      const float2 l = *reinterpret_cast<const float2*>(lse_s + qc);
      const float2 dl = *reinterpret_cast<const float2*>(delta_s + qc);
      const float2 dd = *reinterpret_cast<const float2*>(dlse_s + qc);
      const float l2[2] = {l.x * LOG2E, l.y * LOG2E};
      const float cq[2] = {dd.x - dl.x, dd.y - dl.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e, col = e & 1;
        float x = fmaf(sc[i], c, -l2[col]);
        float p;
        if (edge) {
          const int qr = q0 + qc + col;
          if (CAUSAL && kr0 + 8 * (e >> 1) > qr) x = MASKED2 - l2[col];
          p = qr < lq ? hwg::exp2_approx(x) : 0.f;
        } else {
          p = hwg::exp2_approx(x);
        }
        sc[i] = p;
        dps[i] = p * (dps[i] + cq[col]);
      }
    }
    // p^T and ds^T / scale rounded to bf16 into the A fragments of the
    // accumulating products (8-query chunks 2kc and 2kc + 1)
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pf[kc][r] =
            hmma::pack_bf16(sc[8 * kc + 2 * r], sc[8 * kc + 2 * r + 1]);
        dsf[kc][r] =
            hmma::pack_bf16(dps[8 * kc + 2 * r], dps[8 * kc + 2 * r + 1]);
      }
    grads(st);
    hwg::wait<0>();
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
      hwg::fence_regs(adk[h]);
      hwg::fence_regs(adv[h]);
    }
    hwg::mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = kr0 + 8 * h2;
    if (r < lk) {
      const size_t off = ((size_t)bh * lk + r) * D;
#pragma unroll
      for (int h = 0; h < HALVES; ++h)
#pragma unroll
        for (int j = 0; j < DH / 8; ++j) {
          const int col = h * DH + j * 8 + 2 * t;
          store2(dk + off + col, adk[h][4 * j + 2 * h2] * scale,
                 adk[h][4 * j + 2 * h2 + 1] * scale);
          store2(dv + off + col, adv[h][4 * j + 2 * h2],
                 adv[h][4 * j + 2 * h2 + 1]);
        }
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta, *dlse;
  void *out0, *out1;  // dq (K2), or dk and dv (K3)
  int bh, lq, lk;
  float scale;
  cudaStream_t stream;
};

template <int D, bool CAUSAL>
cudaError_t launch_dq(const Args& a) {
  auto kernel = flash_attn_bwd_dq_kernel<D, CAUSAL>;
  constexpr int smem = smem_bytes<D, false>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (a.lq + BM - 1) / BM;
  const long long blocks = (long long)a.bh * n_qt;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)blocks), NT, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, a.dlse, static_cast<float*>(a.out0), a.lq, a.lk, n_qt,
      a.scale);
  return cudaGetLastError();
}

template <int D, bool CAUSAL>
cudaError_t launch_dkv(const Args& a) {
  auto kernel = flash_attn_bwd_dkv_kernel<D, CAUSAL>;
  constexpr int smem = smem_bytes<D, true>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_kt = (a.lk + BM - 1) / BM;
  const long long blocks = (long long)a.bh * n_kt;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)blocks), NT, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, a.dlse, static_cast<float*>(a.out0),
      static_cast<float*>(a.out1), a.lq, a.lk, n_kt, a.scale);
  return cudaGetLastError();
}

// the maps of q, k, v and dO for tiles of ``q_rows`` query and ``k_rows``
// key rows, one column block wide
template <int D>
CUresult encode_qkvo(hhost::EncodeTiled fn, const Args& a, int q_rows,
                     int k_rows, CUtensorMap (&m)[4]) {
  constexpr int DH = D == 128 ? 64 : D;
  CUresult res = hhost::encode_bf16(fn, &m[0], a.q, a.bh, a.lq, D, DH, q_rows);
  if (res == CUDA_SUCCESS)
    res = hhost::encode_bf16(fn, &m[1], a.k, a.bh, a.lk, D, DH, k_rows);
  if (res == CUDA_SUCCESS)
    res = hhost::encode_bf16(fn, &m[2], a.v, a.bh, a.lk, D, DH, k_rows);
  if (res == CUDA_SUCCESS)
    res = hhost::encode_bf16(fn, &m[3], a.dout, a.bh, a.lq, D, DH, q_rows);
  return res;
}

template <int D, bool CAUSAL>
cudaError_t launch_dq_wgmma(const Args& a) {
  using S = WgBwdSmem<D, WG_KEYS, false>;
  auto kernel = flash_attn_bwd_dq_wgmma_kernel<D, CAUSAL>;
  static bool raised[64] = {};
  cudaError_t err = hhost::allow_smem(kernel, S::ALLOC, raised);
  if (err != cudaSuccess) return err;
  const int n_qt = (a.lq + WG_BM - 1) / WG_BM;
  const long long blocks = (long long)a.bh * n_qt;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  hhost::EncodeTiled fn;
  err = hhost::encode_tiled(&fn);
  if (err != cudaSuccess) return err;
  CUtensorMap m[4];
  const CUresult res = encode_qkvo<D>(fn, a, WG_BM, WG_KEYS, m);
  if (res != CUDA_SUCCESS) return static_cast<cudaError_t>(res);
  kernel<<<dim3((unsigned)blocks), WG_NT, S::ALLOC, a.stream>>>(
      m[0], m[1], m[2], m[3], a.lse, a.delta, a.dlse,
      static_cast<bf16*>(a.out0), a.lq, a.lk, n_qt, a.scale);
  return cudaGetLastError();
}

template <int D, bool CAUSAL>
cudaError_t launch_dkv_wgmma(const Args& a) {
  constexpr int BN = wg_query_rows<D>();
  using S = WgBwdSmem<D, BN, true>;
  auto kernel = flash_attn_bwd_dkv_wgmma_kernel<D, CAUSAL>;
  static bool raised[64] = {};
  cudaError_t err = hhost::allow_smem(kernel, S::ALLOC, raised);
  if (err != cudaSuccess) return err;
  const int n_kt = (a.lk + WG_BM - 1) / WG_BM;
  const long long blocks = (long long)a.bh * n_kt;
  const long long rows = (long long)a.bh * a.lq;
  if (blocks <= 0 || blocks > 0x7fffffffLL || rows > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  hhost::EncodeTiled fn;
  err = hhost::encode_tiled(&fn);
  if (err != cudaSuccess) return err;
  CUtensorMap m[4], tlse, tdelta, tdlse;
  CUresult res = encode_qkvo<D>(fn, a, BN, WG_BM, m);
  if (res == CUDA_SUCCESS)
    res = hhost::encode_f32_rows(fn, &tlse, a.lse, rows, BN);
  if (res == CUDA_SUCCESS)
    res = hhost::encode_f32_rows(fn, &tdelta, a.delta, rows, BN);
  if (res == CUDA_SUCCESS)
    res = hhost::encode_f32_rows(fn, &tdlse, a.dlse, rows, BN);
  if (res != CUDA_SUCCESS) return static_cast<cudaError_t>(res);
  kernel<<<dim3((unsigned)blocks), WG_NT, S::ALLOC, a.stream>>>(
      m[0], m[1], m[2], m[3], tlse, tdelta, tdlse, static_cast<bf16*>(a.out0),
      static_cast<bf16*>(a.out1), a.lq, a.lk, n_kt, a.scale);
  return cudaGetLastError();
}

template <bool DKV, int D, bool CAUSAL>
cudaError_t launch_fp32(const Args& a) {
  if constexpr (DKV) {
    return launch_dkv<D, CAUSAL>(a);
  } else {
    return launch_dq<D, CAUSAL>(a);
  }
}

template <bool DKV, int D, bool CAUSAL>
cudaError_t launch_bf16(const Args& a) {
  if constexpr (DKV) {
    return launch_dkv_wgmma<D, CAUSAL>(a);
  } else {
    return launch_dq_wgmma<D, CAUSAL>(a);
  }
}

// fp32 inputs: the mma.sync kernels, one of 8 instantiations (head dim x
// causal) of K2 or K3
template <bool DKV, bool CAUSAL>
cudaError_t dispatch_fp32(int d, const Args& a) {
  switch (d) {
    case 16:
      return launch_fp32<DKV, 16, CAUSAL>(a);
    case 32:
      return launch_fp32<DKV, 32, CAUSAL>(a);
    case 64:
      return launch_fp32<DKV, 64, CAUSAL>(a);
    case 128:
      return launch_fp32<DKV, 128, CAUSAL>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

// bf16 inputs: the wgmma kernels at every head dim the wrapper takes
template <bool DKV, bool CAUSAL>
cudaError_t dispatch_bf16(int d, const Args& a) {
  switch (d) {
    case 16:
      return launch_bf16<DKV, 16, CAUSAL>(a);
    case 32:
      return launch_bf16<DKV, 32, CAUSAL>(a);
    case 64:
      return launch_bf16<DKV, 64, CAUSAL>(a);
    case 128:
      return launch_bf16<DKV, 128, CAUSAL>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool DKV>
int dispatch(int d, int dtype, int causal, const Args& a) {
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = causal ? dispatch_fp32<DKV, true>(d, a)
                 : dispatch_fp32<DKV, false>(d, a);
  } else if (dtype == 1) {
    err = causal ? dispatch_bf16<DKV, true>(d, a)
                 : dispatch_bf16<DKV, false>(d, a);
  }
  return static_cast<int>(err);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, dout, dq are [bh, lq, d]; k, v are
// [bh, lk, d]; lse, delta, dlse are fp32 [bh, lq].  Every pointer must be
// 16-byte aligned (cp.async, TMA).  Returns a cudaError_t value, or the
// CUDA driver API's CUresult when a tensor map cannot be encoded.
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
