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
// read once per query tile and O and lse written once.  No block reads
// another's result, so every run gives the same bits.
//
// What bounds it on the H100.  Per (b, h) the work is 4*Lq*Lk*D operations
// (s = q k^T and p v) against (2*Lq + 2*Lk)*D elements moved.  Each input
// type has a kernel of its own:
//   * fp32: at BERT's L = 512, D = 64 the work is far above the card's
//     ridge, so it is bound by the product rate.  mma.sync m16n8k8 runs in
//     three TF32 passes over split operands (hopper_mma.cuh), which keeps
//     fp32-level accuracy at up to 495/3 TFLOP/s.
//   * bf16: the products run at 989 TFLOP/s, and at [8, 12, 512, 64] the
//     bound is the bytes moved (0.0076 ms).  mma.sync does not reach that
//     rate on Hopper, so this kernel runs on wgmma fed by TMA through an
//     mbarrier ring (hopper_wgmma.cuh).
//
// fp32 design, as K2's dq kernel (flash_attn_bwd.cu), which does most of
// this work too.  Each block is four warps and each warp owns 16 query
// rows, so its scores, its row max and sum, and its 16 x D output
// accumulator stay in registers:
//   * Q.  The tile is read once, multiplied by the scale before the
//     product, as the TPU kernel scales q, and split into its TF32 big and
//     small parts once for the block, not once per key tile; the fragments
//     stay in registers, except at D = 128, where they would crowd out the
//     accumulator and are read again from shared memory for each key tile.
//   * K and V stream through a two-stage cp.async ring (64-row tiles, 32
//     at D = 128) with rows padded by 16 bytes; each warp splits the
//     fragments it loads in registers, as K2 does.
//   * s = q k^T by mma.sync; the causal mask (-1e30) and keys past lk
//     (-inf) are applied in registers.  Lanes 4g..4g+3 hold rows g and g+8
//     of the warp's 16, so a row's max takes two quad shuffles; each lane
//     keeps its own part of the row sum, added up once at the end.
//   * acc = alpha * acc + p v, with p's accumulator taken as the A operand
//     of the product (k permuted inside each 8-wide chunk, V loaded to
//     match).  Every SUM_CHUNKS 8-key chunks of p v are summed in an
//     accumulator of their own and added to acc in fp32: the tensor cores
//     truncate as they accumulate, and an O summed inside them over the
//     whole sequence drifts toward zero, which the training step's
//     gradients showed (PERF.md).
// Rows past a ragged end load as zeros and are not stored.
//
// bf16 design.  A block is one consumer warpgroup (4 warps, 64 query rows:
// one wgmma's M) and one producer warp:
//   * The producer's lane 0 loads the Q tile once and then streams the K
//     and V tiles (64 keys each) by TMA into a WG_STAGES-deep ring, each
//     stage with a full barrier (the producer's arrival and the tiles'
//     bytes) and an empty one (the consumers' 128 arrivals).  The tensor
//     maps are built on the host for each call and passed by value, so a
//     CUDA graph keeps them.  They are rank 3, [b*h][L][D], so a box past
//     one (b, h)'s last row arrives as TMA's zeros, not as the next one's
//     rows.  Tiles lie as TMA swizzles them: 128-byte rows at D = 64, two
//     64-column blocks of 128-byte rows at D = 128, 64- and 32-byte rows
//     at D = 32 and 16.
//   * s = q k^T: wgmma m64n64k16 with both operands in shared memory (Q and
//     the K tile [keys][D] are both K-major), D / 16 products a tile.  The
//     accumulator gives each warp 16 rows in mma.sync's quad layout, so
//     the masks, the quad-shuffle row max and the per-lane row sums are
//     the fp32 kernel's.  The scale is applied to s in fp32 after the
//     product (rounding q * scale to bf16 would add an error), folded with
//     log2(e) into c = scale * log2e: for c > 0 the row max is taken on s
//     (max(s) * c = max(s * c)), masked scores are -1e30 * log2e / c there,
//     and p = exp2(fma(s, c, -m)); any other scale takes x = s * c first.
//     m is kept in base 2, so lse = m * ln2 + log(l).
//   * acc = alpha * acc + p v: p is rounded to bf16 (as FlashAttention-2
//     does) into the register A operand of wgmma m64nNk16 (two neighbouring
//     8-key chunks of s make one 16-key A fragment), and V's tile [keys][D]
//     is the B operand, read MN-major with the transpose bit: no scalar
//     loads.  At D = 128 each column block of V and of acc is one N = 64
//     product.
//   * The warpgroup runs q k^T, the softmax and p v of a tile in turn and
//     frees the stage; the softmax of one block overlaps the products of
//     the other blocks on the SM.  Measured on the H100 (PERF.md): more
//     warps per SM (4 blocks, or two consumer warpgroups a block) or more
//     work in flight per warpgroup (the next tile's q k^T during this
//     tile's softmax, or 128-key tiles) each need more registers than the
//     blocks per SM leave, and ptxas then serializes the wgmma (C7512):
//     all were slower.
//   * Sizes.  Shared memory per block: the Q tile (64 * D * 2 bytes),
//     WG_STAGES = 2 stages of a K and a V tile (64 * D * 2 bytes each), 5
//     barriers, and 1 KB to align the tiles for the swizzle: 42,024 bytes
//     at D = 64, 82,984 at D = 128.  Blocks per SM by __launch_bounds__: 3
//     at D <= 64 (at most 136 registers a thread; ptxas takes 106 at
//     D = 64), 2 at D = 128 (204).  At [8, 12, 512, 64]: 96 (b, h) pairs x
//     8 query tiles = 768 blocks on 132 SMs x 3 = 396 slots, 1.94 waves.
//     No setmaxnreg: the producer warp is a fifth of the block's threads.
//
// The C entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() after the launch
// (or the CUDA driver API's CUresult when a tensor map cannot be
// encoded).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "hopper_host.cuh"
#include "hopper_mma.cuh"
#include "hopper_wgmma.cuh"

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

// whether Q's fragments stay in registers for the whole block: at D = 128
// they would hold 128 registers beside a 64-register accumulator
template <int D>
__host__ __device__ constexpr bool q_in_registers() {
  return D <= 64;
}

// shared memory: the Q tile (its big parts, then its small parts) and two
// stages of the K and V tiles
template <int D>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int ST = D + hmma::row_pad<float>();
  return (2 * BM + 4 * key_rows<D>()) * ST * (int)sizeof(float);
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

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(NT, 2)
flash_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int lq, int lk, int n_qt,
                      float scale) {
  using A = hmma::FragA32;
  using B = hmma::FragB32;
  constexpr bool Q_REGS = q_in_registers<D>();
  constexpr int KS = hmma::Frag<float>::K;
  constexpr int BN = key_rows<D>();
  constexpr int ST = D + hmma::row_pad<float>();
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ring = qs + 2 * BM * ST;  // stage i: K at 2*i*BN*ST, V after it

  const int warp = threadIdx.x / 32;
  const int g = hmma::lane_g(), t = hmma::lane_t();
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * BM;
  const int row0 = q0 + warp * 16 + g;  // this lane's rows: row0, row0 + 8
  const float* kb = k + (size_t)bh * lk * D;
  const float* vb = v + (size_t)bh * lk * D;
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

  // Q's A fragments: scaled and split once, in place
  float* qlo = qs + BM * ST;
  scale_and_split_q<D>(qs, qlo, scale);
  __syncthreads();
  A qf[Q_REGS ? D / KS : 1];
  auto q_frag = [&](A& a, int kk) {
    hmma::load_a(a, qs, qlo, ST, warp * 16, kk);
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
    const float* ks = ring + (it & 1) * 2 * BN * ST;
    const float* vs = ks + BN * ST;

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
        float x = s[j][e];
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

    // acc = alpha acc + p v.  Every SUM_CHUNKS chunks of p v are summed
    // alone (started by hmma::mma_alone) and added in fp32, so that O
    // carries no drift toward zero: the backward's delta = rowsum(dO * O)
    // must match its own sum of p * dp.
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
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
    __syncthreads();  // this stage is free for the tile after next
    if (it + 2 < n_kt) {
      float* nxt = ring + (it & 1) * 2 * BN * ST;
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
      float* orow = o + ((size_t)bh * lq + r) * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        store2(orow + n * 8 + 2 * t, acc[n][2 * h] / l,
               acc[n][2 * h + 1] / l);
      if (t == 0) lse[(size_t)bh * lq + r] = m_row[h] + logf(l);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA through an mbarrier ring
// ---------------------------------------------------------------------------

constexpr int WG_BM = 64;          // query rows of a block: one wgmma's M
constexpr int WG_BN = 64;          // keys of a K/V tile: one wgmma's N
constexpr int WG_STAGES = 2;       // K/V stages in the ring
constexpr int WG_CONSUMERS = 128;  // the consumer warpgroup's threads
constexpr int WG_NT = WG_CONSUMERS + 32;  // and the producer warp
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// a block's shared memory at head dim D: the tiles at 1024-byte boundaries
// (the swizzle's atom), then the barriers
template <int D>
struct WgSmem {
  static constexpr int ROW = D >= 64 ? 128 : 2 * D;  // bytes of a tile row
  static constexpr int HALVES = D == 128 ? 2 : 1;    // column blocks
  static constexpr int DH = D / HALVES;              // columns of a block
  static constexpr int Q_BYTES = WG_BM * D * 2;
  static constexpr int KV_BYTES = WG_BN * D * 2;  // one K or one V tile
  static constexpr int RING = Q_BYTES;            // stage i: K, then V
  static constexpr int BARS = RING + 2 * WG_STAGES * KV_BYTES;
  static constexpr int ALLOC = BARS + (1 + 2 * WG_STAGES) * 8 + 1024;
};

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(WG_NT, D == 128 ? 2 : 3)
flash_attn_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            bf16* __restrict__ o, float* __restrict__ lse,
                            int lq, int lk, int n_qt, float scale) {
  using S = WgSmem<D>;
  constexpr int BN = WG_BN, ROW = S::ROW, HALVES = S::HALVES, DH = S::DH;
  constexpr int LAYOUT = hwg::swizzle_layout(ROW);
  constexpr uint32_t SBO = 8 * ROW;  // from one 8-row group to the next
  constexpr float MASKED2 = MASKED * LOG2E;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = hwg::align_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + S::BARS);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + WG_STAGES;
  auto k_tile = [&](int st) { return smem + S::RING + 2 * st * S::KV_BYTES; };

  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * WG_BM;
  // causal: keys past this tile's last query row contribute nothing
  const int k_end = CAUSAL ? min(lk, min(q0 + WG_BM, lq)) : lk;
  const int n_kt = (k_end + BN - 1) / BN;

  hwg::init_ring_barriers(q_full, WG_STAGES, WG_CONSUMERS);

  if (hwg::producer_warp(WG_CONSUMERS)) {
    // the producer: Q once, then each key tile into its stage once the
    // consumers have freed the stage's previous tile (completion
    // it / WG_STAGES - 1 of its empty barrier)
    if (threadIdx.x == WG_CONSUMERS) {
      hwg::mbar_arrive_expect_tx(q_full, S::Q_BYTES);
      for (int h = 0; h < HALVES; ++h)
        hwg::tma_load_3d(smem + h * WG_BM * ROW, &tq, q_full, h * DH, q0, bh);
      for (int it = 0; it < n_kt; ++it) {
        const int st = it % WG_STAGES;
        if (it >= WG_STAGES)
          hwg::mbar_wait(&empty[st], (it / WG_STAGES + 1) & 1);
        hwg::mbar_arrive_expect_tx(&full[st], 2 * S::KV_BYTES);
        unsigned char* kt = k_tile(st);
        for (int h = 0; h < HALVES; ++h) {
          hwg::tma_load_3d(kt + h * BN * ROW, &tk, &full[st], h * DH,
                           it * BN, bh);
          hwg::tma_load_3d(kt + S::KV_BYTES + h * BN * ROW, &tv, &full[st],
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
  // masked scores before the scale (for c > 0): times c they are MASKED2
  const float masked = MASKED2 / c;

  float s[BN / 2];
  float acc[HALVES][DH / 2];
  uint32_t p[BN / 16][4];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
#pragma unroll
  for (int h = 0; h < HALVES; ++h)
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[h][i] = 0.f;
  // per row of this lane's two: the running max (base 2) and this lane's
  // share of the running sum
  float m_row[2] = {MASKED2, MASKED2}, l_row[2] = {0.f, 0.f};

  // issue s = q k^T on stage st: D / 16 products of 16 columns
  auto qk = [&](int st) {
    const unsigned char* kt = k_tile(st);
    hwg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int h = kk * 16 / DH, off = (kk * 16 % DH) * 2;
      hwg::wgmma_ss_n64(
          s, hwg::make_desc(smem + h * WG_BM * ROW + off, 16, SBO, LAYOUT),
          hwg::make_desc(kt + h * BN * ROW + off, 16, SBO, LAYOUT),
          kk > 0);
    }
    hwg::commit();
  };
  // issue acc += p v on stage st: per 16 keys, one product per column
  // block
  auto pv = [&](int st) {
    const unsigned char* vt = k_tile(st) + S::KV_BYTES;
    hwg::fence();
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc)
#pragma unroll
      for (int h = 0; h < HALVES; ++h)
        hwg::wgmma_rs<DH>(acc[h], p[kc],
                     hwg::make_desc(vt + h * BN * ROW + kc * 16 * ROW,
                                    BN * ROW, SBO, LAYOUT));
    hwg::commit();
  };

  hwg::mbar_wait(q_full, 0);
  if (n_kt > 0) {
    hwg::mbar_wait(&full[0], 0);
    qk(0);
    hwg::wait<0>();
    hwg::fence_regs(s);
  }
  for (int it = 0; it < n_kt; ++it) {
    const int st = it % WG_STAGES;
    const int k0 = it * BN;
    // masks (only where this warp's rows meet the diagonal or the tile
    // passes lk), the tile's row max, alpha, p in place of s and its row
    // sums.  With c > 0 (FOLD) the masks and the max are taken on s before
    // the scale, since max(s) * c = max(s * c), and p = exp2(fma(s, c, -m));
    // any other scale takes x = s * c first.
    const bool edge =
        (CAUSAL && k0 + BN - 1 > q0 + warp * 16) || k0 + BN > lk;
    float alpha[2], sum[2] = {0.f, 0.f};
    auto softmax = [&](auto fold) {
      constexpr bool FOLD = decltype(fold)::value;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = FOLD ? s[4 * j + e] : s[4 * j + e] * c;
          if (edge) {
            const int row = row0 + 8 * (e >> 1);
            const int col = k0 + j * 8 + 2 * t + (e & 1);
            if (CAUSAL && col > row) x = FOLD ? masked : MASKED2;
            if (col >= lk) x = -INFINITY;  // past the last key: weight 0
          }
          s[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_row[h], FOLD ? mx[h] * c : mx[h]);
        alpha[h] = hwg::exp2_approx(m_row[h] - m_new);
        m_row[h] = m_new;
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const float m = m_row[(i >> 1) & 1];
        s[i] = hwg::exp2_approx(FOLD ? fmaf(s[i], c, -m) : s[i] - m);
        sum[(i >> 1) & 1] += s[i];
      }
    };
    if (c > 0.f) {
      softmax(std::true_type());
    } else {
      softmax(std::false_type());
    }
    // l = alpha l + rowsum(p); p rounded to bf16 into the A fragments of
    // p v (8-key chunks 2kc and 2kc + 1: keys 16kc..)
#pragma unroll
    for (int h = 0; h < 2; ++h) l_row[h] = l_row[h] * alpha[h] + sum[h];
#pragma unroll
    for (int kc = 0; kc < BN / 16; ++kc)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p[kc][r] = hmma::pack_bf16(s[8 * kc + 2 * r], s[8 * kc + 2 * r + 1]);
#pragma unroll
    for (int h = 0; h < HALVES; ++h)
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) acc[h][i] *= alpha[(i >> 1) & 1];

    pv(st);
    hwg::wait<0>();
#pragma unroll
    for (int h = 0; h < HALVES; ++h) hwg::fence_regs(acc[h]);
    hwg::mbar_arrive(&empty[st]);
    if (it + 1 < n_kt) {
      const int nst = (it + 1) % WG_STAGES;
      hwg::mbar_wait(&full[nst], ((it + 1) / WG_STAGES) & 1);
      qk(nst);
      hwg::wait<0>();
      hwg::fence_regs(s);
    }
  }

  // O = acc / l and lse = m ln2 + log(l), l the quad's sum of its lanes'
  // shares
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    float l = l_row[h2];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l = fmaxf(l, 1e-30f);
    const int r = row0 + 8 * h2;
    if (r < lq) {
      bf16* orow = o + ((size_t)bh * lq + r) * D;
#pragma unroll
      for (int h = 0; h < HALVES; ++h)
#pragma unroll
        for (int j = 0; j < DH / 8; ++j)
          store2(orow + h * DH + j * 8 + 2 * t, acc[h][4 * j + 2 * h2] / l,
                 acc[h][4 * j + 2 * h2 + 1] / l);
      if (t == 0) lse[(size_t)bh * lq + r] = m_row[h2] * LN2 + logf(l);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int D, bool CAUSAL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int lq, int lk, float scale,
                   cudaStream_t stream) {
  auto kernel = flash_attn_fwd_kernel<D, CAUSAL>;
  constexpr int smem = smem_bytes<D>();
  static bool raised[64] = {};
  cudaError_t err = hhost::allow_smem(kernel, smem, raised);
  if (err != cudaSuccess) return err;
  const int n_qt = (lq + BM - 1) / BM;
  const long long blocks = (long long)bh * n_qt;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)blocks), NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), lq, lk, n_qt, scale);
  return cudaGetLastError();
}

template <int D, bool CAUSAL>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, void* lse, int bh, int lq, int lk,
                         float scale, cudaStream_t stream) {
  using S = WgSmem<D>;
  auto kernel = flash_attn_fwd_wgmma_kernel<D, CAUSAL>;
  static bool raised[64] = {};
  cudaError_t err = hhost::allow_smem(kernel, S::ALLOC, raised);
  if (err != cudaSuccess) return err;
  const int n_qt = (lq + WG_BM - 1) / WG_BM;
  const long long blocks = (long long)bh * n_qt;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  hhost::EncodeTiled fn;
  err = hhost::encode_tiled(&fn);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  CUresult res = hhost::encode_bf16(fn, &tq, q, bh, lq, D, S::DH, WG_BM);
  if (res == CUDA_SUCCESS)
    res = hhost::encode_bf16(fn, &tk, k, bh, lk, D, S::DH, WG_BN);
  if (res == CUDA_SUCCESS)
    res = hhost::encode_bf16(fn, &tv, v, bh, lk, D, S::DH, WG_BN);
  if (res != CUDA_SUCCESS) return static_cast<cudaError_t>(res);
  kernel<<<dim3((unsigned)blocks), WG_NT, S::ALLOC, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse), lq, lk,
      n_qt, scale);
  return cudaGetLastError();
}

// fp32 inputs: the mma.sync kernel
template <bool CAUSAL>
cudaError_t dispatch_fp32(int d, const void* q, const void* k, const void* v,
                          void* o, void* lse, int bh, int lq, int lk,
                          float scale, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<16, CAUSAL>(q, k, v, o, lse, bh, lq, lk, scale, stream);
    case 32:
      return launch<32, CAUSAL>(q, k, v, o, lse, bh, lq, lk, scale, stream);
    case 64:
      return launch<64, CAUSAL>(q, k, v, o, lse, bh, lq, lk, scale, stream);
    case 128:
      return launch<128, CAUSAL>(q, k, v, o, lse, bh, lq, lk, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// bf16 inputs: the wgmma kernel at every head dim the wrapper takes
template <bool CAUSAL>
cudaError_t dispatch_bf16(int d, const void* q, const void* k, const void* v,
                          void* o, void* lse, int bh, int lq, int lk,
                          float scale, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch_wgmma<16, CAUSAL>(q, k, v, o, lse, bh, lq, lk, scale,
                                      stream);
    case 32:
      return launch_wgmma<32, CAUSAL>(q, k, v, o, lse, bh, lq, lk, scale,
                                      stream);
    case 64:
      return launch_wgmma<64, CAUSAL>(q, k, v, o, lse, bh, lq, lk, scale,
                                      stream);
    case 128:
      return launch_wgmma<128, CAUSAL>(q, k, v, o, lse, bh, lq, lk, scale,
                                       stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q and o are [bh, lq, d], k and v
// [bh, lk, d], lse fp32 [bh, lq]; q, k and v must be 16-byte aligned
// (cp.async, TMA).  Returns a cudaError_t value, or the CUDA driver API's
// CUresult when a tensor map cannot be encoded.
extern "C" int mxtt_flash_attn_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int bh, int lq, int lk,
                                   int d, int dtype, int causal, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) {
    err = causal ? dispatch_fp32<true>(d, q, k, v, o, lse, bh, lq, lk, scale,
                                       s)
                 : dispatch_fp32<false>(d, q, k, v, o, lse, bh, lq, lk, scale,
                                        s);
  } else if (dtype == 1) {
    err = causal ? dispatch_bf16<true>(d, q, k, v, o, lse, bh, lq, lk, scale,
                                       s)
                 : dispatch_bf16<false>(d, q, k, v, o, lse, bh, lq, lk, scale,
                                        s);
  }
  return static_cast<int>(err);
}

extern "C" const char* mxtt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
