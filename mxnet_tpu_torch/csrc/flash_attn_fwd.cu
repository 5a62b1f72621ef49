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
// type has a kernel of its own, both on wgmma fed by TMA through mbarrier
// rings (hopper_wgmma.cuh, tensor maps from hopper_host.cuh):
//   * fp32: at BERT's L = 512, D = 64 the work is far above the card's
//     ridge, so it is bound by the product rate.  Each product runs in
//     three TF32 passes over split operands (hopper_mma.cuh's rule), which
//     keeps fp32-level accuracy at up to 495/3 TFLOP/s: 0.0390 ms at
//     [96, 512, 64].
//   * bf16: the products run at 989 TFLOP/s, and at [8, 12, 512, 64] the
//     bound is the bytes moved (0.0076 ms).
//
// fp32 design.  A block is WGS consumer warpgroups of 64 query rows each
// (2 at D <= 64, 1 at D = 128) and one splitter warpgroup:
//   * The splitter's thread 0 loads the Q tile once by TMA, then each raw
//     K and V tile (BN keys: 64, 32 at D = 128) into one raw buffer.  Its
//     128 threads split Q, times the scale (as the TPU kernel scales q),
//     once in place into its TF32 big and small parts, then split each raw
//     tile into a ring stage (TF_STAGES = 2) once the consumers have freed
//     it: K's big and small parts in the layout TMA wrote (rows of 32
//     floats, 128-byte swizzle; 16 floats and 64 bytes at D = 16), and
//     V^T's parts, [D][keys], which `split_vt` transposes.  A named
//     barrier over the splitters frees the raw buffer for the next tile's
//     load and completes the stage's full barrier.  So each tile is split
//     once for the block, by threads that issue no products; the split
//     rule is hopper_mma.cuh's (big rounded to nearest, ties away; small
//     cut toward zero), so the CPU emulations in the tests describe it.
//   * s = q k^T: per 8 columns of D, three wgmma m64nBNk8 .tf32 products
//     with both operands in shared memory (Q's parts and K's, both
//     K-major), small terms first as hmma::mma takes them.  The
//     accumulator gives each warp 16 rows in mma.sync's quad layout, so the
//     causal mask (-1e30) and keys past lk (-inf) are applied in
//     registers, a row's max takes two quad shuffles, and each lane keeps
//     its own part of the row sum, added up once at the end.  q was scaled
//     before the split, so m is kept in base 2 with
//     p = exp2(fma(s, log2 e, -m)) for any sign of the scale.
//   * p v: a tf32 wgmma reads B only K-major (the transpose bit exists
//     only for 16-bit types), so V^T's parts are the B operand and p's
//     parts the register A operand, split from the s accumulator: the
//     tf32 A fragment holds columns t and t + 4 where the accumulator
//     holds 2t and 2t + 1, so split_vt stores each 8 keys in that order
//     (hmma::a_from_c's permutation, applied to V^T once by the
//     splitter).  Every PV_KEYS = SUM_CHUNKS * 8 keys of p v are summed
//     in an accumulator of their own (scale-d 0 on the first product) and
//     added to acc in fp32: the tensor cores truncate as they accumulate,
//     and an O summed inside them over the whole sequence drifts toward
//     zero, which the training step's gradients showed (PERF.md).
//   * Each warpgroup runs q k^T, the softmax and p v of a tile in turn;
//     the two warpgroups of a block share the tensor cores, one's softmax
//     under the other's products.  Causal: a block walks the key tiles up
//     to its last row, and a warpgroup skips (but still frees) the tiles
//     past its own.
//   * Sizes.  Shared memory per block: Q's two parts (2 * BM * D * 4
//     bytes), two stages of four parts (BN * D * 4 bytes each), the raw K
//     and V tiles, 7 barriers and 1 KB to align the tiles: 230,456 bytes
//     at D = 64 and at D = 128, 115,768 at D = 32, 58,424 at D = 16; one
//     block an SM (__launch_bounds__(NT, 1): 384 threads at D <= 64, at
//     most 168 registers a thread; ptxas takes 156 at D = 64, 218 at
//     D = 128 with its 256 threads, no spill and no serialized wgmma).  At
//     [96, 512, 64]: 96 (b, h) pairs x 4 blocks of 128 query rows = 384
//     blocks on 132 SMs, 2.91 waves.
//   * Measured on the H100 and dropped (PERF.md, tools/torch_k1_ab.py):
//     Q's parts in registers (RS q k^T, setmaxnreg 40/232) ran 5 % slower;
//     the two warpgroups taking turns at the tensor cores on named
//     barriers (FlashAttention-3's ping-pong) ran 1.95x slower with a
//     wait for p v's first sum inside the turn, and 1.13-1.16x slower
//     with whole turns of products (tile it + 1's q k^T and tile it's
//     p v, p v's two sums in accumulators of their own, the softmax under
//     them, setmaxnreg 40/232 or 56/224: 96 or 4 bytes spilled); that
//     deferred p v alone, at D = 128, ran 1.07x slower; the next
//     tile's q k^T issued under this tile's softmax (two score buffers)
//     spilled at 168 registers and ran 1.37x slower; the second warpgroup
//     started a tile behind the first changed nothing; splitter loops
//     with addresses taken at run time ran 8 % slower than these
//     unrolled ones.  The other route for p v, O^T = V^T p^T with p's
//     parts in shared memory as B and V^T's in registers, was not built:
//     p's parts take 32 KB a warpgroup beyond the 225 KB the tiles fill,
//     and every consumer would load V^T's fragments, once per warpgroup
//     and not once per block.
//   * Any Lq and Lk: rows past a ragged Lq read TMA's zeros and are not
//     stored; keys past lk read zeros and score -inf.
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

constexpr float MASKED = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// fp32: 8-key chunks of p v summed in the tensor cores before each fp32
// add into O (the kernel's acc += p v step).  On the H100, sums of 4 such
// chunks kept the training gradients as close to the unfused graph's as
// sums of 1 did, and sums of 8 let them drift (PERF.md).
constexpr int SUM_CHUNKS = 4;

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA through an mbarrier ring
// ---------------------------------------------------------------------------

constexpr int WG_BM = 64;          // query rows of a block: one wgmma's M
constexpr int WG_BN = 64;          // keys of a K/V tile: one wgmma's N
constexpr int WG_STAGES = 2;       // K/V stages in the ring
constexpr int WG_CONSUMERS = 128;  // the consumer warpgroup's threads
constexpr int WG_NT = WG_CONSUMERS + 32;  // and the producer warp

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
// fp32: three-pass TF32 wgmma fed by TMA, each tile split once for the block
// ---------------------------------------------------------------------------

constexpr int TF_STAGES = 2;              // split K/V stages in the ring
constexpr int PV_KEYS = SUM_CHUNKS * 8;   // keys of one p v sum
constexpr int TF_SPLITTERS = 128;         // the splitter warpgroup's threads

// a block's shape and shared memory at head dim D: the parts of Q, then
// TF_STAGES stages of four parts (K big, K small, V^T big, V^T small),
// then the raw K and V tiles as TMA writes them, then the barriers; every
// part starts on a 1024-byte boundary (the swizzle's atom)
template <int D>
struct TfCfg {
  static constexpr int WGS = D == 128 ? 1 : 2;      // consumer warpgroups
  static constexpr int BM = 64 * WGS;               // query rows of a block
  static constexpr int BN = D == 128 ? 32 : 64;     // keys of a tile
  static constexpr int NT = 128 * WGS + TF_SPLITTERS;
  static constexpr int ROW = D >= 32 ? 128 : 4 * D;  // bytes of a Q/K row
  static constexpr int DC = ROW / 4;                 // columns of a block
  static constexpr int CB = D / DC;                  // column blocks
  static constexpr int Q_BYTES = BM * D * 4;  // one part of Q
  static constexpr int T_BYTES = BN * D * 4;  // one part of a K or V tile
  static constexpr int QLO = Q_BYTES;         // Q's small part (big at 0)
  static constexpr int RING = 2 * Q_BYTES;
  static constexpr int RAW = RING + 4 * TF_STAGES * T_BYTES;
  static constexpr int BARS = RAW + 2 * T_BYTES;
  static constexpr int NBARS = 3 + 2 * TF_STAGES;
  static constexpr int ALLOC = BARS + NBARS * 8 + 1024;
};

// four fp32 values split into their TF32 big and small parts
__device__ __forceinline__ void split4(const float4& x, uint4& hi, uint4& lo) {
  hmma::split(x.x, hi.x, lo.x);
  hmma::split(x.y, hi.y, lo.y);
  hmma::split(x.z, hi.z, lo.z);
  hmma::split(x.w, hi.w, lo.w);
}

// N 16-byte pieces of ``src`` (times ``scale`` when SCALED) split into
// their big parts at ``hi`` (which may be ``src``) and small parts at
// ``lo``, at the same offsets: the layout TMA wrote stays the layout the
// descriptors read.  N is a multiple of the splitters' 128, so each
// thread's pieces are known at compile time.
template <int N, bool SCALED>
__device__ __forceinline__ void split_pieces(const unsigned char* src,
                                             unsigned char* hi,
                                             unsigned char* lo, float scale,
                                             int tid) {
  static_assert(N % TF_SPLITTERS == 0, "whole rounds of pieces");
  const float4* x4 = reinterpret_cast<const float4*>(src) + tid;
  uint4* h4 = reinterpret_cast<uint4*>(hi) + tid;
  uint4* l4 = reinterpret_cast<uint4*>(lo) + tid;
#pragma unroll
  for (int i = 0; i < N / TF_SPLITTERS; ++i) {
    float4 x = x4[i * TF_SPLITTERS];
    if (SCALED) {
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    uint4 h, l;
    split4(x, h, l);
    h4[i * TF_SPLITTERS] = h;
    l4[i * TF_SPLITTERS] = l;
  }
}

// the raw V tile, [BN keys][D] in column blocks of ROW-byte rows as TMA
// wrote it, split into V^T's big and small parts: [D][BN keys], K-major
// for p v's B operand, 128-byte rows of 32 keys (one block of D rows per
// 32 keys, 128-byte swizzle), and inside each 8 keys position s holds key
// 2s (s < 4) or 2(s - 4) + 1, the order p's A fragments take them in.
// A unit is 4 keys 8j + odd + {0, 2, 4, 6} of one column d, written as
// one 16-byte piece; thread tid takes column d = tid % D (D divides the
// 128 splitters) and units jh = tid / D + (128 / D) i, so its addresses
// are fixed but for compile-time steps.  Lanes walk d, so a warp reads
// whole key rows and writes 16 bytes to each of 8 rows a phase: no bank
// conflicts either way.
template <int D, int BN, int ROW>
__device__ __forceinline__ void split_vt(const unsigned char* v,
                                         unsigned char* hi, unsigned char* lo,
                                         int tid) {
  constexpr int DC = ROW / 4, STEP = TF_SPLITTERS / D;
  static_assert(TF_SPLITTERS % D == 0, "D divides the splitters");
  const int d = tid % D, jh0 = tid / D;
  const unsigned char* block = v + (d / DC) * BN * ROW;
  const int c = (d % DC) * 4;
#pragma unroll
  for (int i = 0; i < D * BN / 4 / TF_SPLITTERS; ++i) {
    const int jh = jh0 + STEP * i;  // 2 * (8-key chunk) + odd keys
    const int key = 8 * (jh >> 1) + (jh & 1);
    float4 x;
    x.x = *reinterpret_cast<const float*>(
        block + hwg::swizzle<ROW>((key + 0) * ROW + c));
    x.y = *reinterpret_cast<const float*>(
        block + hwg::swizzle<ROW>((key + 2) * ROW + c));
    x.z = *reinterpret_cast<const float*>(
        block + hwg::swizzle<ROW>((key + 4) * ROW + c));
    x.w = *reinterpret_cast<const float*>(
        block + hwg::swizzle<ROW>((key + 6) * ROW + c));
    const int pos = 4 * jh;  // the first of the four positions
    const int off =
        hwg::swizzle<128>((pos / 32) * D * 128 + d * 128 + (pos % 32) * 4);
    uint4 h, l;
    split4(x, h, l);
    *reinterpret_cast<uint4*>(hi + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(TfCfg<D>::NT, 1)
flash_attn_fwd_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           float* __restrict__ o, float* __restrict__ lse,
                           int lq, int lk, int n_qt, float scale) {
  using C = TfCfg<D>;
  constexpr int BN = C::BN, ROW = C::ROW, DC = C::DC, CB = C::CB;
  constexpr int LAYOUT = hwg::swizzle_layout(ROW);
  constexpr uint32_t SBO = 8 * ROW;  // from one 8-row group to the next
  constexpr int VT_LAYOUT = hwg::swizzle_layout(128);
  constexpr int CONSUMERS = 128 * C::WGS;
  constexpr float MASKED2 = MASKED * LOG2E;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = hwg::align_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + C::BARS);
  uint64_t* q_ready = q_full + 1;
  uint64_t* raw_full = q_full + 2;
  uint64_t* full = q_full + 3;
  uint64_t* empty = full + TF_STAGES;
  // part 0: K's big part, 1: K's small part, 2 and 3: V^T's, of stage st
  auto part = [&](int st, int i) {
    return smem + C::RING + (4 * st + i) * C::T_BYTES;
  };
  unsigned char* raw = smem + C::RAW;

  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * C::BM;
  // causal: keys past this block's last query row contribute nothing
  const int k_end = CAUSAL ? min(lk, min(q0 + C::BM, lq)) : lk;
  const int n_kt = (k_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    hwg::mbar_init(q_full, 1);
    hwg::mbar_init(q_ready, 1);
    hwg::mbar_init(raw_full, 1);
    for (int i = 0; i < TF_STAGES; ++i) {
      hwg::mbar_init(&full[i], 1);
      hwg::mbar_init(&empty[i], CONSUMERS);
    }
    hwg::mbar_fence_init();
  }
  __syncthreads();

  // warpgroups 0..WGS-1 consume, the last splits (a warp-uniform test)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == C::WGS) {
    // the splitter: its thread 0 loads Q once and each raw K/V tile as
    // soon as the tile before it is split; all 128 split Q once and each
    // tile into a stage once the consumers have freed it (completion
    // it / TF_STAGES - 1 of its empty barrier)
    const int tid = threadIdx.x - CONSUMERS;
    auto load_raw = [&](int it) {
      hwg::mbar_arrive_expect_tx(raw_full, 2 * C::T_BYTES);
      for (int c = 0; c < CB; ++c) {
        hwg::tma_load_3d(raw + c * BN * ROW, &tk, raw_full, c * DC, it * BN,
                         bh);
        hwg::tma_load_3d(raw + C::T_BYTES + c * BN * ROW, &tv, raw_full,
                         c * DC, it * BN, bh);
      }
    };
    if (tid == 0) {
      hwg::mbar_arrive_expect_tx(q_full, C::Q_BYTES);
      for (int c = 0; c < CB; ++c)
        hwg::tma_load_3d(smem + c * C::BM * ROW, &tq, q_full, c * DC, q0, bh);
      if (n_kt > 0) load_raw(0);
    }
    hwg::mbar_wait(q_full, 0);
    split_pieces<C::Q_BYTES / 16, true>(smem, smem, smem + C::QLO, scale,
                                        tid);
    hwg::fence_proxy_async();
    hwg::named_sync(1, TF_SPLITTERS);
    if (tid == 0) hwg::mbar_arrive(q_ready);
    for (int it = 0; it < n_kt; ++it) {
      const int st = it % TF_STAGES;
      hwg::mbar_wait(raw_full, it & 1);
      if (it >= TF_STAGES)
        hwg::mbar_wait(&empty[st], (it / TF_STAGES + 1) & 1);
      split_pieces<C::T_BYTES / 16, false>(raw, part(st, 0), part(st, 1),
                                           1.f, tid);
      split_vt<D, BN, ROW>(raw + C::T_BYTES, part(st, 2), part(st, 3), tid);
      // the parts are written before wgmma reads them, and the raw tile
      // read before TMA overwrites it
      hwg::fence_proxy_async();
      hwg::named_sync(1, TF_SPLITTERS);
      if (tid == 0) {
        hwg::mbar_arrive(&full[st]);
        if (it + 1 < n_kt) load_raw(it + 1);
      }
    }
    return;
  }

  // a consumer warpgroup: warp w owns rows r0 + 16w + (g, g + 8)
  const int warp = (threadIdx.x / 32) % 4;
  const int g = hmma::lane_g(), t = hmma::lane_t();
  const int r0 = q0 + wg * 64;
  const int row0 = r0 + warp * 16 + g;
  // causal: this warpgroup's rows see no key tile past their last row
  const int n_own =
      CAUSAL ? (min(lk, min(r0 + 64, lq)) + BN - 1) / BN : n_kt;
  const unsigned char* qhi = smem + wg * 64 * ROW;
  const unsigned char* qlo = qhi + C::QLO;

  float s[BN / 2];
  float acc[D / 2], pv[D / 2];
  uint32_t ph[BN / 8][4], pl[BN / 8][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  // per row of this lane's two: the running max (base 2) and this lane's
  // share of the running sum
  float m_row[2] = {MASKED2, MASKED2}, l_row[2] = {0.f, 0.f};

  // issue s = (scale q) k^T on stage st: per 8 columns, small terms first
  auto qk = [&](int st) {
    const unsigned char* khi = part(st, 0);
    const unsigned char* klo = part(st, 1);
    hwg::fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const int c = kk * 8 / DC, off = (kk * 8 % DC) * 4;
      const int qa = c * C::BM * ROW + off, ka = c * BN * ROW + off;
      const uint64_t a_hi = hwg::make_desc(qhi + qa, 16, SBO, LAYOUT);
      const uint64_t a_lo = hwg::make_desc(qlo + qa, 16, SBO, LAYOUT);
      const uint64_t b_hi = hwg::make_desc(khi + ka, 16, SBO, LAYOUT);
      const uint64_t b_lo = hwg::make_desc(klo + ka, 16, SBO, LAYOUT);
      hwg::wgmma_tf32_ss<BN>(s, a_lo, b_hi, kk > 0);
      hwg::wgmma_tf32_ss<BN>(s, a_hi, b_lo, 1);
      hwg::wgmma_tf32_ss<BN>(s, a_hi, b_hi, 1);
    }
    hwg::commit();
  };
  // issue pv = p v alone over keys PV_KEYS * c.. of stage st (scale-d 0
  // on its first product): per 8 keys, small terms first
  auto pv_sum = [&](int st, int c) {
    const unsigned char* vhi = part(st, 2);
    const unsigned char* vlo = part(st, 3);
    hwg::fence();
#pragma unroll
    for (int jj = 0; jj < PV_KEYS / 8; ++jj) {
      const int j = c * (PV_KEYS / 8) + jj;
      const int off = (j / 4) * D * 128 + (j % 4) * 32;
      const uint64_t b_hi = hwg::make_desc(vhi + off, 16, 1024, VT_LAYOUT);
      const uint64_t b_lo = hwg::make_desc(vlo + off, 16, 1024, VT_LAYOUT);
      hwg::wgmma_tf32_rs<D>(pv, pl[j], b_hi, jj > 0);
      hwg::wgmma_tf32_rs<D>(pv, ph[j], b_lo, 1);
      hwg::wgmma_tf32_rs<D>(pv, ph[j], b_hi, 1);
    }
    hwg::commit();
  };

  hwg::mbar_wait(q_ready, 0);
  for (int it = 0; it < n_kt; ++it) {
    const int st = it % TF_STAGES;
    hwg::mbar_wait(&full[st], (it / TF_STAGES) & 1);
    if (it < n_own) {
      const int k0 = it * BN;
      qk(st);
      hwg::wait<0>();
      hwg::fence_regs(s);
      // masks (only where this warp's rows meet the diagonal or the tile
      // passes lk), the tile's row max, alpha, p in place of s and its
      // row sums.  q was scaled before the product, so s is the scaled
      // score: m is kept in base 2 and p = exp2(fma(s, log2 e, -m)).
      const bool edge =
          (CAUSAL && k0 + BN - 1 > r0 + warp * 16) || k0 + BN > lk;
      float mx[2] = {-INFINITY, -INFINITY}, alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[4 * j + e];
          if (edge) {
            const int row = row0 + 8 * (e >> 1);
            const int col = k0 + j * 8 + 2 * t + (e & 1);
            if (CAUSAL && col > row) x = MASKED;
            if (col >= lk) x = -INFINITY;  // past the last key: weight 0
          }
          s[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_row[h], mx[h] * LOG2E);
        alpha[h] = hwg::exp2_approx(m_row[h] - m_new);
        m_row[h] = m_new;
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        s[i] = hwg::exp2_approx(fmaf(s[i], LOG2E, -m_row[(i >> 1) & 1]));
        sum[(i >> 1) & 1] += s[i];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l_row[h] = l_row[h] * alpha[h] + sum[h];
      // p's parts as the A fragments of p v: 8-key chunk j, slot t is key
      // 2t and slot t + 4 key 2t + 1 (hmma::a_from_c's order)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        hmma::split(s[4 * j], ph[j][0], pl[j][0]);
        hmma::split(s[4 * j + 2], ph[j][1], pl[j][1]);
        hmma::split(s[4 * j + 1], ph[j][2], pl[j][2]);
        hmma::split(s[4 * j + 3], ph[j][3], pl[j][3]);
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      // acc += p v, each PV_KEYS keys summed alone and added in fp32, so
      // that O carries no drift toward zero (the design's note on p v)
#pragma unroll
      for (int c = 0; c < BN / PV_KEYS; ++c) {
        pv_sum(st, c);
        hwg::wait<0>();
        hwg::fence_regs(pv);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] += pv[i];
      }
    }
    hwg::mbar_arrive(&empty[st]);
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
      float* orow = o + ((size_t)bh * lq + r) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        store2(orow + j * 8 + 2 * t, acc[4 * j + 2 * h2] / l,
               acc[4 * j + 2 * h2 + 1] / l);
      if (t == 0) lse[(size_t)bh * lq + r] = m_row[h2] * LN2 + logf(l);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

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

template <int D, bool CAUSAL>
cudaError_t launch_tf32(const void* q, const void* k, const void* v, void* o,
                        void* lse, int bh, int lq, int lk, float scale,
                        cudaStream_t stream) {
  using C = TfCfg<D>;
  auto kernel = flash_attn_fwd_tf32_kernel<D, CAUSAL>;
  static bool raised[64] = {};
  cudaError_t err = hhost::allow_smem(kernel, C::ALLOC, raised);
  if (err != cudaSuccess) return err;
  const int n_qt = (lq + C::BM - 1) / C::BM;
  const long long blocks = (long long)bh * n_qt;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  hhost::EncodeTiled fn;
  err = hhost::encode_tiled(&fn);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  CUresult res = hhost::encode_f32(fn, &tq, q, bh, lq, D, C::DC, C::BM);
  if (res == CUDA_SUCCESS)
    res = hhost::encode_f32(fn, &tk, k, bh, lk, D, C::DC, C::BN);
  if (res == CUDA_SUCCESS)
    res = hhost::encode_f32(fn, &tv, v, bh, lk, D, C::DC, C::BN);
  if (res != CUDA_SUCCESS) return static_cast<cudaError_t>(res);
  kernel<<<dim3((unsigned)blocks), C::NT, C::ALLOC, stream>>>(
      tq, tk, tv, static_cast<float*>(o), static_cast<float*>(lse), lq, lk,
      n_qt, scale);
  return cudaGetLastError();
}

// fp32 inputs: the three-pass TF32 wgmma kernel
template <bool CAUSAL>
cudaError_t dispatch_fp32(int d, const void* q, const void* k, const void* v,
                          void* o, void* lse, int bh, int lq, int lk,
                          float scale, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch_tf32<16, CAUSAL>(q, k, v, o, lse, bh, lq, lk, scale,
                                     stream);
    case 32:
      return launch_tf32<32, CAUSAL>(q, k, v, o, lse, bh, lq, lk, scale,
                                     stream);
    case 64:
      return launch_tf32<64, CAUSAL>(q, k, v, o, lse, bh, lq, lk, scale,
                                     stream);
    case 128:
      return launch_tf32<128, CAUSAL>(q, k, v, o, lse, bh, lq, lk, scale,
                                      stream);
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
// (TMA).  Returns a cudaError_t value, or the CUDA driver API's
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
