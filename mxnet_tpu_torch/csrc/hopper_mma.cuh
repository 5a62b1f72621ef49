// Warp-level tensor-core products and asynchronous tile copies for the
// Hopper kernels of this package (sm_90a).
//
// Products run on mma.sync m16n8k8 TF32 for fp32 K2 and K3, accumulating
// in fp32 (fp32 K1 and every bf16 kernel run on wgmma, hopper_wgmma.cuh;
// fp32 K1 splits its operands with `split` below).  An fp32 product is
// taken at fp32 accuracy in three TF32 passes: each operand is split as
// x = big + small, with big = x rounded to TF32 to nearest, ties away
// (what cvt.rna.tf32.f32 gives), and small = x - big, exact in fp32, then
// cut to TF32 toward zero; big*big + big*small + small*big is accumulated.
// The dropped small*small term is at most 2^-22 of the product and the cut
// of each operand's small part at most 2^-21 (2^-22 if it were rounded to
// nearest too): the same order, three decades under what one TF32 pass
// loses.  Rounding small to nearest costs one integer add more a split and
// made K2 and K3 about a fifth slower on the H100 (PERF.md), so small is
// cut.  Big is rounded in integer ops (add half a TF32 ulp to the bit
// pattern, clear the 13 low bits), which run faster than the cvt
// instruction.
//
// Fragments follow PTX's mma layouts.  In a warp, lane = 4*g + t
// (g = lane / 4, t = lane % 4); an m16n8 accumulator holds
//   c[0] = (g, 2t)   c[1] = (g, 2t+1)   c[2] = (g+8, 2t)   c[3] = (g+8, 2t+1).
// The tf32 A fragment holds columns t and t+4, not 2t and 2t+1, so an
// accumulator does not line up with the A operand of the next product.
// The sum over k does not care about the order of k, so an accumulator is
// taken as an A operand with k permuted inside each 8-column chunk (slot t
// is column 2t, slot t+4 is column 2t+1), and the B operand of that
// product is loaded with the same permutation (`load_b`).
//
// Shared-memory tiles are row-major with rows padded by 16 bytes (4
// floats), which keeps every fragment load below free of bank conflicts
// and every row 16-byte aligned for cp.async and ldmatrix.  pack_bf16
// rounds two accumulator values into the register A operand of the wgmma
// kernels' products.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hmma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// ---------------------------------------------------------------------------
// fragments
// ---------------------------------------------------------------------------

// fp32 operands, each split into its TF32 big and small parts
struct FragA32 {
  uint32_t hi[4], lo[4];
};
struct FragB32 {
  uint32_t hi[2], lo[2];
};

template <typename T>
struct Frag;
template <>
struct Frag<float> {
  using A = FragA32;
  using B = FragB32;
  static constexpr int K = 8;  // depth of one mma
};

// elements of padding at the end of each shared-memory row (16 bytes)
template <typename T>
__host__ __device__ constexpr int row_pad() {
  return 16 / (int)sizeof(T);
}

constexpr uint32_t TF32_MASK = 0xffffe000u;  // sign, exponent, 10 mantissa

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & TF32_MASK;
  lo = __float_as_uint(x - __uint_as_float(hi)) & TF32_MASK;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// four 8-row x 16-byte matrices from shared memory: lane l gives the
// address of row l % 8 of matrix l / 8 and gets word t of row g of each
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// A: rows r0 + (g, g+8) and the k chunk at column k0 of a row-major [M][K]
// tile with row stride st
__device__ __forceinline__ void load_a(FragA32& a, const float* s, int st,
                                       int r0, int k0) {
  const int l = threadIdx.x & 31, m = l >> 3;
  uint32_t r[4];
  ldsm_x4(r, s + (r0 + (l & 7) + (m & 1) * 8) * st + k0 + (m >> 1) * 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) split(__uint_as_float(r[i]), a.hi[i], a.lo[i]);
}

// B = tile^T for a row-major [N][K] tile, for the two n tiles at n0 and
// n0 + 8 and the k chunk at column k0 (the key tile of q k^T)
__device__ __forceinline__ void load_bt2(FragB32& b0, FragB32& b1,
                                         const float* s, int st, int n0,
                                         int k0) {
  const int l = threadIdx.x & 31, m = l >> 3;
  uint32_t r[4];
  ldsm_x4(r, s + (n0 + (l & 7) + (m >> 1) * 8) * st + k0 + (m & 1) * 4);
  split(__uint_as_float(r[0]), b0.hi[0], b0.lo[0]);
  split(__uint_as_float(r[1]), b0.hi[1], b0.lo[1]);
  split(__uint_as_float(r[2]), b1.hi[0], b1.lo[0]);
  split(__uint_as_float(r[3]), b1.hi[1], b1.lo[1]);
}

// B = tile for a row-major [K][N] tile: the k chunk from row k0, n columns
// from n0 (the key tile of ds k), k in the permuted order of a_from_c:
// slot t is row k0 + 2t, slot t+4 is row k0 + 2t + 1.
__device__ __forceinline__ void load_b(FragB32& b, const float* s, int st,
                                       int k0, int n0) {
  const float* p = s + (k0 + 2 * lane_t()) * st + n0 + lane_g();
  split(p[0], b.hi[0], b.lo[0]);
  split(p[st], b.hi[1], b.lo[1]);
}

// A from accumulators: k chunk kc of a 16 x N accumulator tile c[N/8][4]
template <int NJ>
__device__ __forceinline__ void a_from_c(FragA32& a, const float (&c)[NJ][4],
                                         int kc) {
  split(c[kc][0], a.hi[0], a.lo[0]);  // (g, 2t)     -> slot (g, t)
  split(c[kc][2], a.hi[1], a.lo[1]);  // (g+8, 2t)   -> slot (g+8, t)
  split(c[kc][1], a.hi[2], a.lo[2]);  // (g, 2t+1)   -> slot (g, t+4)
  split(c[kc][3], a.hi[3], a.lo[3]);  // (g+8, 2t+1) -> slot (g+8, t+4)
}

// ---------------------------------------------------------------------------
// products: d += a b
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the three-pass fp32 product, small terms first
__device__ __forceinline__ void mma(float (&d)[4], const FragA32& a,
                                    const FragB32& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// ---------------------------------------------------------------------------
// asynchronous copies (cp.async)
// ---------------------------------------------------------------------------

// 16 bytes from global to shared memory; zeros when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes from global to shared memory; zero when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// rows [row0, row0 + ROWS) of a row-major [rows, D] matrix into a tile of
// row stride D + row_pad<T>(), by all NT threads; rows past the end read
// as zeros
template <int ROWS, int D, int NT, typename T>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src,
                                                int row0, int rows) {
  constexpr int ST = D + row_pad<T>();
  constexpr int CHUNKS = D * (int)sizeof(T) / 16;  // 16-byte pieces a row
  constexpr int PER = 16 / (int)sizeof(T);         // elements a piece
  for (int e = threadIdx.x; e < ROWS * CHUNKS; e += NT) {
    const int r = e / CHUNKS, c = (e % CHUNKS) * PER;
    const bool valid = row0 + r < rows;
    cp_async16(dst + r * ST + c,
               src + (size_t)(valid ? row0 + r : 0) * D + c, valid);
  }
}

}  // namespace hmma
