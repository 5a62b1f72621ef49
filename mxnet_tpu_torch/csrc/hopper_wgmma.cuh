// Hopper's asynchronous building blocks for the kernels of this package
// (sm_90a): warpgroup products (wgmma), the tensor memory accelerator
// (TMA) and the transaction barriers (mbarrier) that tie them together.
//
// wgmma.  Four warps (a warpgroup, 128 threads) issue one product of a
// 64-row A and an N-column B, 16 deep in bf16, accumulated in fp32
// registers.  B always comes from shared memory through a matrix
// descriptor; A either does too (the SS form) or comes from registers (the
// RS form).  The accumulator of an m64nNk16 product gives warp w of the
// group rows 16w + g and 16w + g + 8 (lane = 4g + t) and, in each 8-wide
// chunk j, columns 8j + 2t and 8j + 2t + 1:
//   d[4j] = (g, 2t)   d[4j+1] = (g, 2t+1)   d[4j+2] = (g+8, 2t)
//   d[4j+3] = (g+8, 2t+1)
// which is the quad layout of mma.sync's m16n8 accumulator, warp by warp.
// The RS form's A registers are each warp's m16n8k16 A fragment of its 16
// rows (a[0] = (g, 2t..2t+1), a[1] = (g+8, ..), a[2] = (g, 2t+8..),
// a[3] = (g+8, 2t+8..)), so two neighbouring n8 chunks of one product's
// accumulator, rounded to bf16, are the A operand of the next.  Products
// run asynchronously: `fence` before the first one that reads registers
// written since, `commit` closes a group, `wait<N>` returns when at most N
// groups are in flight, and only then may their registers be read.
//
// tf32 products (fp32 K1's three passes) are m64nNk8: 8 deep, 32 bytes of
// a row as bf16's 16 are.  Both operands must be K-major: the transpose
// bits exist only for 16-bit types.  The RS form's A registers are each
// warp's m16n8k8 tf32 A fragment (a[0] = (g, t), a[1] = (g+8, t),
// a[2] = (g, t+4), a[3] = (g+8, t+4)), mma.sync's; the hardware reads an
// operand's top 19 bits.
//
// Descriptors.  Tiles lie in shared memory as TMA writes them with a
// swizzle of S = 32, 64 or 128 bytes: rows of S bytes (S / 2 bf16
// columns), 8 rows to a swizzle atom of 8·S bytes, each 16-byte piece of
// row r stored at piece index (piece ^ (r % 8)) for 128 B, (piece ^
// ((r % 8) / 2)) for 64 B, (piece ^ ((r % 8) / 4)) for 32 B.  The hardware
// swizzles on the address bits, so every tile starts on a 1024-byte
// boundary and the descriptors' base offset stays 0.
//   * K-major (A, and a B stored [N][K]): the 16 columns of one product
//     lie inside a row; the stride byte offset (SBO) steps from one 8-row
//     group to the next (8·S bytes) and the leading byte offset is unused
//     (1).  The next 16 columns of the same swizzled row: the start
//     address plus 32 bytes.
//   * MN-major (a B stored [K][N], read with the transpose bit): a row
//     holds S / 2 consecutive n for one k; SBO steps from one group of 8
//     k to the next (8·S bytes) and LBO from one S / 2-wide column block
//     to the next, which no product here needs (each B is one block wide).
//     The next 16 k: the start address plus 16·S bytes.
//
// TMA.  One thread asks for a whole box of a tensor described by a
// CUtensorMap (built on the host, passed by value as a __grid_constant__
// kernel parameter); the hardware writes it swizzled into shared memory,
// fills what lies past the tensor's end with zeros, and counts the bytes
// onto an mbarrier.  A box is taken from a rank-3 map [outer][rows][cols],
// so a box past the end of one (b, h)'s rows reads zeros, never the next
// one's rows.  fp32 rows [b·h][L] (the backward's lse, delta and dlse)
// come through a rank-1 map over all b·h·L values, which takes any L: a
// box that runs past one (b, h)'s rows reads the next one's, which the
// kernel masks, and zeros past the last.
//
// mbarrier.  A barrier completes a phase when its expected arrivals have
// arrived and the bytes announced by `arrive_expect_tx` have landed;
// `wait(bar, parity)` returns once the phase of that parity (completion
// number c has parity c % 2) is over.

#pragma once

#include <cuda.h>
#include <stdint.h>

namespace hwg {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the other threads and to the
// asynchronous proxy (TMA); a __syncthreads follows
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// one arrival that also announces ``bytes`` to land before the phase ends
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// until the phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// the barriers of a ring of ``stages`` stages at ``bars``: one for the
// tiles loaded once (1 arrival), full[stages] (the producer's arrival) and
// empty[stages] (``consumers`` arrivals), initialised by thread 0 before a
// __syncthreads
__device__ __forceinline__ void init_ring_barriers(uint64_t* bars,
                                                   int stages,
                                                   int consumers) {
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);
    for (int i = 0; i < stages; ++i) {
      mbar_init(bars + 1 + i, 1);
      mbar_init(bars + 1 + stages + i, consumers);
    }
    mbar_fence_init();
  }
  __syncthreads();
}

// the block's dynamic shared memory from its first 1024-byte boundary (the
// 128-byte swizzle's atom)
__device__ __forceinline__ unsigned char* align_1024(unsigned char* raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
}

// whether this thread is in the producer warp that follows ``consumers``
// consumer threads, by a test the compiler sees as warp-uniform (a branch
// it cannot prove uniform serializes the consumers' wgmma: C7518)
__device__ __forceinline__ bool producer_warp(int consumers) {
  return __shfl_sync(0xffffffffu, threadIdx.x / consumers, 0) != 0;
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// the box at (c0 columns, c1 rows, c2 outer) of ``map`` into ``dst``,
// its bytes counted onto ``bar``
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// the box at element c0 of the rank-1 ``map`` into ``dst`` (128-byte
// aligned), its bytes counted onto ``bar``
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// descriptor layout types, by swizzle width in bytes
__host__ __device__ constexpr int swizzle_layout(int bytes) {
  return bytes == 128 ? 1 : bytes == 64 ? 2 : 3;
}

// a shared-memory matrix descriptor: start address, leading and stride
// byte offsets (all in 16-byte units), base offset 0, layout type
__device__ __forceinline__ uint64_t make_desc(const void* smem, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return (uint64_t)((smem_addr(smem) & 0x3ffff) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32) |
         ((uint64_t)layout << 62);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous product: a no-op that claims to read and write
// each of them
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= a b for a 64 x 16 A and a 16 x 32 B both read from shared
// memory through descriptors, both K-major
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= a b for a 64 x 16 A and a 16 x 64 B both read from shared
// memory through descriptors, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= a b for a 64 x 16 A from registers (the m16n8k16 A fragment of
// each warp's 16 rows) and a 16 x 16 B read from shared memory MN-major
// (transposed)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// d (+)= a b for a 64 x 16 A from registers (the m16n8k16 A fragment of
// each warp's 16 rows) and a 16 x 32 B read from shared memory MN-major
// (transposed)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// d (+)= a b for a 64 x 16 A from registers (the m16n8k16 A fragment of
// each warp's 16 rows) and a 16 x 64 B read from shared memory MN-major
// (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// the SS product of N columns (32 or 64), both operands K-major
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate) {
  static_assert(N == 32 || N == 64, "an SS product of 32 or 64 columns");
  if constexpr (N == 64) {
    wgmma_ss_n64(d, a, b, accumulate);
  } else {
    wgmma_ss_n32(d, a, b, accumulate);
  }
}

// d += a b, the RS product of N columns (16, 32 or 64) with B read
// MN-major
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  static_assert(N == 16 || N == 32 || N == 64,
                "an RS product of 16, 32 or 64 columns");
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, b, 1);
  } else if constexpr (N == 32) {
    wgmma_rs_n32(d, a, b, 1);
  } else {
    wgmma_rs_n16(d, a, b, 1);
  }
}

// d (+)= a b for a 64 x 8 A and an 8 x 32 B, both tf32 read from shared
// memory through descriptors, both K-major
__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[16], uint64_t a,
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= a b for a 64 x 8 A and an 8 x 64 B, both tf32 read from shared
// memory through descriptors, both K-major
__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[32], uint64_t a,
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= a b for a 64 x 8 tf32 A from registers (the m16n8k8 tf32 A
// fragment of each warp's 16 rows) and an 8 x 16 tf32 B read from shared
// memory, K-major
__device__ __forceinline__ void wgmma_tf32_rs_n16(float (&d)[8],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// d (+)= a b for a 64 x 8 tf32 A from registers (the m16n8k8 tf32 A
// fragment of each warp's 16 rows) and an 8 x 32 tf32 B read from shared
// memory, K-major
__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// d (+)= a b for a 64 x 8 tf32 A from registers (the m16n8k8 tf32 A
// fragment of each warp's 16 rows) and an 8 x 64 tf32 B read from shared
// memory, K-major
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// d (+)= a b for a 64 x 8 tf32 A from registers (the m16n8k8 tf32 A
// fragment of each warp's 16 rows) and an 8 x 128 tf32 B read from shared
// memory, K-major
__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}


// the tf32 SS product of N columns (32 or 64)
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t a,
                                              uint64_t b, int accumulate) {
  static_assert(N == 32 || N == 64, "a tf32 SS product of 32 or 64 columns");
  if constexpr (N == 64) {
    wgmma_tf32_ss_n64(d, a, b, accumulate);
  } else {
    wgmma_tf32_ss_n32(d, a, b, accumulate);
  }
}

// the tf32 RS product of N columns (16, 32, 64 or 128)
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128,
                "a tf32 RS product of 16, 32, 64 or 128 columns");
  if constexpr (N == 128) {
    wgmma_tf32_rs_n128(d, a, b, accumulate);
  } else if constexpr (N == 64) {
    wgmma_tf32_rs_n64(d, a, b, accumulate);
  } else if constexpr (N == 32) {
    wgmma_tf32_rs_n32(d, a, b, accumulate);
  } else {
    wgmma_tf32_rs_n16(d, a, b, accumulate);
  }
}

// orders this thread's shared-memory accesses before later accesses by
// the asynchronous proxy (wgmma's operand reads, TMA's writes)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// named barrier ``id`` (1-15; 0 is __syncthreads) over ``threads`` threads
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// byte offset ``off`` (from a 1024-byte boundary, as TMA writes with a
// swizzle of ROW bytes: 32, 64 or 128) moved to where the swizzle puts it:
// the 16-byte piece index XORed with the 128-byte line index
template <int ROW>
__device__ __forceinline__ int swizzle(int off) {
  static_assert(ROW == 32 || ROW == 64 || ROW == 128, "a TMA swizzle width");
  return off ^ (((off >> 7) & (ROW / 16 - 1)) << 4);
}

// 2^x to about 2 ulp (ex2.approx; 0 for -inf and for large negative x)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace hwg
