// wgmma.cuh — Hopper's warpgroup matrix multiply (wgmma) from inline PTX,
// for kernels compiled for sm_90a: the shared-memory matrix descriptor of
// a 128-byte-swizzled K-major bf16 tile, the fences, and
// wgmma.mma_async m64nNk16 (bf16 x bf16 -> fp32, both operands in shared
// memory, both K-major) for N = 8, 16, 32, 64 and 128; and the form with
// A in registers and B MN-major in shared memory (MmaRS, N = 64 and 128,
// with its descriptor desc_sw128_mn), below.
//
// The tile layout the descriptor describes (CUTLASS's SW128 K-major atom):
// row r of the tile (a row of M or N) holds 64 bf16 values of k in 128
// bytes at byte r * 128, and its 16-byte chunk c (values 8c .. 8c + 7)
// lies at chunk c ^ (r % 8).  Eight rows make a 1024-byte atom; the tile
// must start on a 1024-byte boundary, because the hardware applies the
// swizzle to the address bits.  The k16 slice j (0..3) of such a tile is
// the descriptor of its start plus 32 j bytes (`advance`).
//
// Order of operations around a product:
//   generic stores to the tiles (st.shared, cp.async), then
//   fence_proxy_async() by every thread that stored, then __syncthreads(),
//   then fence(), the mma_async calls, commit(), and wait<N>() before the
//   accumulators are read or the tiles are overwritten.
// fence_operands() after wait<N>() keeps the compiler from reading the
// accumulator registers before the products land in them.  Registers
// that a product reads (accumulators, MmaRS's A) and that plain
// instructions wrote since the last product need a fence() before it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wgmma {

// byte offset of 16-byte chunk c (0..7) of row r in a swizzled tile
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// descriptor of a K-major bf16 tile with 128-byte swizzled rows: start
// address >> 4 (bits 0-13), leading byte offset 16 B (bits 16-29; unused
// by a swizzled K-major layout), stride byte offset 1024 B between
// 8-row atoms (bits 32-45), swizzle mode 1 = 128 B (bits 62-63)
__device__ __forceinline__ uint64_t desc_sw128(const void* smem) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// the descriptor of k16 slice j of the tile
__device__ __forceinline__ uint64_t advance(uint64_t desc, int j) {
  return desc + static_cast<uint64_t>(2 * j);    // 32 bytes, in 16 B units
}

// make this thread's generic-proxy shared-memory writes visible to the
// async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x N, fp32, in registers) = a (64 x 16) . b (N x 16)^T, plus d
// where scale_d is not 0; a and b given by descriptors.  Register i of a thread in warp w (0..3) of the
// warpgroup, lane l, holds row 16 w + l / 4 + 8 ((i / 2) % 2), column
// 8 (i / 4) + 2 (l % 4) + i % 2.
template <int N> struct Mma;

template <> struct Mma<8> {
  static constexpr int kRegs = 4;
  static __device__ __forceinline__ void run(int scale_d, float (&d)[4], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3},"
        " %4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct Mma<16> {
  static constexpr int kRegs = 8;
  static __device__ __forceinline__ void run(int scale_d, float (&d)[8], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7},"
        " %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct Mma<32> {
  static constexpr int kRegs = 16;
  static __device__ __forceinline__ void run(int scale_d, float (&d)[16], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15},"
        " %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct Mma<64> {
  static constexpr int kRegs = 32;
  static __device__ __forceinline__ void run(int scale_d, float (&d)[32], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31},"
        " %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <> struct Mma<128> {
  static constexpr int kRegs = 64;
  static __device__ __forceinline__ void run(int scale_d, float (&d)[64], uint64_t a,
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63},"
        " %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// ---- A from registers, B MN-major ------------------------------------ //
//
// desc_sw128_mn describes a B tile (k rows x N columns) stored MN-major
// with 128-byte swizzle, CUTLASS's SW128 MN-major atom: k row r of an
// atom holds 64 bf16 values of N in 128 bytes at byte r * 128, its
// 16-byte chunk c (N values 8c .. 8c + 7) at chunk c ^ (r % 8); an atom
// is 8 k rows x 64 N values, 1024 bytes, starting on a 1024-byte
// boundary.  Atoms along k lie 1024 bytes apart (the stride byte offset),
// atoms along N `lbo` bytes apart (the leading byte offset): a tile
// whose 64-wide column blocks are stored one after another, each of
// `rows` k rows, has lbo = rows * 128.  This is the layout a TMA box of
// 64 values x rows with 128-byte swizzle writes.  The k16 slice j of the
// tile starts 16 rows = 2048 bytes further (`advance_mn`).
__device__ __forceinline__ uint64_t desc_sw128_mn(const void* smem,
                                                  uint32_t lbo) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// the MN-major descriptor of k16 slice j (16 rows further)
__device__ __forceinline__ uint64_t advance_mn(uint64_t desc, int j) {
  return desc + static_cast<uint64_t>(128 * j);  // 2048 bytes, in 16 B
}

// d (64 x N, fp32) = a (64 x 16, bf16, in registers) . b (16 x N), plus d
// where scale_d is not 0; b by an MN-major descriptor (imm-trans-b 1).
// a's registers are those of an mma.sync m16n8k16 A fragment, a warp's
// 16 rows each: thread l of warp w holds in a[0] row 16 w + l / 4,
// columns 2 (l % 4) and + 1 (low half first), a[1] the same columns of
// row + 8, a[2] and a[3] columns + 8.  That is the accumulator layout of
// Mma<N> above for the columns 16 j .. 16 j + 15: registers 8 j .. 8 j + 7
// of an S = Q K^T product, packed pairwise to bf16, are the A operand of
// slice j of the next product (P V), with no shuffle and no shared
// memory.  d's registers are laid out as Mma<N>'s.
template <int N> struct MmaRS;

template <> struct MmaRS<64> {
  static constexpr int kRegs = 32;
  static __device__ __forceinline__ void run(int scale_d, float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31},"
        " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <> struct MmaRS<128> {
  static constexpr int kRegs = 64;
  static __device__ __forceinline__ void run(int scale_d, float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63},"
        " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

}  // namespace wgmma
