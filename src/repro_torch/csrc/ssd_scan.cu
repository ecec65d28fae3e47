// ssd_scan.cu — the Mamba-2 SSD chunked scan with a carried fp32 state,
// for Hopper (compiled for sm_90a), with a plain C entry point for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan_bhsp
// and computes the function of src/repro/models/ssm.py::ssd_chunked on
// the model layout: x (bt, s, h, p) pre-discretized (x * dt), dt_a
// (bt, s, h), b and c (bt, s, n) shared by all heads, an optional
// initial state (bt, h, p, n).  Per (row, head), for each chunk of q
// positions in order:
//   acs = cumsum(dt_a)                         (over the chunk, in fp64)
//   y   = ((C·Bᵀ) ⊙ L) x + (C · stateᵀ) ⊙ exp(acs),
//         L[i,j] = exp(acs_i - acs_j) for i >= j, else 0
//   state <- state * exp(acs_last) + xᵀ (B ⊙ exp(acs_last - acs))
// y is written at x's dtype; the final state in fp32.  With a states
// pointer (training's forward) each block also stores its slice of the
// state entering every chunk, (bt, s / q, h, p, n) fp32, at the chunk's
// first sub-chunk: what the backward (ssd_scan_bwd.cu) reads.  Serving
// and prefill pass nullptr and run an instantiation without the store
// (kStates false), so they pay nothing for it.
//
// What bounds it.  At the serving shape (q = 256, p = 64, n = 128, 80
// heads, x fp32, b / c bf16) the function moves 16 MB and needs about 2
// GFLOP, held to fp32 accuracy (atol 2e-4 at |y| ~ 30).  The fp32 CUDA
// cores would take 40 us for that; the tensor cores' TF32 (10-bit
// mantissa) alone misses the tolerance 55x, so each product with an fp32
// operand is split: v = hi + lo, hi = cvt.rna.tf32(v), lo =
// cvt.rna.tf32(v - hi), and a·b = a_hi·b_hi + a_hi·b_lo + a_lo·b_hi
// (three mma.sync.m16n8k8 TF32; two where one operand is exact in TF32,
// as bf16 b / c are).  C·Bᵀ with bf16 b / c is exact products on
// mma.sync.m16n8k16 bf16.  The products sum straight into their fp32
// accumulators: the tensor cores' truncating accumulation leaves y within
// 4e-5 of the plain version at 8 chunks (a fresh sum a k step was 1.5e-5,
// and 11% slower).  What is left bounds it: latency.  Two blocks of 8
// warps an SM, each sub-chunk a chain of dependent products behind
// shared-memory fragment loads and two barriers; the tensor cores run at
// a small share of their rate.
//
// What the design does:
//   * sub-chunks.  A chunk is scanned in sub-chunks of kR = 64 rows with
//     the state carried between them: y_i = C_i·Bᵀ ⊙ L x over the
//     sub-chunk + exp(acs_i - acs_base) C_i · stateᵀ, where the state
//     already holds the chunk's earlier sub-chunks and acs_base is acs at
//     the end of the previous sub-chunk (0 at a chunk's start).  That is
//     the chunk's function (the same acs, the same decays) with a q x q
//     quadratic part cut to q x 64, and each tile of B, C and x is read
//     once per chunk and used by every product of its sub-chunk;
//   * a block per (row, head, slice of p).  The slices of p are
//     independent recurrences sharing B, C and dt_a, so splitting p
//     needs no communication; the wrapper's plan() chooses the slice
//     width PW (16, 32 or 64) so the grid fills the card (160 blocks of
//     PW 32, two an SM, at the serving shape) and passes it here;
//   * the fp32 state slice (PW x n) stays in shared memory across all
//     chunks, never in device memory;
//   * copies.  One thread issues the next sub-chunk's B, C and x tiles as
//     TMA boxes (kR rows x 128 bytes, swizzled 128B) into the second
//     stage while the block works on the current one; 16-byte cp.async
//     from every thread stalled each warp ~4k cycles a sub-chunk, and one
//     cp.async.bulk a row took a producer warp ~11k.  A fragment's
//     address in the swizzled tile is a base each lane computes once XOR
//     the chunk of k, so it costs one instruction.  Warp 0 loads dt_a of
//     the next sub-chunk into registers, scans it in fp64 (a warp scan of
//     shuffles, continuing the chunk's running fp64 sum) and writes acs,
//     exp(acs_end - acs_j) and exp(acs_i - acs_base) beside the stage;
//   * 8 warps, a pair a row group of 16 rows.  Each warp of a pair forms
//     G = C·Bᵀ over half the row group's causal 8-column tiles (ldmatrix
//     of C and B), S = G ⊙ L in the accumulator registers, which are
//     exactly the A fragments of S·x once the k index of a fragment runs
//     (2t, 2t+1) instead of (t, t + 4) (any order of k is the same sum),
//     and the partial S·x over all the slice's columns; it forms C·stᵀ
//     for half the columns from the same C fragments.  The pair swaps the
//     partial sums of each other's columns through shared memory.  The
//     causal loads are paired on a sub-partition (rows 0-15 with 48-63,
//     16-31 with 32-47).  Then each warp forms its tile of xᵀ(B ⊙ w) (B
//     by ldmatrix.trans) and, after a barrier, folds it into the state:
//     state = state * exp(acs_end - acs_base) + tile;
//   * the state slice's rows are padded so its fragment reads hit
//     distinct banks; the swizzle does that for the boxes;
//   * L is selected, never multiplied by a mask: above the diagonal
//     exp(acs_i - acs_j) can be inf.
// Left for later: C·Bᵀ is formed again by every slice of p and every
// head (a block over a group of heads would share it); the split of the
// state and of x is redone by every warp that reads them; 16 warps an
// SM leave the chain of each sub-chunk exposed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kR = 64;             // rows of a sub-chunk
constexpr int kMaxP = 64;          // head_dim limit
constexpr int kMaxN = 128;         // ssm_state limit
constexpr int kMaxChunk = 1024;
constexpr int kStages = 2;
constexpr int kScal = 3 * kR + 4;  // acs, w, eoff of a sub-chunk, dec
constexpr int kSmemLimit = 232448;

// shared memory, from a 1024-byte boundary: kStages stages of B, C and
// x tiles in TMA boxes of kR rows x 128 bytes swizzled 128B (B and C
// across kMaxN columns, n padded; x across the slice, at least a box);
// the scalars of each stage; the fp32 state slice (rows of kMaxN + 8,
// padded for conflict-free fragments); the warp pairs' partial sums (8
// warps x pw / 16 8-column tiles x 128 floats); an mbarrier a stage
constexpr int kBox = kR * 128;     // bytes of a TMA box

struct Layout {
  int bc_tile, x_off, x_boxes, stage_bytes, sc_off, st_off, st_stride,
      xch_off, bar_off, total;
};

__host__ __device__ inline Layout layout(int pw, int bc_elt, int x_elt) {
  Layout l;
  l.bc_tile = kR * kMaxN * bc_elt;   // B at 0, C at bc_tile, x at x_off
  l.x_off = 2 * l.bc_tile;
  l.x_boxes = (pw * x_elt + 127) / 128;
  l.stage_bytes = l.x_off + l.x_boxes * kBox;
  l.sc_off = kStages * l.stage_bytes;
  l.st_off = l.sc_off + kStages * kScal * 4;
  l.st_stride = kMaxN + 8;
  l.xch_off = l.st_off + pw * l.st_stride * 4;
  l.bar_off = l.xch_off + 8 * (pw / 16) * 128 * 4;
  l.total = l.bar_off + kStages * 8 + 1024;   // + alignment to 1024
  return l;
}

// byte offset of byte cb of row r in a tile of boxes of kR rows x 128
// bytes, swizzled 128B: the 16-byte chunk of a row XOR the row mod 8.
// With the tile on 1024 bytes, chunk c of a fragment's row is the row's
// chunk-0 address XOR (c << 4): a load's address is one XOR away from a
// base each lane computes once.
__device__ __forceinline__ int swz(int r, int cb) {
  return (cb >> 7) * kBox + r * 128 + ((((cb >> 4) & 7) ^ (r & 7)) << 4) +
         (cb & 15);
}

struct Params {
  CUtensorMap tb, tc, tx;   // TMA maps of b, c (2-D) and x (4-D), with vec
  const void* x;
  const float* dt_a;
  const void* b;
  const void* c;
  const float* h0;
  void* y;
  float* state;
  float* states;   // (bt, s / q, h, p, n) entering states, or nullptr
  int s, h, p, n, q, splits, vec;
};

// ---- numbers ---------------------------------------------------------- //

template <typename T>
constexpr bool kExact = sizeof(T) == 2;   // bf16 is exact in TF32

__device__ __forceinline__ uint32_t tf32(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(f));
  return r;
}

// hi = tf32(v), lo = tf32(v - hi); an exact v is its own hi
template <bool kEx>
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  if (kEx) {
    hi = __float_as_uint(v);
    lo = 0u;
  } else {
    hi = tf32(v);
    lo = tf32(v - __uint_as_float(hi));
  }
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a·b for bf16 a (16 x 16) and b (16 x 8), exact products
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a·b in split TF32: the small terms first, then hi·hi
template <bool kExA, bool kExB>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  if (!kExB) mma(d, ah, bl[0], bl[1]);
  if (!kExA) mma(d, al, bh[0], bh[1]);
  mma(d, ah, bh[0], bh[1]);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// four (two) 8 x 8 bf16 matrices at shared address a, lane l giving the
// address of row l % 8 of matrix l / 8; each thread gets (row g, columns
// 2t, 2t + 1) of each, or with .trans (rows 2t, 2t + 1, column g), as
// one register
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}

__device__ __forceinline__ float lds_f32(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}

// fp32 x tile: the shared address of (row 8 J + 2t + e, column 8 np + g)
// is (xbase(e) ^ ((np % 4) << 5)) + (np / 4) kBox + 1024 J: row 2t + e of
// the box, the lane's byte of its chunk, the chunk (g / 4) XOR the
// row's swizzle; 8 np columns further is chunk 2 np further
__device__ __forceinline__ uint32_t xbase(const void* x_t, int e) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  return tma::smem_addr(x_t) + (2 * t + e) * 128 + 4 * (g & 3) +
         ((((g >> 2) ^ (2 * t + e)) & 7) << 4);
}

// elements (r, k) and (r, k + 1) of a B or C tile of T, k even
template <typename T>
__device__ __forceinline__ void bc_pair(const unsigned char* tile, int r,
                                        int k, float& v0, float& v1) {
  if constexpr (sizeof(T) == 2) {
    const uint32_t w =
        *reinterpret_cast<const uint32_t*>(tile + swz(r, 2 * k));
    v0 = __uint_as_float(w << 16);
    v1 = __uint_as_float(w & 0xffff0000u);
  } else {
    const float2 v = *reinterpret_cast<const float2*>(tile + swz(r, 4 * k));
    v0 = v.x;
    v1 = v.y;
  }
}

// element (r, c) of a B or C tile of T
template <typename T>
__device__ __forceinline__ float bc_elem(const unsigned char* tile, int r,
                                         int c) {
  return to_f32(*reinterpret_cast<const T*>(
      tile + swz(r, c * static_cast<int>(sizeof(T)))));
}

// elements (r, k) and (r, k + 1) of the fp32 state slice, k even
__device__ __forceinline__ void st_pair(const float* st_s, int stride, int r,
                                        int k, float& v0, float& v1) {
  const float2 v = *reinterpret_cast<const float2*>(st_s + r * stride + k);
  v0 = v.x;
  v1 = v.y;
}

__device__ __forceinline__ void store2(float* p, float v0, float v1,
                                       bool both) {
  if (both) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    p[0] = v0;
  }
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1,
                                       bool both) {
  if (both) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    p[0] = __float2bfloat16(v0);
  }
}

// ---- copies ----------------------------------------------------------- //

// the element copies of a tile that TMA cannot take (rows off 16
// bytes), by the whole block, in TMA's layout: `rows` rows of `cols`
// valid elements of W from src (row stride `ld`); the rest of the kR x W
// tile is zero
template <int W, typename T>
__device__ __forceinline__ void stage_swz(unsigned char* dst, const T* src,
                                          size_t ld, int rows, int cols) {
  for (int e = threadIdx.x; e < kR * W; e += kThreads) {
    const int r = e / W, col = e - r * W;
    *reinterpret_cast<T*>(dst + swz(r, col * static_cast<int>(sizeof(T)))) =
        (r < rows && col < cols) ? src[r * ld + col] : T(0.f);
  }
}

// ---- the sub-chunk's scalars (warp 0) ---------------------------------- //

// dt_a of the sub-chunk's rows 2*lane and 2*lane + 1 (0 past its `rows`)
// -> acs (the chunk's prefix sum, carried in fp64 in `run`), w =
// exp(acs_end - acs), eoff = exp(acs - base) and dec = exp(acs_end -
// base); rows past the sub-chunk get acs_end, so every exponent stays
// finite, and w = 0, so what a stage holds there never reaches the state
__device__ __forceinline__ void scalars(float v0, float v1, int rows,
                                        double& run, float& base,
                                        float* sc) {
  const int lane = threadIdx.x & 31;
  const double d0 = v0, d1 = d0 + static_cast<double>(v1);
  double incl = d1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0;
  const double total = __shfl_sync(0xffffffffu, incl, 31);
  const double pre = run + excl;
  const float a0 = static_cast<float>(pre + d0);
  const float a1 = static_cast<float>(pre + d1);
  run += total;
  const float end = static_cast<float>(run);
  *reinterpret_cast<float2*>(sc + 2 * lane) = make_float2(a0, a1);
  *reinterpret_cast<float2*>(sc + kR + 2 * lane) =
      make_float2(2 * lane < rows ? __expf(end - a0) : 0.f,
                  2 * lane + 1 < rows ? __expf(end - a1) : 0.f);
  *reinterpret_cast<float2*>(sc + 2 * kR + 2 * lane) =
      make_float2(__expf(a0 - base), __expf(a1 - base));
  if (lane == 0) sc[3 * kR] = expf(end - base);
  base = end;
}

// ---- the kernel -------------------------------------------------------- //

// the 64 threads of a pair of warps wait for each other (barrier `id`)
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// y of rows [i0, i0 + 16) of the slice, one warp of the row group's pair
// (ph 0 or 1; i0 = 16 rg): G = C·Bᵀ over its half of the NJ causal
// 8-column tiles, S = G ⊙ L in the accumulators and S·x over all PW
// columns (a partial sum); C·stᵀ over its half of the columns, in the
// same pass over k as G.  The pair swaps the partial sums of each
// other's columns through xch, and each warp writes y = S·x (both
// halves of j) + eoff ⊙ C·stᵀ for its columns [ph PW/2, (ph + 1) PW/2).
template <typename TX, typename TBC, int PW, int NJ>
__device__ __forceinline__ void y_rows(const unsigned char* b_t,
                                       const unsigned char* c_t,
                                       const unsigned char* x_t,
                                       const float* st_s,
                                       const float* sc, float* xch,
                                       const Layout& L, int rg, int ph,
                                       int rows, int pv, TX* out, size_t ld,
                                       bool vec) {
  constexpr bool kExBC = kExact<TBC>, kExX = kExact<TX>;
  constexpr int kNPY = PW / 16;   // 8-column tiles of y this warp writes
  constexpr int kNP = PW / 8;     // 8-column tiles of the slice
  constexpr int kNJH = NJ / 2;    // the causal 8-column tiles it takes
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int i0 = 16 * rg, yc0 = ph * (PW / 2), jt0 = ph * kNJH;
  float gacc[kNJH][4], yo[kNPY][4], yd[kNP][4];
#pragma unroll
  for (int jj = 0; jj < kNJH; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) gacc[jj][e] = 0.f;
#pragma unroll
  for (int np = 0; np < kNPY; ++np)
#pragma unroll
    for (int e = 0; e < 4; ++e) yo[np][e] = 0.f;
#pragma unroll
  for (int np = 0; np < kNP; ++np)
#pragma unroll
    for (int e = 0; e < 4; ++e) yd[np][e] = 0.f;

  if constexpr (kExBC) {
    // bf16 b / c: G on mma.m16n8k16.bf16 from ldmatrix: lane l gives row
    // l % 16 of C's rows at k + 8 (l / 16), and row 8 (l / 16) + l % 8 of
    // two j-tiles of B at k + 8 ((l / 8) % 2), each as its chunk-0 address
    // XOR the swizzle of that row, then XOR the chunk of k.  Each register
    // of C's A fragment also holds two TF32 values (its halves) for
    // C·stᵀ's two k steps.
    const uint32_t c_base = tma::smem_addr(c_t) + (i0 + (lane & 15)) * 128 +
                            ((((lane >> 4) ^ lane) & 7) << 4);
    const uint32_t b_base =
        tma::smem_addr(b_t) +
        (8 * jt0 + 8 * (lane >> 4) + (lane & 7)) * 128 +
        (((((lane >> 3) & 1) ^ lane) & 7) << 4);
#pragma unroll 1
    for (int ks = 0; ks < kMaxN; ks += 16) {
      const uint32_t sw = ((ks >> 3) & 7) << 4, box = (ks >> 6) * kBox;
      uint32_t ca[4];
      ldsm_x4(ca, (c_base ^ sw) + box);
#pragma unroll
      for (int jj = 0; jj + 1 < kNJH; jj += 2) {
        uint32_t bb[4];
        ldsm_x4(bb, (b_base ^ sw) + box + jj * 1024);
        mma_bf16(gacc[jj], ca, bb[0], bb[1]);
        mma_bf16(gacc[jj + 1], ca, bb[2], bb[3]);
      }
      if constexpr (kNJH % 2 == 1) {
        uint32_t bb[2];
        ldsm_x2(bb, (b_base ^ sw) + box + (kNJH - 1) * 1024);
        mma_bf16(gacc[kNJH - 1], ca, bb[0], bb[1]);
      }
      const int k = ks + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t lo_row = ca[2 * half], hi_row = ca[2 * half + 1];
        const uint32_t ah[4] = {lo_row << 16, hi_row << 16,
                                lo_row & 0xffff0000u, hi_row & 0xffff0000u};
#pragma unroll
        for (int np = 0; np < kNPY; ++np) {
          float sv0, sv1;
          st_pair(st_s, L.st_stride, yc0 + 8 * np + g, k + 8 * half, sv0,
                  sv1);
          uint32_t bh[2], bl[2];
          split<false>(sv0, bh[0], bl[0]);
          split<false>(sv1, bh[1], bl[1]);
          mma3<true, false>(yo[np], ah, ah, bh, bl);
        }
      }
    }
  } else {
#pragma unroll 2
    for (int ks = 0; ks < kMaxN; ks += 8) {
      const int k = ks + 2 * t;
      float cv[4];
      bc_pair<TBC>(c_t, i0 + g, k, cv[0], cv[2]);
      bc_pair<TBC>(c_t, i0 + g + 8, k, cv[1], cv[3]);
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split<false>(cv[e], ah[e], al[e]);
#pragma unroll
      for (int jj = 0; jj < kNJH; ++jj) {
        float bv0, bv1;
        bc_pair<TBC>(b_t, 8 * (jt0 + jj) + g, k, bv0, bv1);
        uint32_t bh[2], bl[2];
        split<false>(bv0, bh[0], bl[0]);
        split<false>(bv1, bh[1], bl[1]);
        mma3<false, false>(gacc[jj], ah, al, bh, bl);
      }
#pragma unroll
      for (int np = 0; np < kNPY; ++np) {
        float sv0, sv1;
        st_pair(st_s, L.st_stride, yc0 + 8 * np + g, k, sv0, sv1);
        uint32_t bh[2], bl[2];
        split<false>(sv0, bh[0], bl[0]);
        split<false>(sv1, bh[1], bl[1]);
        mma3<false, false>(yo[np], ah, al, bh, bl);
      }
    }
  }

  const int r0 = i0 + g, r1 = r0 + 8;
  const float ai0 = sc[r0], ai1 = sc[r1];
  const uint32_t xb0 = xbase(x_t, 0), xb1 = xbase(x_t, 1);
#pragma unroll
  for (int jj = 0; jj < kNJH; ++jj) {
    const int j = 8 * (jt0 + jj) + 2 * t;
    const float2 aj = *reinterpret_cast<const float2*>(sc + j);
    // select, never multiply by the mask: above the diagonal the
    // exponent is positive and can overflow
    const float s0 = j <= r0 ? gacc[jj][0] * __expf(ai0 - aj.x) : 0.f;
    const float s1 = j + 1 <= r0 ? gacc[jj][1] * __expf(ai0 - aj.y) : 0.f;
    const float s2 = j <= r1 ? gacc[jj][2] * __expf(ai1 - aj.x) : 0.f;
    const float s3 = j + 1 <= r1 ? gacc[jj][3] * __expf(ai1 - aj.y) : 0.f;
    // accumulator (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1) is the A
    // fragment (g, t), (g, t+4), (g+8, t), (g+8, t+4) with k t at column
    // 2t and k t + 4 at 2t + 1
    uint32_t ah[4], al[4];
    split<false>(s0, ah[0], al[0]);
    split<false>(s2, ah[1], al[1]);
    split<false>(s1, ah[2], al[2]);
    split<false>(s3, ah[3], al[3]);
#pragma unroll
    for (int np = 0; np < kNP; ++np) {
      float x0, x1;
      if constexpr (sizeof(TX) == 4) {
        const uint32_t off = (np >> 2) * kBox + 1024 * (jt0 + jj);
        x0 = lds_f32((xb0 ^ ((np & 3) << 5)) + off);
        x1 = lds_f32((xb1 ^ ((np & 3) << 5)) + off);
      } else {
        x0 = bc_elem<TX>(x_t, j, 8 * np + g);
        x1 = bc_elem<TX>(x_t, j + 1, 8 * np + g);
      }
      uint32_t bh[2], bl[2];
      split<kExX>(x0, bh[0], bl[0]);
      split<kExX>(x1, bh[1], bl[1]);
      mma3<false, kExX>(yd[np], ah, al, bh, bl);
    }
  }

  // swap the partial sums: the partner's columns out, this warp's in
  float* mine = xch + (2 * rg + ph) * (kNPY * 128) + 4 * lane;
  const float* theirs = xch + (2 * rg + (ph ^ 1)) * (kNPY * 128) + 4 * lane;
  // (selects, not an index by ph: that would put yd in local memory)
#pragma unroll
  for (int i = 0; i < kNPY; ++i) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = ph ? yd[i][e] : yd[kNPY + i][e];
    *reinterpret_cast<float4*>(mine + 128 * i) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
  pair_sync(1 + rg);
  // y = y_diag + exp(acs_i - acs_base) C·stᵀ
  const float e0 = sc[2 * kR + r0], e1 = sc[2 * kR + r1];
#pragma unroll
  for (int i = 0; i < kNPY; ++i) {
    const float4 o = *reinterpret_cast<const float4*>(theirs + 128 * i);
    const float oe[4] = {o.x, o.y, o.z, o.w};
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = (ph ? yd[kNPY + i][e] : yd[i][e]) + oe[e];
    const int col = yc0 + 8 * i + 2 * t;
    if (col >= pv) continue;
    const bool both = col + 1 < pv && vec;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r1 : r0;
      if (r >= rows) continue;
      const float ee = half ? e1 : e0;
      TX* dst = out + static_cast<size_t>(r) * ld + col;
      const float v0 = v[2 * half] + yo[i][2 * half] * ee;
      const float v1 = v[2 * half + 1] + yo[i][2 * half + 1] * ee;
      store2(dst, v0, v1, both);
      if (!both && col + 1 < pv) store2(dst + 1, v1, v1, false);
    }
  }
}

// this warp's tile of xᵀ (B ⊙ w): rows [pr - g, pr - g + 16) of the
// slice, PW / 8 8-column tiles from ncol0
template <typename TX, typename TBC, int PW>
__device__ __forceinline__ void state_tile(const unsigned char* b_t,
                                           const unsigned char* x_t,
                                           const float* sc, const Layout& L,
                                           int pr, int ncol0,
                                           float (&acc)[PW / 8][4]) {
  constexpr bool kExBC = kExact<TBC>;
  const int lane = threadIdx.x & 31, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < PW / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  // fp32 x: columns pr and pr + 8 (pr = 16 pg + g) of rows 2t and 2t + 1,
  // less 8 jt rows: chunk 4 pg + 2 h + g / 4 of box pg / 2
  uint32_t xa[4];
  const int pg = (pr >> 4);
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      xa[2 * e + hh] = (xbase(x_t, e) ^ (((4 * pg + 2 * hh) & 7) << 4)) +
                       (pg >> 1) * kBox;
  // ldmatrix.trans: lane l gives row 8 jt + l % 8 of the n-tile 4 i +
  // l / 8, as its address in the swizzled tile less 8 jt rows
  constexpr int kQ = PW / 8 >= 4 ? PW / 32 : 1;
  uint32_t bq[kQ];
#pragma unroll
  for (int i = 0; i < kQ; ++i) {
    const int col = ncol0 + 8 * (4 * i + (lane >> 3));
    bq[i] = tma::smem_addr(b_t) + (col >> 6) * kBox + (lane & 7) * 128 +
            ((((col >> 3) ^ lane) & 7) << 4);
  }
#pragma unroll 2
  for (int jt = 0; jt < kR / 8; ++jt) {
    const int j = 8 * jt + 2 * t;
    const float2 w = *reinterpret_cast<const float2*>(sc + kR + j);
    float xv[4];   // x at (j, pr), (j, pr + 8), (j + 1, pr), (j + 1, pr + 8)
    if constexpr (sizeof(TX) == 4) {
#pragma unroll
      for (int e = 0; e < 4; ++e) xv[e] = lds_f32(xa[e] + 1024 * jt);
    } else {
      xv[0] = bc_elem<TX>(x_t, j, pr);
      xv[1] = bc_elem<TX>(x_t, j, pr + 8);
      xv[2] = bc_elem<TX>(x_t, j + 1, pr);
      xv[3] = bc_elem<TX>(x_t, j + 1, pr + 8);
    }
    uint32_t ah[4], al[4];
    split<false>(xv[0] * w.x, ah[0], al[0]);
    split<false>(xv[1] * w.x, ah[1], al[1]);
    split<false>(xv[2] * w.y, ah[2], al[2]);
    split<false>(xv[3] * w.y, ah[3], al[3]);
    if constexpr (kExBC) {
      // each thread gets rows (2t, 2t + 1) of column g, its B fragment
      if constexpr (PW / 8 == 2) {
        uint32_t r[2];
        ldsm_x2_t(r, bq[0] + jt * 1024);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const uint32_t bh[2] = {r[m] << 16, r[m] & 0xffff0000u};
          mma3<false, true>(acc[m], ah, al, bh, bh);
        }
      } else {
#pragma unroll
        for (int q = 0; q < PW / 8; q += 4) {
          uint32_t r[4];
          ldsm_x4_t(r, bq[q / 4] + jt * 1024);
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const uint32_t bh[2] = {r[m] << 16, r[m] & 0xffff0000u};
            mma3<false, true>(acc[q + m], ah, al, bh, bh);
          }
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < PW / 8; ++nt) {
        const int col = ncol0 + 8 * nt + lane / 4;
        uint32_t bh[2], bl[2];
        split<false>(bc_elem<TBC>(b_t, j, col), bh[0], bl[0]);
        split<false>(bc_elem<TBC>(b_t, j + 1, col), bh[1], bl[1]);
        mma3<false, false>(acc[nt], ah, al, bh, bl);
      }
    }
  }
}

// kStates: store the state entering each chunk (training's forward); the
// serving instantiations compile without the store
template <typename TX, typename TBC, int PW, bool kStates>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_scan_kernel(const __grid_constant__ Params P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kNPG = PW / 16;     // 16-row groups of the state slice
  constexpr int kNT = PW / 8;       // 8-column state tiles a warp
  const Layout L = layout(PW, sizeof(TBC), sizeof(TX));
  // TMA's 128B swizzle repeats every 1024 bytes: the tiles start on one
  unsigned char* smem =
      smem_raw + ((1024 - (tma::smem_addr(smem_raw) & 1023)) & 1023);
  float* st_s = reinterpret_cast<float*>(smem + L.st_off);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ps = blockIdx.x % P.splits, pair_id = blockIdx.x / P.splits;
  const int bi = pair_id / P.h, hi = pair_id - bi * P.h;
  const int p0 = ps * PW, pv = min(PW, P.p - p0);
  const int s = P.s, h = P.h, p = P.p, n = P.n, q = P.q;
  const TX* x = static_cast<const TX*>(P.x);
  const TBC* b = static_cast<const TBC*>(P.b);
  const TBC* c = static_cast<const TBC*>(P.c);
  const size_t row_base = static_cast<size_t>(bi) * s;

  // roles: y rows [16 rg, 16 rg + 16), columns [ph PW/2, (ph + 1) PW/2);
  // a sub-partition (warp % 4) holds row groups {0, 3} or {1, 2}
  const int rg = warp < 4 ? ((warp + 1) >> 1) & 1
                          : 3 - (((warp - 3) >> 1) & 1);
  const int ph = (warp >> 1) & 1;
  // state tile: rows [16 pg, 16 pg + 16) of the slice, kNT 8-column
  // tiles from column ncol0
  const int pg = warp % kNPG, ncol0 = (warp / kNPG) * kNT * 8;
  const int pr = 16 * pg + g;

  // the entering state (zeros without one); padding rows / columns zero
  for (int e = threadIdx.x; e < PW * kMaxN; e += kThreads) {
    const int r = e / kMaxN, k = e % kMaxN;
    st_s[r * L.st_stride + k] =
        (P.h0 != nullptr && r < pv && k < n)
            ? P.h0[(static_cast<size_t>(pair_id) * p + p0 + r) * n + k]
            : 0.f;
  }

  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bar_off);
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) tma::mbar_init(bars + st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nsc = (q + kR - 1) / kR;        // sub-chunks a chunk
  const int n_sub = (s / q) * nsc;
  auto b_tile = [&](int st) { return smem + st * L.stage_bytes; };
  auto scal = [&](int st) {
    return reinterpret_cast<float*>(smem + L.sc_off) + st * kScal;
  };
  auto rows_of = [&](int u, int& row0) {
    const int ci = u / nsc, k = u - ci * nsc;
    row0 = ci * q + k * kR;
    return min(kR, q - k * kR);
  };
  // sub-chunk u into stage st.  With vec, one thread issues the TMA boxes
  // of B, C (kR rows x 128 bytes, across kMaxN columns) and x (the
  // slice), completing on the stage's mbarrier; TMA fills what lies past
  // n, p or the sequence with zeros, and what lies past the sub-chunk
  // (the next one's rows) meets masked entries of S and w = 0.  Else the
  // whole block copies element by element.
  auto issue = [&](int u, int st) {
    int row0;
    const int rows = rows_of(u, row0);
    unsigned char* bt = b_tile(st);
    const size_t r0 = row_base + row0;
    if (P.vec) {
      if (threadIdx.x == 0) {
        constexpr int kCols = 128 / sizeof(TBC), kXCols = 128 / sizeof(TX);
        tma::mbar_expect(bars + st, L.stage_bytes);
#pragma unroll
        for (int bx = 0; bx < kMaxN / kCols; ++bx) {
          tma::tma_2d(bt + bx * kBox, &P.tb, bx * kCols,
                      static_cast<int>(r0), bars + st);
          tma::tma_2d(bt + L.bc_tile + bx * kBox, &P.tc, bx * kCols,
                      static_cast<int>(r0), bars + st);
        }
        for (int bx = 0; bx < L.x_boxes; ++bx)
          tma::tma_4d(bt + L.x_off + bx * kBox, &P.tx, p0 + bx * kXCols, hi,
                      row0, bi, bars + st);
      }
    } else {
      stage_swz<kMaxN>(bt, b + r0 * n, static_cast<size_t>(n), rows, n);
      stage_swz<kMaxN>(bt + L.bc_tile, c + r0 * n, static_cast<size_t>(n),
                       rows, n);
      stage_swz<PW>(bt + L.x_off, x + (r0 * h + hi) * p + p0,
                    static_cast<size_t>(h) * p, rows, pv);
    }
  };
  // warp 0: dt_a of sub-chunk u, rows 2 lane and 2 lane + 1
  auto load_dt = [&](int u, float& v0, float& v1) {
    int row0;
    const int rows = rows_of(u, row0);
    const float* d = P.dt_a + (row_base + row0) * h + hi;
    v0 = 2 * lane < rows ? d[static_cast<size_t>(2 * lane) * h] : 0.f;
    v1 = 2 * lane + 1 < rows ? d[static_cast<size_t>(2 * lane + 1) * h]
                             : 0.f;
  };

  double run = 0.0;
  float base = 0.f;
  issue(0, 0);
  if (warp == 0) {
    float v0, v1;
    load_dt(0, v0, v1);
    int row0;
    scalars(v0, v1, rows_of(0, row0), run, base, scal(0));
  }

  for (int u = 0; u < n_sub; ++u) {
    const int st = u & 1;
    if (P.vec) tma::mbar_wait(bars + st, (u >> 1) & 1);
    // stage u and its scalars landed, the last state update is visible,
    // and no warp reads the other stage any more
    __syncthreads();
    float nv0 = 0.f, nv1 = 0.f;
    if (u + 1 < n_sub) {
      issue(u + 1, st ^ 1);
      if (warp == 0) load_dt(u + 1, nv0, nv1);
    }
    int row0;
    const int rows = rows_of(u, row0);
    const unsigned char* b_s = b_tile(st);
    const unsigned char* c_s = b_s + L.bc_tile;
    const unsigned char* x_s = b_s + L.x_off;
    const float* sc = scal(st);

    // the state entering a chunk, for the backward: at its first
    // sub-chunk the slice holds exactly that (the barrier above made the
    // last update visible; the next update waits on the barrier below)
    if constexpr (kStates) {
      if (row0 % q == 0) {
        float* dst =
            P.states +
            ((static_cast<size_t>(bi) * (s / q) + row0 / q) * h + hi) *
                static_cast<size_t>(p) * n +
            static_cast<size_t>(p0) * n;
#pragma unroll 1
        for (int e = threadIdx.x; e < PW * kMaxN; e += kThreads) {
          const int r = e / kMaxN, k = e % kMaxN;
          if (r < pv && k < n) dst[r * n + k] = st_s[r * L.st_stride + k];
        }
      }
    }

    if (16 * rg < rows) {
      TX* out = static_cast<TX*>(P.y) + ((row_base + row0) * h + hi) * p +
                p0;
      const size_t ld = static_cast<size_t>(h) * p;
      float* xch = reinterpret_cast<float*>(smem + L.xch_off);
      switch (rg) {   // the causal 8-column tiles of the row group
        case 0:
          y_rows<TX, TBC, PW, 2>(b_s, c_s, x_s, st_s, sc, xch, L, rg, ph,
                                 rows, pv, out, ld, P.vec);
          break;
        case 1:
          y_rows<TX, TBC, PW, 4>(b_s, c_s, x_s, st_s, sc, xch, L, rg, ph,
                                 rows, pv, out, ld, P.vec);
          break;
        case 2:
          y_rows<TX, TBC, PW, 6>(b_s, c_s, x_s, st_s, sc, xch, L, rg, ph,
                                 rows, pv, out, ld, P.vec);
          break;
        default:
          y_rows<TX, TBC, PW, 8>(b_s, c_s, x_s, st_s, sc, xch, L, rg, ph,
                                 rows, pv, out, ld, P.vec);
      }
    }

    float acc[kNT][4];
    state_tile<TX, TBC, PW>(b_s, x_s, sc, L, pr, ncol0, acc);
    // every warp is done reading the state (C·stᵀ above)
    __syncthreads();
    const float dec = sc[3 * kR];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int col = ncol0 + 8 * nt + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float2* sp = reinterpret_cast<float2*>(
            st_s + (pr + 8 * half) * L.st_stride + col);
        float2 v = *sp;
        v.x = v.x * dec + acc[nt][2 * half];
        v.y = v.y * dec + acc[nt][2 * half + 1];
        *sp = v;
      }
    }
    if (warp == 0 && u + 1 < n_sub) {
      int nrow0;
      const int nrows = rows_of(u + 1, nrow0);
      if (nrow0 % q == 0) {   // a new chunk: the running sums restart
        run = 0.0;
        base = 0.f;
      }
      scalars(nv0, nv1, nrows, run, base, scal(st ^ 1));
    }
  }

  __syncthreads();
  for (int e = threadIdx.x; e < pv * n; e += kThreads) {
    const int r = e / n, k = e - r * n;
    P.state[(static_cast<size_t>(pair_id) * p + p0 + r) * n + k] =
        st_s[r * L.st_stride + k];
  }
}

template <typename TX, typename TBC, int PW, bool kStates>
int launch_k(const Params& prm, int blocks, int smem, cudaStream_t stream) {
  auto kernel = ssd_scan_kernel<TX, TBC, PW, kStates>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, smem, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TBC, int PW>
int launch(const Params& prm, int blocks, int smem, cudaStream_t stream) {
  return prm.states != nullptr
             ? launch_k<TX, TBC, PW, true>(prm, blocks, smem, stream)
             : launch_k<TX, TBC, PW, false>(prm, blocks, smem, stream);
}

template <typename TX, typename TBC>
int launch_pw(int pw, const Params& prm, int blocks, int smem,
              cudaStream_t stream) {
  if (pw == 16) return launch<TX, TBC, 16>(prm, blocks, smem, stream);
  if (pw == 32) return launch<TX, TBC, 32>(prm, blocks, smem, stream);
  return launch<TX, TBC, 64>(prm, blocks, smem, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, for x (and y) and for b / c;
// dt_a, the initial state (nullptr: zeros), the final state and the
// entering states (nullptr: not stored) are float32.  Every tensor is
// contiguous; s >= 1 is a multiple of the chunk q.  The plan
// (kernels/ssd_scan.py::plan): slices of pw columns of p (16, 32 or 64;
// splits = ceil(p / pw) of them), vec = 1 when every row
// and pointer lies on 16 bytes (TMA copies; else element copies), and the
// shared memory it computed (n is padded to kMaxN in shared memory); a
// plan that disagrees with this file's layout is refused.
// Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int repro_ssd_scan(int x_dtype, int bc_dtype, const void* x,
                              const void* dt_a, const void* b,
                              const void* c, const void* h0, void* y,
                              void* state, void* states, int bt, int s,
                              int h, int p,
                              int n, int q, int pw, int splits, int vec,
                              int smem_bytes, void* stream) {
  if (bt < 0 || h < 1 || p < 1 || p > kMaxP || n < 1 || n > kMaxN ||
      q < 1 || q > kMaxChunk || s < 1 || s % q != 0 ||
      (x_dtype != 0 && x_dtype != 1) || (bc_dtype != 0 && bc_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = layout(pw, bc_dtype == 1 ? 2 : 4, x_dtype == 1 ? 2 : 4);
  if ((pw != 16 && pw != 32 && pw != 64) || splits != (p + pw - 1) / pw ||
      smem_bytes != l.total ||
      smem_bytes > kSmemLimit ||
      static_cast<long long>(bt) * h * splits > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bt == 0) return 0;
  Params prm{};
  prm.x = x;
  prm.dt_a = static_cast<const float*>(dt_a);
  prm.b = b;
  prm.c = c;
  prm.h0 = static_cast<const float*>(h0);
  prm.y = y;
  prm.state = static_cast<float*>(state);
  prm.states = static_cast<float*>(states);
  prm.s = s;
  prm.h = h;
  prm.p = p;
  prm.n = n;
  prm.q = q;
  prm.splits = splits;
  prm.vec = vec;
  if (vec) {
    // b, c: (bt s, n) in boxes of kR rows x 128 bytes; x: (p, h, s, bt)
    // in boxes of 128 bytes of p x 1 head x kR positions x 1 row; all
    // swizzled 128B
    const int bce = bc_dtype == 1 ? 2 : 4, xe = x_dtype == 1 ? 2 : 4;
    const CUtensorMapDataType bct = bc_dtype == 1
                                        ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    const CUtensorMapDataType xt = x_dtype == 1
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    const long long rows = static_cast<long long>(bt) * s;
    const long long dim[4] = {p, h, s, bt};
    const long long stride[3] = {static_cast<long long>(p) * xe,
                                 static_cast<long long>(h) * p * xe,
                                 static_cast<long long>(s) * h * p * xe};
    const int box[4] = {128 / xe, 1, kR, 1};
    if (!tma::make_map(&prm.tb, bct, b, rows, n,
                       static_cast<long long>(n) * bce, kR, 128 / bce,
                       CU_TENSOR_MAP_SWIZZLE_128B) ||
        !tma::make_map(&prm.tc, bct, c, rows, n,
                       static_cast<long long>(n) * bce, kR, 128 / bce,
                       CU_TENSOR_MAP_SWIZZLE_128B) ||
        !tma::make_map_4d(&prm.tx, xt, x, dim, stride, box,
                          CU_TENSOR_MAP_SWIZZLE_128B))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = bt * h * splits;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && bc_dtype == 0)
    return launch_pw<float, float>(pw, prm, blocks, smem_bytes, st);
  if (x_dtype == 0 && bc_dtype == 1)
    return launch_pw<float, __nv_bfloat16>(pw, prm, blocks, smem_bytes, st);
  if (x_dtype == 1 && bc_dtype == 1)
    return launch_pw<__nv_bfloat16, __nv_bfloat16>(pw, prm, blocks,
                                                   smem_bytes, st);
  return launch_pw<__nv_bfloat16, float>(pw, prm, blocks, smem_bytes, st);
}
