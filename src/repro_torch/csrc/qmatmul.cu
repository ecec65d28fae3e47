// qmatmul.cu — block-scaled low-precision matmul for Hopper (compiled for
// sm_90a), with plain C entry points for ctypes.
//
// Replaces the TPU kernels src/repro/kernels/qmatmul.py:76 qmatmul_mkn
// (weights in a container byte: fp8 e4m3 / e5m2, or fp6 / fp4 values held
// in e4m3) and :106 qmatmul_packed_mkn (weights bit-packed: fp4 two values
// per byte, fp6 four values in 3 bytes), computing
//   out (m, n) = x (m, k) @ (decode(w (n, k)) * scales (n, k/32)).T
// with scales fp32 powers of two (e8m0 content), 32 values of k each, and
// fp32 accumulation; out is bf16 or fp32.
//
// Bound: 2mnk operations against the bytes of x, w, scales and out.  At
// 2048^3 the operations bound it (17.4 us at 989 TFLOP/s bf16); at small
// m the weight bytes do ((8, 8192, 2048): 5.7 us for fp8, 3.2 us for fp4
// at 3.35 TB/s).
//
// Every expanded weight, an fp8 / fp6 / fp4 value times a power of two,
// is exact in bf16, and bf16 x bf16 products are exact in fp32, so for
// bf16 x the bf16 tensor cores compute exactly the products of the
// reference.  The design, for bf16 x (qmatmul_tc_kernel):
//   * a block is two consumer warpgroups and one producer warp.  The
//     producer fills a ring of shared-memory stages, each one k step of
//     64 values (two scale blocks): the x tile (bf16, 128-byte swizzled
//     K-major rows, as wgmma reads it), the weight *bytes* (1, 0.75 or
//     0.5 B a value) and their fp32 scales.  Each goes by TMA (one 2-D
//     box; rows and k past the end arrive as zeros) where its base and
//     row stride are 16-byte aligned, else by cp.async; an mbarrier a
//     stage says "filled", another "free again";
//   * the consumers expand a stage's codes (lowbits.cuh decode8: the
//     hardware's exact fp8 -> f16 conversion for fp8, a bf16 table of the
//     format's values filled from lowbits::decode for fp6 / fp4),
//     multiply by the scale in fp32 and store bf16 (exact) into a
//     swizzled K-major tile, two of which alternate, then
//     fence.proxy.async;
//   * each warpgroup issues four wgmma.mma_async m64nNk16 a step (A and B
//     from shared memory) into fresh fp32 registers, added to the running
//     sum with round-to-nearest fp32 adds once they are done (the tensor
//     cores' own accumulation truncates); the product of step t runs on
//     the tensor cores while step t + 1 is expanded;
//   * m > 64 ("wide", repro_qmatmul): 128 x 128 output tiles; warpgroup
//     g takes x rows 64 g .. 64 g + 63 as A, the 128 expanded weight
//     rows as B (m64n128k16), so every expanded weight serves 128 rows
//     of x;
//   * m <= 64 ("narrow", A and B swapped, repro_qmatmul_narrow): out^T =
//     W . x^T, one block per 128 weight rows, warpgroup g takes expanded
//     rows 64 g .. 64 g + 63 as A and x, padded to N = 8, 16, 32 or 64
//     rows, as B (m64nNk16).  Where that leaves SMs idle, k is split:
//     each block writes its fp32 partial sum to a workspace, and a
//     second kernel, launched as a programmatic dependent, sums the
//     splits in a fixed order (repro_qmatmul_reduce).  No atomics: two
//     calls give the same bits.  The wrapper (kernels/qmatmul.py plan)
//     chooses the path and the number of splits; these entries only
//     check that the kernel can take what they are given;
//   * ragged m, n and a last half step of 32 values of k: rows out of
//     range are zeros on load and masked on store, and a half step's
//     second half is zeros in both tiles, so every step issues the same
//     four products (a branch around a wgmma makes ptxas serialize them
//     all).
// Both entry points are one template over the weight format F: only the
// staged code bytes and their decode differ, the expanded bf16 tile and
// the wgmma sequence are the same, so qmatmul_packed is bit-identical to
// qmatmul on the same values (the reference's property,
// tests/test_lowbits.py).
//
// fp32 x keeps the CUDA-core kernel (v1, qmatmul_f32_kernel): a bf16 or
// TF32 tensor-core product would round x and compute another function.
// It tiles 64 x 64 outputs, steps of 32 values of k with x and the
// expanded weights in fp32 in shared memory, 4 x 4 accumulators per
// thread.  repro_qmatmul chooses by x's dtype; that is the dispatch, not
// a fallback.
//
// Not done (later work): A from registers (the expanded weights never
// stored), wider k boxes a stage for the narrow path, setmaxnreg, a
// persistent schedule.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lowbits.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

struct Args {
  CUtensorMap tx, tw, ts;  // TMA maps of x, the codes and the scales
  const void* x;
  const uint8_t* w;
  const float* scales;
  void* out;          // (m, n) at out_bf16 ? bf16 : fp32
  float* part;        // narrow path with split k: (splits, m, n) fp32
  int m, n, k;
  long long ldx, ldw, lds, ldo;   // row strides: elements (bytes for w)
  int out_bf16, splits;
  int xg, wg;         // bytes of one copy of x / of the weight codes
  int tma_x, tma_w, tma_s;  // copy x / codes / scales by TMA (16-byte
                            // strides), else by cp.async
};

__device__ __forceinline__ void store_out(const Args& a, int r, int c,
                                          float v) {
  const long long o = static_cast<long long>(r) * a.ldo + c;
  if (a.out_bf16)
    static_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16(v);
  else
    static_cast<float*>(a.out)[o] = v;
}

// --------------------------------------------------------------------- //
// v1: fp32 x on the CUDA cores
// --------------------------------------------------------------------- //

constexpr int kThreads = 256;
constexpr int kBM = 64, kBN = 64, kBK = 32;   // kBK = one scale block
constexpr int kPad = 4;                       // keeps float4 rows aligned

template <int F>
__global__ void __launch_bounds__(kThreads) qmatmul_f32_kernel(Args a) {
  const float* x = static_cast<const float*>(a.x);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;      // 4x4 outputs per thread
  const int lr = tid / 4, lc = (tid % 4) * 8;  // loader: row, 8 values of k

  __shared__ __align__(16) float xs[kBK][kBM + kPad];
  __shared__ __align__(16) float ws[kBK][kBN + kPad];

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int xrow = m0 + lr, wrow = n0 + lr;
  const bool x_ok = xrow < a.m, w_ok = wrow < a.n;
  const float* xr = x + static_cast<long long>(x_ok ? xrow : 0) * a.ldx;
  const uint8_t* wr = a.w + static_cast<long long>(w_ok ? wrow : 0) * a.ldw;
  const float* sr = a.scales + static_cast<long long>(w_ok ? wrow : 0) * a.lds;

  for (int k0 = 0; k0 < a.k; k0 += kBK) {
    // stage x: 8 values of one row, stored k-major
    float xv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) xv[i] = xr[k0 + lc + i];
    // stage w: two quads of one row, expanded and scaled on the way in
    const uint32_t q0 = lowbits::load_quad<F>(wr, (k0 + lc) / 4);
    const uint32_t q1 = lowbits::load_quad<F>(wr, (k0 + lc) / 4 + 1);
    const float sc = sr[k0 / kBK];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float wv = lowbits::quad_value<F>(i < 4 ? q0 : q1, i % 4);
      xs[lc + i][lr] = x_ok ? xv[i] : 0.f;
      ws[lc + i][lr] = w_ok ? wv * sc : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= a.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c < a.n) store_out(a, r, c, acc[i][j]);
    }
  }
}

// --------------------------------------------------------------------- //
// bf16 x on the tensor cores
// --------------------------------------------------------------------- //

constexpr int kTK = 64;        // values of k a step: one 128-byte bf16 row
constexpr int kNarrowM = 64;   // the most rows of x a narrow block takes

// one copy of g bytes (16, 8, 4: cp.async, zero-filled when !ok; 2, 1:
// plain load and store, for rows too ragged for cp.async)
__device__ __forceinline__ void copy_piece(uint8_t* dst, const uint8_t* src,
                                           int g, bool ok) {
  const uint32_t d = tma::smem_addr(dst);
  const int n = ok ? g : 0;
  if (g == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n) : "memory");
  else if (g == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(n) : "memory");
  else if (g == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(n) : "memory");
  else if (g == 2)
    *reinterpret_cast<uint16_t*>(dst) =
        ok ? *reinterpret_cast<const uint16_t*>(src) : 0;
  else
    *dst = ok ? *src : 0;
}

__device__ __forceinline__ int log2i(int v) { return 31 - __clz(v); }

// The kernel's shape: WR weight rows and XR x rows a block, kStages
// stages in the ring.  SWAP: A = the expanded weights (narrow), else x.
template <int F, int WR, int XR, bool SWAP>
struct Tc {
  static constexpr int kWG = 2;                  // consumer warpgroups
  static constexpr int kConsumers = 128 * kWG;
  static constexpr int kThreads = kConsumers + 32;  // + the producer warp
  static constexpr int kStages = 4;
  static constexpr int kN = SWAP ? XR : 128;     // a warpgroup's wgmma N
  static constexpr int kCodeB = kTK * lowbits::Fmt<F>::bits / 8;  // 64/48/32
  static constexpr int kCodeBase = kCodeB % 3 == 0 ? 3 : 1;  // fp6: 3 x 2^j
  static constexpr int kTile = WR * 128;       // one expanded weight tile
  static constexpr int kX = XR * 128;          // one stage of x
  static constexpr int kW = WR * kCodeB;       // one stage of codes
  static constexpr int kS = WR * 16;  // one stage of scales: 4 a row,
                                      // those of steps 2 (t / 2) and + 1
  static constexpr int kXOff = 2 * kTile;      // tiles and x: 1024-aligned
  static constexpr int kWOff = kXOff + kStages * kX;
  static constexpr int kSOff = kWOff + kStages * kW;
  static constexpr int kLutOff = kSOff + kStages * kS;   // decode8's table
  static constexpr int kBarOff = kLutOff + 64 * 2;  // mbarriers: filled,
                                                     // free, a stage each
  static constexpr int kBytes = kBarOff + kStages * 16 + 1024;  // + align
  static constexpr int kAcc = kN / 2;           // fp32 registers a thread
};

// copies of k step t: rows [x0, x0 + XR) of x, [w0, w0 + WR) of the
// codes and scales, into one stage of the ring, by the producer warp
// (lane 0..31), completing on bar (33 arrivals: lane 0's with the TMA
// bytes, then every lane's)
template <int F, int WR, int XR, bool SWAP>
__device__ __forceinline__ void load_step(const Args& a, int t, int x0,
                                          int w0, uint8_t* xs, uint8_t* wb,
                                          float* sb, uint64_t* bar,
                                          int lane) {
  using T = Tc<F, WR, XR, SWAP>;
  const int kv = min(kTK, a.k - t * kTK);        // 64, or 32 at a last half
  // TMA, whole boxes: rows and k past the end arrive as zeros
  if (lane == 0) {
    tma::mbar_expect(bar, (a.tma_x ? T::kX : 0) + (a.tma_w ? T::kW : 0) +
                              (a.tma_s ? T::kS : 0));
    if (a.tma_x) tma::tma_2d(xs, &a.tx, t * kTK, x0, bar);
    if (a.tma_w) tma::tma_2d(wb, &a.tw, t * T::kCodeB, w0, bar);
    // scales 4 (t / 2) .. + 3: a box starts on 16 bytes
    if (a.tma_s) tma::tma_2d(sb, &a.ts, (t >> 1) * 4, w0, bar);
  }
  if (!a.tma_x) {  // x: 2 kv bytes a row into the stage's swizzled rows;
                   // a half step's second half is zero-filled
    const int lg = log2i(a.xg), lp = log2i(2 * kTK) - lg;   // pieces a row
    const uint8_t* xb = static_cast<const uint8_t*>(a.x) +
                        static_cast<long long>(t) * kTK * 2;
    for (int i = lane; i < (XR << lp); i += 32) {
      const int r = i >> lp, o = (i & ((1 << lp) - 1)) << lg;
      const int row = x0 + r;
      const bool ok = row < a.m && o < 2 * kv;
      const uint8_t* src =
          xb + static_cast<long long>(ok ? row : 0) * a.ldx * 2 + o;
      copy_piece(xs + wgmma::sw128(r, o >> 4) + (o & 15), src, a.xg, ok);
    }
  }
  if (!a.tma_w) {  // codes: kv * bits / 8 bytes a row, in kCodeBase x 2^lp
                   // pieces
    const int rb = kv * lowbits::Fmt<F>::bits / 8;
    const int lg = log2i(a.wg), lp = log2i(rb / T::kCodeBase) - lg;
    const uint8_t* wsrc = a.w + static_cast<long long>(t) * T::kCodeB;
    for (int i = lane; i < WR * (T::kCodeBase << lp); i += 32) {
      const int r = (i >> lp) / T::kCodeBase;
      const int o = (i - r * (T::kCodeBase << lp)) << lg;
      const int row = w0 + r;
      const bool ok = row < a.n;
      copy_piece(wb + r * T::kCodeB + o,
                 wsrc + static_cast<long long>(ok ? row : 0) * a.ldw + o,
                 a.wg, ok);
    }
  }
  if (!a.tma_s) {  // scales: kv / 32 floats a row
    const int lp = kv == kTK ? 1 : 0;
    for (int i = lane; i < (WR << lp); i += 32) {
      const int r = i >> lp, j = i & lp;
      const int row = w0 + r;
      const bool ok = row < a.n;
      copy_piece(reinterpret_cast<uint8_t*>(sb + r * 4 + (t & 1) * 2 + j),
                 reinterpret_cast<const uint8_t*>(
                     a.scales + static_cast<long long>(ok ? row : 0) * a.lds +
                     t * 2 + j),
                 4, ok);
    }
  }
  if (!(a.tma_x && a.tma_w && a.tma_s)) {
    // copies too ragged for TMA: landed and fenced for wgmma before the
    // arrival (synchronous, rare)
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    wgmma::fence_proxy_async();
  }
  tma::mbar_arrive(bar);
}

// the staged codes of one step, decoded (lowbits::decode8), scaled in
// fp32 and stored as bf16 (round to nearest: exact here) into a swizzled
// K-major tile: one 16-byte chunk (8 values of k of one row) a piece
template <int F, int WR, int XR, bool SWAP>
__device__ __forceinline__ void expand(const uint8_t* wb, const float* sb,
                                       const uint16_t* lut, uint8_t* tile,
                                       int kv, int t) {
  using T = Tc<F, WR, XR, SWAP>;
  // a thread's chunks share c; every chunk is decoded (no branch, for
  // the scheduler), then zeroed past a half step
  const int c = threadIdx.x & 7;
  const uint32_t keep = c < kv / 8 ? 0xffffffffu : 0u;
  const float* sr = sb + (t & 1) * 2 + (c >> 2);
#pragma unroll
  for (int i = threadIdx.x; i < WR * 8; i += T::kConsumers) {
    const int r = i >> 3;
    float v[8];
    lowbits::decode8<F>(wb + r * T::kCodeB + c * (T::kCodeB / 8), lut, v);
    const float sc = sr[r * 4];
    uint32_t h[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 b =
          __floats2bfloat162_rn(v[2 * j] * sc, v[2 * j + 1] * sc);
      h[j] = *reinterpret_cast<const uint32_t*>(&b) & keep;
    }
    *reinterpret_cast<uint4*>(tile + wgmma::sw128(r, c)) =
        make_uint4(h[0], h[1], h[2], h[3]);
  }
}

// Wide (SWAP false): block (n tile of 128, m tile of 128), warpgroup g
// multiplies x rows 64 g .. 64 g + 63 by the 128 expanded weight rows
// (m64n128k16), one block an SM (128 fp32 registers a thread).
// Narrow (SWAP true): block (n tile of 128, split of k), warpgroup g
// multiplies expanded weight rows 64 g .. 64 g + 63 by the XR rows of x
// (padded to 8 .. 64), two blocks an SM.
//
// Each step's four products go into fresh registers (scale-d 0 on the
// first), which the running sum then takes by fp32 adds: the tensor
// cores add into their accumulator with truncation, a bias that over
// thousands of k grows past the reference's tolerance; a round-to-
// nearest add each 64 values of k does not.
template <int F, int WR, int XR, bool SWAP>
__global__ void __launch_bounds__(Tc<F, WR, XR, SWAP>::kThreads,
                                  SWAP ? 2 : 1)
    qmatmul_tc_kernel(const __grid_constant__ Args a) {
  using T = Tc<F, WR, XR, SWAP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (tma::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* tiles = smem;
  uint8_t* xs = smem + T::kXOff;
  uint8_t* wbs = smem + T::kWOff;
  float* sbs = reinterpret_cast<float*>(smem + T::kSOff);
  uint16_t* lut = reinterpret_cast<uint16_t*>(smem + T::kLutOff);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + T::kBarOff);
  uint64_t* empty = bars + T::kStages;
  lowbits::bf16_table<F>(lut, threadIdx.x, T::kThreads);
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      tma::mbar_init(bars + s, 33);   // stage s filled: the producer warp
      tma::mbar_init(empty + s, 1);   // stage s free: the consumers
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int w0 = blockIdx.x * WR;
  const int x0 = SWAP ? 0 : blockIdx.y * XR;
  const int steps = (a.k + kTK - 1) / kTK;
  const int split = SWAP ? blockIdx.y : 0;
  const int t0 = SWAP ? split * steps / a.splits : 0;
  const int nt = (SWAP ? (split + 1) * steps / a.splits : steps) - t0;

  // a split-k reduce queued behind this grid may launch now (it waits
  // for the grid's end before it reads)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  if (threadIdx.x >= T::kConsumers) {   // the producer warp
    const int lane = threadIdx.x - T::kConsumers;
    for (int i = 0; i < nt; ++i) {
      const int st = i % T::kStages;
      if (i >= T::kStages)
        tma::mbar_wait(empty + st, (i / T::kStages - 1) & 1);
      load_step<F, WR, XR, SWAP>(a, t0 + i, x0, w0, xs + st * T::kX,
                                 wbs + st * T::kW, sbs + st * WR * 4,
                                 bars + st, lane);
    }
    return;
  }

  const int wgi = threadIdx.x / 128;            // this thread's warpgroup
  float acc[T::kAcc], part[T::kAcc];           // running sum, one step's
#pragma unroll
  for (int i = 0; i < T::kAcc; ++i) acc[i] = part[i] = 0.f;

  for (int i = 0; i < nt; ++i) {
    const int st = i % T::kStages;
    const int kv = min(kTK, a.k - (t0 + i) * kTK);
    uint8_t* tile = tiles + (i & 1) * T::kTile;
    tma::mbar_wait(bars + st, (i / T::kStages) & 1);  // step i's copies landed
    expand<F, WR, XR, SWAP>(wbs + st * T::kW, sbs + st * WR * 4, lut, tile,
                            kv, t0 + i);
    wgmma::fence_proxy_async();
    wgmma::wait<0>();                 // step i - 1's products are done
    wgmma::fence_operands(part);
#pragma unroll
    for (int r = 0; r < T::kAcc; ++r) acc[r] += part[r];
    // the consumers only: tile i written, stage i - 1 free
    asm volatile("bar.sync 1, %0;\n" ::"n"(T::kConsumers) : "memory");
    if (threadIdx.x == 0 && i > 0)
      tma::mbar_arrive(empty + (i - 1) % T::kStages);
    const uint8_t* xt = xs + st * T::kX;
    const uint64_t da = wgmma::desc_sw128((SWAP ? tile : xt) + wgi * 64 * 128);
    const uint64_t db = wgmma::desc_sw128(SWAP ? xt : tile);
    // unconditional: a branch around a product makes ptxas serialize
    // every wgmma; a half step's zeros add nothing
    wgmma::fence();
#pragma unroll
    for (int j = 0; j < kTK / 16; ++j)
      wgmma::Mma<T::kN>::run(j > 0, part, wgmma::advance(da, j),
                             wgmma::advance(db, j));
    wgmma::commit();
  }
  wgmma::wait<0>();
  wgmma::fence_operands(part);
#pragma unroll
  for (int r = 0; r < T::kAcc; ++r) acc[r] += part[r];

  // register i: row 16 w + l / 4 + 8 ((i / 2) % 2), column
  // 8 (i / 4) + 2 (l % 4) + i % 2 of this warpgroup's 64 x N product
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
  if (SWAP) {   // rows are weight rows (n), columns rows of x (m)
    float* ws = a.splits > 1
                    ? a.part + static_cast<long long>(split) * a.m * a.n
                    : nullptr;
#pragma unroll
    for (int i = 0; i < T::kAcc; ++i) {
      const int nn = w0 + 64 * wgi + r0 + 8 * ((i >> 1) & 1);
      const int mm = 8 * (i >> 2) + c0 + (i & 1);
      if (nn >= a.n || mm >= a.m) continue;
      if (ws)
        ws[static_cast<long long>(mm) * a.n + nn] = acc[i];
      else
        store_out(a, mm, nn, acc[i]);
    }
  } else {
    const bool pairs = (a.ldo & 1) == 0;
#pragma unroll
    for (int i = 0; i < T::kAcc; i += 2) {
      const int mm = x0 + 64 * wgi + r0 + 8 * ((i >> 1) & 1);
      const int nn = w0 + 8 * (i >> 2) + c0;
      if (mm >= a.m || nn >= a.n) continue;
      const long long o = static_cast<long long>(mm) * a.ldo + nn;
      if (pairs && nn + 1 < a.n) {
        if (a.out_bf16)
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(a.out) + o) =
              __floats2bfloat162_rn(acc[i], acc[i + 1]);
        else
          *reinterpret_cast<float2*>(static_cast<float*>(a.out) + o) =
              make_float2(acc[i], acc[i + 1]);
      } else {
        store_out(a, mm, nn, acc[i]);
        if (nn + 1 < a.n) store_out(a, mm, nn + 1, acc[i + 1]);
      }
    }
  }
}

// out = the sum of the splits' partials, in split order.  Launched as a
// programmatic dependent of the partial kernel: its blocks may start
// early and wait here until that grid is done and its writes visible.
__global__ void qmatmul_reduce_kernel(Args a) {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const long long mn = static_cast<long long>(a.m) * a.n;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int p = 0; p < a.splits; ++p) s += a.part[p * mn + i];
  store_out(a, static_cast<int>(i / a.n), static_cast<int>(i % a.n), s);
}

template <int F, int WR, int XR, bool SWAP>
int launch_tc(const Args& args, dim3 grid, cudaStream_t st) {
  using T = Tc<F, WR, XR, SWAP>;
  Args a = args;
  // x: boxes of XR rows x 64 bf16, swizzled as wgmma reads them; codes:
  // WR rows x one step's bytes; scales: WR rows x 4 (16 bytes, the least
  // box)
  a.tma_x = tma::make_map(&a.tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.x,
                          a.m, a.k, a.ldx * 2, XR, kTK,
                          CU_TENSOR_MAP_SWIZZLE_128B);
  a.tma_w = tma::make_map(
      &a.tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.w, a.n,
      static_cast<long long>(a.k) * lowbits::Fmt<F>::bits / 8, a.ldw, WR,
      T::kCodeB, CU_TENSOR_MAP_SWIZZLE_NONE);
  a.tma_s = tma::make_map(&a.ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a.scales,
                          a.n, a.k / kBK, a.lds * 4, WR, 4,
                          CU_TENSOR_MAP_SWIZZLE_NONE);
  const cudaError_t err = cudaFuncSetAttribute(
      qmatmul_tc_kernel<F, WR, XR, SWAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  qmatmul_tc_kernel<F, WR, XR, SWAP><<<grid, T::kThreads, T::kBytes, st>>>(a);
  return 0;
}

// the narrow kernel for x rows padded to 8, 16, 32 or 64
template <int F>
int launch_narrow(const Args& a, cudaStream_t st) {
  const dim3 grid((a.n + 127) / 128, a.splits);
  if (a.m <= 8) return launch_tc<F, 128, 8, true>(a, grid, st);
  if (a.m <= 16) return launch_tc<F, 128, 16, true>(a, grid, st);
  if (a.m <= 32) return launch_tc<F, 128, 32, true>(a, grid, st);
  return launch_tc<F, 128, 64, true>(a, grid, st);
}

enum Path { kCudaCores, kWide, kNarrow };

template <int F>
int launch_fmt(Path path, const Args& a, cudaStream_t st) {
  if (path == kCudaCores) {
    const dim3 grid((a.n + kBN - 1) / kBN, (a.m + kBM - 1) / kBM);
    qmatmul_f32_kernel<F><<<grid, kThreads, 0, st>>>(a);
    return 0;
  }
  if (path == kNarrow) return launch_narrow<F>(a, st);
  return launch_tc<F, 128, 128, false>(
      a, dim3((a.n + 127) / 128, (a.m + 127) / 128), st);
}

int dispatch(int fmt, Path path, const Args& a, cudaStream_t st) {
  switch (fmt) {
    case 0: return launch_fmt<0>(path, a, st);
    case 1: return launch_fmt<1>(path, a, st);
    case 2: return launch_fmt<2>(path, a, st);
    case 3: return launch_fmt<3>(path, a, st);
    case 4: return launch_fmt<4>(path, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// the largest of 16, 8, 4, 2, 1 bytes that divides every address
int granule(long long a, long long b, long long c) {
  int g = 16;
  while (g > 1 && ((a | b | c) & (g - 1))) g /= 2;
  return g;
}

// common checks and the argument block; returns 0 or a CUDA error
int make_args(int fmt, const void* x, const void* w, const void* scales,
              int m, int n, int k, long long ldx, long long ldw,
              long long lds, Args* a) {
  if (m < 0 || n < 0 || k < 0 || k % kBK != 0 || m / kBM >= 65535 ||
      fmt < 0 || fmt > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  // the CUDA-core kernel loads fp8 / fp4 quads as one aligned word
  const int align = fmt <= 1 ? 4 : fmt == 4 ? 2 : 1;
  if (reinterpret_cast<uintptr_t>(w) % align || ldw % align)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int bits = fmt <= 1 ? 8 : fmt == 4 ? 4 : 6;
  *a = Args{};
  a->x = x;
  a->w = static_cast<const uint8_t*>(w);
  a->scales = static_cast<const float*>(scales);
  a->m = m;
  a->n = n;
  a->k = k;
  a->ldx = ldx;
  a->ldw = ldw;
  a->lds = lds;
  a->splits = 1;
  a->xg = granule(reinterpret_cast<uintptr_t>(x), ldx * 2, 16);
  // a row's step of codes starts at a multiple of 16 bytes; a last half
  // step holds 16 (fp8 32) or 24 (fp6) bytes
  a->wg = granule(reinterpret_cast<uintptr_t>(w), ldw,
                  k % kTK ? kBK * bits / 8 : 16);
  return 0;
}

}  // namespace

// x_dtype / out_dtype: 0 = float32, 1 = bfloat16.  fmt: 0 e4m3fn, 1 e5m2
// (container bytes, w (n, k)), 2 fp6 e2m3, 3 fp6 e3m2 (w (n, 3k/4)), 4 fp4
// e2m1 (w (n, k/2)).  Row strides in elements (bytes for w); every
// matrix has a unit-stride last axis.  k must be a multiple of 32.
// fp32 x: the CUDA-core kernel; bf16 x: the wide tensor-core kernel, at
// any m (the wrapper sends m <= 64 to repro_qmatmul_narrow).
// Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int repro_qmatmul(int x_dtype, int out_dtype, int fmt,
                             const void* x, const void* w,
                             const void* scales, void* out, int m, int n,
                             int k, long long ldx, long long ldw,
                             long long lds, long long ldo, void* stream) {
  if (x_dtype < 0 || x_dtype > 1 || out_dtype < 0 || out_dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  int err = make_args(fmt, x, w, scales, m, n, k, ldx, ldw, lds, &a);
  if (err) return err;
  if (m == 0 || n == 0) return 0;
  a.out = out;
  a.ldo = ldo;
  a.out_bf16 = out_dtype;
  err = dispatch(fmt, x_dtype ? kWide : kCudaCores, a,
                 static_cast<cudaStream_t>(stream));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

// The narrow path, A and B swapped: bf16 x, m <= 64, arguments as
// repro_qmatmul's.  splits == 1: out receives the product; k split in
// `splits` ranges of steps of 64: part (splits, m, n) fp32 receives each
// split's sum, for repro_qmatmul_reduce, and out is not written.
extern "C" int repro_qmatmul_narrow(int out_dtype, int fmt, const void* x,
                                    const void* w, const void* scales,
                                    void* out, void* part, int m, int n,
                                    int k, long long ldx, long long ldw,
                                    long long lds, long long ldo,
                                    int splits, void* stream) {
  Args a;
  int err = make_args(fmt, x, w, scales, m, n, k, ldx, ldw, lds, &a);
  if (err) return err;
  if (out_dtype < 0 || out_dtype > 1 || m > kNarrowM || splits < 1 ||
      splits > 65535 ||
      (splits > 1 && (splits > (k + kTK - 1) / kTK || part == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return 0;
  a.out = out;
  a.ldo = ldo;
  a.out_bf16 = out_dtype;
  a.part = static_cast<float*>(part);
  a.splits = splits;
  err = dispatch(fmt, kNarrow, a, static_cast<cudaStream_t>(stream));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

// out (m, n) = the sum over s = 0, 1, .. of part[s], in that order.
extern "C" int repro_qmatmul_reduce(int out_dtype, const void* part,
                                    void* out, int m, int n, long long ldo,
                                    int splits, void* stream) {
  if (out_dtype < 0 || out_dtype > 1 || m < 0 || n < 0 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return 0;
  Args a{};
  a.part = static_cast<float*>(const_cast<void*>(part));
  a.out = out;
  a.m = m;
  a.n = n;
  a.ldo = ldo;
  a.out_bf16 = out_dtype;
  a.splits = splits;
  const long long mn = static_cast<long long>(m) * n;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((mn + 255) / 256));
  cfg.blockDim = dim3(256);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, qmatmul_reduce_kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// A check of wgmma.cuh: one warpgroup computes d (64, 128) fp32 =
// a (64, k) @ b (128, k)^T for bf16 a, b (row-major, row stride k, k a
// multiple of 16 up to 64): the tiles are stored swizzled, zero past k,
// then four m64n128k16 products at advancing descriptors, the first with
// scale-d 0 (it overwrites the accumulator).
__global__ void __launch_bounds__(128) wgmma_unit_kernel(
    const __nv_bfloat16* a, const __nv_bfloat16* b, float* d, int k) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sa =
      smem_raw + ((1024 - (tma::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* sb = sa + 64 * 128;
  for (int i = threadIdx.x; i < 192 * 8; i += 128) {
    const int r = i / 8, c = i % 8;
    const __nv_bfloat16* src = r < 64 ? a + r * k : b + (r - 64) * k;
    uint8_t* dst = r < 64 ? sa + wgmma::sw128(r, c)
                          : sb + wgmma::sw128(r - 64, c);
    *reinterpret_cast<uint4*>(dst) =
        8 * c < k ? *reinterpret_cast<const uint4*>(src + 8 * c)
                  : make_uint4(0, 0, 0, 0);
  }
  wgmma::fence_proxy_async();
  __syncthreads();
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  wgmma::fence_operands(acc);
  wgmma::fence();
  const uint64_t da = wgmma::desc_sw128(sa), db = wgmma::desc_sw128(sb);
#pragma unroll
  for (int j = 0; j < 4; ++j)   // the slices past k are zeros
    wgmma::Mma<128>::run(j > 0, acc, wgmma::advance(da, j),
                         wgmma::advance(db, j));
  wgmma::commit();
  wgmma::wait<0>();
  wgmma::fence_operands(acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
    const int c = 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
    d[r * 128 + c] = acc[i];
  }
}

// a (64, k), b (128, k) bf16 row-major and 16-byte aligned, d (64, 128)
// fp32; k in 16, 32, 48, 64.
extern "C" int repro_wgmma_unit(const void* a, const void* b, void* d, int k,
                                void* stream) {
  if (k < 16 || k > 64 || k % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  wgmma_unit_kernel<<<1, 128, 192 * 128 + 1024,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(b), static_cast<float*>(d), k);
  return static_cast<int>(cudaGetLastError());
}
