// flash_attention_bwd.cu — the backward of whole-sequence attention
// (training) for Hopper (compiled for sm_90a), with a plain C entry point
// for ctypes.
//
// Replaces no Pallas kernel: the reference differentiates the XLA
// attention() (src/repro/models/attention.py:221) that its training
// path runs, and src/repro/kernels/flash_attention.py::
// flash_attention_bhsd (the forward this is the backward of) has no
// backward.  It computes what differentiating that function computes,
// in the model layout q, o, dO (b, sq, hq, d), k / v (b, skv, hkv, d),
// read through their strides (head_dim unit-stride); dq (b, sq, hq, d)
// and dk / dv (b, skv, hkv, d) are written contiguous at the input dtype:
//   r_ij = scale * q_i·k_j,  s_ij = softcap(r_ij) = c tanh(r_ij / c)
//   visible_ij = j < skv (and i >= j if causal) (and i - j < window)
//   lse_i = log sum_j visible exp(s_ij)        (written by the forward)
//   P_ij = visible ? exp(s_ij - lse_i) : 0,  D_i = sum_d dO_i O_i
//   dV_j = sum_i P_ij dO_i,  dP_ij = dO_i·v_j
//   dS_ij = P_ij (dP_ij - D_i) (1 - (s_ij / c)^2 with a softcap)
//   dQ_i = scale sum_j dS_ij k_j,  dK_j = scale sum_i dS_ij q_i
// GQA through the head index: dK and dV of a kv head sum over the
// hq / hkv q heads of its group.  A row with no visible key has P = 0
// and gives nothing.  Queries sit at 0..sq-1 (no training path uses a
// q_offset).
//
// Bound: the backward does 10 d flops a visible (query, key) pair and q
// head (S and dP recomputed, dV, dK, dQ) against 4 reads or writes of a
// q-sized and 4 of a kv-sized tensor: at the training shapes (s 256 ..
// 2048, d 128) bound by the tensor cores' bf16 rate, or by the bytes at
// the shortest sequences.
//
// Passes, in stream order, launched as kernels/flash_attention.py
// bwd_plan sizes them (own_plan holds that plan to this file's tiles):
//   (A) fa_bwd_dot_kernel: D = rowsum(dO * O), a warp a row (bytes), and
//       the forward's LSE copied beside it into rows padded to sq_pad
//       (a multiple of 128) with zeros past sq, in log2 units for bf16;
//   (B) dK, dV: bf16 fa_bwd_dkdv_tc_kernel, fp32 fa_bwd_dkdv_kernel;
//   (R) bf16 with head_split > 1 only: fa_bwd_reduce_kernel sums the
//       split's fp32 partials of dK and dV in split order;
//   (C) dQ: bf16 fa_bwd_dq_tc_kernel, fp32 fa_bwd_dq_kernel.
//
// What the bf16 design does about the four causes that held the first,
// fp32 CUDA-core kernel of this backward at ~11 TFLOP/s:
//   * tensor cores: every product is wgmma m64nNk16 (bf16, fp32
//     accumulation), built from the forward's parts (wgmma.cuh's SS Mma
//     and RS MmaRS with desc_sw128_mn, tma.cuh's 4-D maps).  (B): a
//     block owns a tile of keys, 64 a consumer warpgroup (two of them and
//     one TMA producer warpgroup, setmaxnreg 240 / 24); for every q tile
//     of 64 queries of its q heads S^T = K Q^T and dP^T = V dO^T (SS; the
//     Q and dO tiles are the K-major B), P^T and dS^T in registers,
//     packed pairwise to bf16: they are already the A fragments of dV +=
//     P^T dO and dK += dS^T Q (RS; the same swizzled Q and dO tiles read
//     MN-major).  (C): a block owns 128 queries (64 a warpgroup) and
//     streams K / V tiles: S = Q K^T, dP = dO V^T (SS), dS in registers,
//     dQ += dS K (RS, K read MN-major).  At d 256 the 64 x 256 dK and dV
//     accumulators exceed a warpgroup's registers: (B) takes 64 keys a
//     block and each warpgroup keeps half of d (both compute the tile's
//     S^T and dP^T: 12 d flops a pair in (B) instead of 8);
//   * flops: the forward writes each row's LSE, so no pass recomputes
//     Q K^T for it; (B) does 8 d flops a pair, (C) 6 d (S and dP again,
//     dQ): 14 d against the first kernel's 16 d, all on tensor cores;
//   * copies: Q, dO (and their LSE and D rows, by bulk copy) stream
//     through a ring of full / empty mbarriers fed by one TMA thread, K
//     and V stay resident in (B); K / V stream the same way in (C);
//   * grid fill: where b * hkv * key tiles is under the SM count the
//     plan splits each GQA group's q heads over head_split blocks, which
//     write fp32 partials that (R) sums in a fixed order; two calls give
//     the same bits (no atomics anywhere).
//   Tiles that the causal mask or the window hides entirely are skipped
//   (query_tiles, key_tiles); only tiles on the mask's edge pay the
//   per-element mask.  Within a warpgroup the products of a tile run one
//   after the other (S^T and dP^T, then dV and dK); the two warpgroups
//   interleave.
// dQ stays a pass of its own: accumulated inside (B) instead, by fp32
// reductions ordered key block after key block through a counter per q
// tile (FlashAttention-3's deterministic mode), it took 2.1x this
// design's time on an H100 at b 8, s 2048, 16 heads of 128, causal: the
// ordering holds each key block of a head behind the one before it.
// fp32 stays on the CUDA cores (the tests hold it to 1e-5 x max |grad|
// with TF32 off): the first kernel's (B) and (C), 4 x CJ register
// micro-tiles over fp32 rows padded to DP + 1 floats, reading the
// forward's LSE.
// Not done yet: overlap of one tile's elementwise work with the next
// tile's products inside a warpgroup (FlashAttention-3's pipelining), a
// persistent schedule, a tensor-core fp32 leg.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBq = 64;        // fp32: query rows a tile
constexpr int kThreads = 256;  // fp32: 16 x 16 score micro-tiles, 8 warps
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  CUtensorMap tq, tdo, tk, tv;  // bf16: TMA maps of q, dO, k, v
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  const float* lse_in;  // (b, hq, sq): the forward's LSE (natural log)
  float* lse;           // (b * hq, sq_pad): lse_in (x log2 e for bf16)
  float* delta;         // (b * hq, sq_pad): rowsum(dO * O)
  float* part;          // bf16, head_split > 1: (2, head_split, dK elts)
  int b, sq, skv, hq, hkv, ratio, d, sq_pad, head_split;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  float scale;
  int causal, has_window, window, has_softcap;
  float softcap;
};

__device__ __forceinline__ bool visible(const Args& a, int qi, int kj) {
  return qi < a.sq && kj < a.skv && (!a.causal || kj <= qi) &&
         (!a.has_window || qi - kj < a.window);
}

// is every pair of queries [q_lo, q_hi] x keys [k_lo, k_hi] visible?
__device__ __forceinline__ bool tile_full(const Args& a, int q_lo, int q_hi,
                                          int k_lo, int k_hi) {
  return q_hi < a.sq && k_hi < a.skv && (!a.causal || k_hi <= q_lo) &&
         (!a.has_window || q_hi - k_lo < a.window);
}

// key tiles [lo, hi) of bk keys that hold a key visible to a query of
// [q0, q0 + bq)
__device__ __forceinline__ void key_tiles(const Args& a, int q0, int bq,
                                          int bk, int& lo, int& hi) {
  int k_end = a.skv;
  if (a.causal) k_end = min(k_end, q0 + bq);
  int k_begin = 0;
  if (a.has_window) k_begin = max(0, q0 - a.window + 1);
  lo = k_begin / bk;
  hi = k_end > k_begin ? (k_end + bk - 1) / bk : lo;
}

// q tiles [lo, hi) of bq queries that hold a query that sees a key of
// [k0, k0 + bk)
__device__ __forceinline__ void query_tiles(const Args& a, int k0, int bk,
                                            int bq, int& lo, int& hi) {
  int q_begin = a.causal ? k0 : 0;
  int q_end = a.sq;
  if (a.has_window) {
    const long long last = (long long)k0 + bk - 1 + a.window;  // exclusive
    if (last < q_end) q_end = static_cast<int>(last);
  }
  lo = q_begin / bq;
  hi = q_end > q_begin ? (q_end + bq - 1) / bq : lo;
}

// ---- (A) D = rowsum(dO * O), the LSE into padded rows -------------- //
__device__ __forceinline__ float row_dot(const float* x, const float* y,
                                         int d, int lane) {
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc = fmaf(x[c], y[c], acc);
  return acc;
}
__device__ __forceinline__ float row_dot(const __nv_bfloat16* x,
                                         const __nv_bfloat16* y, int d,
                                         int lane) {
  float acc = 0.f;   // d and the rows' strides are even (8 | d for bf16)
  for (int c = 2 * lane; c < d; c += 64) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(x + c));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(y + c));
    acc = fmaf(a.x, b.x, fmaf(a.y, b.y, acc));
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(256)
    fa_bwd_dot_kernel(const Args a, float lse_mul) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)a.b * a.hq * a.sq_pad) return;
  const long long bh = row / a.sq_pad;
  const int i = static_cast<int>(row % a.sq_pad);
  float acc = 0.f, l = 0.f;
  if (i < a.sq) {
    const int bi = static_cast<int>(bh / a.hq), h = static_cast<int>(bh % a.hq);
    const T* orow = static_cast<const T*>(a.o) + bi * a.o_sb + h * a.o_sh +
                    i * a.o_ss;
    const T* drow = static_cast<const T*>(a.dout) + bi * a.do_sb +
                    h * a.do_sh + i * a.do_ss;
    acc = row_dot(orow, drow, a.d, lane);
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    l = a.lse_in[bh * a.sq + i] * lse_mul;
  }
  if (lane == 0) {
    a.delta[row] = acc;
    a.lse[row] = l;
  }
}

// ===================================================================== //
// bf16: wgmma, TMA-fed, warp-specialized
// ===================================================================== //

// 2^x (ex2.approx: relative error ~2^-22; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (tma::smem_addr(p) & 1023)) & 1023);
}

// the scores' constants: a raw product x becomes log2 units as x * xs,
// or under a softcap as tanh(x * x_mul) * x_cap
struct Consts {
  float xs, x_mul, x_cap;
};

__device__ __forceinline__ Consts consts(const Args& a) {
  return {a.scale * kLog2e, a.scale / a.softcap, a.softcap * kLog2e};
}

// P and dS of one product tile (S and dP accumulators of KK k16 slices,
// wgmma.cuh's layout: register i at row rbase + 8 ((i >> 1) & 1), column
// cbase + 8 (i >> 2) + 2 t + (i & 1)) into bf16 A fragments, packed
// pairwise (pp: P, TRANS only; pd: dS).  TRANS: rows are keys and
// columns queries (S^T of the dK / dV kernel; the LSE and D of column c
// at lse_c[c], dlt_c[c]); else rows are queries (the LSE and D of the
// thread's two rows in l2[2], dl[2]).  `masked`: apply the mask per element.
template <bool CAP, bool TRANS, int KK>
__device__ __forceinline__ void p_and_ds(
    const Args& a, const Consts& k, const float (&s)[8 * KK],
    const float (&dp)[8 * KK], const float* lse_c, const float* dlt_c,
    const float (&l2)[2], const float (&dl)[2], int rbase, int cbase, int t,
    bool masked, uint32_t (&pp)[KK][4], uint32_t (&pd)[KK][4]) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float p2[2], d2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 8 * kk + 2 * r + e;
        const int col = 8 * (i >> 2) + 2 * t + e;
        const int row = rbase + 8 * (r & 1);
        const float lse = TRANS ? lse_c[col] : l2[r & 1];
        const float dlt = TRANS ? dlt_c[col] : dl[r & 1];
        float p, ds;
        if (CAP) {
          const float th = tanhf(s[i] * k.x_mul);
          p = ex2(fmaf(th, k.x_cap, -lse));
          ds = p * (dp[i] - dlt) * (1.f - th * th);
        } else {
          p = ex2(fmaf(s[i], k.xs, -lse));
          ds = p * (dp[i] - dlt);
        }
        if (masked) {
          const bool ok = TRANS ? visible(a, cbase + col, row)
                                : visible(a, row, cbase + col);
          p = ok ? p : 0.f;
          ds = ok ? ds : 0.f;
        }
        p2[e] = p;
        d2[e] = ds;
      }
      if (TRANS) pp[kk][r] = pack_bf16(p2[0], p2[1]);
      pd[kk][r] = pack_bf16(d2[0], d2[1]);
    }
}

// ---- (B) dK, dV ---------------------------------------------------- //
// Shared memory, each tile on a 1024-byte boundary: K, V (kCols column
// blocks of kKeys rows x 128 bytes each), then kStages ring stages of a
// Q tile and a dO tile (kCols column blocks of 64 rows x 128 bytes),
// then a stage's LSE and D rows (64 floats each), then the mbarriers:
// K / V, then a "full" and an "empty" one a stage.
template <int D>
struct Kv {
  static constexpr bool kSplitD = D == 256;      // both WGs: 64 keys, d / 2
  static constexpr int kKeys = kSplitD ? 64 : 128;
  static constexpr int kStages = D == 256 ? 2 : 3;
  static constexpr int kThreads = 384;           // 2 consumer WGs + 1
  static constexpr int kCols = D / 64;
  static constexpr int kDW = kSplitD ? D / 2 : D;  // dK / dV columns a WG
  static constexpr int kK = kKeys * D * 2;       // bytes of K (of V)
  static constexpr int kQ = 64 * D * 2;          // bytes of a Q (dO) tile
  static constexpr int kRingOff = 2 * kK;
  static constexpr int kStatOff = kRingOff + kStages * 2 * kQ;
  static constexpr int kBarOff = kStatOff + kStages * 2 * 64 * 4;
  static constexpr int kBytes = kBarOff + (1 + 2 * kStages) * 8 + 1024;
};

template <int D>
__global__ void __launch_bounds__(Kv<D>::kThreads, 1)
    fa_bwd_dkdv_tc_kernel(const __grid_constant__ Args a) {
  using T = Kv<D>;
  constexpr int S = T::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* ks = smem;
  uint8_t* vs = smem + T::kK;
  uint8_t* ring = smem + T::kRingOff;
  float* stat = reinterpret_cast<float*>(smem + T::kStatOff);
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(smem + T::kBarOff);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + S;

  // block -> (b * hkv + kv head, key tile, split): key tiles in order
  // (the first sees the most q tiles under a causal mask)
  const int n_kt = (a.skv + T::kKeys - 1) / T::kKeys;
  const int per_pair = n_kt * a.head_split;
  const int pair = blockIdx.x / per_pair, rest = blockIdx.x % per_pair;
  const int kt = rest / a.head_split, sp = rest % a.head_split;
  const int bi = pair / a.hkv, hk = pair % a.hkv;
  const int k0 = kt * T::kKeys;
  const int hps = a.ratio / a.head_split;        // q heads of this block
  const int h0 = hk * a.ratio + sp * hps;
  int lo, hi;
  query_tiles(a, k0, T::kKeys, 64, lo, hi);
  const int n_qt = hi - lo, n = hps * n_qt;      // (q head, q tile) steps

  if (threadIdx.x == 0) {
    tma::mbar_init(kvbar, 1);
    for (int s = 0; s < S; ++s) {
      tma::mbar_init(full + s, 1);     // the producer's arrival + bytes
      tma::mbar_init(empty + s, 2);    // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {                       // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256 && n > 0) {
      tma::mbar_expect(kvbar, 2 * T::kK);
#pragma unroll
      for (int c = 0; c < T::kCols; ++c) {
        tma::tma_4d(ks + c * T::kKeys * 128, &a.tk, 64 * c, hk, k0, bi, kvbar);
        tma::tma_4d(vs + c * T::kKeys * 128, &a.tv, 64 * c, hk, k0, bi, kvbar);
      }
      for (int i = 0; i < n; ++i) {
        const int st = i % S;
        if (i >= S) tma::mbar_wait(empty + st, (i / S - 1) & 1);
        const int h = h0 + i / n_qt, q0 = (lo + i % n_qt) * 64;
        tma::mbar_expect(full + st, 2 * T::kQ + 2 * 64 * 4);
        uint8_t* qs = ring + st * 2 * T::kQ;
#pragma unroll
        for (int c = 0; c < T::kCols; ++c) {
          tma::tma_4d(qs + c * 64 * 128, &a.tq, 64 * c, h, q0, bi, full + st);
          tma::tma_4d(qs + T::kQ + c * 64 * 128, &a.tdo, 64 * c, h, q0, bi,
                      full + st);
        }
        const long long row = ((long long)bi * a.hq + h) * a.sq_pad + q0;
        tma::bulk_copy(stat + st * 128, a.lse + row, 256, full + st);
        tma::bulk_copy(stat + st * 128 + 64, a.delta + row, 256, full + st);
      }
    }
    return;
  }

  // ---- the consumer warpgroups ------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key_off = T::kSplitD ? 0 : 64 * wg;  // this WG's keys
  const int col_off = T::kSplitD ? T::kDW * wg : 0;  // its dK / dV columns
  const int w_lo = k0 + key_off + 16 * warp;     // the warp's 16 keys
  const int key0 = w_lo + g;                     // this thread's: +0, +8
  const Consts cst = consts(a);

  float dk[T::kDW / 2], dv[T::kDW / 2];
#pragma unroll
  for (int i = 0; i < T::kDW / 2; ++i) dk[i] = dv[i] = 0.f;

  // out rows key0, key0 + 8: bf16 dK (x scale) and dV, or fp32 partials
  auto store = [&]() {
    const long long n_el = (long long)a.b * a.skv * a.hkv * a.d;
#pragma unroll
    for (int r = 0; r < T::kDW / 2; r += 4) {
      const int col = col_off + 2 * r + 2 * t;   // 8 (r / 4) + 2 t
      if (col >= a.d) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int key = key0 + 8 * half;
        if (key >= a.skv) continue;
        const long long at =
            (((long long)bi * a.skv + key) * a.hkv + hk) * a.d + col;
        const int j = r + 2 * half;
        if (a.head_split == 1) {
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(a.dk) + at) =
              __floats2bfloat162_rn(dk[j] * a.scale, dk[j + 1] * a.scale);
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(a.dv) + at) =
              __floats2bfloat162_rn(dv[j], dv[j + 1]);
        } else {
          *reinterpret_cast<float2*>(a.part + sp * n_el + at) =
              make_float2(dk[j], dk[j + 1]);
          *reinterpret_cast<float2*>(a.part + (a.head_split + sp) * n_el +
                                     at) = make_float2(dv[j], dv[j + 1]);
        }
      }
    }
  };
  if (n == 0) {            // no query sees these keys: zeros (no copies
    store();               // were issued)
    return;
  }

  // descriptors: this WG's 64 rows of K and V (column block 0); the
  // ring's first tile, K-major (B of S^T, dP^T) and MN-major (B of dV,
  // dK: 64 query rows a column block); 16-byte units step across
  const uint64_t dka = wgmma::desc_sw128(ks + key_off * 128);
  const uint64_t dva = wgmma::desc_sw128(vs + key_off * 128);
  const uint64_t dring = wgmma::desc_sw128(ring);
  const uint64_t dring_mn = wgmma::desc_sw128_mn(ring, 64 * 128);
  constexpr uint32_t kColsOff = (T::kSplitD ? T::kDW / 64 : 0) * 64 * 128;
  const uint32_t mn_off = wg * kColsOff;        // this WG's column blocks
  const float no[2] = {0.f, 0.f};

  tma::mbar_wait(kvbar, 0);
  for (int i = 0; i < n; ++i) {
    const int st = i % S;
    const int q0 = (lo + i % n_qt) * 64;
    const uint32_t qoff = st * 2 * T::kQ, dooff = qoff + T::kQ;
    tma::mbar_wait(full + st, (i / S) & 1);
    float s[32], dp[32];
    wgmma::fence();
#pragma unroll
    for (int k16 = 0; k16 < D / 16; ++k16) {
      const int c = k16 / 4;                      // column block of d
      wgmma::Mma<64>::run(
          k16 > 0, s,
          wgmma::advance(dka + ((c * T::kKeys * 128) >> 4), k16 % 4),
          wgmma::advance(dring + ((qoff + c * 64 * 128) >> 4), k16 % 4));
    }
#pragma unroll
    for (int k16 = 0; k16 < D / 16; ++k16) {
      const int c = k16 / 4;
      wgmma::Mma<64>::run(
          k16 > 0, dp,
          wgmma::advance(dva + ((c * T::kKeys * 128) >> 4), k16 % 4),
          wgmma::advance(dring + ((dooff + c * 64 * 128) >> 4), k16 % 4));
    }
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operands(s);
    wgmma::fence_operands(dp);

    const float* lse_c = stat + st * 128;
    const float* dlt_c = lse_c + 64;
    const bool masked = !tile_full(a, q0, q0 + 63, w_lo, w_lo + 15);
    uint32_t pp[4][4], pd[4][4];
    if (a.has_softcap)
      p_and_ds<true, true, 4>(a, cst, s, dp, lse_c, dlt_c, no, no, key0, q0,
                              t, masked, pp, pd);
    else
      p_and_ds<false, true, 4>(a, cst, s, dp, lse_c, dlt_c, no, no, key0, q0,
                               t, masked, pp, pd);

    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma::MmaRS<T::kDW>::run(
          1, dv, pp[kk],
          wgmma::advance_mn(dring_mn + ((dooff + mn_off) >> 4), kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma::MmaRS<T::kDW>::run(
          1, dk, pd[kk],
          wgmma::advance_mn(dring_mn + ((qoff + mn_off) >> 4), kk));
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operands(dv);
    wgmma::fence_operands(dk);
    if (threadIdx.x % 128 == 0) tma::mbar_arrive(empty + st);
  }
  store();
}

// ---- (R) the split's partials -------------------------------------- //
// dk = scale * sum_s part[0][s], dv = sum_s part[1][s], s = 0, 1, ... in
// order; n (elements of dK) a multiple of 4
__global__ void __launch_bounds__(256)
    fa_bwd_reduce_kernel(const float* part, __nv_bfloat16* dk,
                         __nv_bfloat16* dv, long long n, int split,
                         float scale) {
  const long long i =
      4 * ((long long)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
  for (int s = 0; s < split; ++s) {
    const float4 u = *reinterpret_cast<const float4*>(part + s * n + i);
    const float4 w =
        *reinterpret_cast<const float4*>(part + (split + s) * n + i);
    x.x += u.x, x.y += u.y, x.z += u.z, x.w += u.w;
    y.x += w.x, y.y += w.y, y.z += w.z, y.w += w.w;
  }
  __nv_bfloat162* pk = reinterpret_cast<__nv_bfloat162*>(dk + i);
  __nv_bfloat162* pv = reinterpret_cast<__nv_bfloat162*>(dv + i);
  pk[0] = __floats2bfloat162_rn(x.x * scale, x.y * scale);
  pk[1] = __floats2bfloat162_rn(x.z * scale, x.w * scale);
  pv[0] = __floats2bfloat162_rn(y.x, y.y);
  pv[1] = __floats2bfloat162_rn(y.z, y.w);
}

// ---- (C) dQ -------------------------------------------------------- //
// Shared memory: the Q and dO tiles of 128 rows (kCols column blocks of
// 128 rows x 128 bytes each), then kStages ring stages of a K tile and a
// V tile (kCols column blocks of kBK keys x 128 bytes), then the
// mbarriers: Q / dO, then a "full" and an "empty" one a stage.
template <int D>
struct Dq {
  static constexpr int kRows = 128;              // 64 a consumer WG
  static constexpr int kBK = D == 256 ? 32 : 64;
  static constexpr int kStages = D == 256 ? 2 : 3;
  static constexpr int kThreads = 384;
  static constexpr int kCols = D / 64;
  static constexpr int kQ = kRows * D * 2;       // bytes of Q (of dO)
  static constexpr int kKV = kBK * D * 2;        // bytes of a K (V) tile
  static constexpr int kRingOff = 2 * kQ;
  static constexpr int kBarOff = kRingOff + kStages * 2 * kKV;
  static constexpr int kBytes = kBarOff + (1 + 2 * kStages) * 8 + 1024;
  static constexpr int kN = D < 128 ? D : 128;   // N of one dQ product
  static constexpr int kNs = D / kN;
};

template <int D>
__global__ void __launch_bounds__(Dq<D>::kThreads, 1)
    fa_bwd_dq_tc_kernel(const __grid_constant__ Args a) {
  using T = Dq<D>;
  constexpr int S = T::kStages, kBK = T::kBK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* qs = smem;
  uint8_t* dos = smem + T::kQ;
  uint8_t* ring = smem + T::kRingOff;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + T::kBarOff);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + S;

  // block -> (b * hq + q head, q tile), the last q tile first (it sees
  // the most key tiles under a causal mask)
  const int n_qt = (a.sq + T::kRows - 1) / T::kRows;
  const int pair = blockIdx.x / n_qt;
  const int qt = n_qt - 1 - blockIdx.x % n_qt;
  const int bi = pair / a.hq, h = pair % a.hq, hk = h / a.ratio;
  const int q0 = qt * T::kRows;
  int jb, je;
  key_tiles(a, q0, T::kRows, kBK, jb, je);

  if (threadIdx.x == 0) {
    tma::mbar_init(qbar, 1);
    for (int s = 0; s < S; ++s) {
      tma::mbar_init(full + s, 1);
      tma::mbar_init(empty + s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {                       // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256 && jb < je) {
      tma::mbar_expect(qbar, 2 * T::kQ);
#pragma unroll
      for (int c = 0; c < T::kCols; ++c) {
        tma::tma_4d(qs + c * T::kRows * 128, &a.tq, 64 * c, h, q0, bi, qbar);
        tma::tma_4d(dos + c * T::kRows * 128, &a.tdo, 64 * c, h, q0, bi,
                    qbar);
      }
      for (int i = 0; i < je - jb; ++i) {
        const int st = i % S;
        const int k0 = (jb + i) * kBK;
        if (i >= S) tma::mbar_wait(empty + st, (i / S - 1) & 1);
        tma::mbar_expect(full + st, 2 * T::kKV);
        uint8_t* kst = ring + st * 2 * T::kKV;
#pragma unroll
        for (int c = 0; c < T::kCols; ++c) {
          tma::tma_4d(kst + c * kBK * 128, &a.tk, 64 * c, hk, k0, bi,
                      full + st);
          tma::tma_4d(kst + T::kKV + c * kBK * 128, &a.tv, 64 * c, hk, k0,
                      bi, full + st);
        }
      }
    }
    return;
  }

  // ---- the consumer warpgroups ------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int w_lo = q0 + 64 * wg + 16 * warp;     // the warp's 16 queries
  const int row0 = w_lo + g;                     // this thread's: +0, +8
  const Consts cst = consts(a);

  float dq[T::kNs][T::kN / 2];
#pragma unroll
  for (int n = 0; n < T::kNs; ++n)
#pragma unroll
    for (int i = 0; i < T::kN / 2; ++i) dq[n][i] = 0.f;

  auto store = [&]() {
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.dq);
#pragma unroll
    for (int n = 0; n < T::kNs; ++n)
#pragma unroll
      for (int r = 0; r < T::kN / 2; r += 4) {
        const int col = n * T::kN + 2 * r + 2 * t;
        if (col >= a.d) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int qi = row0 + 8 * half;
          if (qi >= a.sq) continue;
          const long long at =
              (((long long)bi * a.sq + qi) * a.hq + h) * a.d + col;
          *reinterpret_cast<__nv_bfloat162*>(out + at) =
              __floats2bfloat162_rn(dq[n][r + 2 * half] * a.scale,
                                    dq[n][r + 2 * half + 1] * a.scale);
        }
      }
  };
  if (jb >= je) {          // no key visible to these queries: zeros
    store();
    return;
  }

  // the LSE (log2 units) and D of rows row0, row0 + 8 (padded: in range)
  const long long rbase = ((long long)bi * a.hq + h) * a.sq_pad + row0;
  const float l2[2] = {a.lse[rbase], a.lse[rbase + 8]};
  const float dl[2] = {a.delta[rbase], a.delta[rbase + 8]};

  const uint64_t dqa = wgmma::desc_sw128(qs + 64 * wg * 128);
  const uint64_t doa = wgmma::desc_sw128(dos + 64 * wg * 128);
  const uint64_t dkb = wgmma::desc_sw128(ring);
  const uint64_t dkb_mn = wgmma::desc_sw128_mn(ring, kBK * 128);

  tma::mbar_wait(qbar, 0);
  for (int j = jb; j < je; ++j) {
    const int i = j - jb, st = i % S, k0 = j * kBK;
    const uint32_t koff = st * 2 * T::kKV, voff = koff + T::kKV;
    tma::mbar_wait(full + st, (i / S) & 1);
    float s[kBK / 2], dp[kBK / 2];
    wgmma::fence();
#pragma unroll
    for (int k16 = 0; k16 < D / 16; ++k16) {
      const int c = k16 / 4;
      wgmma::Mma<kBK>::run(
          k16 > 0, s,
          wgmma::advance(dqa + ((c * T::kRows * 128) >> 4), k16 % 4),
          wgmma::advance(dkb + ((koff + c * kBK * 128) >> 4), k16 % 4));
    }
#pragma unroll
    for (int k16 = 0; k16 < D / 16; ++k16) {
      const int c = k16 / 4;
      wgmma::Mma<kBK>::run(
          k16 > 0, dp,
          wgmma::advance(doa + ((c * T::kRows * 128) >> 4), k16 % 4),
          wgmma::advance(dkb + ((voff + c * kBK * 128) >> 4), k16 % 4));
    }
    wgmma::commit();
    wgmma::wait<0>();
    wgmma::fence_operands(s);
    wgmma::fence_operands(dp);

    const bool masked = !tile_full(a, w_lo, w_lo + 15, k0, k0 + kBK - 1);
    uint32_t pd[kBK / 16][4];
    if (a.has_softcap)
      p_and_ds<true, false, kBK / 16>(a, cst, s, dp, nullptr, nullptr, l2,
                                      dl, row0, k0, t, masked, pd, pd);
    else
      p_and_ds<false, false, kBK / 16>(a, cst, s, dp, nullptr, nullptr, l2,
                                       dl, row0, k0, t, masked, pd, pd);

    wgmma::fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int n = 0; n < T::kNs; ++n)
        wgmma::MmaRS<T::kN>::run(
            1, dq[n], pd[kk],
            wgmma::advance_mn(
                dkb_mn + ((koff + n * (T::kN / 64) * kBK * 128) >> 4), kk));
    wgmma::commit();
    wgmma::wait<0>();
#pragma unroll
    for (int n = 0; n < T::kNs; ++n) wgmma::fence_operands(dq[n]);
    if (threadIdx.x % 128 == 0) tma::mbar_arrive(empty + st);
  }
  store();
}

// ===================================================================== //
// fp32: CUDA cores, fp32 rows padded to DP + 1 floats
// ===================================================================== //

// rows [0, n) of a tile into shared fp32 rows of DP + 1 floats; rows at
// or past `valid` and columns at or past d are zeros
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int n,
                                          int valid, int d) {
  for (int i = threadIdx.x; i < n * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    float x = 0.f;
    if (r < valid && c < d) x = src[r * row_stride + c];
    dst[r * (DP + 1) + c] = x;
  }
}

// s[i][j] = As[ty + 16 i] · Bs[tx + 16 j] over DP (4 x CJ micro-tile)
template <int DP, int CJ>
__device__ __forceinline__ void micro_product(const float* __restrict__ a,
                                              const float* __restrict__ b,
                                              float (&s)[4][CJ], int ty,
                                              int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < DP; ++kk) {
    float x[4], y[CJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty + 16 * i) * (DP + 1) + kk];
#pragma unroll
    for (int j = 0; j < CJ; ++j) y[j] = b[(tx + 16 * j) * (DP + 1) + kk];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
  }
}

// raw product -> the capped score, and tanh(r / c) for the chain rule
__device__ __forceinline__ float score(const Args& a, float raw, float& t) {
  float s = raw * a.scale;
  t = 0.f;
  if (a.has_softcap) {
    t = tanhf(s / a.softcap);
    s = a.softcap * t;
  }
  return s;
}

// P and dS of one (q tile, key tile) into shared memory (rows of
// BK + 16 floats: the two half-warps' rows land 16 banks apart)
template <int DP, int BK>
__device__ __forceinline__ void p_and_ds_f32(
    const Args& a, const float* Qs, const float* Ks, const float* Vs,
    const float* dOs, const float* lse, const float* dlt, float* Ps,
    float* dSs, int q0, int k0) {
  constexpr int CJ = BK / 16, BKS = BK + 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[4][CJ], dp[4][CJ];
  micro_product<DP, CJ>(Qs, Ks, s, ty, tx);
  micro_product<DP, CJ>(dOs, Vs, dp, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      float p = 0.f, ds = 0.f;
      if (visible(a, q0 + r, k0 + c)) {
        float t;
        const float x = score(a, s[i][j], t);
        p = expf(x - lse[r]);
        ds = p * (dp[i][j] - dlt[r]);
        if (a.has_softcap) ds *= 1.f - t * t;
      }
      if (Ps != nullptr) Ps[r * BKS + c] = p;
      dSs[r * BKS + c] = ds;
    }
}

template <int DP, int BK>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dkdv_kernel(const Args a) {
  constexpr int BKS = BK + 16, RJ = DP / 32, RI = BK / 8;
  extern __shared__ float smem_f[];
  float* Ks = smem_f;
  float* Vs = Ks + BK * (DP + 1);
  float* Qs = Vs + BK * (DP + 1);
  float* dOs = Qs + kBq * (DP + 1);
  float* Ps = dOs + kBq * (DP + 1);
  float* dSs = Ps + kBq * BKS;
  float* lse = dSs + kBq * BKS;
  float* dlt = lse + kBq;
  const int pair = blockIdx.x, bi = pair / a.hkv, hk = pair % a.hkv;
  const int k0 = blockIdx.y * BK;
  const int wy = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* k = static_cast<const float*>(a.k) + bi * a.k_sb + hk * a.k_sh;
  const float* v = static_cast<const float*>(a.v) + bi * a.v_sb + hk * a.v_sh;
  load_tile<DP>(Ks, k + k0 * a.k_ss, a.k_ss, BK, a.skv - k0, a.d);
  load_tile<DP>(Vs, v + k0 * a.v_ss, a.v_ss, BK, a.skv - k0, a.d);

  // thread holds keys wy + 8 i and columns lane + 32 j
  float dk[RI][RJ], dv[RI][RJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) dk[i][j] = 0.f, dv[i][j] = 0.f;

  int lo, hi;
  query_tiles(a, k0, BK, kBq, lo, hi);
  for (int g = 0; g < a.ratio; ++g) {
    const int h = hk * a.ratio + g;
    const long long row = ((long long)bi * a.hq + h) * a.sq_pad;
    const float* q = static_cast<const float*>(a.q) + bi * a.q_sb + h * a.q_sh;
    const float* dout =
        static_cast<const float*>(a.dout) + bi * a.do_sb + h * a.do_sh;
    for (int qt = lo; qt < hi; ++qt) {
      const int q0 = qt * kBq;
      __syncthreads();
      load_tile<DP>(Qs, q + q0 * a.q_ss, a.q_ss, kBq, a.sq - q0, a.d);
      load_tile<DP>(dOs, dout + q0 * a.do_ss, a.do_ss, kBq, a.sq - q0, a.d);
      for (int r = threadIdx.x; r < kBq; r += kThreads) {
        lse[r] = a.lse[row + q0 + r];        // padded rows: 0 past sq
        dlt[r] = a.delta[row + q0 + r];
      }
      __syncthreads();
      p_and_ds_f32<DP, BK>(a, Qs, Ks, Vs, dOs, lse, dlt, Ps, dSs, q0, k0);
      __syncthreads();
#pragma unroll 2
      for (int r = 0; r < kBq; ++r) {
        float x[RJ], y[RJ];
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          x[j] = dOs[r * (DP + 1) + lane + 32 * j];
          y[j] = Qs[r * (DP + 1) + lane + 32 * j];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const float p = Ps[r * BKS + wy + 8 * i];
          const float ds = dSs[r * BKS + wy + 8 * i];
#pragma unroll
          for (int j = 0; j < RJ; ++j) {
            dv[i][j] = fmaf(p, x[j], dv[i][j]);
            dk[i][j] = fmaf(ds, y[j], dk[i][j]);
          }
        }
      }
    }
  }
  float* dkp = static_cast<float*>(a.dk);
  float* dvp = static_cast<float*>(a.dv);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int kj = k0 + wy + 8 * i;
    if (kj >= a.skv) continue;
    const long long base = (((long long)bi * a.skv + kj) * a.hkv + hk) * a.d;
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      const int c = lane + 32 * j;
      if (c < a.d) {
        dkp[base + c] = dk[i][j] * a.scale;
        dvp[base + c] = dv[i][j];
      }
    }
  }
}

template <int DP, int BK>
__global__ void __launch_bounds__(kThreads) fa_bwd_dq_kernel(const Args a) {
  constexpr int BKS = BK + 16, RJ = DP / 32, RI = kBq / 8;
  extern __shared__ float smem_f[];
  float* Qs = smem_f;
  float* dOs = Qs + kBq * (DP + 1);
  float* Ks = dOs + kBq * (DP + 1);
  float* Vs = Ks + BK * (DP + 1);
  float* dSs = Vs + BK * (DP + 1);
  float* lse = dSs + kBq * BKS;
  float* dlt = lse + kBq;
  const int pair = blockIdx.x, bi = pair / a.hq, h = pair % a.hq;
  const int hk = h / a.ratio, q0 = blockIdx.y * kBq;
  const int wy = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = (long long)pair * a.sq_pad;
  const float* q = static_cast<const float*>(a.q) + bi * a.q_sb + h * a.q_sh;
  const float* dout =
      static_cast<const float*>(a.dout) + bi * a.do_sb + h * a.do_sh;
  const float* k = static_cast<const float*>(a.k) + bi * a.k_sb + hk * a.k_sh;
  const float* v = static_cast<const float*>(a.v) + bi * a.v_sb + hk * a.v_sh;
  load_tile<DP>(Qs, q + q0 * a.q_ss, a.q_ss, kBq, a.sq - q0, a.d);
  load_tile<DP>(dOs, dout + q0 * a.do_ss, a.do_ss, kBq, a.sq - q0, a.d);
  for (int r = threadIdx.x; r < kBq; r += kThreads) {
    lse[r] = a.lse[row + q0 + r];
    dlt[r] = a.delta[row + q0 + r];
  }

  // thread holds rows wy + 8 i and columns lane + 32 j
  float dq[RI][RJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) dq[i][j] = 0.f;

  int lo, hi;
  key_tiles(a, q0, kBq, BK, lo, hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<DP>(Ks, k + k0 * a.k_ss, a.k_ss, BK, a.skv - k0, a.d);
    load_tile<DP>(Vs, v + k0 * a.v_ss, a.v_ss, BK, a.skv - k0, a.d);
    __syncthreads();
    p_and_ds_f32<DP, BK>(a, Qs, Ks, Vs, dOs, lse, dlt, nullptr, dSs, q0, k0);
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float y[RJ];
#pragma unroll
      for (int j = 0; j < RJ; ++j) y[j] = Ks[c * (DP + 1) + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float ds = dSs[(wy + 8 * i) * BKS + c];
#pragma unroll
        for (int j = 0; j < RJ; ++j) dq[i][j] = fmaf(ds, y[j], dq[i][j]);
      }
    }
  }
  float* dqp = static_cast<float*>(a.dq);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + wy + 8 * i;
    if (qi >= a.sq) continue;
    const long long base = (((long long)bi * a.sq + qi) * a.hq + h) * a.d;
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      const int c = lane + 32 * j;
      if (c < a.d) dqp[base + c] = dq[i][j] * a.scale;
    }
  }
}

template <int DP, int BK>
constexpr int dkdv_smem() {
  return (2 * BK + 2 * kBq) * (DP + 1) * 4 + 2 * kBq * (BK + 16) * 4 +
         2 * kBq * 4;
}
template <int DP, int BK>
constexpr int dq_smem() {
  return (2 * BK + 2 * kBq) * (DP + 1) * 4 + kBq * (BK + 16) * 4 +
         2 * kBq * 4;
}

// ===================================================================== //
// launches
// ===================================================================== //

// The launch plan, in the order of kernels/flash_attention.py BwdPlan's
// fields (BwdPlan.launch_args).  The wrapper's plan is held to this
// kernel's own layout field by field (own_plan); the passes then launch
// the grids and shared memory it gives.
namespace pf {
enum Field {
  kDPad, kKeys, kQTile, kKvStages, kKvSmem, kDqRows, kDqBk, kDqStages,
  kDqSmem, kThreads, kSqPad, kHeadSplit, kDotBlocks, kKvBlocks,
  kReduceBlocks, kDqBlocks, kPartFloats, kFields
};
}  // namespace pf
constexpr int kPlanMismatch = -1;  // returned for a plan not this layout

// does `p` describe this call at these tiles?  head_split is the
// wrapper's choice (checked by the entry point); everything else
// follows from it and the tiles
bool own_plan(const long long* p, const Args& a, int dp, int keys,
              int kv_stages, int kv_smem, int dq_rows, int dq_bk,
              int dq_stages, int dq_smem, int threads) {
  const long long split = a.head_split;
  const long long n = (long long)a.b * a.skv * a.hkv * a.d;
  const long long sq_pad = (a.sq + 127LL) / 128 * 128;
  const long long want[pf::kFields] = {
      dp, keys, kBq, kv_stages, kv_smem, dq_rows, dq_bk, dq_stages, dq_smem,
      threads, sq_pad, split, ((long long)a.b * a.hq * sq_pad + 7) / 8,
      (long long)a.b * a.hkv * ((a.skv + keys - 1) / keys) * split,
      split > 1 ? (n + 1023) / 1024 : 0,
      (long long)a.b * a.hq * ((a.sq + dq_rows - 1) / dq_rows),
      split > 1 ? 2 * split * n : 0};
  for (int i = 0; i < pf::kFields; ++i)
    if (p[i] != want[i]) return false;
  return true;
}

int dot_pass(const Args& a, long long blocks, bool bf16, cudaStream_t st) {
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16)
    fa_bwd_dot_kernel<__nv_bfloat16>
        <<<static_cast<unsigned>(blocks), 256, 0, st>>>(a, kLog2e);
  else
    fa_bwd_dot_kernel<float><<<static_cast<unsigned>(blocks), 256, 0, st>>>(
        a, 1.f);
  return static_cast<int>(cudaGetLastError());
}

// the TMA map of q, dO, k or v: (d, heads, s, b) with byte strides of a
// head, a position and a batch row, boxes of 64 values x `rows`; a
// stride of a dimension of extent 1 is never followed and is replaced by
// 16 bytes, which TMA takes
bool bhsd_map(CUtensorMap* map, const void* base, int d, int heads, int s,
              int b, long long sh, long long ss, long long sb, int rows) {
  const long long dim[4] = {d, heads, s > 0 ? s : 1, b};
  const long long stride[3] = {heads > 1 ? 2 * sh : 16, s > 1 ? 2 * ss : 16,
                               b > 1 ? 2 * sb : 16};
  const int box[4] = {64, 1, rows, 1};
  return tma::make_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, dim,
                          stride, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

bool maps(Args& a, int q_rows, int kv_rows) {
  return bhsd_map(&a.tq, a.q, a.d, a.hq, a.sq, a.b, a.q_sh, a.q_ss, a.q_sb,
                  q_rows) &&
         bhsd_map(&a.tdo, a.dout, a.d, a.hq, a.sq, a.b, a.do_sh, a.do_ss,
                  a.do_sb, q_rows) &&
         bhsd_map(&a.tk, a.k, a.d, a.hkv, a.skv, a.b, a.k_sh, a.k_ss, a.k_sb,
                  kv_rows) &&
         bhsd_map(&a.tv, a.v, a.d, a.hkv, a.skv, a.b, a.v_sh, a.v_ss, a.v_sb,
                  kv_rows);
}

template <int D>
int launch_tc(Args a, const long long* p, cudaStream_t st) {
  using KV = Kv<D>;
  using DQ = Dq<D>;
  static_assert(KV::kThreads == DQ::kThreads, "one thread count a plan");
  if (!own_plan(p, a, D, KV::kKeys, KV::kStages, KV::kBytes, DQ::kRows,
                DQ::kBK, DQ::kStages, DQ::kBytes, KV::kThreads))
    return kPlanMismatch;
  cudaError_t e;
  int err = dot_pass(a, p[pf::kDotBlocks], true, st);
  if (err != 0) return err;
  if (p[pf::kKvBlocks] > 0) {
    if (!maps(a, static_cast<int>(p[pf::kQTile]),
              static_cast<int>(p[pf::kKeys])))
      return static_cast<int>(cudaErrorInvalidValue);
    if ((e = cudaFuncSetAttribute(fa_bwd_dkdv_tc_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(p[pf::kKvSmem]))) !=
        cudaSuccess)
      return static_cast<int>(e);
    fa_bwd_dkdv_tc_kernel<D>
        <<<static_cast<unsigned>(p[pf::kKvBlocks]),
           static_cast<unsigned>(p[pf::kThreads]),
           static_cast<size_t>(p[pf::kKvSmem]), st>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  if (p[pf::kReduceBlocks] > 0) {
    fa_bwd_reduce_kernel<<<static_cast<unsigned>(p[pf::kReduceBlocks]), 256,
                           0, st>>>(
        a.part, static_cast<__nv_bfloat16*>(a.dk),
        static_cast<__nv_bfloat16*>(a.dv),
        p[pf::kPartFloats] / 2 / a.head_split, a.head_split, a.scale);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  if (p[pf::kDqBlocks] > 0) {
    if (!maps(a, static_cast<int>(p[pf::kDqRows]),
              static_cast<int>(p[pf::kDqBk])))
      return static_cast<int>(cudaErrorInvalidValue);
    if ((e = cudaFuncSetAttribute(fa_bwd_dq_tc_kernel<D>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(p[pf::kDqSmem]))) !=
        cudaSuccess)
      return static_cast<int>(e);
    fa_bwd_dq_tc_kernel<D>
        <<<static_cast<unsigned>(p[pf::kDqBlocks]),
           static_cast<unsigned>(p[pf::kThreads]),
           static_cast<size_t>(p[pf::kDqSmem]), st>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

template <int DP, int BK>
int launch_f32(const Args& a, const long long* p, cudaStream_t st) {
  auto* kb = fa_bwd_dkdv_kernel<DP, BK>;
  auto* kc = fa_bwd_dq_kernel<DP, BK>;
  constexpr int sb = dkdv_smem<DP, BK>(), sc = dq_smem<DP, BK>();
  static_assert(sb <= 232448 && sc <= 232448, "shared memory");
  if (!own_plan(p, a, DP, BK, 1, sb, kBq, BK, 1, sc, kThreads))
    return kPlanMismatch;
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(kb, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                sb)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(kc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                sc)) != cudaSuccess)
    return static_cast<int>(e);
  int err = dot_pass(a, p[pf::kDotBlocks], false, st);
  if (err != 0) return err;
  // (B) and (C) read what (A) wrote: one stream orders them; their grids
  // are (pair, tile): the plan's block counts over the pairs
  if (p[pf::kKvBlocks] > 0) {
    const unsigned pairs = a.b * a.hkv;
    kb<<<dim3(pairs, static_cast<unsigned>(p[pf::kKvBlocks] / pairs)),
         kThreads, sb, st>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  if (p[pf::kDqBlocks] > 0) {
    const unsigned pairs = a.b * a.hq;
    kc<<<dim3(pairs, static_cast<unsigned>(p[pf::kDqBlocks] / pairs)),
         kThreads, sc, st>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16.  lse_in: the forward's (b, hq, sq)
// fp32 LSE; lse / delta: fp32 workspaces of b * hq * sq_pad floats;
// part: bf16 with head_split > 1, an fp32 workspace of part_floats = 2 x
// head_split x (b * skv * hkv * d) floats.  plan: pf::kFields values, the
// launch that kernels/flash_attention.py bwd_plan chose (it chooses
// head_split, a divisor of hq / hkv; fp32 takes 1): a plan that is not
// this kernel's layout returns kPlanMismatch (-1) and launches nothing.
// dq, dk, dv contiguous in the model layout.  bf16 needs d a multiple
// of 8, strides of q, k, v, dO a multiple of 8 and positive where the
// extent is above 1, and 16-byte aligned pointers (TMA; the wrapper
// checks).  Otherwise returns a CUDA error code (0 = launched).
extern "C" int repro_flash_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse_in, void* dq, void* dk, void* dv,
    void* lse, void* delta, void* part, int b, int sq, int skv, int hq,
    int hkv, int d, const long long* plan, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, long long do_sb, long long do_ss,
    long long do_sh, float scale, int causal, int has_window, int window,
    int has_softcap, float softcap, void* stream) {
  if ((dtype != 0 && dtype != 1) || d < 1 || d > 256 || hkv < 1 ||
      hq < hkv || hq % hkv != 0 || b < 0 || sq < 0 || skv < 0 ||
      (has_window && window < 1) || plan == nullptr ||
      (dtype == 1 && d % 8) || (sq + kBq - 1) / kBq > 65535 ||
      (skv + 31) / 32 > 65535 || (long long)b * hq > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  // head_split is the wrapper's choice: a divisor of hq / hkv, 1 for fp32
  const long long split = plan[pf::kHeadSplit];
  if (split < 1 || (hq / hkv) % split || (dtype == 0 && split != 1))
    return kPlanMismatch;
  if ((split > 1 && part == nullptr) || plan[pf::kSqPad] > 0x7fffffffLL ||
      plan[pf::kDotBlocks] > 0x7fffffffLL ||
      plan[pf::kKvBlocks] > 0x7fffffffLL ||
      plan[pf::kReduceBlocks] > 0x7fffffffLL ||
      plan[pf::kDqBlocks] > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.lse_in = static_cast<const float*>(lse_in);
  a.lse = static_cast<float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.part = static_cast<float*>(part);
  a.b = b;
  a.sq = sq;
  a.skv = skv;
  a.hq = hq;
  a.hkv = hkv;
  a.ratio = hq / hkv;
  a.d = d;
  a.sq_pad = static_cast<int>(plan[pf::kSqPad]);
  a.head_split = static_cast<int>(split);
  a.q_sb = q_sb;
  a.q_ss = q_ss;
  a.q_sh = q_sh;
  a.k_sb = k_sb;
  a.k_ss = k_ss;
  a.k_sh = k_sh;
  a.v_sb = v_sb;
  a.v_ss = v_ss;
  a.v_sh = v_sh;
  a.o_sb = o_sb;
  a.o_ss = o_ss;
  a.o_sh = o_sh;
  a.do_sb = do_sb;
  a.do_ss = do_ss;
  a.do_sh = do_sh;
  a.scale = scale;
  a.causal = causal;
  a.has_window = has_window;
  a.window = window;
  a.has_softcap = has_softcap;
  a.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (d <= 64) return launch_tc<64>(a, plan, st);
    if (d <= 128) return launch_tc<128>(a, plan, st);
    return launch_tc<256>(a, plan, st);
  }
  if (d <= 64) return launch_f32<64, 64>(a, plan, st);
  if (d <= 128) return launch_f32<128, 64>(a, plan, st);
  return launch_f32<256, 32>(a, plan, st);
}
