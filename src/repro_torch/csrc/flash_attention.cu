// flash_attention.cu — whole-sequence attention (prefill, scoring) for
// Hopper (compiled for sm_90a), with a plain C entry point for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_bhsd and computes its function, in the model layout
// q (b, sq, hq, d), k / v (b, skv, hkv, d), read through their strides
// (head_dim unit-stride), out (b, sq, hq, d) at q's dtype:
//   q_pos = q_offset + i,  k_pos = j
//   s_ij = softcap(scale * q_i·k_j)              (softcap before masking)
//   visible_ij = j < skv  (and q_pos >= k_pos if causal)
//                         (and q_pos - k_pos < window if windowed)
//   out_i = sum_j softmax(s_i)_j v_j             over the visible keys
// GQA through the head index (kv head = q head / (hq / hkv)), no KV copy.
// A row with no visible key yields zeros (l == 0 -> 1 over acc == 0), as
// the Pallas kernel does where it skips every tile of the row.  Given an
// lse array (training), each row's log-sum-exp over its visible keys is
// stored beside the output in fp32 (0 for a row with none), for
// flash_attention_bwd.cu; a null pointer stores nothing.
//
// Bound: at the prefill shapes (s in the thousands, d = 128) attention
// does ~s/2 flops per byte of q, k, v and out, above the card's ~295
// flop/byte balance point: it is bound by the tensor cores' rate
// (bf16) or the fp32 CUDA-core rate (fp32).  What the design does:
//   * the online softmax keeps the (sq, skv) score matrix out of device
//     memory: each block reads its q tile once and streams K/V tiles;
//   * K/V tiles that the causal mask or the window hides entirely are
//     never loaded nor computed (the Pallas kernel's pl.when skip,
//     with the same test on q_offset and the window), which halves a
//     causal prefill's work; only the tiles on the mask's edge pay the
//     per-element mask;
//   * q tiles of one (b, head) are issued heaviest first (the causal
//     tail has the most K/V tiles), so the last wave is short.  bf16
//     takes the (b, head) pairs in groups of `head_group` whose K and V
//     fit the L2 cache together, every q tile of a group before the
//     next group (heaviest first within it): a head's K/V tiles then come
//     from device memory about once, not once per q tile.
//
// bf16 (flash_attention_tc_kernel), after FlashAttention-3's plan:
//   * a block takes 128 query rows: two consumer warpgroups of 64 rows
//     and one producer warpgroup, of which one thread issues every copy
//     by TMA and the rest exit; setmaxnreg moves the producer's
//     registers to the consumers (24 against 240 a thread);
//   * TMA reads q, k and v through 4-D maps (d, head, s, b) over the
//     model layout as it is, in boxes of 64 values of d (128 bytes,
//     128-byte swizzle, the layout wgmma reads) x 128 rows (q) or BK keys
//     (k, v); the maps' zero fill pads a ragged last tile and d up to
//     64, 128 or 256, so no padded copy is ever made.  Q goes in once;
//     K and V tiles fill a ring of kStages stages, each tile with a
//     "full" mbarrier (the copies' bytes) and an "empty" one (both
//     warpgroups done with it): K is freed once Q K^T has read it, V
//     once P V has;
//   * S = Q K^T by wgmma m64nBKk16, both operands in shared memory, both
//     K-major (wgmma.cuh Mma<BK>); scores in log2 units with the scale
//     folded in, so p is one ex2; the online softmax keeps each row's
//     max and sum over the 4 threads that share it;
//   * O += P V by wgmma with A from registers (wgmma.cuh MmaRS): S's
//     fp32 accumulator fragment, packed pairwise to bf16, is already the
//     A operand of the next k16 slice, so P never touches shared memory;
//     V is the B operand, MN-major (d contiguous), read through
//     desc_sw128_mn;
//   * each warpgroup overlaps its own work (FlashAttention-3's
//     intra-warpgroup pipeline): tile j + 1's Q K^T is issued before
//     tile j's P V, and tile j + 1's softmax runs while P V of tile j is
//     still on the tensor cores; the two warpgroups interleave besides;
//   * BK = 128 keys a tile at d <= 128, 64 at d = 256 (the output
//     accumulators take 128 registers a thread there); 2 stages: 80 KB
//     of shared memory at d 64, 160 KB at 128, 192 KB at 256, one block
//     an SM.
//   The tensor cores' fp32 accumulation truncates; at these depths (d
//   values a score, one tile of keys a product into O) that is far inside
//   the bf16 tolerance.
//
// fp32 (flash_attention_f32_kernel) runs on the CUDA cores in fp32 (no
// TF32: the conformance tests hold it to 2e-5 of the plain version), 64
// query rows a block of 256 threads, as 4x4 register micro-tiles over
// transposed shared tiles (float4 loads), K/V tiles of 64 keys, d padded
// to 64 / 128 / 256 with zeros.
//
// Not yet done (later work): ping-pong ordering of the two consumer
// warpgroups' products, a persistent schedule, a TMA store of the
// output, a tensor-core fp32 leg.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma.cuh"
#include "wgmma.cuh"

namespace {

constexpr float kNegInf = -INFINITY;

struct Args {
  CUtensorMap tq, tk, tv;   // TMA maps of q, k, v (bf16 kernel)
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;               // (b, hq, sq) natural-log LSE, or null
  int sq, skv, hq, ratio, d, q_offset;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb,
      o_ss, o_sh;
  float scale;
  int causal, has_window, window, has_softcap;
  float softcap;
  int head_group;           // bf16: (b, head) pairs a group of the grid
};

// The K/V tiles [j_begin, j_end) a q tile must visit (the others are
// fully masked), for q positions [q_lo, q_hi] and tiles of bk keys.
__device__ __forceinline__ void kv_range(const Args& a, int q_lo, int q_hi,
                                         int bk, int* j_begin, int* j_end) {
  const int nk = (a.skv + bk - 1) / bk;
  int jb = 0, je = nk;
  if (a.causal) je = min(nk, q_hi / bk + 1);          // k0 <= q_hi
  if (a.has_window) {                                 // k0+bk-1 > q_lo-w
    const int lo = q_lo - a.window + 1;               // first visible key
    jb = lo > 0 ? lo / bk : 0;
  }
  *j_begin = jb;
  *j_end = je;
}

__device__ __forceinline__ bool visible(const Args& a, int q_pos,
                                        int k_pos) {
  if (k_pos >= a.skv) return false;
  if (a.causal && q_pos < k_pos) return false;
  if (a.has_window && q_pos - k_pos >= a.window) return false;
  return true;
}

// Is every key of [k0, k0 + bk) visible to every row of [q_lo, q_hi]?
__device__ __forceinline__ bool tile_full(const Args& a, int q_lo, int q_hi,
                                          int k0, int bk) {
  if (k0 + bk > a.skv) return false;
  if (a.causal && k0 + bk - 1 > q_lo) return false;
  if (a.has_window && q_hi - k0 >= a.window) return false;
  return true;
}

__device__ __forceinline__ float softcapped(const Args& a, float s) {
  s *= a.scale;
  if (a.has_softcap) s = tanhf(s / a.softcap) * a.softcap;
  return s;
}

// ===================================================================== //
// bf16: wgmma, TMA-fed K/V, warp-specialized
// ===================================================================== //

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// The bf16 kernel's shape at padded head_dim D (64, 128, 256).  Shared
// memory, each piece on a 1024-byte boundary: the q tile (D / 64 column
// blocks of 128 rows x 128 bytes), then kStages K tiles and kStages V
// tiles (D / 64 column blocks of kBK rows x 128 bytes each), then the
// mbarriers: q, then for K and for V a "full" and an "empty" barrier a
// stage.
template <int D>
struct Tc {
  static constexpr int kRows = 128;               // query rows a block
  static constexpr int kBK = D == 256 ? 64 : 128; // keys a tile
  static constexpr int kStages = 2;
  static constexpr int kThreads = 384;            // 2 consumer WGs + 1
  static constexpr int kCols = D / 64;            // 64-wide column blocks
  static constexpr int kQ = kRows * D * 2;        // bytes of the q tile
  static constexpr int kKV = kBK * D * 2;         // bytes of a K (V) tile
  static constexpr int kKOff = kQ;
  static constexpr int kVOff = kKOff + kStages * kKV;
  static constexpr int kBarOff = kVOff + kStages * kKV;
  static constexpr int kBytes = kBarOff + (1 + 4 * kStages) * 8 + 1024;
  static constexpr int kPV = D < 128 ? D : 128;   // N of one P V product
  static constexpr int kPVs = D / kPV;            // P V products a slice
};

template <int D>
__global__ void __launch_bounds__(Tc<D>::kThreads, 1)
    flash_attention_tc_kernel(const __grid_constant__ Args a) {
  using T = Tc<D>;
  constexpr int kBK = T::kBK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (tma::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* qs = smem;
  uint8_t* ks = smem + T::kKOff;
  uint8_t* vs = smem + T::kVOff;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + T::kBarOff);
  uint64_t* kfull = qbar + 1;                     // K tile landed
  uint64_t* vfull = kfull + T::kStages;           // V tile landed
  uint64_t* kempty = vfull + T::kStages;          // K tile read by both
  uint64_t* vempty = kempty + T::kStages;         // V tile read by both

  // block -> (b * hq + head, q tile): group of head_group pairs, then
  // the q tile (heaviest first), then the pair within the group
  const int n_qt = (a.sq + T::kRows - 1) / T::kRows;
  const int bh_all = gridDim.x / n_qt;
  const int group = blockIdx.x / (a.head_group * n_qt);
  const int in_group = min(a.head_group, bh_all - group * a.head_group);
  const int rank = blockIdx.x - group * a.head_group * n_qt;
  const int qt = n_qt - 1 - rank / in_group;
  const int bh = group * a.head_group + rank % in_group;
  const int bi = bh / a.hq, h = bh % a.hq, kvh = h / a.ratio;
  const int q0 = qt * T::kRows;
  const int q_lo = a.q_offset + q0;
  const int q_hi = a.q_offset + min(q0 + T::kRows, a.sq) - 1;
  int jb, je;
  kv_range(a, q_lo, q_hi, kBK, &jb, &je);

  if (threadIdx.x == 0) {
    tma::mbar_init(qbar, 1);
    for (int s = 0; s < T::kStages; ++s) {
      tma::mbar_init(kfull + s, 1);    // the producer's arrival + bytes
      tma::mbar_init(vfull + s, 1);
      tma::mbar_init(kempty + s, 2);   // one arrival a consumer warpgroup
      tma::mbar_init(vempty + s, 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {                       // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256 && jb < je) {    // else the tile sees no key
      tma::mbar_expect(qbar, T::kQ);
#pragma unroll
      for (int c = 0; c < T::kCols; ++c)
        tma::tma_4d(qs + c * T::kRows * 128, &a.tq, 64 * c, h, q0, bi, qbar);
      // K and V of a stage are freed apart: K once both warpgroups'
      // Q K^T is done, V once their P V is
      for (int i = 0; i < je - jb; ++i) {
        const int st = i % T::kStages, ph = (i / T::kStages - 1) & 1;
        const int k0 = (jb + i) * kBK;
        if (i >= T::kStages) tma::mbar_wait(kempty + st, ph);
        tma::mbar_expect(kfull + st, T::kKV);
#pragma unroll
        for (int c = 0; c < T::kCols; ++c)
          tma::tma_4d(ks + st * T::kKV + c * kBK * 128, &a.tk, 64 * c, kvh,
                      k0, bi, kfull + st);
        if (i >= T::kStages) tma::mbar_wait(vempty + st, ph);
        tma::mbar_expect(vfull + st, T::kKV);
#pragma unroll
        for (int c = 0; c < T::kCols; ++c)
          tma::tma_4d(vs + st * T::kKV + c * kBK * 128, &a.tv, 64 * c, kvh,
                      k0, bi, vfull + st);
      }
    }
    return;
  }

  // ---- the consumer warpgroups ------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // this thread's rows: row0 and row0 + 8 (registers 4 i + 0, 1 and
  // 4 i + 2, 3 of every accumulator)
  const int row0 = q0 + 64 * wg + 16 * warp + g;
  const int pos0 = a.q_offset + row0, pos1 = pos0 + 8;
  const int w_lo = a.q_offset + q0 + 64 * wg + 16 * warp;  // the warp's
  const int w_hi = w_lo + 15;                               // rows

  // the softmax's constants (see softmax below)
  const float x_mul = a.scale / a.softcap;
  const float x_cap = a.softcap * kLog2e;
  const float xs = a.has_softcap ? 1.f : a.scale * kLog2e;

  // descriptors: this warpgroup's 64 q rows of column block 0; K and V of
  // stage 0, column block 0 (16-byte units are added to step across)
  const uint64_t dq = wgmma::desc_sw128(qs + 64 * wg * 128);
  const uint64_t dk = wgmma::desc_sw128(ks);
  const uint64_t dv = wgmma::desc_sw128_mn(vs, kBK * 128);

  float o[T::kPVs][T::kPV / 2];
#pragma unroll
  for (int n = 0; n < T::kPVs; ++n)
#pragma unroll
    for (int i = 0; i < T::kPV / 2; ++i) o[n][i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float s[kBK / 2];                               // S of one tile
  uint32_t p[kBK / 16][4];                        // P of one tile, bf16

  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.out) + bi * a.o_sb +
                      h * a.o_sh;
  // out rows row0, row0 + 8 = o / l (0 where l == 0); with a.lse, their
  // LSE, (m + log2 l) ln 2 (0 where l == 0)
  auto store = [&]() {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    if (a.lse != nullptr && t == 0) {
      float* lse = a.lse + (long long)bh * a.sq;
      if (row0 < a.sq)
        lse[row0] = l0 > 0.f ? (m0 + log2f(l0)) * kLn2 : 0.f;
      if (row0 + 8 < a.sq)
        lse[row0 + 8] = l1 > 0.f ? (m1 + log2f(l1)) * kLn2 : 0.f;
    }
    const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
    const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
#pragma unroll
    for (int n = 0; n < T::kPVs; ++n)
#pragma unroll
      for (int r = 0; r < T::kPV / 2; r += 4) {
        const int col = n * T::kPV + 2 * r + 2 * t;   // 8 (r / 4) + 2 t
        if (col >= a.d) continue;
        if (row0 < a.sq)
          *reinterpret_cast<__nv_bfloat162*>(og + row0 * a.o_ss + col) =
              __floats2bfloat162_rn(o[n][r] * inv0, o[n][r + 1] * inv0);
        if (row0 + 8 < a.sq)
          *reinterpret_cast<__nv_bfloat162*>(og + (row0 + 8) * a.o_ss +
                                             col) =
              __floats2bfloat162_rn(o[n][r + 2] * inv1, o[n][r + 3] * inv1);
      }
  };
  if (jb >= je) {          // no visible key in the tile: zeros (no copies
    store();               // were issued)
    return;
  }

  // S = Q K_j^T into s (64 rows x kBK keys, d / 16 slices): one group
  auto issue_s = [&](int j) {
    const int st = (j - jb) % T::kStages;
#pragma unroll
    for (int ks16 = 0; ks16 < D / 16; ++ks16) {
      const int c = ks16 / 4;                     // column block of d
      wgmma::Mma<kBK>::run(
          ks16 > 0, s,
          wgmma::advance(dq + (c * T::kRows * 128 >> 4), ks16 % 4),
          wgmma::advance(dk + ((st * T::kKV + c * kBK * 128) >> 4),
                         ks16 % 4));
    }
    wgmma::commit();
  };
  // O += P V_j (kBK / 16 slices of keys, A from registers): one group
  auto issue_pv = [&](int j) {
    const int st = (j - jb) % T::kStages;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int n = 0; n < T::kPVs; ++n)
        wgmma::MmaRS<T::kPV>::run(
            1, o[n], p[kk],
            wgmma::advance_mn(
                dv + ((st * T::kKV + n * (T::kPV / 64) * kBK * 128) >> 4),
                kk));
    wgmma::commit();
  };
  // Tile j's softcap, mask and online softmax on rows g, g + 8: s becomes
  // the tile's exponentials, m and l move on, c0 / c1 rescale o.  The
  // softcap and the mask are warp-uniform loops of their own: a plain
  // tile spends one fmax, one fma and one ex2 an element.  Scores in
  // log2 units are x = xs * s: with a softcap s is first replaced by
  // log2(e) * softcap * tanh(scale * s / softcap) and xs = 1, else xs =
  // log2(e) * scale folds into the fma of the exponent.
  auto softmax = [&](int j, float& c0, float& c1) {
    const int k0 = j * kBK;
    if (a.has_softcap) {
#pragma unroll
      for (int r = 0; r < kBK / 2; ++r) s[r] = tanhf(s[r] * x_mul) * x_cap;
    }
    if (!tile_full(a, w_lo, w_hi, k0, kBK)) {
#pragma unroll
      for (int r = 0; r < kBK / 2; ++r)
        if (!visible(a, (r & 2) ? pos1 : pos0,
                     k0 + 8 * (r >> 2) + 2 * t + (r & 1)))
          s[r] = kNegInf;
    }
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * nt], s[4 * nt + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * nt + 2], s[4 * nt + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {      // the quad of a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // a row with nothing visible yet has m = -inf: subtract 0 instead,
    // so its p = 2^-inf = 0 and acc = l = 0 stay (no inf - inf)
    const float mn0 = fmaxf(m0, mx0 * xs), mn1 = fmaxf(m1, mx1 * xs);
    const float mu0 = mn0 == kNegInf ? 0.f : mn0;
    const float mu1 = mn1 == kNegInf ? 0.f : mn1;
    c0 = ex2(m0 - mu0);
    c1 = ex2(m1 - mu1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int r = 0; r < kBK / 2; ++r) {
      s[r] = ex2(fmaf(s[r], xs, (r & 2) ? -mu1 : -mu0));
      if (r & 2)
        sum1 += s[r];
      else
        sum0 += s[r];
    }
    l0 = l0 * c0 + sum0;                          // per-thread partials
    l1 = l1 * c1 + sum1;
  };
  // registers 8 kk .. 8 kk + 7 of S, packed pairwise: the A fragment of
  // keys 16 kk .. 16 kk + 15 (wgmma.cuh MmaRS)
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
  };
  // landed: wait for tile j's K (V) copies; release: this warpgroup is
  // done with them (one of the two arrivals that free the stage)
  auto landed = [&](uint64_t* bar, int j) {
    tma::mbar_wait(bar + (j - jb) % T::kStages,
                   ((j - jb) / T::kStages) & 1);
  };
  auto release = [&](uint64_t* bar, int j) {
    if (threadIdx.x % 128 == 0)
      tma::mbar_arrive(bar + (j - jb) % T::kStages);
  };

  // The pipeline, FlashAttention-3's intra-warpgroup overlap: tile j + 1's
  // Q K^T is issued before tile j's P V, and runs on the tensor cores
  // while this warpgroup waits for it; tile j + 1's softmax then runs
  // while P V of tile j is still in flight.  No product sits behind a
  // branch: the first S and the last P V are peeled out of the loop.
  tma::mbar_wait(qbar, 0);
  landed(kfull, jb);
  wgmma::fence();
  issue_s(jb);
  wgmma::wait<0>();
  wgmma::fence_operands(s);
  release(kempty, jb);
  {
    float c0, c1;                                 // o is 0: no rescale
    softmax(jb, c0, c1);
  }
  pack();
  for (int j = jb; j + 1 < je; ++j) {
    landed(kfull, j + 1);
    landed(vfull, j);
    wgmma::fence();
    issue_s(j + 1);
    issue_pv(j);
    wgmma::wait<1>();                             // S of tile j + 1
    wgmma::fence_operands(s);
    release(kempty, j + 1);
    float c0, c1;
    softmax(j + 1, c0, c1);
    wgmma::wait<0>();                             // P V of tile j
#pragma unroll
    for (int n = 0; n < T::kPVs; ++n) wgmma::fence_operands(o[n]);
    release(vempty, j);
#pragma unroll
    for (int n = 0; n < T::kPVs; ++n)
#pragma unroll
      for (int r = 0; r < T::kPV / 2; ++r) o[n][r] *= (r & 2) ? c1 : c0;
    pack();
  }
  landed(vfull, je - 1);
  wgmma::fence();
  issue_pv(je - 1);
  wgmma::wait<0>();
#pragma unroll
  for (int n = 0; n < T::kPVs; ++n) wgmma::fence_operands(o[n]);
  release(vempty, je - 1);
  store();
}

// ===================================================================== //
// fp32: CUDA cores, 4x4 register micro-tiles
// ===================================================================== //

constexpr int kBq = 64;          // query rows per block
constexpr int kF32Threads = 256;
constexpr int kBk32 = 64;        // keys per tile
constexpr int kLdT = 68;         // row stride of the transposed tiles

// Transposed tile dst[c][r] (row stride kLdT) of src rows [r0, r0 + 64),
// columns [0, D), zero-filled past n_rows and d.  Consecutive threads
// take consecutive rows: conflict-free shared writes.
template <int D>
__device__ __forceinline__ void load_transposed(float* dst, const float* base,
                                                long long row_stride, int r0,
                                                int n_rows, int d) {
  for (int i = threadIdx.x; i < 64 * (D / 4); i += kF32Threads) {
    const int r = i % 64, c = (i / 64) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n_rows && c < d)
      x = *reinterpret_cast<const float4*>(base + (long long)(r0 + r) *
                                                      row_stride + c);
    dst[(c + 0) * kLdT + r] = x.x;
    dst[(c + 1) * kLdT + r] = x.y;
    dst[(c + 2) * kLdT + r] = x.z;
    dst[(c + 3) * kLdT + r] = x.w;
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
    flash_attention_f32_kernel(Args a) {
  constexpr int kOC = D / 64;                       // float4 O groups
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qt_s = reinterpret_cast<float*>(smem_raw);  // [D][kLdT]
  float* kv_s = qt_s + D * kLdT;                    // K^T [D][kLdT] or V [64][D]
  float* pt_s = kv_s + D * kLdT;                    // P^T [64][kLdT]

  const int n_qt = gridDim.y;
  const int qt = n_qt - 1 - blockIdx.y;             // heaviest first
  const int bh = blockIdx.x;
  const int bi = bh / a.hq, h = bh % a.hq, kvh = h / a.ratio;
  const int q0 = qt * kBq;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const float* qg = static_cast<const float*>(a.q) + bi * a.q_sb + h * a.q_sh;
  const float* kg = static_cast<const float*>(a.k) + bi * a.k_sb +
                    kvh * a.k_sh;
  const float* vg = static_cast<const float*>(a.v) + bi * a.v_sb +
                    kvh * a.v_sh;

  const int q_lo = a.q_offset + q0;
  const int q_hi = a.q_offset + min(q0 + kBq, a.sq) - 1;
  int jb, je;
  kv_range(a, q_lo, q_hi, kBk32, &jb, &je);

  float o[4][kOC][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kOC; ++c) o[r][c][0] = o[r][c][1] = o[r][c][2] =
        o[r][c][3] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  load_transposed<D>(qt_s, qg, a.q_ss, q0, a.sq, a.d);

  for (int j = jb; j < je; ++j) {
    const int k0 = j * kBk32;
    load_transposed<D>(kv_s, kg, a.k_ss, k0, a.skv, a.d);
    __syncthreads();

    // ---- S: rows ty*4 + r, keys tx*4 + c ------------------------------
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) s[r][0] = s[r][1] = s[r][2] = s[r][3] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      const float4 qa = *reinterpret_cast<const float4*>(qt_s + kk * kLdT +
                                                         ty * 4);
      const float4 kb = *reinterpret_cast<const float4*>(kv_s + kk * kLdT +
                                                         tx * 4);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

    const bool full = tile_full(a, q_lo + ty * 4, q_lo + ty * 4 + 3, k0,
                                kBk32);
    float corr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qp = q_lo + ty * 4 + r;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = softcapped(a, s[r][c]);
        if (!full && !visible(a, qp, k0 + tx * 4 + c)) x = kNegInf;
        s[r][c] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)        // the 16 tx of a row
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[r], mx);
      corr[r] = mn == kNegInf ? 1.f : expf(m[r] - mn);
      m[r] = mn;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = s[r][c] == kNegInf ? 0.f : expf(s[r][c] - mn);
        s[r][c] = p;
        sum += p;
      }
      l[r] = l[r] * corr[r] + sum;                  // per-thread partial
    }
    // P^T[key][row]
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(pt_s + (tx * 4 + c) * kLdT + ty * 4) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();                                // K^T read, P^T written

    // V tile [64][D] into the same buffer
    for (int i = threadIdx.x; i < 64 * (D / 4); i += kF32Threads) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < a.skv && c < a.d)
        x = *reinterpret_cast<const float4*>(vg + (long long)(k0 + r) *
                                                      a.v_ss + c);
      *reinterpret_cast<float4*>(kv_s + r * D + c) = x;
    }
    __syncthreads();

    // ---- O = O * corr + P V: rows ty*4 + r, columns tx*4 + 64*c --------
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < kOC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[r][c][e] *= corr[r];
#pragma unroll 4
    for (int kk = 0; kk < kBk32; ++kk) {
      const float4 pa = *reinterpret_cast<const float4*>(pt_s + kk * kLdT +
                                                         ty * 4);
      const float pv[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int c = 0; c < kOC; ++c) {
        const float4 vb = *reinterpret_cast<const float4*>(
            kv_s + kk * D + c * 64 + tx * 4);
        const float vv[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[r][c][e] = fmaf(pv[r], vv[e], o[r][c][e]);
      }
    }
    __syncthreads();                                // V, P^T reused next
  }

  float* og = static_cast<float*>(a.out) + bi * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float lr = l[r];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      lr += __shfl_xor_sync(0xffffffffu, lr, off);
    const float inv = 1.f / (lr == 0.f ? 1.f : lr);
    const int row = q0 + ty * 4 + r;
    if (row >= a.sq) continue;
    if (a.lse != nullptr && tx == 0)
      a.lse[(long long)bh * a.sq + row] = lr > 0.f ? m[r] + logf(lr) : 0.f;
#pragma unroll
    for (int c = 0; c < kOC; ++c) {
      const int col = c * 64 + tx * 4;
      if (col < a.d)
        *reinterpret_cast<float4*>(og + row * a.o_ss + col) =
            make_float4(o[r][c][0] * inv, o[r][c][1] * inv,
                        o[r][c][2] * inv, o[r][c][3] * inv);
    }
  }
}


// A check of wgmma.cuh's MmaRS and desc_sw128_mn: one warpgroup computes
// d (64, N) fp32 = a (64, k) @ b (k, N) for bf16 a (row-major, row
// stride k) and b (row-major, row stride N: N contiguous, MN-major), k a
// multiple of 16 up to 64, N 64 or 128.  b is stored as N / 64 column
// blocks of 64 k rows x 128 bytes, swizzled, zero past k (lbo = 64 x
// 128 bytes); a's fragments are loaded from device memory straight into
// the registers MmaRS reads; k / 16 products, the first with scale-d 0.
template <int N>
__global__ void __launch_bounds__(128) wgmma_rs_unit_kernel(
    const __nv_bfloat16* a, const __nv_bfloat16* b, float* d, int k) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sb =
      smem_raw + ((1024 - (tma::smem_addr(smem_raw) & 1023)) & 1023);
  constexpr int kLbo = 64 * 128;
  for (int i = threadIdx.x; i < (N / 64) * 64 * 8; i += 128) {
    const int blk = i / 512, r = (i / 8) % 64, c = i % 8;
    *reinterpret_cast<uint4*>(sb + blk * kLbo + wgmma::sw128(r, c)) =
        r < k ? *reinterpret_cast<const uint4*>(b + r * N + blk * 64 + 8 * c)
              : make_uint4(0, 0, 0, 0);
  }
  wgmma::fence_proxy_async();
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = 16 * warp + lane / 4, col = 2 * (lane % 4);
  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  const uint64_t db = wgmma::desc_sw128_mn(sb, kLbo);
  uint32_t frag[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int kc = 16 * j + col + 8 * (r >> 1), rr = row + 8 * (r & 1);
      frag[j][r] = kc < k ? *reinterpret_cast<const uint32_t*>(
                                a + rr * k + kc)
                          : 0u;
    }
  wgmma::fence_operands(acc);
  wgmma::fence();
#pragma unroll
  for (int j = 0; j < 4; ++j)   // the slices past k are zeros
    wgmma::MmaRS<N>::run(j > 0, acc, frag[j], wgmma::advance_mn(db, j));
  wgmma::commit();
  wgmma::wait<0>();
  wgmma::fence_operands(acc);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int r = row + 8 * ((i >> 1) & 1);
    const int c = 8 * (i >> 2) + col + (i & 1);
    d[r * N + c] = acc[i];
  }
}

// the TMA map of q, k or v: (d, heads, s, b) with byte strides of a
// head, a position and a batch row, boxes of 64 values x `rows`; a
// stride of a dimension of extent 1 is never followed and is replaced by
// 16 bytes, which TMA takes
bool fa_map(CUtensorMap* map, const void* base, int d, int heads, int s,
            int b, long long sh, long long ss, long long sb, int rows) {
  const long long dim[4] = {d, heads, s, b};
  const long long stride[3] = {heads > 1 ? 2 * sh : 16, s > 1 ? 2 * ss : 16,
                               b > 1 ? 2 * sb : 16};
  const int box[4] = {64, 1, rows, 1};
  return tma::make_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, dim,
                          stride, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D>
int launch_tc(const Args& args, int b, cudaStream_t st) {
  using T = Tc<D>;
  Args a = args;
  const int hkv = a.hq / a.ratio;
  // with skv 0 no K / V tile is ever copied, but a map needs extent 1
  const int kv_len = a.skv > 0 ? a.skv : 1;
  if (!fa_map(&a.tq, a.q, a.d, a.hq, a.sq, b, a.q_sh, a.q_ss, a.q_sb,
              T::kRows) ||
      !fa_map(&a.tk, a.k, a.d, hkv, kv_len, b, a.k_sh, a.k_ss, a.k_sb,
              T::kBK) ||
      !fa_map(&a.tv, a.v, a.d, hkv, kv_len, b, a.v_sh, a.v_ss, a.v_sb,
              T::kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = static_cast<long long>(b) * a.hq *
                           ((a.sq + T::kRows - 1) / T::kRows);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_attention_tc_kernel<D>
      <<<static_cast<unsigned>(blocks), T::kThreads, T::kBytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const Args& a, int b, cudaStream_t st) {
  const int smem = sizeof(float) * kLdT * (2 * D + kBk32);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_f32_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * a.hq, (a.sq + kBq - 1) / kBq);
  flash_attention_f32_kernel<D><<<grid, kF32Threads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype code: 0 = float32, 1 = bfloat16 (q, k, v and out alike).  lse:
// null, or an fp32 (b, hq, sq) contiguous array that receives each row's
// natural-log LSE over its visible keys (0 for a row with none), which
// the backward reads.
// Strides are in elements; head_dim must be the unit-stride axis, d a
// multiple of 8 (bf16) or 4 (fp32), every stride a multiple of that and
// the pointers 16-byte aligned (the wrapper checks; bf16 also needs
// every stride of an extent above 1 positive, for TMA).  head_group (>=
// 1): the bf16 grid's (b, head) pairs a group (kernels/flash_attention.py
// plan chooses it; the fp32 grid is (b * hq, q tiles)).  Returns
// cudaGetLastError() after the launch (0 = ok), cudaErrorInvalidValue
// for what the kernels do not take.
extern "C" int repro_flash_attention(
    int dtype, const void* q, const void* k, const void* v, void* out,
    void* lse, int b, int sq, int skv, int hq, int hkv, int d,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, float scale, int causal, int has_window,
    int window, int has_softcap, float softcap, int q_offset, int head_group,
    void* stream) {
  const int vec = dtype == 1 ? 8 : 4;
  if (d < 1 || d > 256 || d % vec != 0 || hkv < 1 || hq < hkv ||
      hq % hkv != 0 || b < 0 || sq < 0 || skv < 0 || q_offset < 0 ||
      (has_window && window < 1) || (sq + kBq - 1) / kBq > 65535 ||
      head_group < 1 ||
      (long long)b * hq > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || sq == 0) return 0;
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.lse = static_cast<float*>(lse);
  a.sq = sq;
  a.skv = skv;
  a.hq = hq;
  a.ratio = hq / hkv;
  a.d = d;
  a.q_offset = q_offset;
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
  a.scale = scale;
  a.causal = causal;
  a.has_window = has_window;
  a.window = window;
  a.has_softcap = has_softcap;
  a.softcap = softcap;
  a.head_group = head_group;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (d <= 64) return launch_tc<64>(a, b, st);
    if (d <= 128) return launch_tc<128>(a, b, st);
    return launch_tc<256>(a, b, st);
  }
  if (dtype == 0) {
    if (d <= 64) return launch_f32<64>(a, b, st);
    if (d <= 128) return launch_f32<128>(a, b, st);
    return launch_f32<256>(a, b, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// a (64, k), b (k, n) bf16 row-major and 16-byte aligned, d (64, n) fp32;
// k in 16, 32, 48, 64, n in 64, 128.
extern "C" int repro_wgmma_rs_unit(const void* a, const void* b, void* d,
                                   int k, int n, void* stream) {
  if (k < 16 || k > 64 || k % 16 || (n != 64 && n != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* pa = static_cast<const __nv_bfloat16*>(a);
  const auto* pb = static_cast<const __nv_bfloat16*>(b);
  float* pd = static_cast<float*>(d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = (n / 64) * 64 * 128 + 1024;
  if (n == 64)
    wgmma_rs_unit_kernel<64><<<1, 128, smem, st>>>(pa, pb, pd, k);
  else
    wgmma_rs_unit_kernel<128><<<1, 128, smem, st>>>(pa, pb, pd, k);
  return static_cast<int>(cudaGetLastError());
}
