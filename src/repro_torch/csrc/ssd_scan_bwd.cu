// ssd_scan_bwd.cu — the backward of the Mamba-2 SSD chunked scan
// (ssd_scan.cu), for Hopper (compiled for sm_90a), with a plain C entry
// point for ctypes.
//
// Replaces no Pallas kernel: the reference's Pallas ssd_scan_bhsp
// (src/repro/kernels/ssd_scan.py) has no backward, and the reference
// trains by differentiating its XLA ssd_chunked
// (src/repro/models/ssm.py).  The port's forward is the hand-written
// ssd_scan.cu, so training through it needs this kernel; it computes the
// gradients of kernels/ssd_scan.py::ssd_scan_bwd_plain, on the model
// layout: x (bt, s, h, p), dt_a (bt, s, h), b and c (bt, s, n) shared by
// all heads, dy like x, the states the forward stored (the state
// entering each chunk, (bt, s / q, h, p, n) fp32) and an optional
// cotangent of the final state (bt, h, p, n) fp32.
//
// The formulas, for one (row, head) and one chunk of q positions:
//   A = cumsum(dt_a) over the chunk (fp64, rounded to fp32, as the
//   forward), A_last its last value; L[l,s] = exp(A_l - A_s) for l >= s,
//   else 0; G = (C·Bᵀ) ⊙ L; S the state entering the chunk, dS' the
//   gradient of the state leaving it (the final-state cotangent, or 0,
//   at the last chunk); M[l,s] = dy_l · x_s; w_s = exp(A_last - A_s),
//   e_l = exp(A_l); then
//   dx_s = Σ_l G[l,s] dy_l + w_s dS' b_s
//   dc_l = Σ_s (M ⊙ L)[l,s] b_s + e_l Sᵀ dy_l          (+ over heads)
//   db_s = Σ_l (M ⊙ L)[l,s] c_l + w_s dS'ᵀ x_s         (+ over heads)
//   dA_l = Σ_s W[l,s] - Σ_s W[s,l] + e_l dy_l·(S c_l) - V_l, W = M ⊙ G,
//          V_s = w_s x_s·(dS' b_s); at l = q-1 also + Σ_s V_s +
//          exp(A_last) ⟨dS', S⟩
//   d dt_a = the reverse cumulative sum of dA within the chunk
//   dS = exp(A_last) dS' + Σ_l e_l dy_l c_lᵀ, the previous chunk's dS';
//   at chunk 0 the gradient of the initial state.
//
// The passes (one launch each, in this order, on the caller's stream):
//   acs    a thread per (row, chunk, head): A in fp64 over the chunk, to
//          scratch (bt, h, s) fp32;
//   cb     a block per (row, chunk, causal 64 x 64 tile): C·Bᵀ, stored and
//          stored transposed (bt, s / q, q, q): it is the same for every
//          head;
//   sweep  a block per (row, head), the chunks in reverse: the fp32 dS
//          (p x n) in registers, dS' of each chunk to scratch the size of
//          the states, exp(A_last) ⟨dS', S⟩ a chunk, and the initial
//          state's gradient;
//   rows   a block per (row, chunk, tile of 64 positions l, group of
//          heads): for each head of the group in order, M and G over the
//          tiles s <= l, then dc's terms (summed over the group's heads
//          into registers) and dA's row terms;
//   cols   a block per (row, chunk, tile of 64 positions s, group of
//          heads): for each head, the tiles l >= s: dx (written at x's
//          dtype), db's terms (summed over the group's heads), dA's
//          column terms and V;
//   dA     a thread per (row, head, chunk): dA and its reverse cumulative
//          sum (fp64) into d dt_a;
//   sum    a thread per element of b: db and dc, the groups' fp32 partial
//          sums added in group order and cast once.
// No atomics: every sum has a fixed order, and two calls give the same
// bits.  The scratch: A, C·Bᵀ twice (2 bt s q), dS' (the states' size),
// three (bt, h, s) rows, and the groups' partial db / dc (2 groups bt s n,
// at most the states' size: kernels/ssd_scan.py::bwd_plan chooses the
// groups so the quadratic passes fill the card within that).
//
// Products: fp32 FMAs on the CUDA cores, every operand fp32 in shared
// memory (bf16 inputs widened as they are loaded).  A single TF32 product
// misses the forward's accuracy 55x (ssd_scan.cu's header), and dA's row
// minus column sums cancel.  Each thread owns rows ty + 16 i and columns
// tx + 16 j of a 64-row tile; every shared tile has an odd row stride, so
// the 16 columns a warp reads fall in distinct banks.
//
// What bounds it.  At training's call (bt 4, s 512, 80 heads, p 64,
// n 128, chunk 256) it needs ~37 GFLOP (C·Bᵀ once, then M, dc, twice M,
// dx, db a head over the causal tiles) and moves ~0.1 GB: the fp32 rate,
// ~0.55 ms at 67 TFLOP/s.  Two fp32 loads from shared memory feed 4-8
// FMAs, so the shared-memory pipe holds it at about a quarter of that.
// Left for later: split-TF32 mma.sync as the forward (3 products at the
// tensor-core rate), M formed once for the rows and the cols passes, the
// register tiles widened to cut the shared-memory loads, and the
// sweep's dS' and the dA pass merged into the quadratic passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;             // rows of a tile
constexpr int kLD = kT + 1;        // row stride of a 64-wide shared tile
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kMaxChunk = 1024;
constexpr int kSmemLimit = 232448;
// the plan's fields, in kernels/ssd_scan.py::BwdPlan.launch_args order
constexpr int kPlanFields = 13;
constexpr int kPlanMismatch = 1000;

// row stride of a shared tile NJ x 16 columns wide (odd)
__host__ __device__ constexpr int ldn(int nj) { return 16 * nj + 1; }

struct Smem {
  int cb, sweep, rows, cols;
};

// bytes of each pass's shared memory at nj 16-column groups of n
__host__ __device__ inline Smem smem_of(int nj) {
  const int t64 = kT * kLD, tn = kT * ldn(nj);
  Smem m;
  m.cb = 2 * kT * ldn(8) * 4;                  // C and B tiles, n <= 128
  m.sweep = (t64 + tn + 8) * 4;                // dy, e ⊙ C, a sum a warp
  m.rows = (3 * t64 + tn + 2 * kT) * 4;        // dy, x, M ⊙ L, B / S / C
  m.cols = (4 * t64 + tn + 2 * kT) * 4;        // x, dy, Gᵀ, (M⊙L)ᵀ, C / B
  return m;
}

struct Params {
  const void* x;
  const float* dt_a;
  const void* b;
  const void* c;
  const float* states;
  const void* dy;
  const float* dfinal;
  void* dx;
  float* ddt;
  void* db;
  void* dc;
  float* dh0;
  // scratch
  float* acs;    // (bt, h, s)
  float* cb;     // (bt, nc, q, q): C·Bᵀ
  float* cbt;    // (bt, nc, q, q): its transpose
  float* dsp;    // (bt, nc, h, p, n): dS' of each chunk
  float* da_r;   // (bt, h, s)
  float* da_c;   // (bt, h, s)
  float* vv;     // (bt, h, s)
  float* dec;    // (bt, h, nc): exp(A_last) <dS', S>
  float* dbp;    // (groups, bt, s, n)
  float* dcp;    // (groups, bt, s, n)
  int bt, s, h, p, n, q, nc, nt, hpg, groups, x_bf16, bc_bf16;
};

__device__ __forceinline__ float ldv(const void* p, size_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void stv(void* p, size_t i, float v, int bf16) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[i] = v;
}

// rows [0, rows) x columns [0, cols) of a row-major matrix (row stride
// ld_g from element `base`) into a shared tile of kT rows x `width`
// columns (row stride ld_s), widened to fp32; zeros elsewhere in the tile
__device__ __forceinline__ void load_tile(float* dst, int ld_s, int width,
                                          const void* src, size_t base,
                                          size_t ld_g, int rows, int cols,
                                          int bf16) {
  for (int e = threadIdx.x; e < kT * width; e += kThreads) {
    const int r = e / width, k = e - r * width;
    dst[r * ld_s + k] =
        (r < rows && k < cols) ? ldv(src, base + r * ld_g + k, bf16) : 0.f;
  }
}

// acc[i][j] += Σ_k A(ty + 16 i, k) B(tx + 16 j, k), A(r, k) = A[r ars + k
// aks], B(c, k) = B[c bcs + k bks], over k < K
template <int NI, int NJ>
__device__ __forceinline__ void mac(float (&acc)[NI][NJ], const float* A,
                                    int ars, int aks, const float* B,
                                    int bcs, int bks, int K) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* a0 = A + ty * ars;
  const float* b0 = B + tx * bcs;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[NI], bv[NJ];
#pragma unroll
    for (int i = 0; i < NI; ++i) a[i] = a0[16 * i * ars + k * aks];
#pragma unroll
    for (int j = 0; j < NJ; ++j) bv[j] = b0[16 * j * bcs + k * bks];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
  }
}

template <int NI, int NJ>
__device__ __forceinline__ void zero(float (&acc)[NI][NJ]) {
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
}

// the sum over the 16 lanes of a half-warp (one tile row's threads)
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---- acs: A = cumsum(dt_a) a chunk, fp64 ------------------------------ //

__global__ void ssdb_acs_kernel(const Params P) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(P.bt) * P.nc * P.h) return;
  const int hh = static_cast<int>(i % P.h);
  const long long rest = i / P.h;
  const int ci = static_cast<int>(rest % P.nc);
  const int bi = static_cast<int>(rest / P.nc);
  const size_t pos0 = static_cast<size_t>(ci) * P.q;
  const float* d = P.dt_a + (static_cast<size_t>(bi) * P.s + pos0) * P.h + hh;
  float* out = P.acs + (static_cast<size_t>(bi) * P.h + hh) * P.s + pos0;
  double run = 0.0;
  for (int l = 0; l < P.q; ++l) {
    run += static_cast<double>(d[static_cast<size_t>(l) * P.h]);
    out[l] = static_cast<float>(run);
  }
}

// ---- cb: C·Bᵀ of each causal tile, and its transpose ------------------ //

__global__ void __launch_bounds__(kThreads)
    ssdb_cb_kernel(const Params P) {
  extern __shared__ float sm[];
  const int lt = blockIdx.y, st = blockIdx.z;
  if (st > lt) return;
  const int bc = blockIdx.x;                 // row * nc + chunk
  const int bi = bc / P.nc, ci = bc - bi * P.nc;
  constexpr int ld = ldn(8);
  float* cs = sm;
  float* bs = sm + kT * ld;
  const int l0 = lt * kT, s0 = st * kT;
  const int lrows = min(kT, P.q - l0), srows = min(kT, P.q - s0);
  const size_t row0 = static_cast<size_t>(bi) * P.s +
                      static_cast<size_t>(ci) * P.q;
  const int width = 16 * ((P.n + 15) / 16);
  load_tile(cs, ld, width, P.c, (row0 + l0) * P.n, P.n, lrows, P.n,
            P.bc_bf16);
  load_tile(bs, ld, width, P.b, (row0 + s0) * P.n, P.n, srows, P.n,
            P.bc_bf16);
  __syncthreads();
  float acc[4][4];
  zero(acc);
  mac<4, 4>(acc, cs, ld, 1, bs, ld, 1, P.n);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t base = static_cast<size_t>(bc) * P.q * P.q;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int l = ty + 16 * i, s = tx + 16 * j;
      if (l < lrows && s < srows) {
        P.cb[base + static_cast<size_t>(l0 + l) * P.q + s0 + s] = acc[i][j];
        P.cbt[base + static_cast<size_t>(s0 + s) * P.q + l0 + l] = acc[i][j];
      }
    }
}

// ---- sweep: dS over the chunks in reverse ----------------------------- //

template <int NJ>
__global__ void __launch_bounds__(kThreads)
    ssdb_sweep_kernel(const Params P) {
  extern __shared__ float sm[];
  constexpr int ldc = ldn(NJ);
  float* dys = sm;                    // kT x kLD: dy of 64 positions
  float* ces = sm + kT * kLD;         // kT x ldc: e_l c_l
  float* red = ces + kT * ldc;        // a partial sum a warp
  const int bh = blockIdx.x;          // row * h + head
  const int bi = bh / P.h, hh = bh - bi * P.h;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int p = P.p, n = P.n, h = P.h;
  const size_t pn = static_cast<size_t>(p) * n;
  float ds[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int pp = ty + 16 * i, nn = tx + 16 * j;
      ds[i][j] = (P.dfinal != nullptr && pp < p && nn < n)
                     ? P.dfinal[bh * pn + static_cast<size_t>(pp) * n + nn]
                     : 0.f;
    }
  const float* arow = P.acs + static_cast<size_t>(bh) * P.s;
  for (int ci = P.nc - 1; ci >= 0; --ci) {
    const size_t off = ((static_cast<size_t>(bi) * P.nc + ci) * h + hh) * pn;
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int pp = ty + 16 * i, nn = tx + 16 * j;
        if (pp < p && nn < n) {
          const size_t e = off + static_cast<size_t>(pp) * n + nn;
          P.dsp[e] = ds[i][j];
          part = fmaf(ds[i][j], P.states[e], part);
        }
      }
    // <dS', S>: lanes, then the 8 warps in order
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = part;
    const float alast = arow[static_cast<size_t>(ci) * P.q + P.q - 1];
    const float decay = expf(alast);
    float acc[4][NJ];
    zero(acc);
    const size_t row0 = static_cast<size_t>(bi) * P.s +
                        static_cast<size_t>(ci) * P.q;
    for (int lt = 0; lt < P.nt; ++lt) {
      const int l0 = lt * kT, rows = min(kT, P.q - l0);
      __syncthreads();
      if (lt == 0 && threadIdx.x == 0) {
        float t = 0.f;
        for (int w = 0; w < kThreads / 32; ++w) t += red[w];
        P.dec[static_cast<size_t>(bh) * P.nc + ci] = decay * t;
      }
      load_tile(dys, kLD, kT, P.dy, ((row0 + l0) * h + hh) * p,
                static_cast<size_t>(h) * p, rows, p, P.x_bf16);
      for (int e = threadIdx.x; e < kT * 16 * NJ; e += kThreads) {
        const int r = e / (16 * NJ), k = e - r * (16 * NJ);
        ces[r * ldc + k] =
            (r < rows && k < n)
                ? expf(arow[static_cast<size_t>(ci) * P.q + l0 + r]) *
                      ldv(P.c, (row0 + l0 + r) * n + k, P.bc_bf16)
                : 0.f;
      }
      __syncthreads();
      // acc[p, n] += Σ_l dy[l, p] (e_l c_l)[n]
      mac<4, NJ>(acc, dys, 1, kLD, ces, 1, ldc, rows);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) ds[i][j] = fmaf(decay, ds[i][j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int pp = ty + 16 * i, nn = tx + 16 * j;
      if (pp < p && nn < n)
        P.dh0[bh * pn + static_cast<size_t>(pp) * n + nn] = ds[i][j];
    }
}

// which (row, chunk, tile, group) a block of the quadratic passes takes
struct QuadBlock {
  int bi, ci, t, g, h0, h1;
};

__device__ __forceinline__ QuadBlock quad_block(const Params& P) {
  QuadBlock qb;
  long long r = blockIdx.x;
  qb.g = static_cast<int>(r % P.groups);
  r /= P.groups;
  qb.t = static_cast<int>(r % P.nt);
  r /= P.nt;
  qb.ci = static_cast<int>(r % P.nc);
  qb.bi = static_cast<int>(r / P.nc);
  qb.h0 = qb.g * P.hpg;
  qb.h1 = min(P.h, qb.h0 + P.hpg);
  return qb;
}

// ---- rows: dc and dA's row terms --------------------------------------- //

template <int NJ>
__global__ void __launch_bounds__(kThreads, 2)
    ssdb_rows_kernel(const Params P) {
  extern __shared__ float sm[];
  constexpr int ldc = ldn(NJ);
  float* dyl = sm;                    // dy of the l tile
  float* xs = dyl + kT * kLD;         // x of an s tile
  float* mls = xs + kT * kLD;         // (M ⊙ L) of the tile pair
  float* nb = mls + kT * kLD;         // B of an s tile, then S, then C
  float* al = nb + kT * ldc;          // A of the l tile
  float* as = al + kT;                // A of the s tile
  const QuadBlock qb = quad_block(P);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int p = P.p, n = P.n, h = P.h, q = P.q;
  const int l0 = qb.t * kT, lrows = min(kT, q - l0);
  const size_t row0 = static_cast<size_t>(qb.bi) * P.s +
                      static_cast<size_t>(qb.ci) * q;
  const size_t bcq = static_cast<size_t>(qb.bi) * P.nc + qb.ci;
  const float* cbm = P.cb + bcq * q * q;
  const size_t hp = static_cast<size_t>(h) * p;
  float dcacc[4][NJ];
  zero(dcacc);
  for (int hh = qb.h0; hh < qb.h1; ++hh) {
    const float* arow = P.acs + (static_cast<size_t>(qb.bi) * h + hh) * P.s +
                        static_cast<size_t>(qb.ci) * q;
    __syncthreads();
    load_tile(dyl, kLD, kT, P.dy,
              (row0 + l0) * hp + static_cast<size_t>(hh) * p, hp, lrows, p,
              P.x_bf16);
    for (int r = threadIdx.x; r < kT; r += kThreads)
      al[r] = r < lrows ? arow[l0 + r] : 0.f;
    float rw[4] = {0.f, 0.f, 0.f, 0.f};
    for (int st = 0; st <= qb.t; ++st) {
      const int s0 = st * kT, srows = min(kT, q - s0);
      __syncthreads();
      load_tile(xs, kLD, kT, P.x,
                (row0 + s0) * hp + static_cast<size_t>(hh) * p, hp, srows, p,
                P.x_bf16);
      load_tile(nb, ldc, 16 * NJ, P.b, (row0 + s0) * n, n, srows, n,
                P.bc_bf16);
      for (int r = threadIdx.x; r < kT; r += kThreads)
        as[r] = r < srows ? arow[s0 + r] : 0.f;
      __syncthreads();
      float m[4][4];
      zero(m);
      mac<4, 4>(m, dyl, kLD, 1, xs, kLD, 1, p);     // M[l, s]
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int l = ty + 16 * i, s = tx + 16 * j;
          // select, never multiply by a mask: above the diagonal
          // exp(A_l - A_s) can overflow
          const bool ok = l < lrows && s < srows && l0 + l >= s0 + s;
          const float lv = ok ? expf(al[l] - as[s]) : 0.f;
          const float cbv =
              ok ? cbm[static_cast<size_t>(l0 + l) * q + s0 + s] : 0.f;
          const float ml = m[i][j] * lv;
          rw[i] = fmaf(ml, cbv, rw[i]);             // W = M ⊙ L ⊙ C·Bᵀ
          mls[l * kLD + s] = ml;
        }
      __syncthreads();
      mac<4, NJ>(dcacc, mls, kLD, 1, nb, 1, ldc, srows);   // += (M⊙L) B
    }
    // e_l Sᵀ dy_l into dc, e_l dy_l·(S c_l) into dA
    __syncthreads();
    load_tile(nb, ldc, 16 * NJ, P.states, (bcq * h + hh) *
                                              static_cast<size_t>(p) * n,
              n, p, n, 0);
    __syncthreads();
    float d2[4][NJ];
    zero(d2);
    mac<4, NJ>(d2, dyl, kLD, 1, nb, 1, ldc, p);      // (dy S)[l, n]
    float el[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = ty + 16 * i;
      el[i] = l < lrows ? expf(al[l]) : 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        d2[i][j] *= el[i];
        dcacc[i][j] += d2[i][j];
      }
    }
    __syncthreads();
    load_tile(nb, ldc, 16 * NJ, P.c, (row0 + l0) * n, n, lrows, n, P.bc_bf16);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int l = ty + 16 * i;
      float rd = rw[i];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        rd = fmaf(nb[l * ldc + tx + 16 * j], d2[i][j], rd);
      rd = sum16(rd);
      if (tx == 0 && l < lrows)
        P.da_r[(static_cast<size_t>(qb.bi) * h + hh) * P.s +
               static_cast<size_t>(qb.ci) * q + l0 + l] = rd;
    }
  }
  float* out = P.dcp + (static_cast<size_t>(qb.g) * P.bt * P.s + row0 + l0) * n;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int l = ty + 16 * i, nn = tx + 16 * j;
      if (l < lrows && nn < n)
        out[static_cast<size_t>(l) * n + nn] = dcacc[i][j];
    }
}

// ---- cols: dx, db and dA's column terms -------------------------------- //

template <int NJ>
__global__ void __launch_bounds__(kThreads, 2)
    ssdb_cols_kernel(const Params P) {
  extern __shared__ float sm[];
  constexpr int ldc = ldn(NJ);
  float* xs = sm;                     // x of the s tile
  float* dyl = xs + kT * kLD;         // dy of an l tile
  float* gt = dyl + kT * kLD;         // Gᵀ of the tile pair, then with
  float* mlt = gt + kT * kLD;         //   (M ⊙ L)ᵀ: dS' (p x ldc)
  float* nc_ = mlt + kT * kLD;        // C of an l tile, then B of the s tile
  float* al = nc_ + kT * ldc;
  float* as = al + kT;
  float* dss = gt;
  const QuadBlock qb = quad_block(P);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int p = P.p, n = P.n, h = P.h, q = P.q;
  const int s0 = qb.t * kT, srows = min(kT, q - s0);
  const size_t row0 = static_cast<size_t>(qb.bi) * P.s +
                      static_cast<size_t>(qb.ci) * q;
  const size_t bcq = static_cast<size_t>(qb.bi) * P.nc + qb.ci;
  const float* cbtm = P.cbt + bcq * q * q;
  const size_t hp = static_cast<size_t>(h) * p;
  float dbacc[4][NJ];
  zero(dbacc);
  for (int hh = qb.h0; hh < qb.h1; ++hh) {
    const float* arow = P.acs + (static_cast<size_t>(qb.bi) * h + hh) * P.s +
                        static_cast<size_t>(qb.ci) * q;
    __syncthreads();
    load_tile(xs, kLD, kT, P.x, (row0 + s0) * hp + static_cast<size_t>(hh) * p,
              hp, srows, p, P.x_bf16);
    for (int r = threadIdx.x; r < kT; r += kThreads)
      as[r] = r < srows ? arow[s0 + r] : 0.f;
    float dxacc[4][4];
    zero(dxacc);
    float cw[4] = {0.f, 0.f, 0.f, 0.f};
    for (int lt = qb.t; lt < P.nt; ++lt) {
      const int l0 = lt * kT, lrows = min(kT, q - l0);
      __syncthreads();
      load_tile(dyl, kLD, kT, P.dy,
                (row0 + l0) * hp + static_cast<size_t>(hh) * p, hp, lrows, p,
                P.x_bf16);
      load_tile(nc_, ldc, 16 * NJ, P.c, (row0 + l0) * n, n, lrows, n,
                P.bc_bf16);
      for (int r = threadIdx.x; r < kT; r += kThreads)
        al[r] = r < lrows ? arow[l0 + r] : 0.f;
      __syncthreads();
      float mt[4][4];
      zero(mt);
      mac<4, 4>(mt, xs, kLD, 1, dyl, kLD, 1, p);    // Mᵀ[s, l]
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = ty + 16 * i, l = tx + 16 * j;
          const bool ok = s < srows && l < lrows && l0 + l >= s0 + s;
          const float lv = ok ? expf(al[l] - as[s]) : 0.f;
          const float cbv =
              ok ? cbtm[static_cast<size_t>(s0 + s) * q + l0 + l] : 0.f;
          const float g = cbv * lv;
          cw[i] = fmaf(mt[i][j], g, cw[i]);         // W[l, s]
          gt[s * kLD + l] = g;
          mlt[s * kLD + l] = mt[i][j] * lv;
        }
      __syncthreads();
      mac<4, 4>(dxacc, gt, kLD, 1, dyl, 1, kLD, lrows);     // += Gᵀ dy
      mac<4, NJ>(dbacc, mlt, kLD, 1, nc_, 1, ldc, lrows);   // += (M⊙L)ᵀ C
    }
    // the terms of dS': w_s dS' b_s into dx, w_s dS'ᵀ x_s into db, V
    __syncthreads();
    load_tile(nc_, ldc, 16 * NJ, P.b, (row0 + s0) * n, n, srows, n,
              P.bc_bf16);
    load_tile(dss, ldc, 16 * NJ, P.dsp, (bcq * h + hh) *
                                            static_cast<size_t>(p) * n,
              n, p, n, 0);
    __syncthreads();
    float u[4][4];
    zero(u);
    mac<4, 4>(u, nc_, ldc, 1, dss, ldc, 1, n);       // (B dS'ᵀ)[s, p]
    float d2[4][NJ];
    zero(d2);
    mac<4, NJ>(d2, xs, kLD, 1, dss, 1, ldc, p);      // (x dS')[s, n]
    const float alast = arow[q - 1];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = ty + 16 * i;
      const float w = s < srows ? expf(alast - as[s]) : 0.f;
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float wu = w * u[i][j];
        v = fmaf(xs[s * kLD + tx + 16 * j], wu, v);
        dxacc[i][j] += wu;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) dbacc[i][j] = fmaf(w, d2[i][j], dbacc[i][j]);
      v = sum16(v);
      const float cws = sum16(cw[i]);
      if (tx == 0 && s < srows) {
        const size_t e = (static_cast<size_t>(qb.bi) * h + hh) * P.s +
                         static_cast<size_t>(qb.ci) * q + s0 + s;
        P.da_c[e] = -cws - v;
        P.vv[e] = v;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int pp = tx + 16 * j;
        if (s < srows && pp < p)
          stv(P.dx, (row0 + s0 + s) * hp + static_cast<size_t>(hh) * p + pp,
              dxacc[i][j], P.x_bf16);
      }
    }
  }
  float* out = P.dbp + (static_cast<size_t>(qb.g) * P.bt * P.s + row0 + s0) * n;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int s = ty + 16 * i, nn = tx + 16 * j;
      if (s < srows && nn < n)
        out[static_cast<size_t>(s) * n + nn] = dbacc[i][j];
    }
}

// ---- dA: the reverse cumulative sum into d dt_a ------------------------ //

__global__ void ssdb_da_kernel(const Params P) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(P.bt) * P.h * P.nc) return;
  const int ci = static_cast<int>(i % P.nc);
  const long long bh = i / P.nc;
  const int hh = static_cast<int>(bh % P.h);
  const int bi = static_cast<int>(bh / P.h);
  const size_t base = static_cast<size_t>(bh) * P.s +
                      static_cast<size_t>(ci) * P.q;
  double vs = 0.0;
  for (int l = 0; l < P.q; ++l) vs += P.vv[base + l];
  const double extra = vs + P.dec[static_cast<size_t>(bh) * P.nc + ci];
  double run = 0.0;
  for (int l = P.q - 1; l >= 0; --l) {
    const float da = P.da_r[base + l] + P.da_c[base + l];
    run += static_cast<double>(da) + (l == P.q - 1 ? extra : 0.0);
    P.ddt[(static_cast<size_t>(bi) * P.s + static_cast<size_t>(ci) * P.q +
           l) * P.h + hh] = static_cast<float>(run);
  }
}

// ---- sum: db and dc over the groups ----------------------------------- //

__global__ void ssdb_sum_kernel(const Params P) {
  const size_t total = static_cast<size_t>(P.bt) * P.s * P.n;
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float sb = 0.f, sc = 0.f;
  for (int g = 0; g < P.groups; ++g) {
    sb += P.dbp[g * total + e];
    sc += P.dcp[g * total + e];
  }
  stv(P.db, e, sb, P.bc_bf16);
  stv(P.dc, e, sc, P.bc_bf16);
}

// n's 16-column groups a thread takes in the n-wide products
int nj_of(int n) { return n <= 16 ? 1 : n <= 32 ? 2 : n <= 64 ? 4 : 8; }

template <typename K>
int set_smem(K kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int NJ>
int launch_nj(const Params& P, const Smem& sm, long long quad_blocks,
              cudaStream_t st) {
  int err;
  if ((err = set_smem(ssdb_sweep_kernel<NJ>, sm.sweep))) return err;
  ssdb_sweep_kernel<NJ><<<P.bt * P.h, kThreads, sm.sweep, st>>>(P);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  if ((err = set_smem(ssdb_rows_kernel<NJ>, sm.rows))) return err;
  ssdb_rows_kernel<NJ><<<static_cast<unsigned>(quad_blocks), kThreads, sm.rows,
                    st>>>(P);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  if ((err = set_smem(ssdb_cols_kernel<NJ>, sm.cols))) return err;
  ssdb_cols_kernel<NJ><<<static_cast<unsigned>(quad_blocks), kThreads, sm.cols,
                    st>>>(P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, for x (dy, dx) and for b / c
// (db, dc); dt_a, states, dfinal (nullptr: zeros), d dt_a, the initial
// state's gradient dh0 and the scratch are float32.  Every tensor is
// contiguous; s >= 1 is a multiple of the chunk q.  `plan` holds
// kernels/ssd_scan.py::BwdPlan.launch_args(): tile, tiles a chunk, heads a
// group, groups, n's column groups, the blocks of the quadratic passes,
// the shared-memory bytes of the cb, sweep, rows and cols passes, the
// scratch floats, the cb pass's blocks and the sweep's; a plan that is
// not this file's layout returns kPlanMismatch (1000) and launches
// nothing.  Else returns cudaGetLastError() after the launches (0 = ok).
extern "C" int repro_ssd_scan_bwd(
    int x_dtype, int bc_dtype, const void* x, const void* dt_a,
    const void* b, const void* c, const void* states, const void* dy,
    const void* dfinal, void* dx, void* ddt, void* db, void* dc, void* dh0,
    void* scratch, int bt, int s, int h, int p, int n, int q,
    const long long* plan, int plan_len, void* stream) {
  if (bt < 0 || h < 1 || p < 1 || p > kMaxP || n < 1 || n > kMaxN ||
      q < 1 || q > kMaxChunk || s < 1 || s % q != 0 ||
      (x_dtype != 0 && x_dtype != 1) || (bc_dtype != 0 && bc_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (plan_len != kPlanFields) return kPlanMismatch;
  const int nc = s / q, nt = (q + kT - 1) / kT, nj = nj_of(n);
  const long long hpg = plan[2], groups = plan[3];
  const Smem sm = smem_of(nj);
  const long long quad = static_cast<long long>(bt) * nc * nt * groups;
  const long long bs_ = static_cast<long long>(bt) * s;
  const long long scratch_floats =
      bs_ * h * 4 + 2 * bs_ * q + bs_ / q * h * p * n +
      static_cast<long long>(bt) * h * nc + 2 * groups * bs_ * n;
  const long long own[kPlanFields] = {
      kT, nt, hpg, groups, nj, quad, sm.cb, sm.sweep, sm.rows, sm.cols,
      scratch_floats, static_cast<long long>(bt) * nc * nt * nt,
      static_cast<long long>(bt) * h};
  // the heads in `groups` groups of hpg, none empty: hpg = ceil(h /
  // groups) and groups = ceil(h / hpg)
  if (hpg < 1 || groups < 1 || groups != (h + hpg - 1) / hpg ||
      hpg != (h + groups - 1) / groups)
    return kPlanMismatch;
  for (int i = 0; i < kPlanFields; ++i)
    if (plan[i] != own[i]) return kPlanMismatch;
  if (sm.rows > kSmemLimit || sm.cols > kSmemLimit || sm.cb > kSmemLimit ||
      quad > 2147483647LL || static_cast<long long>(bt) * nc > 2147483647LL ||
      nt > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bt == 0) return 0;

  Params P{};
  P.x = x;
  P.dt_a = static_cast<const float*>(dt_a);
  P.b = b;
  P.c = c;
  P.states = static_cast<const float*>(states);
  P.dy = dy;
  P.dfinal = static_cast<const float*>(dfinal);
  P.dx = dx;
  P.ddt = static_cast<float*>(ddt);
  P.db = db;
  P.dc = dc;
  P.dh0 = static_cast<float*>(dh0);
  float* w = static_cast<float*>(scratch);
  P.acs = w;
  w += bs_ * h;
  P.cb = w;
  w += bs_ * q;
  P.cbt = w;
  w += bs_ * q;
  P.dsp = w;
  w += bs_ / q * h * p * n;
  P.da_r = w;
  w += bs_ * h;
  P.da_c = w;
  w += bs_ * h;
  P.vv = w;
  w += bs_ * h;
  P.dec = w;
  w += static_cast<long long>(bt) * h * nc;
  P.dbp = w;
  w += groups * bs_ * n;
  P.dcp = w;
  P.bt = bt;
  P.s = s;
  P.h = h;
  P.p = p;
  P.n = n;
  P.q = q;
  P.nc = nc;
  P.nt = nt;
  P.hpg = static_cast<int>(hpg);
  P.groups = static_cast<int>(groups);
  P.x_bf16 = x_dtype;
  P.bc_bf16 = bc_dtype;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long per_chunk = static_cast<long long>(bt) * nc * h;
  const unsigned chunk_blocks = static_cast<unsigned>((per_chunk + 255) / 256);
  ssdb_acs_kernel<<<chunk_blocks, 256, 0, st>>>(P);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  if ((err = set_smem(ssdb_cb_kernel, sm.cb))) return err;
  ssdb_cb_kernel<<<dim3(static_cast<unsigned>(bt * nc), nt, nt), kThreads,
                   sm.cb, st>>>(P);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  if (nj == 1) err = launch_nj<1>(P, sm, quad, st);
  else if (nj == 2) err = launch_nj<2>(P, sm, quad, st);
  else if (nj == 4) err = launch_nj<4>(P, sm, quad, st);
  else err = launch_nj<8>(P, sm, quad, st);
  if (err) return err;
  ssdb_da_kernel<<<chunk_blocks, 256, 0, st>>>(P);
  if ((err = static_cast<int>(cudaGetLastError()))) return err;
  const long long elems = bs_ * n;
  ssdb_sum_kernel<<<static_cast<unsigned>((elems + 255) / 256), 256, 0,
                    st>>>(P);
  return static_cast<int>(cudaGetLastError());
}
