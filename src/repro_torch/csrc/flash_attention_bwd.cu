// flash_attention_bwd.cu — the backward of whole-sequence attention
// (training) for Hopper (compiled for sm_90a), with a plain C entry point
// for ctypes.
//
// Replaces no Pallas kernel: the reference differentiates the XLA
// attention() (src/repro/models/attention.py) that its training path
// runs, and src/repro/kernels/flash_attention.py::flash_attention_bhsd
// (the forward this is the backward of) has no backward.  It computes
// what differentiating that function computes, in the model layout
// q, o, dO (b, sq, hq, d), k / v (b, skv, hkv, d), read through their
// strides (head_dim unit-stride); dq (b, sq, hq, d) and dk / dv (b, skv,
// hkv, d) are written contiguous at the input dtype:
//   r_ij = scale * q_i·k_j,  s_ij = softcap(r_ij) = c tanh(r_ij / c)
//   visible_ij = j < skv (and i >= j if causal) (and i - j < window)
//   lse_i = log sum_j visible exp(s_ij),  P_ij = visible ? exp(s_ij - lse_i) : 0
//   D_i = sum_d dO_i O_i                       (O: the forward's output)
//   dV_j = sum_i P_ij dO_i,  dP_ij = dO_i·v_j
//   dS_ij = P_ij (dP_ij - D_i) (1 - (s_ij / c)^2 with a softcap)
//   dQ_i = scale sum_j dS_ij k_j,  dK_j = scale sum_i dS_ij q_i
// GQA through the head index: dK and dV of a kv head sum over the
// hq / hkv q heads of its group, inside one block.  A row with no
// visible key has P = 0 and gives nothing.  Queries sit at 0..sq-1
// (no q_offset: no training path uses one).
//
// Bound: at the training shapes (s 256..2048, d 128) the backward does
// ~10 d flops per visible (query, key) pair and head against ~8 reads or
// writes of d values per row: far above the card's flop/byte balance,
// so bound by the arithmetic rate.  This first kernel is simple and
// deterministic, after FlashAttention-2's backward, on the CUDA cores in
// fp32 (bf16 inputs are widened on load; no tensor cores yet):
//   (A) row statistics: one block per (b, q head, tile of 64 queries)
//       recomputes each row's log-sum-exp over its visible keys (an
//       online max / sum), and D = rowsum(dO * O); the forward kernel
//       is left as it is (it writes no LSE);
//   (B) dK, dV: one block per (b, kv head, tile of BK keys) loops over
//       the group's q heads and the q tiles that see the tile, with K,
//       V and the dK / dV accumulators resident (registers);
//   (C) dQ: one block per (b, q head, tile of 64 queries) loops over the
//       key tiles it sees, with Q, dO and dQ resident.
//   Every output element is written once by one thread: no atomics, so
//   two runs give the same bits.  K / V tiles that the causal mask or
//   the window hides entirely are skipped in (A), (B) and (C) alike.
//   Tiles live in shared memory as fp32 rows padded to DP + 1 floats
//   (DP = head_dim padded to 64, 128 or 256 with zeros), so the 4 x CJ
//   register micro-tiles of the score products and the row-broadcast
//   reads of the accumulations are free of bank conflicts.  BK = 64
//   keys a tile at DP <= 128, 32 at DP 256 (shared memory: 217 KB).
// Later work: mma.sync / wgmma products, TMA copies, the LSE from the
// forward.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBq = 64;        // query rows a tile
constexpr int kThreads = 256;  // 16 x 16 score micro-tiles, 8 warps
constexpr float kNegInf = -1.0e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* lse;    // (b, hq, sq)
  float* delta;  // (b, hq, sq)
  int sq, skv, hq, hkv, ratio, d;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh, do_sb, do_ss, do_sh;
  float scale;
  int causal, has_window, window, has_softcap;
  float softcap;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows [0, n) of a tile into shared fp32 rows of DP + 1 floats; rows at
// or past `valid` and columns at or past d are zeros
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int n,
                                          int valid, int d) {
  for (int i = threadIdx.x; i < n * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    float x = 0.f;
    if (r < valid && c < d) x = to_f(src[r * row_stride + c]);
    dst[r * (DP + 1) + c] = x;
  }
}

__device__ __forceinline__ bool visible(const Args& a, int qi, int kj) {
  return qi < a.sq && kj < a.skv && (!a.causal || kj <= qi) &&
         (!a.has_window || qi - kj < a.window);
}

// key tiles [lo, hi) that hold a key visible to a query of [q0, q0 + kBq)
template <int BK>
__device__ __forceinline__ void key_tiles(const Args& a, int q0, int& lo,
                                          int& hi) {
  int k_end = a.skv;
  if (a.causal) k_end = min(k_end, q0 + kBq);
  int k_begin = 0;
  if (a.has_window) k_begin = max(0, q0 - a.window + 1);
  lo = k_begin / BK;
  hi = k_end > k_begin ? (k_end + BK - 1) / BK : lo;
}

// q tiles [lo, hi) that hold a query that sees a key of [k0, k0 + BK)
template <int BK>
__device__ __forceinline__ void query_tiles(const Args& a, int k0, int& lo,
                                            int& hi) {
  int q_begin = a.causal ? k0 : 0;
  int q_end = a.sq;
  if (a.has_window) {
    const long long last = (long long)k0 + BK - 1 + a.window;  // exclusive
    if (last < q_end) q_end = static_cast<int>(last);
  }
  lo = q_begin / kBq;
  hi = q_end > q_begin ? (q_end + kBq - 1) / kBq : lo;
}

// s[i][j] = Qs[ty + 16 i] · Ks[tx + 16 j] over DP (4 x CJ micro-tile)
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

// ---- (A) row statistics ------------------------------------------- //
template <typename T, int DP, int BK>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_stats_kernel(const Args a) {
  constexpr int CJ = BK / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBq * (DP + 1);
  const int pair = blockIdx.x, bi = pair / a.hq, h = pair % a.hq;
  const int hk = h / a.ratio, q0 = blockIdx.y * kBq;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const T* q = static_cast<const T*>(a.q) + bi * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + bi * a.k_sb + hk * a.k_sh;
  load_tile<T, DP>(Qs, q + q0 * a.q_ss, a.q_ss, kBq, a.sq - q0, a.d);

  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = kNegInf, l[i] = 0.f;
  int lo, hi;
  key_tiles<BK>(a, q0, lo, hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<T, DP>(Ks, k + k0 * a.k_ss, a.k_ss, BK, a.skv - k0, a.d);
    __syncthreads();
    float s[4][CJ];
    micro_product<DP, CJ>(Qs, Ks, s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int qi = q0 + ty + 16 * i, kj = k0 + tx + 16 * j;
        if (!visible(a, qi, kj)) continue;
        float t;
        const float x = score(a, s[i][j], t);
        if (x > m[i]) {
          l[i] = l[i] * expf(m[i] - x) + 1.f;
          m[i] = x;
        } else {
          l[i] += expf(x - m[i]);
        }
      }
  }
  // combine the 16 threads of a row (lanes tx of one half-warp)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off >= 1; off >>= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[i], off);
      const float mm = fmaxf(m[i], m2);
      l[i] = l[i] * expf(m[i] - mm) + l2 * expf(m2 - mm);
      m[i] = mm;
    }
    const int qi = q0 + ty + 16 * i;
    if (tx == 0 && qi < a.sq)
      a.lse[(long long)pair * a.sq + qi] =
          l[i] > 0.f ? m[i] + logf(l[i]) : 0.f;
  }

  // D = rowsum(dO * O): a warp a row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* o = static_cast<const T*>(a.o) + bi * a.o_sb + h * a.o_sh;
  const T* dout = static_cast<const T*>(a.dout) + bi * a.do_sb + h * a.do_sh;
  for (int r = warp; r < kBq && q0 + r < a.sq; r += kThreads / 32) {
    const T* orow = o + (q0 + r) * a.o_ss;
    const T* drow = dout + (q0 + r) * a.do_ss;
    float acc = 0.f;
    for (int c = lane; c < a.d; c += 32) acc += to_f(orow[c]) * to_f(drow[c]);
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) a.delta[(long long)pair * a.sq + q0 + r] = acc;
  }
}

// P and dS of one (q tile, key tile) into shared memory (rows of
// BK + 16 floats: the two half-warps' rows land 16 banks apart)
template <int DP, int BK>
__device__ __forceinline__ void p_and_ds(const Args& a, const float* Qs,
                                         const float* Ks, const float* Vs,
                                         const float* dOs, const float* lse,
                                         const float* dlt, float* Ps,
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

// ---- (B) dK, dV ---------------------------------------------------- //
template <typename T, int DP, int BK>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dkdv_kernel(const Args a) {
  constexpr int BKS = BK + 16, RJ = DP / 32, RI = BK / 8;
  extern __shared__ float smem[];
  float* Ks = smem;
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
  const T* k = static_cast<const T*>(a.k) + bi * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + bi * a.v_sb + hk * a.v_sh;
  load_tile<T, DP>(Ks, k + k0 * a.k_ss, a.k_ss, BK, a.skv - k0, a.d);
  load_tile<T, DP>(Vs, v + k0 * a.v_ss, a.v_ss, BK, a.skv - k0, a.d);

  // thread holds keys wy + 8 i and columns lane + 32 j
  float dk[RI][RJ], dv[RI][RJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) dk[i][j] = 0.f, dv[i][j] = 0.f;

  int lo, hi;
  query_tiles<BK>(a, k0, lo, hi);
  for (int g = 0; g < a.ratio; ++g) {
    const int h = hk * a.ratio + g;
    const long long row = ((long long)bi * a.hq + h) * a.sq;
    const T* q = static_cast<const T*>(a.q) + bi * a.q_sb + h * a.q_sh;
    const T* dout =
        static_cast<const T*>(a.dout) + bi * a.do_sb + h * a.do_sh;
    for (int qt = lo; qt < hi; ++qt) {
      const int q0 = qt * kBq;
      __syncthreads();
      load_tile<T, DP>(Qs, q + q0 * a.q_ss, a.q_ss, kBq, a.sq - q0, a.d);
      load_tile<T, DP>(dOs, dout + q0 * a.do_ss, a.do_ss, kBq, a.sq - q0,
                       a.d);
      for (int r = threadIdx.x; r < kBq; r += kThreads) {
        const bool ok = q0 + r < a.sq;
        lse[r] = ok ? a.lse[row + q0 + r] : 0.f;
        dlt[r] = ok ? a.delta[row + q0 + r] : 0.f;
      }
      __syncthreads();
      p_and_ds<DP, BK>(a, Qs, Ks, Vs, dOs, lse, dlt, Ps, dSs, q0, k0);
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
  T* dkp = static_cast<T*>(a.dk);
  T* dvp = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int kj = k0 + wy + 8 * i;
    if (kj >= a.skv) continue;
    const long long base = (((long long)bi * a.skv + kj) * a.hkv + hk) * a.d;
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      const int c = lane + 32 * j;
      if (c < a.d) {
        dkp[base + c] = from_f<T>(dk[i][j] * a.scale);
        dvp[base + c] = from_f<T>(dv[i][j]);
      }
    }
  }
}

// ---- (C) dQ -------------------------------------------------------- //
template <typename T, int DP, int BK>
__global__ void __launch_bounds__(kThreads) fa_bwd_dq_kernel(const Args a) {
  constexpr int BKS = BK + 16, RJ = DP / 32, RI = kBq / 8;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kBq * (DP + 1);
  float* Ks = dOs + kBq * (DP + 1);
  float* Vs = Ks + BK * (DP + 1);
  float* dSs = Vs + BK * (DP + 1);
  float* lse = dSs + kBq * BKS;
  float* dlt = lse + kBq;
  const int pair = blockIdx.x, bi = pair / a.hq, h = pair % a.hq;
  const int hk = h / a.ratio, q0 = blockIdx.y * kBq;
  const int wy = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = (long long)pair * a.sq;
  const T* q = static_cast<const T*>(a.q) + bi * a.q_sb + h * a.q_sh;
  const T* dout = static_cast<const T*>(a.dout) + bi * a.do_sb + h * a.do_sh;
  const T* k = static_cast<const T*>(a.k) + bi * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + bi * a.v_sb + hk * a.v_sh;
  load_tile<T, DP>(Qs, q + q0 * a.q_ss, a.q_ss, kBq, a.sq - q0, a.d);
  load_tile<T, DP>(dOs, dout + q0 * a.do_ss, a.do_ss, kBq, a.sq - q0, a.d);
  for (int r = threadIdx.x; r < kBq; r += kThreads) {
    const bool ok = q0 + r < a.sq;
    lse[r] = ok ? a.lse[row + q0 + r] : 0.f;
    dlt[r] = ok ? a.delta[row + q0 + r] : 0.f;
  }

  // thread holds rows wy + 8 i and columns lane + 32 j
  float dq[RI][RJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < RJ; ++j) dq[i][j] = 0.f;

  int lo, hi;
  key_tiles<BK>(a, q0, lo, hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<T, DP>(Ks, k + k0 * a.k_ss, a.k_ss, BK, a.skv - k0, a.d);
    load_tile<T, DP>(Vs, v + k0 * a.v_ss, a.v_ss, BK, a.skv - k0, a.d);
    __syncthreads();
    p_and_ds<DP, BK>(a, Qs, Ks, Vs, dOs, lse, dlt, nullptr, dSs, q0, k0);
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
  T* dqp = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int qi = q0 + wy + 8 * i;
    if (qi >= a.sq) continue;
    const long long base = (((long long)bi * a.sq + qi) * a.hq + h) * a.d;
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      const int c = lane + 32 * j;
      if (c < a.d) dqp[base + c] = from_f<T>(dq[i][j] * a.scale);
    }
  }
}

template <int DP, int BK>
constexpr int stats_smem() {
  return (kBq + BK) * (DP + 1) * 4;
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

template <typename T, int DP, int BK>
int launch(const Args& a, int b, cudaStream_t st) {
  auto* ka = fa_bwd_stats_kernel<T, DP, BK>;
  auto* kb = fa_bwd_dkdv_kernel<T, DP, BK>;
  auto* kc = fa_bwd_dq_kernel<T, DP, BK>;
  constexpr int sa = stats_smem<DP, BK>(), sb = dkdv_smem<DP, BK>(),
                sc = dq_smem<DP, BK>();
  static_assert(sb <= 232448 && sc <= 232448, "shared memory");
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(ka, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                sa)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(kb, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                sb)) != cudaSuccess ||
      (e = cudaFuncSetAttribute(kc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                sc)) != cudaSuccess)
    return static_cast<int>(e);
  // (B) reads what (A) wrote, (C) too: one stream orders them
  const dim3 q_grid(b * a.hq, (a.sq + kBq - 1) / kBq);
  if (a.sq > 0) {
    ka<<<q_grid, kThreads, sa, st>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  if (a.skv > 0) {
    const dim3 k_grid(b * a.hkv, (a.skv + BK - 1) / BK);
    kb<<<k_grid, kThreads, sb, st>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  if (a.sq > 0) {
    kc<<<q_grid, kThreads, sc, st>>>(a);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

template <typename T>
int launch_d(const Args& a, int b, cudaStream_t st) {
  if (a.d <= 64) return launch<T, 64, 64>(a, b, st);
  if (a.d <= 128) return launch<T, 128, 64>(a, b, st);
  return launch<T, 256, 32>(a, b, st);
}

}  // namespace

// dtype 0 = float32, 1 = bfloat16.  lse / delta: fp32 workspaces of b *
// hq * sq floats.  dq, dk, dv contiguous in the model layout.  Returns a
// CUDA error code (0 = launched).
extern "C" int repro_flash_attention_bwd(
    int dtype, const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* delta,
    int b, int sq, int skv, int hq, int hkv, int d, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, long long do_sb,
    long long do_ss, long long do_sh, float scale, int causal,
    int has_window, int window, int has_softcap, float softcap,
    void* stream) {
  if ((dtype != 0 && dtype != 1) || d < 1 || d > 256 || hkv < 1 ||
      hq < hkv || hq % hkv != 0 || b < 0 || sq < 0 || skv < 0 ||
      (has_window && window < 1) || (sq + kBq - 1) / kBq > 65535 ||
      (skv + 31) / 32 > 65535 || (long long)b * hq > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || (sq == 0 && skv == 0)) return 0;
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.lse = static_cast<float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.sq = sq;
  a.skv = skv;
  a.hq = hq;
  a.hkv = hkv;
  a.ratio = hq / hkv;
  a.d = d;
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
  if (dtype == 1) return launch_d<__nv_bfloat16>(a, b, st);
  return launch_d<float>(a, b, st);
}
