// ssd_scan.cu — the Mamba-2 SSD chunked scan with a carried fp32 state,
// for Hopper (compiled for sm_90a), with a plain C entry point for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan_bhsp
// and computes the function of src/repro/models/ssm.py::ssd_chunked on
// the model layout: x (bt, s, h, p) pre-discretized (x * dt), dt_a
// (bt, s, h), b and c (bt, s, n) shared by all heads, an optional
// initial state (bt, h, p, n).  Per (row, head), for each chunk of q
// positions in order, all in fp32:
//   acs = cumsum(dt_a)                         (over the chunk)
//   y   = ((C·Bᵀ) ⊙ L) x + (C · stateᵀ) ⊙ exp(acs),
//         L[i,j] = exp(acs_i - acs_j) for i >= j, else 0
//   state <- state * exp(acs_last) + xᵀ (B ⊙ exp(acs_last - acs))
// y is written at x's dtype; the final state in fp32.
//
// Bound: per (row, head, chunk) the function does 2q²n + 2q²p + 4qpn
// flops; at the serving shape (q = 256, p = 64, n = 128, 80 heads, x and
// y fp32) that is about 2.7 GFLOP against 16 MB moved, 170 flop/byte,
// below the card's bf16 balance point (~295) but far above its fp32
// CUDA-core one (~20).  This kernel does its math in fp32 FMAs on the
// CUDA cores, so what bounds it is the fp32 operation rate and, since
// every FMA reads its operands from shared memory, the shared-memory
// bandwidth behind it.  What the design does about that:
//   * one block per (row, head); a loop over the chunks inside the block
//     takes the place of the TPU kernel's sequential ("arbitrary") grid
//     axis, and the (p x n) fp32 state stays in shared memory across
//     chunks: it never round-trips through device memory;
//   * the q x q score matrix never exists whole: the chunk is cut into
//     kR-row tiles, and for each row tile i only the column tiles j <= i
//     are formed (the causal half), masked by selection, never by
//     multiplying (above the diagonal exp(acs_i - acs_j) can be inf);
//   * exp(acs_i - acs_j) is taken of the difference, never as
//     exp(acs_i) * exp(-acs_j), which overflows over a long chunk;
//   * each thread owns a 4x4 (or 4x8) register tile of its outputs and
//     reads rows of C / B / state padded by one float, so the reads of
//     a warp fall in distinct banks;
//   * acs is summed in double by one thread, which makes it the
//     correctly rounded prefix sum.
// Not yet done (later work): C·Bᵀ does not depend on the head, and is
// recomputed per head here as on the TPU; tensor cores (mma / wgmma on
// bf16 or TF32 tiles); splitting the heads of a row across more blocks
// (bt = 1 x 80 heads fills 80 of the 132 SMs); cp.async staging of the
// next tile under the current one's math.
//
// Block structure: 256 threads as a 16 x 16 grid (ty, tx).  Per chunk:
//   0. acs of the chunk in shared memory;
//   1. per row tile I: load C_I; y_off = exp(acs) ⊙ (C_I · stateᵀ);
//      per column tile J <= I: load B_J, x_J; S = (C_I · B_Jᵀ) ⊙ L
//      (into shared memory); y_diag += S · x_J; write y = y_diag + y_off;
//   2. per column tile J: state_acc += x_Jᵀ (B_J ⊙ exp(acs_last - acs));
//      then state = state * exp(acs_last) + state_acc.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kR = 64;             // rows of a tile
constexpr int kMaxP = 64;          // head_dim limit
constexpr int kMaxN = 128;         // ssm_state limit
constexpr int kMaxChunk = 1024;
constexpr int kNP = kMaxN + 1;     // padded row of C, B and the state
constexpr int kRP = kR + 1;        // padded row of the score tile
constexpr int kSmemFloats = kMaxP * kNP      // state
                            + 2 * kR * kNP   // C tile, B tile
                            + kR * kMaxP     // x tile
                            + kR * kRP       // score tile (and weights)
                            + kMaxChunk;     // acs
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// rows [t, t + rows) of a (bt, s, n) stream into dst[kR][kNP]; rows past
// `rows` and columns past n are zero
template <typename T>
__device__ __forceinline__ void load_bc(float* dst, const T* src, int rows,
                                        int n) {
  for (int e = threadIdx.x; e < kR * kMaxN; e += kThreads) {
    const int j = e / kMaxN, k = e % kMaxN;
    dst[j * kNP + k] =
        (j < rows && k < n) ? to_f32(src[static_cast<size_t>(j) * n + k])
                            : 0.f;
  }
}

// rows [t, t + rows) of head hi of x (bt, s, h, p) into dst[kR][kMaxP]
template <typename T>
__device__ __forceinline__ void load_x(float* dst, const T* src, int rows,
                                       int h, int p) {
  for (int e = threadIdx.x; e < kR * kMaxP; e += kThreads) {
    const int j = e / kMaxP, pp = e % kMaxP;
    dst[e] = (j < rows && pp < p)
                 ? to_f32(src[static_cast<size_t>(j) * h * p + pp])
                 : 0.f;
  }
}

template <typename TX, typename TBC>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const TX* __restrict__ x, const float* __restrict__ dt_a,
                    const TBC* __restrict__ b, const TBC* __restrict__ c,
                    const float* __restrict__ h0, TX* __restrict__ y,
                    float* __restrict__ state_out, int s, int h, int p,
                    int n, int q) {
  extern __shared__ float smem[];
  float* st_s = smem;                  // [kMaxP][kNP]
  float* c_s = st_s + kMaxP * kNP;     // [kR][kNP]
  float* b_s = c_s + kR * kNP;         // [kR][kNP]
  float* x_s = b_s + kR * kNP;         // [kR][kMaxP]
  float* s_s = x_s + kR * kMaxP;       // [kR][kRP]
  float* acs_s = s_s + kR * kRP;       // [kMaxChunk]

  const int bh = blockIdx.x;
  const int bi = bh / h, hi = bh % h;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t row0 = static_cast<size_t>(bi) * s;   // first (bi, t=0)

  for (int e = threadIdx.x; e < kMaxP * kNP; e += kThreads) {
    const int pp = e / kNP, k = e % kNP;
    st_s[e] = (h0 != nullptr && pp < p && k < n)
                  ? h0[(static_cast<size_t>(bh) * p + pp) * n + k]
                  : 0.f;
  }

  for (int t0 = 0; t0 < s; t0 += q) {
    // ---- 0. acs of the chunk ---------------------------------------- //
    __syncthreads();   // the previous chunk is done with acs_s / st_s
    for (int t = threadIdx.x; t < q; t += kThreads)
      acs_s[t] = dt_a[(row0 + t0 + t) * h + hi];
    __syncthreads();
    if (threadIdx.x == 0) {
      double run = 0.0;
      for (int t = 0; t < q; ++t) {
        run += acs_s[t];
        acs_s[t] = static_cast<float>(run);
      }
    }
    __syncthreads();

    // ---- 1. outputs, one row tile at a time ------------------------- //
    for (int i0 = 0; i0 < q; i0 += kR) {
      const int ri = min(kR, q - i0);
      load_bc(c_s, c + (row0 + t0 + i0) * n, ri, n);
      __syncthreads();
      float yo[4][4], yd[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) yo[r][cc] = yd[r][cc] = 0.f;
      // the entering state's contribution: C_I · stateᵀ
      for (int k = 0; k < n; ++k) {
        float cv[4], sv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = c_s[(ty + 16 * r) * kNP + k];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) sv[cc] = st_s[(tx + 16 * cc) * kNP + k];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            yo[r][cc] = fmaf(cv[r], sv[cc], yo[r][cc]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        const float e = i < ri ? expf(acs_s[i0 + i]) : 0.f;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) yo[r][cc] *= e;
      }
      // the chunk's own inputs: column tiles up to the diagonal
      for (int j0 = 0; j0 <= i0; j0 += kR) {
        const int rj = min(kR, q - j0);
        __syncthreads();   // the previous tile is done with b_s/x_s/s_s
        load_bc(b_s, b + (row0 + t0 + j0) * n, rj, n);
        load_x(x_s, x + ((row0 + t0 + j0) * h + hi) * p, rj, h, p);
        __syncthreads();
        float sc[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) sc[r][cc] = 0.f;
        for (int k = 0; k < n; ++k) {
          float cv[4], bv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) cv[r] = c_s[(ty + 16 * r) * kNP + k];
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            bv[cc] = b_s[(tx + 16 * cc) * kNP + k];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
              sc[r][cc] = fmaf(cv[r], bv[cc], sc[r][cc]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = ty + 16 * r;
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const int j = tx + 16 * cc;
            const int gi = i0 + i, gj = j0 + j;
            // select, never multiply by the mask: above the diagonal
            // the exponent is positive and can overflow
            s_s[i * kRP + j] =
                (i < ri && j < rj && gi >= gj)
                    ? sc[r][cc] * expf(acs_s[gi] - acs_s[gj])
                    : 0.f;
          }
        }
        __syncthreads();
        for (int j = 0; j < rj; ++j) {
          float sv[4], xv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) sv[r] = s_s[(ty + 16 * r) * kRP + j];
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            xv[cc] = x_s[j * kMaxP + tx + 16 * cc];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc)
              yd[r][cc] = fmaf(sv[r], xv[cc], yd[r][cc]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        if (i >= ri) continue;
        TX* out = y + ((row0 + t0 + i0 + i) * h + hi) * p;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const int pp = tx + 16 * cc;
          if (pp < p) store(out + pp, yd[r][cc] + yo[r][cc]);
        }
      }
      __syncthreads();   // c_s is reloaded by the next row tile
    }

    // ---- 2. the state update ----------------------------------------- //
    // thread (ty, tx) owns state[pp = ty + 16 r][k = tx + 16 cc]
    const float last = acs_s[q - 1];
    float acc[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) acc[r][cc] = 0.f;
    float* w_s = s_s;                  // exp(acs_last - acs_j) of a tile
    for (int j0 = 0; j0 < q; j0 += kR) {
      const int rj = min(kR, q - j0);
      __syncthreads();
      load_bc(b_s, b + (row0 + t0 + j0) * n, rj, n);
      load_x(x_s, x + ((row0 + t0 + j0) * h + hi) * p, rj, h, p);
      if (threadIdx.x < kR)
        w_s[threadIdx.x] =
            threadIdx.x < rj ? expf(last - acs_s[j0 + threadIdx.x]) : 0.f;
      __syncthreads();
      for (int j = 0; j < rj; ++j) {
        const float w = w_s[j];
        float xv[4], bv[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) xv[r] = x_s[j * kMaxP + ty + 16 * r];
#pragma unroll
        for (int cc = 0; cc < 8; ++cc)
          bv[cc] = b_s[j * kNP + tx + 16 * cc] * w;
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 8; ++cc)
            acc[r][cc] = fmaf(xv[r], bv[cc], acc[r][cc]);
      }
    }
    const float decay = expf(last);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 8; ++cc) {
        float* sp = st_s + (ty + 16 * r) * kNP + tx + 16 * cc;
        *sp = *sp * decay + acc[r][cc];
      }
  }

  __syncthreads();
  for (int e = threadIdx.x; e < p * n; e += kThreads) {
    const int pp = e / n, k = e % n;
    state_out[static_cast<size_t>(bh) * p * n + e] = st_s[pp * kNP + k];
  }
}

template <typename TX, typename TBC>
int launch(const void* x, const void* dt_a, const void* b, const void* c,
           const void* h0, void* y, void* state, int bt, int s, int h,
           int p, int n, int q, cudaStream_t stream) {
  auto kernel = ssd_scan_kernel<TX, TBC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<bt * h, kThreads, kSmemBytes, stream>>>(
      static_cast<const TX*>(x), static_cast<const float*>(dt_a),
      static_cast<const TBC*>(b), static_cast<const TBC*>(c),
      static_cast<const float*>(h0), static_cast<TX*>(y),
      static_cast<float*>(state), s, h, p, n, q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16, for x (and y) and for b / c;
// dt_a, the initial state (nullptr: zeros) and the final state are
// float32.  Every tensor is contiguous; s >= 1 is a multiple of the
// chunk q.
// Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int repro_ssd_scan(int x_dtype, int bc_dtype, const void* x,
                              const void* dt_a, const void* b,
                              const void* c, const void* h0, void* y,
                              void* state, int bt, int s, int h, int p,
                              int n, int q, void* stream) {
  if (bt < 0 || h < 1 || p < 1 || p > kMaxP || n < 1 || n > kMaxN ||
      q < 1 || q > kMaxChunk || s < 1 || s % q != 0 ||
      static_cast<long long>(bt) * h > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bt == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && bc_dtype == 0)
    return launch<float, float>(x, dt_a, b, c, h0, y, state, bt, s, h, p, n,
                                q, st);
  if (x_dtype == 0 && bc_dtype == 1)
    return launch<float, __nv_bfloat16>(x, dt_a, b, c, h0, y, state, bt, s,
                                        h, p, n, q, st);
  if (x_dtype == 1 && bc_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, dt_a, b, c, h0, y, state,
                                                bt, s, h, p, n, q, st);
  if (x_dtype == 1 && bc_dtype == 0)
    return launch<__nv_bfloat16, float>(x, dt_a, b, c, h0, y, state, bt, s,
                                        h, p, n, q, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
