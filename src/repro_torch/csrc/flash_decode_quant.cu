// flash_decode_quant.cu — one-token attention against a QUANTIZED ring KV
// cache, for Hopper (compiled for sm_90a), with a plain C entry point for
// ctypes.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py::
// flash_decode_quant_bhd (its tile expansion `_expand_kv_tile`) and
// computes decode_attention over dequantize_kv of the cache: per (row b,
// q-head h)
//   k_j, v_j = codes(slot j) decoded to fp32 x e8m0 block scale
//   s_j = softcap(scale * q·k_j)               (softcap before masking)
//   visible_j = 0 <= slot_pos[b,j] <= pos[b]  (and > pos[b] - window)
//   out = sum_j softmax(s)_j v_j               over the visible slots
// with GQA (kv_head = h / (hq / hkv)) and fp32 m/l/acc.  A row with no
// visible slot yields zeros, as the dense kernel does.
//
// Storage (the layout of repro_torch.models.attention.init_kv_cache):
// codes (b, S, hkv, stored_d) bytes — fp8 e4m3/e5m2 one byte per value,
// fp4 e2m1 two per byte (low nibble first), fp6 e2m3/e3m2 four values in
// a little-endian 24-bit word of 3 bytes — and e8m0 scale bytes (b, S,
// hkv, d/blk), code c = 2^(c-127).  The scale is built with ldexpf, so
// code 0 is the subnormal 2^-127 (the build uses no flush-to-zero).
//
// Bound: as for the dense kernel, ~4 flops per K/V byte, far below the
// card's balance point, so the K/V bytes read bound it; quantized they
// are stored_d + d/blk bytes per (slot, head) instead of 2d (bf16):
// 0.53 B/value for fp4, 1.03 for fp8.  What the design does about that:
//   * the structure of flash_decode.cu v3: one block per (b, kv_head)
//     serving every q-head of its GQA group, so each code byte is read
//     once; 64-slot tiles; a tile with no visible slot is never loaded;
//     the cache is read through its strides (the engine's pool view);
//     each phase starts all its loads before it uses any, with no branch
//     on memory contents between them;
//   * the unit of work is a quad of 4 consecutive values of d: whole
//     bytes in every format (4 fp8 bytes, 2 fp4 bytes, one 3-byte fp6
//     group) and always inside one scale block (blk >= 4), so a thread
//     loads a quad's bytes and its scale byte and expands them to fp32 in
//     registers (lowbits.cuh): the codes never exist in device memory at
//     full width.  An fp8 / fp4 quad is one aligned 4- / 2-byte load (the
//     wrapper requires the alignment), an fp6 quad three byte loads.
// Split-S, 16-byte loads of several quads and cp.async/TMA staging are
// later work.
//
// Block structure: 256 threads; per tile:
//   0. visibility of the tile's slots from one read of slot_pos;
//   A. warp-per-slot scores: lane l expands quads l and l+32 of each of
//      its warp's 8 slots, then a warp reduction per q-head;
//   B. warp-per-head online softmax: tile max, rescale factor, p, l;
//   C. thread-per-quad PV: thread (split, quad) accumulates its 4 values
//      over the slots t = split (mod splits); the splits' partial sums are
//      added once at the end (they share m).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lowbits.cuh"

namespace {

using lowbits::load_quad;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;     // slots per tile
constexpr int kMaxG = 8;      // q-heads per block (<= kWarps)
constexpr int kMaxD = 256;    // head_dim limit
constexpr int kQuadsPerLane = kMaxD / 4 / 32;   // phase A
constexpr int kSlotsPerWarp = kTile / kWarps;   // phase A
constexpr int kUnrollC = 8;   // quads in flight per thread (phase C)
constexpr float kNegInf = -1.0e30f;

// a quad's 4 values, decoded and scaled (lowbits.cuh)
template <int F>
__device__ __forceinline__ void expand_quad(uint32_t w, uint32_t s,
                                            float out[4]) {
  const float sc = lowbits::e8m0(s);
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = lowbits::quad_value<F>(w, i) * sc;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// strides in elements (bytes for the code and scale tensors)
enum Stride {
  Q_SB, Q_SH, KQ_SB, KQ_SS, KQ_SH, KS_SB, KS_SS, KS_SH, VQ_SB, VQ_SS,
  VQ_SH, VS_SB, VS_SS, VS_SH, SP_SB, O_SB, O_SH, N_STRIDES
};

struct Args {
  const void* q;
  const uint8_t* kq;
  const uint8_t* ks;
  const uint8_t* vq;
  const uint8_t* vs;
  const int* slot_pos;
  const int* pos;
  void* out;
  int S, hkv, d, blk, ratio, g_per_block;
  long long st[N_STRIDES];
  float scale;
  int has_window, window, has_softcap;
  float softcap;
};

template <typename TQ, int F>
__global__ void __launch_bounds__(kThreads) flash_decode_quant_kernel(Args a) {
  const TQ* q = static_cast<const TQ*>(a.q);
  TQ* out = static_cast<TQ*>(a.out);

  const int b = blockIdx.y;
  const int chunks = (a.ratio + a.g_per_block - 1) / a.g_per_block;
  const int kvh = blockIdx.x / chunks;
  const int h0 = kvh * a.ratio + (blockIdx.x % chunks) * a.g_per_block;
  const int G = min(a.g_per_block, (kvh + 1) * a.ratio - h0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = a.d;
  const int nq = d / 4;                        // quads per row
  const int splits = kThreads / nq;            // phase C slot splits
  const int split = tid / nq, qc = tid % nq;
  const bool c_thread = split < splits;
  const int row_pos = a.pos[b];

  __shared__ float q_s[kMaxG][kMaxD];
  __shared__ float p_s[kMaxG][kTile];        // scores, then p
  __shared__ int vis_s[kTile];
  __shared__ float m_s[kMaxG], l_s[kMaxG], corr_s[kMaxG];
  __shared__ float red_s[kThreads * 4];

  for (int i = tid; i < G * d; i += kThreads) {
    const int g = i / d, j = i % d;
    q_s[g][j] = to_f(q[b * a.st[Q_SB] + (h0 + g) * a.st[Q_SH] + j]);
  }
  if (tid < kMaxG) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxG][4];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[g][i] = 0.f;
  __syncthreads();

  const uint8_t* kq_row = a.kq + b * a.st[KQ_SB] + kvh * a.st[KQ_SH];
  const uint8_t* ks_row = a.ks + b * a.st[KS_SB] + kvh * a.st[KS_SH];
  const uint8_t* vq_row = a.vq + b * a.st[VQ_SB] + kvh * a.st[VQ_SH];
  const uint8_t* vs_row = a.vs + b * a.st[VS_SB] + kvh * a.st[VS_SH];
  const int* sp_row = a.slot_pos + b * a.st[SP_SB];
  const int qpb = a.blk / 4;                   // quads per scale block

  for (int t0 = 0; t0 < a.S; t0 += kTile) {
    // ---- 0: visibility of the tile's slots ------------------------------
    int vis = 0;
    if (tid < kTile) {
      const int slot = t0 + tid;
      if (slot < a.S) {
        const int sp = sp_row[slot];
        vis = sp >= 0 && sp <= row_pos &&
              (!a.has_window || sp > row_pos - a.window);
      }
      vis_s[tid] = vis;
    }
    if (!__syncthreads_or(vis)) continue;            // block-uniform

    // ---- A: scores, one warp per slot; the warp's code and scale bytes
    // are all loaded before any is used -------------------------------
    {
      uint32_t kraw[kSlotsPerWarp][kQuadsPerLane];
      uint32_t sraw[kSlotsPerWarp][kQuadsPerLane];
#pragma unroll
      for (int i = 0; i < kSlotsPerWarp; ++i) {
        const int slot = min(t0 + warp + i * kWarps, a.S - 1);
#pragma unroll
        for (int jj = 0; jj < kQuadsPerLane; ++jj) {
          const int qd = min(lane + 32 * jj, nq - 1);
          kraw[i][jj] = load_quad<F>(kq_row + slot * a.st[KQ_SS], qd);
          sraw[i][jj] = ks_row[slot * a.st[KS_SS] + qd / qpb];
        }
      }
#pragma unroll
      for (int i = 0; i < kSlotsPerWarp; ++i) {
        const int t = warp + i * kWarps;
        if (!vis_s[t]) continue;                     // warp-uniform
        float kv[kQuadsPerLane][4];
#pragma unroll
        for (int jj = 0; jj < kQuadsPerLane; ++jj)
          expand_quad<F>(kraw[i][jj], sraw[i][jj], kv[jj]);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            float s = 0.f;
#pragma unroll
            for (int jj = 0; jj < kQuadsPerLane; ++jj) {
              const int qd = lane + 32 * jj;
              if (qd < nq) {
#pragma unroll
                for (int e = 0; e < 4; ++e) s += q_s[g][4 * qd + e] * kv[jj][e];
              }
            }
            for (int off = 16; off > 0; off >>= 1)
              s += __shfl_xor_sync(0xffffffffu, s, off);
            s *= a.scale;
            if (a.has_softcap) s = tanhf(s / a.softcap) * a.softcap;
            if (lane == 0) p_s[g][t] = s;
          }
        }
      }
    }
    __syncthreads();

    // ---- B: online softmax, one warp per q-head ------------------------
    if (warp < G) {
      const int g = warp;
      float mx = -INFINITY;
      for (int t = lane; t < kTile; t += 32)
        if (vis_s[t]) mx = fmaxf(mx, p_s[g][t]);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < kTile; t += 32) {
        const float p = vis_s[t] ? expf(p_s[g][t] - m_new) : 0.f;
        p_s[g][t] = p;                               // 0 where not visible
        sum += p;
      }
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // ---- C: acc = acc * corr + p @ V, one thread per (split, quad).
    // kUnrollC quads and scales are loaded unconditionally before any is
    // used; slots that are not visible are masked out of the sum -------
    if (c_thread) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[g][e] *= corr_s[g];
      for (int t = split; t < kTile; t += kUnrollC * splits) {
        uint32_t vraw[kUnrollC], sraw[kUnrollC];
#pragma unroll
        for (int u = 0; u < kUnrollC; ++u) {
          const int slot = min(t0 + t + u * splits, a.S - 1);
          vraw[u] = load_quad<F>(vq_row + slot * a.st[VQ_SS], qc);
          sraw[u] = vs_row[slot * a.st[VS_SS] + qc / qpb];
        }
#pragma unroll
        for (int u = 0; u < kUnrollC; ++u) {
          const int tt = t + u * splits;
          if (tt < kTile && vis_s[tt]) {
            float vv[4];
            expand_quad<F>(vraw[u], sraw[u], vv);
#pragma unroll
            for (int g = 0; g < kMaxG; ++g)
              if (g < G) {
                const float p = p_s[g][tt];
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[g][e] += p * vv[e];
              }
          }
        }
      }
    }
    __syncthreads();   // p_s / vis_s / corr_s are rewritten next tile
  }

  // ---- combine the splits' partial sums and normalize, head by head ---
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      if (c_thread) {
#pragma unroll
        for (int e = 0; e < 4; ++e) red_s[split * d + 4 * qc + e] = acc[g][e];
      }
      __syncthreads();
      if (c_thread && split == 0) {
        const float l = l_s[g];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float o = 0.f;
          for (int s = 0; s < splits; ++s) o += red_s[s * d + 4 * qc + e];
          store_f(&out[b * a.st[O_SB] + (h0 + g) * a.st[O_SH] + 4 * qc + e],
                  l > 0.f ? o / l : 0.f);
        }
      }
      __syncthreads();
    }
  }
}

template <typename TQ, int F>
void launch(const Args& a, int b, cudaStream_t stream) {
  const int chunks = (a.ratio + a.g_per_block - 1) / a.g_per_block;
  const dim3 grid(a.hkv * chunks, b);
  flash_decode_quant_kernel<TQ, F><<<grid, kThreads, 0, stream>>>(a);
}

template <typename TQ>
int dispatch_fmt(int fmt, const Args& a, int b, cudaStream_t st) {
  switch (fmt) {
    case 0: launch<TQ, 0>(a, b, st); break;
    case 1: launch<TQ, 1>(a, b, st); break;
    case 2: launch<TQ, 2>(a, b, st); break;
    case 3: launch<TQ, 3>(a, b, st); break;
    case 4: launch<TQ, 4>(a, b, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16 (output has q's dtype).  fmt: 0
// e4m3fn, 1 e5m2, 2 fp6 e2m3, 3 fp6 e3m2, 4 fp4 e2m1.  `strides` is a
// host array of N_STRIDES int64 in the order of enum Stride, in elements
// (bytes for the codes and scales); head_dim is the unit-stride axis of
// every tensor.  Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int repro_flash_decode_quant(
    int q_dtype, int fmt, const void* q, const void* kq, const void* ks,
    const void* vq, const void* vs, const void* slot_pos, const void* pos,
    void* out, int b, int S, int hq, int hkv, int d, int blk,
    const long long* strides, float scale, int has_window, int window,
    int has_softcap, float softcap, void* stream) {
  if (d < 4 || d > kMaxD || d % 4 != 0 || blk < 4 || blk % 4 != 0 ||
      d % blk != 0 || hkv < 1 || hq < hkv || hq % hkv != 0 || b < 0 ||
      b > 65535 || S < 1 || fmt < 0 || fmt > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  // fp8 / fp4 quads are loaded as one aligned word / half-word
  const int align = fmt <= 1 ? 4 : fmt == 4 ? 2 : 1;
  if (reinterpret_cast<uintptr_t>(kq) % align ||
      reinterpret_cast<uintptr_t>(vq) % align)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int code_strides[] = {KQ_SB, KQ_SS, KQ_SH, VQ_SB, VQ_SS, VQ_SH};
  for (int i : code_strides)
    if (strides[i] % align) return static_cast<int>(cudaErrorMisalignedAddress);
  if (b == 0) return 0;
  Args a;
  a.q = q;
  a.kq = static_cast<const uint8_t*>(kq);
  a.ks = static_cast<const uint8_t*>(ks);
  a.vq = static_cast<const uint8_t*>(vq);
  a.vs = static_cast<const uint8_t*>(vs);
  a.slot_pos = static_cast<const int*>(slot_pos);
  a.pos = static_cast<const int*>(pos);
  a.out = out;
  a.S = S;
  a.hkv = hkv;
  a.d = d;
  a.blk = blk;
  a.ratio = hq / hkv;
  a.g_per_block = a.ratio < kMaxG ? a.ratio : kMaxG;
  for (int i = 0; i < N_STRIDES; ++i) a.st[i] = strides[i];
  a.scale = scale;
  a.has_window = has_window;
  a.window = window;
  a.has_softcap = has_softcap;
  a.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (q_dtype == 0)
    err = dispatch_fmt<float>(fmt, a, b, st);
  else if (q_dtype == 1)
    err = dispatch_fmt<__nv_bfloat16>(fmt, a, b, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
