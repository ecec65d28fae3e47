// flash_decode.cu — one-token attention against a ring KV cache, for
// Hopper (compiled for sm_90a), with a plain C entry point for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode.py::
// flash_decode_bhd and computes the function of
// src/repro/models/attention.py::decode_attention: per (row b, q-head h)
//   s_j = softcap(scale * q·k_j)               (softcap before masking)
//   visible_j = 0 <= slot_pos[b,j] <= pos[b]  (and > pos[b] - window)
//   out = sum_j softmax(s)_j v_j               over the visible slots
// with GQA (kv_head = h / (hq / hkv)) and fp32 m/l/acc.  A row with no
// visible slot yields zeros (the reference yields the mean of V there;
// the engine never samples such a row).
//
// Bound: decode attention does ~4 flops per K/V byte, far below the
// card's ~295 flop/byte balance point, so it is bound by the K/V bytes
// it reads: 2 * b * hkv * (visible slots) * d * sizeof(kv dtype).
// What the design does about that:
//   * one block per (b, kv_head) serves all the q-heads of its group
//     (up to kMaxG), so each K/V row is read from device memory once;
//   * a tile with no visible slot is never loaded, so the bytes read
//     follow the visible slots, not the capacity S (in a partly visible
//     tile every slot is loaded and the invisible ones are masked out);
//   * the cache is read through its strides: the model's (b, S, hkv, d)
//     pool is used as it lies, with no transposed copy per step;
//   * with so few blocks (b * hkv = 128 at the serving shape) the time
//     is memory latency, so each phase starts all its loads before it
//     uses any, with no branch on memory contents between a load and the
//     next (such a branch serializes them: one full latency per load):
//     a tile's slot_pos in one coalesced read, a warp's 8 K rows at
//     once, kUnrollC V loads in flight per thread.
// Not yet done (later work): splitting S across blocks with a combine
// pass (the row with the most visible slots walks all its tiles alone,
// and b * hkv blocks do not fill 132 SMs at small batch), cp.async/TMA
// staging of K/V tiles, and 16-byte vector loads.
//
// Block structure: 256 threads; the loop over S in tiles of kTile slots
// takes the place of the TPU kernel's sequential grid axis.  Per tile:
//   0. visibility of the tile's slots from one read of slot_pos; a tile
//      with no visible slot is skipped;
//   A. warp-per-slot scores: lanes split d, a warp reduction finishes
//      the dot product for each q-head of the group;
//   B. warp-per-head online softmax: tile max, rescale factor, p, l;
//   C. thread-per-element PV: thread (split, e) accumulates element e
//      over the slots t = split (mod splits) of the tile; the splits'
//      partial sums are added once at the end (they share m).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;     // slots per tile
constexpr int kMaxG = 8;      // q-heads per block (<= kWarps)
constexpr int kMaxD = 256;    // head_dim limit
constexpr int kSlotsPerWarp = kTile / kWarps;   // phase A
constexpr int kUnrollC = 16;  // V loads in flight per thread (phase C)
constexpr float kNegInf = -1.0e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* slot_pos;
  const int* pos;
  void* out;
  int S, hkv, d, ratio, g_per_block;
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, sp_sb, o_sb,
      o_sh;
  float scale;
  int has_window, window, has_softcap;
  float softcap;
};

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(Args a) {
  const TQ* q = static_cast<const TQ*>(a.q);
  const TKV* kc = static_cast<const TKV*>(a.k);
  const TKV* vc = static_cast<const TKV*>(a.v);
  TQ* out = static_cast<TQ*>(a.out);

  const int b = blockIdx.y;
  const int chunks = (a.ratio + a.g_per_block - 1) / a.g_per_block;
  const int kvh = blockIdx.x / chunks;
  const int h0 = kvh * a.ratio + (blockIdx.x % chunks) * a.g_per_block;
  const int G = min(a.g_per_block, (kvh + 1) * a.ratio - h0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d = a.d;
  const int nj = (d + 31) / 32;               // phase A: d per lane
  const int splits = kThreads / d;            // phase C slot splits
  const int split = tid / d, e = tid % d;
  const bool c_thread = split < splits;
  const int row_pos = a.pos[b];

  __shared__ float q_s[kMaxG][kMaxD];
  __shared__ float p_s[kMaxG][kTile];        // scores, then p
  __shared__ int vis_s[kTile];
  __shared__ float m_s[kMaxG], l_s[kMaxG], corr_s[kMaxG];
  __shared__ float red_s[kMaxG][kThreads];

  for (int i = tid; i < G * d; i += kThreads) {
    const int g = i / d, j = i % d;
    q_s[g][j] = to_f(q[b * a.q_sb + (h0 + g) * a.q_sh + j]);
  }
  if (tid < kMaxG) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) acc[g] = 0.f;
  __syncthreads();

  const TKV* k_row = kc + b * a.k_sb + kvh * a.k_sh;
  const TKV* v_row = vc + b * a.v_sb + kvh * a.v_sh;
  const int* sp_row = a.slot_pos + b * a.sp_sb;

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

    // ---- A: scores, one warp per slot.  The warp's K rows are loaded
    // with no branch on memory contents, all before any is used ---------
    {
      TKV kraw[kSlotsPerWarp][kMaxD / 32];
#pragma unroll
      for (int i = 0; i < kSlotsPerWarp; ++i) {
        const int slot = min(t0 + warp + i * kWarps, a.S - 1);
        const TKV* kr = k_row + slot * a.k_ss;
#pragma unroll
        for (int jj = 0; jj < kMaxD / 32; ++jj)
          if (jj < nj) kraw[i][jj] = kr[min(lane + 32 * jj, d - 1)];
      }
#pragma unroll
      for (int i = 0; i < kSlotsPerWarp; ++i) {
        const int t = warp + i * kWarps;
        if (!vis_s[t]) continue;                     // warp-uniform
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            float s = 0.f;
#pragma unroll
            for (int jj = 0; jj < kMaxD / 32; ++jj) {
              const int j = lane + 32 * jj;
              if (jj < nj && j < d) s += q_s[g][j] * to_f(kraw[i][jj]);
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

    // ---- C: acc = acc * corr + p @ V, one thread per (split, element).
    // kUnrollC V loads are started unconditionally before any is used;
    // slots that are not visible are masked out of the sum -------------
    if (c_thread) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc[g] *= corr_s[g];
      for (int t = split; t < kTile; t += kUnrollC * splits) {
        TKV vraw[kUnrollC];
#pragma unroll
        for (int u = 0; u < kUnrollC; ++u) {
          const int slot = min(t0 + t + u * splits, a.S - 1);
          if (t + u * splits < kTile) vraw[u] = v_row[slot * a.v_ss + e];
        }
#pragma unroll
        for (int u = 0; u < kUnrollC; ++u) {
          const int tt = t + u * splits;
          if (tt < kTile && vis_s[tt]) {
            const float vv = to_f(vraw[u]);
#pragma unroll
            for (int g = 0; g < kMaxG; ++g)
              if (g < G) acc[g] += p_s[g][tt] * vv;
          }
        }
      }
    }
    __syncthreads();   // p_s / vis_s / corr_s are rewritten next tile
  }

  // ---- combine the splits' partial sums and normalize -----------------
  if (c_thread) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G) red_s[g][tid] = acc[g];
  }
  __syncthreads();
  if (c_thread && split == 0) {
    for (int g = 0; g < G; ++g) {
      float o = 0.f;
      for (int s = 0; s < splits; ++s) o += red_s[g][s * d + e];
      const float l = l_s[g];
      store_f(&out[b * a.o_sb + (h0 + g) * a.o_sh + e],
              l > 0.f ? o / l : 0.f);
    }
  }
}

template <typename TQ, typename TKV>
void launch(const Args& a, int b, cudaStream_t stream) {
  const int chunks = (a.ratio + a.g_per_block - 1) / a.g_per_block;
  const dim3 grid(a.hkv * chunks, b);
  flash_decode_kernel<TQ, TKV><<<grid, kThreads, 0, stream>>>(a);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Output has q's dtype.
// Strides are in elements; head_dim must be the unit-stride axis of q,
// k, v and out.  Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int repro_flash_decode(
    int q_dtype, int kv_dtype, const void* q, const void* k, const void* v,
    const void* slot_pos, const void* pos, void* out, int b, int S, int hq,
    int hkv, int d, long long q_sb, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long sp_sb, long long o_sb, long long o_sh,
    float scale, int has_window, int window, int has_softcap, float softcap,
    void* stream) {
  if (d < 1 || d > kMaxD || hkv < 1 || hq < hkv || hq % hkv != 0 ||
      b < 0 || b > 65535 || S < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.slot_pos = static_cast<const int*>(slot_pos);
  a.pos = static_cast<const int*>(pos);
  a.out = out;
  a.S = S;
  a.hkv = hkv;
  a.d = d;
  a.ratio = hq / hkv;
  a.g_per_block = a.ratio < kMaxG ? a.ratio : kMaxG;
  a.q_sb = q_sb;
  a.q_sh = q_sh;
  a.k_sb = k_sb;
  a.k_ss = k_ss;
  a.k_sh = k_sh;
  a.v_sb = v_sb;
  a.v_ss = v_ss;
  a.v_sh = v_sh;
  a.sp_sb = sp_sb;
  a.o_sb = o_sb;
  a.o_sh = o_sh;
  a.scale = scale;
  a.has_window = has_window;
  a.window = window;
  a.has_softcap = has_softcap;
  a.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0)
    launch<float, float>(a, b, st);
  else if (q_dtype == 1 && kv_dtype == 1)
    launch<__nv_bfloat16, __nv_bfloat16>(a, b, st);
  else if (q_dtype == 0 && kv_dtype == 1)
    launch<float, __nv_bfloat16>(a, b, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
