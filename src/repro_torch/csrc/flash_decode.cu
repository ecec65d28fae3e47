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
// card's ~295 flop/byte balance point, so the K/V bytes it reads bound
// it: 2 * b * hkv * (visible slots) * d * sizeof(kv dtype).  Tensor cores
// are not needed: fp32 FMA on the CUDA cores covers that work many times
// over.  What the design does about the bytes (the schedule is
// flash_decode_split.cuh's, shared with flash_decode_quant.cu):
//   * one block per (b, chunk of a GQA group, split) serves every q-head
//     of its chunk, so each K/V row is read from device memory once;
//   * the S axis is split across blocks round-robin in 32-slot tiles, so
//     the row with the most visible slots no longer walks them alone and
//     the serving shape's b * hkv = 128 blocks become 512, a wave on 132
//     SMs; the splits are combined in the same launch by the last one to
//     arrive;
//   * only visible rows are copied: a tile with no visible slot is never
//     listed, and the invisible rows of a listed tile are not loaded;
//   * K and V rows are staged with cp.async, 16 bytes a thread where the
//     alignment allows (neighbouring threads on neighbouring chunks of a
//     row), in a ring of 3 tiles: two tiles' K and V are in flight while
//     one is scored and summed, so no phase waits a memory latency;
//   * the cache is read through its strides: the model's (b, S, hkv, d)
//     pool is used as it lies, with no transposed copy per step.
// Later work: the grid holds one wave of 4 blocks an SM (registers and
// 53 KB of shared memory at the serving shape), so a long row's split
// still walks its tiles one after another, each tile's dependent latency
// in turn; 64-slot tiles or more blocks an SM would shorten that.
//
// Per tile, from shared memory (128 threads; the kernel is instantiated
// for at most 1, 2, 4 or 8 q-heads a block, which sizes its registers):
//   scores: 8 threads a slot, each on every 8th 16-byte chunk of the K
//     row (a quarter warp reads 128 contiguous bytes), q in fp32 from
//     shared memory, a reduction over the 8 lanes per q-head, and each 4
//     slots' max of the visible scores;
//   PV: thread (group, c) owns the 16-byte chunk c of a V row (8 bf16 or
//     4 fp32 values) and sums the group's slots (slot = group mod groups),
//     keeping the online softmax itself (running max, rescale, p, its
//     group's part of l): one barrier a tile besides the ring's; the
//     groups' sums are added in group order at the end.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_decode_split.cuh"

namespace {

using namespace fdsplit;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes of a staged row -> fp32
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

struct Args {
  Sched s;
  const void* q;
  const void* k;
  const void* v;
  void* out;
  // strides in elements
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh;
  int width;          // bytes a K/V copy
};

// bytes of the K/V ring, which the groups' partial sums reuse at the end
template <typename TKV>
__host__ __device__ int region_bytes(int d) {
  constexpr int CW = 16 / static_cast<int>(sizeof(TKV));
  const int ring = 2 * kStages * kTile * round16(d * sizeof(TKV));
  const int red = kThreads * CW * 4;
  return ring > red ? ring : red;
}

// fp32 q of one head, zero-padded to whole 16-byte chunks of K
template <typename TKV>
__host__ __device__ int q_row(int d) {
  constexpr int CW = 16 / static_cast<int>(sizeof(TKV));
  return (d + CW - 1) / CW * CW;
}

template <typename TQ, typename TKV, int KG>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    flash_decode_split_kernel(Args a) {
  constexpr int CW = 16 / static_cast<int>(sizeof(TKV));   // values a chunk
  constexpr int kSub = 8;                  // threads a slot (scores)
  extern __shared__ __align__(16) uint8_t dyn[];
  __shared__ Small sm;
  const Sched s = a.s;
  const Block k = block_of(s);
  const int tid = threadIdx.x;
  const int d = s.d, G = k.G;
  const int row_bytes = d * sizeof(TKV);
  const int rb = round16(row_bytes);             // bytes a staged row
  const int rs = rb / static_cast<int>(sizeof(TKV));
  const int ring = kStages * kTile * rb;
  uint8_t* k_st = dyn;
  uint8_t* v_st = dyn + ring;
  float* red = reinterpret_cast<float*>(dyn);
  const int qd = q_row<TKV>(d);
  float* q_s = reinterpret_cast<float*>(dyn + region_bytes<TKV>(d));

  const TQ* q = static_cast<const TQ*>(a.q);
  for (int i = tid; i < G * qd; i += kThreads) {
    const int g = i / qd, j = i - g * qd;
    q_s[i] = j < d ? to_f(q[k.b * a.q_sb + (k.h0 + g) * a.q_sh + j]) : 0.f;
  }
  // the ring starts at 0: rows are copied only where visible, so a row
  // that was never copied, and every row's tail past d, read as 0
  for (int i = tid; i < 2 * ring / 16; i += kThreads)
    reinterpret_cast<uint4*>(dyn)[i] = make_uint4(0, 0, 0, 0);
  const int n_chunks = (d + CW - 1) / CW;
  const int groups = kThreads / n_chunks;
  const int grp = tid / n_chunks, c = tid - grp * n_chunks;
  const bool c_thread = grp < groups;
  const int sub = tid % kSub;
  float acc[KG][CW], m_run[KG], lpart[KG];
#pragma unroll
  for (int g = 0; g < KG; ++g) {
    m_run[g] = kNegInf;
    lpart[g] = 0.f;
#pragma unroll
    for (int i = 0; i < CW; ++i) acc[g][i] = 0.f;
  }
  // (list_tiles' barriers order q_s and the zeroed ring before use)

  const uint8_t* k_src = static_cast<const uint8_t*>(a.k) +
                         (k.b * a.k_sb + k.kvh * a.k_sh) * sizeof(TKV);
  const uint8_t* v_src = static_cast<const uint8_t*>(a.v) +
                         (k.b * a.v_sb + k.kvh * a.v_sh) * sizeof(TKV);
  const long long k_step = a.k_ss * sizeof(TKV);
  const long long v_step = a.v_ss * sizeof(TKV);
  const int width = a.width;

  auto load = [&](int st, int t0, uint32_t mask) {
    stage_rows(k_st + st * kTile * rb, rb, k_src, k_step, row_bytes, width,
               t0, mask);
    stage_rows(v_st + st * kTile * rb, rb, v_src, v_step, row_bytes, width,
               t0, mask);
  };

  auto compute = [&](int st, int t0, uint32_t mask) {
    const TKV* ks = reinterpret_cast<const TKV*>(k_st + st * kTile * rb);
    const TKV* vs = reinterpret_cast<const TKV*>(v_st + st * kTile * rb);
    // scores: kSub threads a slot, each on the chunks sub, sub + kSub, ...
    // of its K row; every slot is scored (the softmax masks), so the
    // shuffles run converged
#pragma unroll
    for (int pass = 0; pass < kTile * kSub / kThreads; ++pass) {
      const int r = tid / kSub + pass * (kThreads / kSub);
      const TKV* kr = ks + r * rs;
      float dot[KG];
#pragma unroll
      for (int g = 0; g < KG; ++g) dot[g] = 0.f;
#pragma unroll 4
      for (int ch = sub; ch < n_chunks; ch += kSub) {
        float x[CW];
        load16(kr + ch * CW, x);
#pragma unroll
        for (int g = 0; g < KG; ++g) {
          if (g < G) {
            const float* qq = q_s + g * qd + ch * CW;
#pragma unroll
            for (int i = 0; i < CW; i += 4) {
              const float4 q4 = *reinterpret_cast<const float4*>(qq + i);
              dot[g] += q4.x * x[i] + q4.y * x[i + 1] + q4.z * x[i + 2] +
                        q4.w * x[i + 3];
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < KG; ++g)
        if (g < G) put_score(s, sm, g, r, group_sum<kSub>(dot[g]), mask);
    }
    __syncthreads();
    // PV: thread (grp, c) over the slots r = grp (mod groups), keeping the
    // online softmax itself; a slot that is not visible adds p = 0 (its
    // staged row is 0 or an earlier visible row: finite)
    if (c_thread) {
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        if (g < G) {
          const float corr = rescale(sm, g, m_run[g]);
          lpart[g] *= corr;
#pragma unroll
          for (int i = 0; i < CW; ++i) acc[g][i] *= corr;
        }
      }
#pragma unroll 4
      for (int r = grp; r < kTile; r += groups) {
        const bool vis = (mask >> r) & 1u;
        float x[CW];
        load16(vs + r * rs + c * CW, x);
#pragma unroll
        for (int g = 0; g < KG; ++g) {
          if (g < G) {
            const float p = vis ? expf(sm.p[g][r] - m_run[g]) : 0.f;
            lpart[g] += p;
#pragma unroll
            for (int i = 0; i < CW; ++i) acc[g][i] += p * x[i];
          }
        }
      }
    }
  };

  const bool any = run_tiles(s, k, sm, load, compute);
  TQ* out = static_cast<TQ*>(a.out);
  const long long o_sb = a.o_sb, o_sh = a.o_sh;
  finish(s, k, sm, acc, m_run, lpart, c_thread, grp, c, groups,
         n_chunks * CW, red, any, [&](int h, int e, float x) {
           store_f(&out[k.b * o_sb + h * o_sh + e], x);
         });
}

template <typename TQ, typename TKV, int KG>
int launch_heads(const Args& a, int b, cudaStream_t stream) {
  const Sched& s = a.s;
  const int chunks = (s.ratio + s.g_per_block - 1) / s.g_per_block;
  const int smem =
      region_bytes<TKV>(s.d) + s.g_per_block * q_row<TKV>(s.d) * 4;
  auto kern = flash_decode_split_kernel<TQ, TKV, KG>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(s.hkv * chunks * s.splits, b);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return 0;
}

template <typename TQ, typename TKV>
int launch(const Args& a, int b, cudaStream_t stream) {
  switch (heads_of(a.s.g_per_block)) {
    case 1: return launch_heads<TQ, TKV, 1>(a, b, stream);
    case 2: return launch_heads<TQ, TKV, 2>(a, b, stream);
    case 4: return launch_heads<TQ, TKV, 4>(a, b, stream);
    default: return launch_heads<TQ, TKV, 8>(a, b, stream);
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Output has q's dtype.
// Strides are in elements; head_dim must be the unit-stride axis of q,
// k, v and out.  g_per_block (q-heads a block), splits and width (bytes a
// K/V copy: 16, 8, 4, 2 or 1, dividing the cache's addresses, strides and
// rows) are the wrapper's choice, checked here.  With splits > 1, ws is
// the fp32 (b, hq, splits, d + 2) workspace and counters b * hkv *
// ceil(hq / hkv / g_per_block) int32 that are 0 (and are left 0).
// Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int repro_flash_decode(
    int q_dtype, int kv_dtype, const void* q, const void* k, const void* v,
    const void* slot_pos, const void* pos, void* out, void* ws,
    void* counters, int b, int S, int hq, int hkv, int d, int g_per_block,
    int splits, int width, long long q_sb, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long sp_sb, long long o_sb, long long o_sh,
    float scale, int has_window, int window, int has_softcap, float softcap,
    void* stream) {
  Args a;
  Sched& s = a.s;
  s.slot_pos = static_cast<const int*>(slot_pos);
  s.pos = static_cast<const int*>(pos);
  s.ws = static_cast<float*>(ws);
  s.counters = static_cast<int*>(counters);
  s.sp_sb = sp_sb;
  s.S = S;
  s.hq = hq;
  s.hkv = hkv;
  s.d = d;
  s.ratio = hkv > 0 ? hq / hkv : 0;
  s.g_per_block = g_per_block;
  s.splits = splits;
  s.has_window = has_window;
  s.window = window;
  s.has_softcap = has_softcap;
  s.softcap = softcap;
  s.scale = scale;
  if (const int err = check(s, b)) return err;
  const int item = kv_dtype == 0 ? 4 : 2;
  const long long k_st[] = {k_sb * item, k_ss * item, k_sh * item};
  const long long v_st[] = {v_sb * item, v_ss * item, v_sh * item};
  if (!width_fits(width, k, k_st, 3, static_cast<long long>(d) * item) ||
      !width_fits(width, v, v_st, 3, static_cast<long long>(d) * item))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (b == 0) return 0;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.q_sb = q_sb;
  a.q_sh = q_sh;
  a.k_sb = k_sb;
  a.k_ss = k_ss;
  a.k_sh = k_sh;
  a.v_sb = v_sb;
  a.v_ss = v_ss;
  a.v_sh = v_sh;
  a.o_sb = o_sb;
  a.o_sh = o_sh;
  a.width = width;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (q_dtype == 0 && kv_dtype == 0)
    err = launch<float, float>(a, b, st);
  else if (q_dtype == 1 && kv_dtype == 1)
    err = launch<__nv_bfloat16, __nv_bfloat16>(a, b, st);
  else if (q_dtype == 0 && kv_dtype == 1)
    err = launch<float, __nv_bfloat16>(a, b, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
