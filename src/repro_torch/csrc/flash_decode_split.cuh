// flash_decode_split.cuh — the schedule shared by flash_decode.cu and
// flash_decode_quant.cu: one decode-attention design in two sources.
//
// Grid: (kv-head chunk, split) x b.  Block (b, chunk, split) serves the
// q-heads of one chunk of a GQA group (up to kMaxG) and takes the tiles
// split, split + splits, split + 2 splits, ... of the S axis, kTile slots
// each.  Round-robin, not contiguous ranges: a ring fills from slot 0, or
// holds a window-long run modulo S, and round-robin spreads either over
// every split.  The wrapper chooses `splits` (and the copy widths) from
// the shapes alone; the C entries only check them.
//
// Per block:
//   1. list_tiles: the split's slot_pos, 32 tiles a round with every
//      load in flight before any is used, give a 32-bit mask of visible
//      slots per tile; the tiles with a visible slot are listed in order.
//      A split with no visible tile stops there.
//   2. run_tiles: a ring of kStages tiles in shared memory.  The kernel's
//      `load` stages the visible rows of a listed tile with cp.async
//      (16 bytes a thread where the alignment allows, neighbouring threads
//      on neighbouring chunks of a row); tile i + kStages - 1 is in flight
//      while tile i is scored and summed by the kernel's `compute`: the
//      scores (put_score also keeps each 4 slots' max), one barrier, then
//      PV, where every PV thread keeps the online softmax itself (rescale;
//      p = exp(s - m) for its own slots; its group's part of l).
//   3. finish: the groups of PV threads add their partial sums in a fixed
//      order.  With one split the block writes out = acc / l.  Otherwise
//      it writes its unnormalized (m, l, acc[d]) per q-head to the fp32
//      workspace, counts its arrival on the (b, chunk) counter, and the
//      last split to arrive combines all of them in split order, writes
//      out and resets the counter to 0: one launch, and the same bits
//      whatever the order of arrival.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fdsplit {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;        // resident blocks an SM (registers)
constexpr int kTile = 32;            // slots a tile: one bit each of a mask
constexpr int kStages = 3;           // tiles in the shared-memory ring
constexpr int kMaxG = 8;             // q-heads a block
constexpr int kMaxD = 256;           // head_dim limit
constexpr int kList = 128;           // tiles of a split listed at once
constexpr int kListLoads = 8;        // slot_pos loads in flight a lane
constexpr float kNegInf = -1.0e30f;

__host__ __device__ constexpr int round16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

// what the schedule needs of a call (both kernels)
struct Sched {
  const int* slot_pos;
  const int* pos;
  float* ws;              // (b, hq, splits, d + 2) fp32; splits > 1 only
  int* counters;          // (b, blocks a row) int32, 0 between launches
  long long sp_sb;
  int S, hq, hkv, d, ratio, g_per_block, splits;
  int has_window, window, has_softcap;
  float softcap, scale;
};

// the block's small shared state
struct __align__(16) Small {
  float p[kMaxG][kTile];             // the tile's scores
  float tmax[kMaxG][kTile / 4];      // max of each 4 slots' visible scores
  float lsum[kThreads];              // the PV groups' partial l, at the end
  int list[kList];                   // listed tiles, in order
  uint32_t mask[kList];              // their visible slots
  uint32_t all[kList];               // every tile's mask, before listing
  int n, last;
};

struct Block {
  int b, kvh, h0, G, split, row_block, row_pos;
};

__device__ __forceinline__ Block block_of(const Sched& s) {
  Block k;
  const int chunks = (s.ratio + s.g_per_block - 1) / s.g_per_block;
  const int bc = blockIdx.x / s.splits;
  k.split = blockIdx.x % s.splits;
  k.kvh = bc / chunks;
  k.h0 = k.kvh * s.ratio + (bc % chunks) * s.g_per_block;
  k.G = min(s.g_per_block, (k.kvh + 1) * s.ratio - k.h0);
  k.b = blockIdx.y;
  k.row_block = k.b * (s.hkv * chunks) + bc;
  k.row_pos = s.pos[k.b];
  return k;
}

// ---- copies ------------------------------------------------------------ //

// `width` bytes global -> shared: cp.async for 16, 8 and 4 (16 bypasses
// L1), a load and a store for the 2- and 1-byte widths that cp.async
// does not take (a view aligned no further; the wrapper says which)
__device__ __forceinline__ void copy_chunk(void* dst, const void* src,
                                           int width) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (width == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src) : "memory");
  else if (width == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src) : "memory");
  else if (width == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src) : "memory");
  else if (width == 2)
    *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
  else
    *static_cast<uint8_t*>(dst) = *static_cast<const uint8_t*>(src);
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the visible rows (bit r of mask: slot t0 + r) of one tile, row_bytes
// each, from src + slot * stride to dst + r * dst_stride, in chunks of
// `width` bytes; neighbouring threads copy neighbouring chunks of a row
// (thread i takes chunk i, i + kThreads, ... of the tile, stepped without
// a division)
__device__ __forceinline__ void stage_rows(uint8_t* dst, int dst_stride,
                                           const uint8_t* src,
                                           long long stride, int row_bytes,
                                           int width, int t0,
                                           uint32_t mask) {
  const int per_row = row_bytes / width;
  const int dr = kThreads / per_row, dc = kThreads - dr * per_row;
  int r = threadIdx.x / per_row, c = threadIdx.x - r * per_row;
  while (r < kTile) {
    if ((mask >> r) & 1u)
      copy_chunk(dst + r * dst_stride + c * width,
                 src + (t0 + r) * stride + c * width, width);
    r += dr;
    c += dc;
    if (c >= per_row) {
      c -= per_row;
      ++r;
    }
  }
}

// ---- the split's tiles ------------------------------------------------- //

// Lists the tiles seg .. seg + kList - 1 of this split (tile = split + i
// * splits) that hold a visible slot: sm.list / sm.mask, sm.n of them.  A
// warp takes a tile, a lane a slot; kListLoads tiles' loads are in flight
// before any is used.
__device__ __forceinline__ int list_tiles(const Sched& s, const Block& k,
                                          int seg, int n_mine, Small& sm) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cnt = min(kList, n_mine - seg);
  const int* sp_row = s.slot_pos + k.b * s.sp_sb;
  for (int i0 = 0; i0 < cnt; i0 += kWarps * kListLoads) {
    int sp[kListLoads];
#pragma unroll
    for (int u = 0; u < kListLoads; ++u) {
      const int i = i0 + warp + u * kWarps;
      const int slot = (k.split + (seg + i) * s.splits) * kTile + lane;
      sp[u] = -1;
      if (i < cnt && slot < s.S) sp[u] = sp_row[slot];
    }
#pragma unroll
    for (int u = 0; u < kListLoads; ++u) {
      const int i = i0 + warp + u * kWarps;
      const bool vis = sp[u] >= 0 && sp[u] <= k.row_pos &&
                       (!s.has_window || sp[u] > k.row_pos - s.window);
      const uint32_t m = __ballot_sync(0xffffffffu, vis);
      if (lane == 0 && i < cnt) sm.all[i] = m;
    }
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int i0 = 0; i0 < cnt; i0 += 32) {
      const int i = i0 + lane;
      const uint32_t m = i < cnt ? sm.all[i] : 0u;
      const uint32_t has = __ballot_sync(0xffffffffu, m != 0u);
      if (m) {
        const int j = n + __popc(has & ((1u << lane) - 1u));
        sm.list[j] = k.split + (seg + i) * s.splits;
        sm.mask[j] = m;
      }
      n += __popc(has);
    }
    if (lane == 0) sm.n = n;
  }
  __syncthreads();
  return sm.n;
}

// Walks the split's visible tiles through the ring: load(stage, t0, mask)
// starts a tile's copies, compute(stage, t0, mask) uses it once it has
// landed (t0 = the tile's first slot).  Returns whether any tile was
// visible (block-uniform).
template <typename Load, typename Compute>
__device__ __forceinline__ bool run_tiles(const Sched& s, const Block& k,
                                          Small& sm, Load load,
                                          Compute compute) {
  const int n_tiles = (s.S + kTile - 1) / kTile;
  const int n_mine =
      k.split < n_tiles ? (n_tiles - 1 - k.split) / s.splits + 1 : 0;
  bool any = false;
  for (int seg = 0; seg < n_mine; seg += kList) {
    const int n = list_tiles(s, k, seg, n_mine, sm);
    any = any || n > 0;
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < n) load(st, sm.list[st] * kTile, sm.mask[st]);
      commit();
    }
    for (int i = 0; i < n; ++i) {
      wait_pending<kStages - 2>();       // this thread's copies of tile i
      __syncthreads();                   // everyone's; tile i - 1 is done
      const int nx = i + kStages - 1;
      if (nx < n) load(nx % kStages, sm.list[nx] * kTile, sm.mask[nx]);
      commit();
      compute(i % kStages, sm.list[i] * kTile, sm.mask[i]);
    }
    wait_pending<0>();                   // (only empty groups are left)
    __syncthreads();                     // sm.list is rebuilt next
  }
  return any;
}

// ---- scores and the online softmax ------------------------------------- //

// the sum over the kSub lanes of an aligned group of kSub lanes
template <int kSub>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = kSub / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// scale, then softcap (before masking, as the reference does)
__device__ __forceinline__ float score(const Sched& s, float dot) {
  float x = dot * s.scale;
  if (s.has_softcap) x = tanhf(x / s.softcap) * s.softcap;
  return x;
}

// The scores of one pass, in which the kSub = 8 lanes of each group hold
// the dot product of their slot r: its score to sm.p, and the max of the
// warp's 4 slots' visible scores to sm.tmax (a warp covers 4 consecutive
// slots a pass, so lane 0 has r = 4 * (r / 4)).
__device__ __forceinline__ void put_score(const Sched& s, Small& sm, int g,
                                          int r, float dot, uint32_t mask) {
  const int lane = threadIdx.x & 31;
  const float x = score(s, dot);
  if ((lane & 7) == 0) sm.p[g][r] = x;
  float v = ((mask >> r) & 1u) ? x : -INFINITY;
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
  if (lane == 0) sm.tmax[g][r >> 2] = v;
}

// The online softmax, kept by every PV thread: the tile's max (finite: a
// listed tile holds a visible slot), the new running max, and the factor
// that rescales the running sums.
__device__ __forceinline__ float rescale(const Small& sm, int g,
                                         float& m_run) {
  const float4 a = *reinterpret_cast<const float4*>(&sm.tmax[g][0]);
  const float4 b = *reinterpret_cast<const float4*>(&sm.tmax[g][4]);
  const float mx = fmaxf(fmaxf(fmaxf(a.x, a.y), fmaxf(a.z, a.w)),
                         fmaxf(fmaxf(b.x, b.y), fmaxf(b.z, b.w)));
  const float m_new = fmaxf(m_run, mx);
  const float corr = expf(m_run - m_new);
  m_run = m_new;
  return corr;
}

// ---- the end of a block ------------------------------------------------ //

// The last split of a (b, chunk) to arrive combines every split's (m, l,
// acc) in split order and writes out through store(h, e, value).
template <typename Store>
__device__ __forceinline__ void arrive_and_combine(const Sched& s,
                                                   const Block& k, Small& sm,
                                                   Store store) {
  __threadfence();                       // this block's partials, visible
  __syncthreads();
  if (threadIdx.x == 0) {
    const int before = atomicAdd(&s.counters[k.row_block], 1);
    sm.last = before == s.splits - 1;
    if (sm.last) atomicExch(&s.counters[k.row_block], 0);
  }
  __syncthreads();
  if (!sm.last) return;
  __threadfence();
  const int row = s.d + 2;
  for (int g = 0; g < k.G; ++g) {
    const float* w = s.ws + (static_cast<long long>(k.b) * s.hq + k.h0 + g) *
                                s.splits * row;
    float mx = kNegInf;
    for (int j = 0; j < s.splits; ++j) mx = fmaxf(mx, __ldcg(w + j * row));
    for (int e = threadIdx.x; e < s.d; e += kThreads) {
      float l = 0.f, o = 0.f;
      for (int j = 0; j < s.splits; ++j) {
        const float* wj = w + j * row;
        const float c = expf(__ldcg(wj) - mx);   // 0 for an empty split
        l += __ldcg(wj + 1) * c;
        o += __ldcg(wj + 2 + e) * c;
      }
      store(k.h0 + g, e, l > 0.f ? o / l : 0.f);
    }
  }
}

// The PV threads' partial sums: thread (grp, c) holds acc[g][0..CW) of
// elements c * CW .. of q-head h0 + g and its group's part of l, summed
// over the group's slots, all at the running max m_run[g].  Adds the
// groups' partials in group order through `red` (groups rows of row_len
// floats) and sm.lsum, then writes out (one split) or the workspace and
// combines (several).  `any`: some tile was visible (else all are 0).
template <int KG, int CW, typename Store>
__device__ __forceinline__ void finish(const Sched& s, const Block& k,
                                       Small& sm, float (&acc)[KG][CW],
                                       const float (&m_run)[KG],
                                       const float (&lpart)[KG],
                                       bool c_thread, int grp, int c,
                                       int groups, int row_len, float* red,
                                       bool any, Store store) {
#pragma unroll
  for (int g = 0; g < KG; ++g) {
    if (g < k.G) {                                 // block-uniform
      if (any) {
        if (c_thread) {
#pragma unroll
          for (int i = 0; i < CW; ++i) red[grp * row_len + c * CW + i] =
              acc[g][i];
          if (c == 0) sm.lsum[grp] = lpart[g];
        }
        __syncthreads();
      }
      float l = 0.f;
      if (any)
        for (int j = 0; j < groups; ++j) l += sm.lsum[j];
      float* w = s.ws + ((static_cast<long long>(k.b) * s.hq + k.h0 + g) *
                             s.splits + k.split) * (s.d + 2);
      for (int e = threadIdx.x; e < s.d; e += kThreads) {
        float o = 0.f;
        if (any)
          for (int j = 0; j < groups; ++j) o += red[j * row_len + e];
        if (s.splits == 1)
          store(k.h0 + g, e, l > 0.f ? o / l : 0.f);
        else
          w[2 + e] = o;
      }
      if (s.splits > 1 && threadIdx.x == 0) {      // a PV thread
        w[0] = m_run[g];
        w[1] = l;
      }
      __syncthreads();                             // red is reused
    }
  }
  if (s.splits > 1) arrive_and_combine(s, k, sm, store);
}

// The kernels are instantiated for at most 1, 2, 4 or 8 q-heads a block
// (registers for the running sums follow); a launch takes the smallest
// that holds g_per_block.
inline int heads_of(int g_per_block) {
  return g_per_block <= 1 ? 1 : g_per_block <= 2 ? 2 : g_per_block <= 4 ? 4
                                                                         : 8;
}

// Checks of a call that both C entries make; 0 or a cudaError_t.
inline int check(const Sched& s, int b) {
  const int n_tiles = (s.S + kTile - 1) / kTile;
  if (s.d < 1 || s.d > kMaxD || s.hkv < 1 || s.hq < s.hkv ||
      s.hq % s.hkv != 0 || b < 0 || b > 65535 || s.S < 0 ||
      s.g_per_block < 1 || s.g_per_block > kMaxG ||
      s.g_per_block > s.ratio || s.splits < 1 ||
      s.splits > (n_tiles > 1 ? n_tiles : 1) ||
      (s.splits > 1 && (s.ws == nullptr || s.counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

// whether `width` (16, 8, 4, 2 or 1) divides the address and every
// stride (in bytes) and the row's bytes
inline bool width_fits(int width, const void* p, const long long* strides,
                       int n, long long row_bytes) {
  if (width != 16 && width != 8 && width != 4 && width != 2 && width != 1)
    return false;
  if (reinterpret_cast<uintptr_t>(p) % width || row_bytes % width)
    return false;
  for (int i = 0; i < n; ++i)
    if (strides[i] % width) return false;
  return true;
}

}  // namespace fdsplit
