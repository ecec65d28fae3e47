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
// hkv, d/blk), code c = 2^(c-127).
//
// Bound: as for the dense kernel, ~4 flops per K/V byte, far below the
// card's balance point, so the K/V bytes read bound it; quantized they
// are stored_d + d/blk bytes per (slot, head) instead of 2d (bf16):
// 0.53 B/value for fp4, 1.03 for fp8.  Tensor cores are not needed: fp32
// FMA on the CUDA cores covers the work many times over.  The design is
// flash_decode.cu's (the schedule of flash_decode_split.cuh): blocks per
// (b, chunk of a GQA group, split), the S axis split round-robin in
// 32-slot tiles and combined in the same launch, only visible rows
// copied, a ring of 3 tiles staged with cp.async (16 bytes a thread where
// the alignment allows: a code row is 128 B for fp8 at d = 128, 96 B for
// fp6, 64 B for fp4; a scale row 4 B), the cache read through its
// strides.  The codes never exist in device memory at full width: the
// unit of work is a quad of 4 consecutive values of d, whole bytes in
// every format (4 fp8 bytes, one 3-byte fp6 group, 2 fp4 bytes) and
// always inside one scale block (blk >= 4), expanded from shared memory
// to fp32 in registers: fp8 by the hardware's exact fp8 -> f16
// conversion, fp6 / fp4 through a table of their values that
// lowbits::decode fills.  The block scale, a power of two, multiplies a
// quad's partial dot product (scores) or p (PV): exact.
//
// Per tile, from shared memory (128 threads; instantiated for at most 1,
// 2, 4 or 8 q-heads a block): scores, 8 threads a slot, each expanding
// every 8th quad of the row; PV, thread (group, pair) summing two quads
// over the slots r = group (mod groups) and keeping the online softmax
// itself, as in flash_decode.cu; the groups' sums added in group order at
// the end.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_decode_split.cuh"
#include "lowbits.cuh"

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

// quad qd of a staged code row -> its 4 values (before the block scale)
template <int F>
__device__ __forceinline__ void decode_quad(const uint8_t* row, int qd,
                                            const float* lut,
                                            float (&v)[4]) {
  const uint32_t w = lowbits::load_quad<F>(row, qd);
  if constexpr (F <= 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint16_t pair = static_cast<uint16_t>(w >> (16 * i));
      uint32_t h;
      if constexpr (F == 0)
        asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(h) : "h"(pair));
      else
        asm("cvt.rn.f16x2.e5m2x2 %0, %1;\n" : "=r"(h) : "h"(pair));
      const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&h));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  } else {
    constexpr int kBits = lowbits::Fmt<F>::bits;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = lut[(w >> (kBits * i)) & ((1u << kBits) - 1)];
  }
}

// strides in elements (bytes for the code and scale tensors)
enum Stride {
  Q_SB, Q_SH, KQ_SB, KQ_SS, KQ_SH, KS_SB, KS_SS, KS_SH, VQ_SB, VQ_SS,
  VQ_SH, VS_SB, VS_SS, VS_SH, SP_SB, O_SB, O_SH, N_STRIDES
};

struct Args {
  Sched s;
  const void* q;
  const uint8_t* kq;
  const uint8_t* ks;
  const uint8_t* vq;
  const uint8_t* vs;
  void* out;
  int stored_d, n_blk, blk;
  int width, scale_width;    // bytes a code copy, a scale copy
  long long st[N_STRIDES];
};

// bytes of the ring (codes and scales of K and V), which the groups'
// partial sums reuse at the end
__host__ __device__ inline int region_bytes(int stored_d, int n_blk) {
  const int ring = 2 * kStages * kTile * (round16(stored_d) + round16(n_blk));
  const int red = kThreads * 8 * 4;
  return ring > red ? ring : red;
}

template <typename TQ, int F, int KG>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    flash_decode_quant_split_kernel(Args a) {
  constexpr int kSub = 8;                  // threads a slot (scores)
  extern __shared__ __align__(16) uint8_t dyn[];
  __shared__ Small sm;
  __shared__ float lut[64];
  const Sched s = a.s;
  const Block k = block_of(s);
  const int tid = threadIdx.x;
  const int d = s.d, G = k.G;
  const int nq = d / 4;                          // quads a row
  const int qpb = a.blk / 4;                     // quads a scale block
  const int stored_d = a.stored_d, n_blk = a.n_blk;
  const int rc = round16(stored_d), rsc = round16(n_blk);
  const int ring_c = kStages * kTile * rc, ring_s = kStages * kTile * rsc;
  uint8_t* kq_st = dyn;
  uint8_t* vq_st = dyn + ring_c;
  uint8_t* ks_st = dyn + 2 * ring_c;
  uint8_t* vs_st = dyn + 2 * ring_c + ring_s;
  float* red = reinterpret_cast<float*>(dyn);
  float* q_s = reinterpret_cast<float*>(dyn + region_bytes(stored_d, n_blk));

  const TQ* q = static_cast<const TQ*>(a.q);
  for (int i = tid; i < G * d; i += kThreads) {
    const int g = i / d, j = i - g * d;
    q_s[i] = to_f(q[k.b * a.st[Q_SB] + (k.h0 + g) * a.st[Q_SH] + j]);
  }
  if constexpr (F >= 2) {
    for (int c = tid; c < (1 << lowbits::Fmt<F>::bits); c += kThreads)
      lut[c] = lowbits::decode<F>(c);
  }
  // the ring starts at 0: rows are copied only where visible, so a row
  // that was never copied decodes to finite values (codes 0, scale 2^-127)
  for (int i = tid; i < 2 * (ring_c + ring_s) / 16; i += kThreads)
    reinterpret_cast<uint4*>(dyn)[i] = make_uint4(0, 0, 0, 0);
  // PV: thread (grp, qp) owns quads 2 qp and 2 qp + 1 (the second
  // repeats the first where nq is odd; its sums are never read)
  const int npair = (nq + 1) / 2;
  const int groups = kThreads / npair;
  const int grp = tid / npair, qp = tid - grp * npair;
  const int qa = 2 * qp, qb = min(2 * qp + 1, nq - 1);
  const bool c_thread = grp < groups;
  const int sub = tid % kSub;
  float acc[KG][8], m_run[KG], lpart[KG];
#pragma unroll
  for (int g = 0; g < KG; ++g) {
    m_run[g] = kNegInf;
    lpart[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
  }
  // (list_tiles' barriers order q_s, lut and the zeroed ring before use)

  const uint8_t* kq_src = a.kq + k.b * a.st[KQ_SB] + k.kvh * a.st[KQ_SH];
  const uint8_t* ks_src = a.ks + k.b * a.st[KS_SB] + k.kvh * a.st[KS_SH];
  const uint8_t* vq_src = a.vq + k.b * a.st[VQ_SB] + k.kvh * a.st[VQ_SH];
  const uint8_t* vs_src = a.vs + k.b * a.st[VS_SB] + k.kvh * a.st[VS_SH];
  const long long kq_step = a.st[KQ_SS], ks_step = a.st[KS_SS];
  const long long vq_step = a.st[VQ_SS], vs_step = a.st[VS_SS];
  const int width = a.width, scale_width = a.scale_width;

  auto load = [&](int st, int t0, uint32_t mask) {
    stage_rows(kq_st + st * kTile * rc, rc, kq_src, kq_step, stored_d,
               width, t0, mask);
    stage_rows(vq_st + st * kTile * rc, rc, vq_src, vq_step, stored_d,
               width, t0, mask);
    stage_rows(ks_st + st * kTile * rsc, rsc, ks_src, ks_step, n_blk,
               scale_width, t0, mask);
    stage_rows(vs_st + st * kTile * rsc, rsc, vs_src, vs_step, n_blk,
               scale_width, t0, mask);
  };

  auto compute = [&](int st, int t0, uint32_t mask) {
    const uint8_t* kqs = kq_st + st * kTile * rc;
    const uint8_t* vqs = vq_st + st * kTile * rc;
    const uint8_t* kss = ks_st + st * kTile * rsc;
    const uint8_t* vss = vs_st + st * kTile * rsc;
    // scores: kSub threads a slot, each on the quads sub, sub + kSub, ...
    // of its K row; every slot is scored (the softmax masks), so the
    // shuffles run converged
#pragma unroll
    for (int pass = 0; pass < kTile * kSub / kThreads; ++pass) {
      const int r = tid / kSub + pass * (kThreads / kSub);
      float dot[KG];
#pragma unroll
      for (int g = 0; g < KG; ++g) dot[g] = 0.f;
#pragma unroll 4
      for (int qd = sub; qd < nq; qd += kSub) {
        float x[4];
        decode_quad<F>(kqs + r * rc, qd, lut, x);
        const float sc = lowbits::e8m0(kss[r * rsc + qd / qpb]);
#pragma unroll
        for (int g = 0; g < KG; ++g) {
          if (g < G) {
            const float4 q4 =
                *reinterpret_cast<const float4*>(q_s + g * d + 4 * qd);
            dot[g] += sc * (q4.x * x[0] + q4.y * x[1] + q4.z * x[2] +
                            q4.w * x[3]);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < KG; ++g)
        if (g < G) put_score(s, sm, g, r, group_sum<kSub>(dot[g]), mask);
    }
    __syncthreads();
    // PV: thread (grp, qp) over the slots r = grp (mod groups), keeping
    // the online softmax itself; a slot that is not visible adds p = 0
    // (its staged row is 0 or an earlier visible row: finite)
    if (c_thread) {
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        if (g < G) {
          const float corr = rescale(sm, g, m_run[g]);
          lpart[g] *= corr;
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[g][i] *= corr;
        }
      }
#pragma unroll 4
      for (int r = grp; r < kTile; r += groups) {
        const bool vis = (mask >> r) & 1u;
        float xa[4], xb[4];
        decode_quad<F>(vqs + r * rc, qa, lut, xa);
        decode_quad<F>(vqs + r * rc, qb, lut, xb);
        const float sa = lowbits::e8m0(vss[r * rsc + qa / qpb]);
        const float sb = lowbits::e8m0(vss[r * rsc + qb / qpb]);
#pragma unroll
        for (int g = 0; g < KG; ++g) {
          if (g < G) {
            const float p = vis ? expf(sm.p[g][r] - m_run[g]) : 0.f;
            lpart[g] += p;
            const float pa = p * sa, pb = p * sb;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[g][i] += pa * xa[i];
              acc[g][4 + i] += pb * xb[i];
            }
          }
        }
      }
    }
  };

  const bool any = run_tiles(s, k, sm, load, compute);
  TQ* out = static_cast<TQ*>(a.out);
  const long long o_sb = a.st[O_SB], o_sh = a.st[O_SH];
  finish(s, k, sm, acc, m_run, lpart, c_thread, grp, qp, groups, 8 * npair,
         red, any, [&](int h, int e, float x) {
           store_f(&out[k.b * o_sb + h * o_sh + e], x);
         });
}

template <typename TQ, int F, int KG>
int launch_heads(const Args& a, int b, cudaStream_t stream) {
  const Sched& s = a.s;
  const int chunks = (s.ratio + s.g_per_block - 1) / s.g_per_block;
  const int smem =
      region_bytes(a.stored_d, a.n_blk) + s.g_per_block * s.d * 4;
  auto kern = flash_decode_quant_split_kernel<TQ, F, KG>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(s.hkv * chunks * s.splits, b);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return 0;
}

template <typename TQ, int F>
int launch(const Args& a, int b, cudaStream_t stream) {
  switch (heads_of(a.s.g_per_block)) {
    case 1: return launch_heads<TQ, F, 1>(a, b, stream);
    case 2: return launch_heads<TQ, F, 2>(a, b, stream);
    case 4: return launch_heads<TQ, F, 4>(a, b, stream);
    default: return launch_heads<TQ, F, 8>(a, b, stream);
  }
}

template <typename TQ>
int dispatch_fmt(int fmt, const Args& a, int b, cudaStream_t st) {
  switch (fmt) {
    case 0: return launch<TQ, 0>(a, b, st);
    case 1: return launch<TQ, 1>(a, b, st);
    case 2: return launch<TQ, 2>(a, b, st);
    case 3: return launch<TQ, 3>(a, b, st);
    case 4: return launch<TQ, 4>(a, b, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16 (output has q's dtype).  fmt: 0
// e4m3fn, 1 e5m2, 2 fp6 e2m3, 3 fp6 e3m2, 4 fp4 e2m1.  `strides` is a
// host array of N_STRIDES int64 in the order of enum Stride, in elements
// (bytes for the codes and scales); head_dim is the unit-stride axis of
// every tensor.  g_per_block, splits, width (bytes a code copy) and
// scale_width (bytes a scale copy) are the wrapper's choice, checked
// here; ws and counters as for repro_flash_decode.  Returns
// cudaGetLastError() after the launch (0 = ok).
extern "C" int repro_flash_decode_quant(
    int q_dtype, int fmt, const void* q, const void* kq, const void* ks,
    const void* vq, const void* vs, const void* slot_pos, const void* pos,
    void* out, void* ws, void* counters, int b, int S, int hq, int hkv,
    int d, int blk, int g_per_block, int splits, int width, int scale_width,
    const long long* strides, float scale, int has_window, int window,
    int has_softcap, float softcap, void* stream) {
  Args a;
  Sched& s = a.s;
  s.slot_pos = static_cast<const int*>(slot_pos);
  s.pos = static_cast<const int*>(pos);
  s.ws = static_cast<float*>(ws);
  s.counters = static_cast<int*>(counters);
  s.sp_sb = strides[SP_SB];
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
  if (d % 4 != 0 || blk < 4 || blk % 4 != 0 || d % blk != 0 || fmt < 0 ||
      fmt > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bits = fmt <= 1 ? 8 : fmt == 4 ? 4 : 6;
  a.stored_d = d * bits / 8;
  a.n_blk = d / blk;
  a.blk = blk;
  if (!width_fits(width, kq, strides + KQ_SB, 3, a.stored_d) ||
      !width_fits(width, vq, strides + VQ_SB, 3, a.stored_d) ||
      !width_fits(scale_width, ks, strides + KS_SB, 3, a.n_blk) ||
      !width_fits(scale_width, vs, strides + VS_SB, 3, a.n_blk))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (b == 0) return 0;
  a.q = q;
  a.kq = static_cast<const uint8_t*>(kq);
  a.ks = static_cast<const uint8_t*>(ks);
  a.vq = static_cast<const uint8_t*>(vq);
  a.vs = static_cast<const uint8_t*>(vs);
  a.out = out;
  a.width = width;
  a.scale_width = scale_width;
  for (int i = 0; i < N_STRIDES; ++i) a.st[i] = strides[i];
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
