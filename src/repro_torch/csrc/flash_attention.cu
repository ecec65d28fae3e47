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
// the Pallas kernel does where it skips every tile of the row.
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
//   * bf16 runs on the tensor cores: mma.sync m16n8k16 with fp32
//     accumulation, fragments fed by ldmatrix from padded shared tiles
//     (conflict-free rows), P kept in registers between the two
//     products (FA2); cp.async copies the next K tile during this
//     tile's products and the next V tile during the next QK^T (one V
//     buffer: three blocks an SM at d = 128); scores in log2 units with
//     the scale folded in, so p is one ex2;
//   * fp32 runs on the CUDA cores in fp32 (no TF32: the conformance
//     tests hold it to 2e-5 of the plain version), as 4x4 register
//     micro-tiles over transposed shared tiles (float4 loads);
//   * q tiles of one (b, head) are issued heaviest first (the causal
//     tail has the most K/V tiles), so the last wave is short.
// Not yet done (later work): wgmma and TMA, warp specialisation, a
// persistent schedule, 128-row q tiles.
//
// Tiles: 64 query rows a block.  bf16: 4 warps, 16 rows each; K/V tiles
// of 64 keys (32 at head_dim 256, to bound the registers of the output
// accumulators).  fp32: 256 threads, 64-key tiles.  head_dim d <= 256,
// a multiple of 8 (bf16) or 4 (fp32); the tiles are padded to the next
// of 64 / 128 / 256 with zeros.  Rows past sq or skv are zero-filled on
// load and masked (no padded copies in device memory).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBq = 64;          // query rows per block
constexpr float kNegInf = -INFINITY;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int sq, skv, hq, ratio, d, q_offset;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb,
      o_ss, o_sh;
  float scale;
  int causal, has_window, window, has_softcap;
  float softcap;
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
// bf16: tensor cores (mma.sync m16n8k16, fp32 accumulation)
// ===================================================================== //

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !in_range.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in_range) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in_range ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr float kLog2e = 1.4426950408889634f;

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

// rows x D tile of bf16 (row stride D + 8: 16-byte rows land on distinct
// bank groups for ldmatrix) from global rows [r0, r0 + rows), zero-filled
// past n_rows and past d.  128 threads.
template <int D>
__device__ __forceinline__ void load_tile_async(
    __nv_bfloat16* dst, const __nv_bfloat16* base, long long row_stride,
    int r0, int rows, int n_rows, int d) {
  constexpr int kChunks = D / 8;                    // 16-byte chunks a row
  for (int i = threadIdx.x; i < rows * kChunks; i += 128) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool in = r0 + r < n_rows && c < d;
    const __nv_bfloat16* src =
        base + (in ? (long long)(r0 + r) * row_stride + c : 0);
    cp_async16(dst + r * (D + 8) + c, src, in);
  }
}

template <int D, int BK>
__global__ void __launch_bounds__(128) flash_attention_bf16_kernel(Args a) {
  constexpr int kLd = D + 8;                        // shared row stride
  constexpr int kNT = BK / 8;                       // S n-tiles per warp
  constexpr int kDT = D / 8;                        // O n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kBq * kLd;             // 2 buffers
  __nv_bfloat16* v_s = k_s + 2 * BK * kLd;          // 1 buffer

  const int n_qt = gridDim.y;
  const int qt = n_qt - 1 - blockIdx.y;             // heaviest first
  const int bh = blockIdx.x;
  const int bi = bh / a.hq, h = bh % a.hq, kvh = h / a.ratio;
  const int q0 = qt * kBq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(a.q) +
                            bi * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(a.k) +
                            bi * a.k_sb + kvh * a.k_sh;
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(a.v) +
                            bi * a.v_sb + kvh * a.v_sh;

  const int q_lo = a.q_offset + q0;
  const int q_hi = a.q_offset + min(q0 + kBq, a.sq) - 1;
  int jb, je;
  kv_range(a, q_lo, q_hi, BK, &jb, &je);

  // this thread's two rows (g and g + 8 of the warp's 16)
  const int row0 = q0 + warp * 16 + g;
  const int pos0 = a.q_offset + row0, pos1 = pos0 + 8;
  const int w_lo = a.q_offset + q0 + warp * 16;     // the warp's rows
  const int w_hi = w_lo + 15;

  // scores are kept in log2 units: x = log2(e) * softcap(scale * q.k),
  // so p = 2^(x - m) is one ex2 (the scale folded into one multiply)
  const float x_mul = (a.has_softcap ? a.scale / a.softcap : a.scale);
  const float x_cap = a.softcap * kLog2e;
  const float x_lin = a.scale * kLog2e;

  float o[kDT][4];
#pragma unroll
  for (int i = 0; i < kDT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  // cp.async groups, in order: [q, K(jb)], [V(jb)], then per tile j:
  // [K(j + 1)] at its start and [V(j + 1)] at its end.  K is double-
  // buffered (the next tile's K lands during this tile's products); V
  // has one buffer (it lands during the next tile's QK^T), which keeps
  // shared memory to three blocks an SM at d = 128.
  load_tile_async<D>(q_s, qg, a.q_ss, q0, kBq, a.sq, a.d);
  if (jb < je) load_tile_async<D>(k_s, kg, a.k_ss, jb * BK, BK, a.skv, a.d);
  cp_async_commit();
  if (jb < je) load_tile_async<D>(v_s, vg, a.v_ss, jb * BK, BK, a.skv, a.d);
  cp_async_commit();

  for (int j = jb; j < je; ++j) {
    const int buf = (j - jb) & 1;
    const bool next = j + 1 < je;
    if (next) {                                     // prefetch K(j + 1)
      load_tile_async<D>(k_s + (buf ^ 1) * BK * kLd, kg, a.k_ss,
                         (j + 1) * BK, BK, a.skv, a.d);
      cp_async_commit();
      cp_async_wait<2>();                           // K(j) has landed
    } else {
      cp_async_wait<1>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = k_s + buf * BK * kLd;
    const int k0 = j * BK;

    // ---- S = Q K^T for the warp's 16 rows x BK keys ------------------
    float s[kNT][4];
#pragma unroll
    for (int i = 0; i < kNT; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      uint32_t af[4];
      ldmatrix_x4(af, q_s + (warp * 16 + (lane & 15)) * kLd + ks * 16 +
                          (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * kLd +
                            ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], af, bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], af, bf[2], bf[3]);
      }
    }

    // ---- scale, softcap, mask; online softmax on rows g, g + 8 --------
    const bool full = tile_full(a, w_lo, w_hi, k0, BK);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = a.has_softcap ? tanhf(s[nt][e] * x_mul) * x_cap
                                : s[nt][e] * x_lin;
        if (!full &&
            !visible(a, e < 2 ? pos0 : pos1, k0 + nt * 8 + 2 * t + (e & 1)))
          x = kNegInf;
        s[nt][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {        // the quad of a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // a row with nothing visible yet has m = -inf: subtract 0 instead,
    // so its p = 2^-inf = 0 and acc = l = 0 stay (no inf - inf)
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float mu0 = mn0 == kNegInf ? 0.f : mn0;
    const float mu1 = mn1 == kNegInf ? 0.f : mn1;
    const float c0 = ex2(m0 - mu0), c1 = ex2(m1 - mu1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      s[nt][0] = ex2(s[nt][0] - mu0);
      s[nt][1] = ex2(s[nt][1] - mu0);
      s[nt][2] = ex2(s[nt][2] - mu1);
      s[nt][3] = ex2(s[nt][3] - mu1);
      sum0 += s[nt][0] + s[nt][1];
      sum1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * c0 + sum0;                            // per-thread partials
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      o[dt][0] *= c0;
      o[dt][1] *= c0;
      o[dt][2] *= c1;
      o[dt][3] *= c1;
    }

    // ---- O += P V: P's accumulators become the A fragments ------------
    if (next) cp_async_wait<1>();                   // V(j) has landed
    else cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pf[4];
      pf[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, v_s + (kk * 16 + (lane & 7) +
                                     ((lane >> 3) & 1) * 8) * kLd +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pf, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], pf, vf[2], vf[3]);
      }
    }
    __syncthreads();              // every warp is done with K(j), V(j)
    if (next) {
      load_tile_async<D>(v_s, vg, a.v_ss, (j + 1) * BK, BK, a.skv, a.d);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();             // the q tile's copy when no tile ran

  // ---- normalize and store -------------------------------------------
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
  const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(a.out) + bi * a.o_sb +
                      h * a.o_sh;
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (col < a.d) {
      if (row0 < a.sq)
        *reinterpret_cast<__nv_bfloat162*>(og + row0 * a.o_ss + col) =
            __floats2bfloat162_rn(o[dt][0] * inv0, o[dt][1] * inv0);
      if (row0 + 8 < a.sq)
        *reinterpret_cast<__nv_bfloat162*>(og + (row0 + 8) * a.o_ss + col) =
            __floats2bfloat162_rn(o[dt][2] * inv1, o[dt][3] * inv1);
    }
  }
}

// ===================================================================== //
// fp32: CUDA cores, 4x4 register micro-tiles
// ===================================================================== //

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

template <typename Kernel>
int launch(Kernel kernel, int threads, size_t smem, const Args& a, int b,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * a.hq, (a.sq + kBq - 1) / kBq);
  kernel<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int BK>
int launch_bf16(const Args& a, int b, cudaStream_t st) {
  const size_t smem = sizeof(__nv_bfloat16) * (D + 8) * (kBq + 3 * BK);
  return launch(flash_attention_bf16_kernel<D, BK>, 128, smem, a, b, st);
}

template <int D>
int launch_f32(const Args& a, int b, cudaStream_t st) {
  const size_t smem = sizeof(float) * kLdT * (2 * D + kBk32);
  return launch(flash_attention_f32_kernel<D>, kF32Threads, smem, a, b, st);
}

}  // namespace

// dtype code: 0 = float32, 1 = bfloat16 (q, k, v and out alike).
// Strides are in elements; head_dim must be the unit-stride axis, d a
// multiple of 8 (bf16) or 4 (fp32), every stride a multiple of that and
// the pointers 16-byte aligned (the wrapper checks).  Returns
// cudaGetLastError() after the launch (0 = ok).
extern "C" int repro_flash_attention(
    int dtype, const void* q, const void* k, const void* v, void* out, int b,
    int sq, int skv, int hq, int hkv, int d, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, float scale, int causal, int has_window,
    int window, int has_softcap, float softcap, int q_offset, void* stream) {
  const int vec = dtype == 1 ? 8 : 4;
  if (d < 1 || d > 256 || d % vec != 0 || hkv < 1 || hq < hkv ||
      hq % hkv != 0 || b < 0 || sq < 0 || skv < 0 || q_offset < 0 ||
      (has_window && window < 1) || (sq + kBq - 1) / kBq > 65535 ||
      (long long)b * hq > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || sq == 0) return 0;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (d <= 64) return launch_bf16<64, 64>(a, b, st);
    if (d <= 128) return launch_bf16<128, 64>(a, b, st);
    return launch_bf16<256, 32>(a, b, st);
  }
  if (dtype == 0) {
    if (d <= 64) return launch_f32<64>(a, b, st);
    if (d <= 128) return launch_f32<128>(a, b, st);
    return launch_f32<256>(a, b, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
