// probe_mma.cu — the tensor-core probe of the paper's §V.B/§V.D (Fig 4/5)
// for Hopper (compiled for sm_90a), with a plain C entry point for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/probe_mma.py::mma_probe and
// runs the products of src/repro/core/probes/matmul.py::_mm_ilp:
//   out[b, t] = x[b, t] (m, k) @ y[b, t] (k, n),  t < ilp,
// with fp32 accumulation, out in fp32, bf16 or fp16.  y's batch and ilp
// strides may be 0: one y shared by all products, as in the reference
// mma_probe.
//
// The body is mma.sync, the instruction the paper sweeps:
//   bf16 / fp16 inputs  mma.sync.aligned.m16n8k16.row.col.f32.{bf16,f16}
//   fp32 inputs         mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32
//                       (operands rounded to TF32 with cvt.rna.tf32.f32)
// Each warp owns one 16x8 output tile of every one of the ilp products
// of its batch entry: ilp independent accumulator fragments, the paper's
// ILP axis.  Warps across blocks are its warp count: (m/16) * (n/8) per
// batch entry, 4 warps a block, grid.y = batch.  Fragments are loaded
// straight from device memory (A pairs as one 32-bit load), with no
// shared-memory staging; wgmma is later work.
//
// Bound: 2 * m * n * k * batch * ilp operations at the card's bf16 /
// TF32 tensor-core peak, or the operand bytes at the HBM rate; at the
// probe's 128^3 the products are too small for either, and the time is
// the launch and one pass of dependent fragment loads.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

struct Strides {
  long long xb, xi, xm;  // x (batch, ilp, m, k), unit stride along k
  long long yb, yi, yk;  // y (batch, ilp, k, n), unit stride along n
  long long ob, oi, om;  // out (batch, ilp, m, n), unit stride along n
};

__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

__device__ __forceinline__ uint32_t to_tf32(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(f));
  return r;
}

template <int OUT>
__device__ __forceinline__ void store(void* out, long long i, float v) {
  if (OUT == kF32) {
    static_cast<float*>(out)[i] = v;
  } else if (OUT == kBF16) {
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<__half*>(out)[i] = __float2half_rn(v);
  }
}

// 16-bit inputs: m16n8k16.  IN is kBF16 or kF16.
template <int IN, int OUT, int ILP>
__global__ void __launch_bounds__(kWarps * 32)
mma16_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ y,
             void* __restrict__ out, int m, int n, int k, Strides s) {
  const int warp = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tiles_n = n / 8;
  if (warp >= (m / 16) * tiles_n) return;
  const int m0 = (warp / tiles_n) * 16, n0 = (warp % tiles_n) * 8;
  const int g = lane / 4, q = lane % 4;
  const long long b = blockIdx.y;
  float acc[ILP][4];
#pragma unroll
  for (int t = 0; t < ILP; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[t][r] = 0.f;

  for (int k0 = 0; k0 < k; k0 += 16) {
#pragma unroll
    for (int t = 0; t < ILP; ++t) {
      const uint16_t* xa = x + b * s.xb + t * s.xi;
      const uint16_t* yb = y + b * s.yb + t * s.yi;
      const uint16_t* r0 = xa + (long long)(m0 + g) * s.xm + k0 + 2 * q;
      const uint16_t* r1 = r0 + 8 * s.xm;
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(r0);
      const uint32_t a1 = *reinterpret_cast<const uint32_t*>(r1);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(r0 + 8);
      const uint32_t a3 = *reinterpret_cast<const uint32_t*>(r1 + 8);
      const uint16_t* c = yb + (long long)(k0 + 2 * q) * s.yk + n0 + g;
      const uint32_t b0 = pack2(c[0], c[s.yk]);
      const uint32_t b1 = pack2(c[8 * s.yk], c[9 * s.yk]);
      if (IN == kBF16) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};"
            : "+f"(acc[t][0]), "+f"(acc[t][1]), "+f"(acc[t][2]),
              "+f"(acc[t][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};"
            : "+f"(acc[t][0]), "+f"(acc[t][1]), "+f"(acc[t][2]),
              "+f"(acc[t][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
    }
  }
#pragma unroll
  for (int t = 0; t < ILP; ++t) {
    const long long o = b * s.ob + t * s.oi + (long long)(m0 + g) * s.om +
                        n0 + 2 * q;
    store<OUT>(out, o, acc[t][0]);
    store<OUT>(out, o + 1, acc[t][1]);
    store<OUT>(out, o + 8 * s.om, acc[t][2]);
    store<OUT>(out, o + 8 * s.om + 1, acc[t][3]);
  }
}

// fp32 inputs: m16n8k8 TF32.
template <int OUT, int ILP>
__global__ void __launch_bounds__(kWarps * 32)
mma_tf32_kernel(const float* __restrict__ x, const float* __restrict__ y,
                void* __restrict__ out, int m, int n, int k, Strides s) {
  const int warp = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tiles_n = n / 8;
  if (warp >= (m / 16) * tiles_n) return;
  const int m0 = (warp / tiles_n) * 16, n0 = (warp % tiles_n) * 8;
  const int g = lane / 4, q = lane % 4;
  const long long b = blockIdx.y;
  float acc[ILP][4];
#pragma unroll
  for (int t = 0; t < ILP; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[t][r] = 0.f;

  for (int k0 = 0; k0 < k; k0 += 8) {
#pragma unroll
    for (int t = 0; t < ILP; ++t) {
      const float* xa = x + b * s.xb + t * s.xi;
      const float* yb = y + b * s.yb + t * s.yi;
      const float* r0 = xa + (long long)(m0 + g) * s.xm + k0 + q;
      const float* r1 = r0 + 8 * s.xm;
      const uint32_t a0 = to_tf32(r0[0]), a1 = to_tf32(r1[0]);
      const uint32_t a2 = to_tf32(r0[4]), a3 = to_tf32(r1[4]);
      const float* c = yb + (long long)(k0 + q) * s.yk + n0 + g;
      const uint32_t b0 = to_tf32(c[0]), b1 = to_tf32(c[4 * s.yk]);
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};"
          : "+f"(acc[t][0]), "+f"(acc[t][1]), "+f"(acc[t][2]),
            "+f"(acc[t][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
#pragma unroll
  for (int t = 0; t < ILP; ++t) {
    const long long o = b * s.ob + t * s.oi + (long long)(m0 + g) * s.om +
                        n0 + 2 * q;
    store<OUT>(out, o, acc[t][0]);
    store<OUT>(out, o + 1, acc[t][1]);
    store<OUT>(out, o + 8 * s.om, acc[t][2]);
    store<OUT>(out, o + 8 * s.om + 1, acc[t][3]);
  }
}

template <int IN, int OUT, int ILP>
void launch(const void* x, const void* y, void* out, int batch, int m, int n,
            int k, const Strides& s, cudaStream_t stream) {
  const int warps = (m / 16) * (n / 8);
  const dim3 grid((warps + kWarps - 1) / kWarps, batch);
  if constexpr (IN == kF32) {
    mma_tf32_kernel<OUT, ILP><<<grid, kWarps * 32, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(y), out, m,
        n, k, s);
  } else {
    mma16_kernel<IN, OUT, ILP><<<grid, kWarps * 32, 0, stream>>>(
        static_cast<const uint16_t*>(x), static_cast<const uint16_t*>(y),
        out, m, n, k, s);
  }
}

template <int IN, int OUT>
int dispatch_ilp(int ilp, const void* x, const void* y, void* out, int batch,
                 int m, int n, int k, const Strides& s, cudaStream_t st) {
  switch (ilp) {
    case 1: launch<IN, OUT, 1>(x, y, out, batch, m, n, k, s, st); break;
    case 2: launch<IN, OUT, 2>(x, y, out, batch, m, n, k, s, st); break;
    case 3: launch<IN, OUT, 3>(x, y, out, batch, m, n, k, s, st); break;
    case 4: launch<IN, OUT, 4>(x, y, out, batch, m, n, k, s, st); break;
    case 5: launch<IN, OUT, 5>(x, y, out, batch, m, n, k, s, st); break;
    case 6: launch<IN, OUT, 6>(x, y, out, batch, m, n, k, s, st); break;
    case 7: launch<IN, OUT, 7>(x, y, out, batch, m, n, k, s, st); break;
    case 8: launch<IN, OUT, 8>(x, y, out, batch, m, n, k, s, st); break;
    default: return -1;
  }
  return 0;
}

}  // namespace

// in_dtype: 0 fp32, 1 bf16, 2 fp16; out_dtype: 0 fp32 or in_dtype.  m % 16, n % 8 and k % 16
// (k % 8 for fp32) must be 0; the wrapper checks shapes, strides and
// alignment.  Returns cudaGetLastError() after the launch (0 = ok), -1
// for an unsupported dtype pair or ilp (1..8).
extern "C" int repro_mma_probe(int in_dtype, int out_dtype, int ilp,
                               const void* x, const void* y, void* out,
                               int batch, int m, int n, int k, long long xb,
                               long long xi, long long xm, long long yb,
                               long long yi, long long yk, long long ob,
                               long long oi, long long om, void* stream) {
  const Strides s{xb, xi, xm, yb, yi, yk, ob, oi, om};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  // out is fp32 or the input's own type
  if (in_dtype == kF32 && out_dtype == kF32)
    rc = dispatch_ilp<kF32, kF32>(ilp, x, y, out, batch, m, n, k, s, st);
  else if (in_dtype == kBF16 && out_dtype == kF32)
    rc = dispatch_ilp<kBF16, kF32>(ilp, x, y, out, batch, m, n, k, s, st);
  else if (in_dtype == kBF16 && out_dtype == kBF16)
    rc = dispatch_ilp<kBF16, kBF16>(ilp, x, y, out, batch, m, n, k, s, st);
  else if (in_dtype == kF16 && out_dtype == kF32)
    rc = dispatch_ilp<kF16, kF32>(ilp, x, y, out, batch, m, n, k, s, st);
  else if (in_dtype == kF16 && out_dtype == kF16)
    rc = dispatch_ilp<kF16, kF16>(ilp, x, y, out, batch, m, n, k, s, st);
  else
    return -1;
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
