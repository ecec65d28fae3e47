// qmatmul.cu — block-scaled low-precision matmul for Hopper (compiled for
// sm_90a), with a plain C entry point for ctypes.
//
// Replaces the TPU kernels src/repro/kernels/qmatmul.py::qmatmul_mkn
// (weights in a container byte: fp8 e4m3 / e5m2, or fp6 / fp4 values held
// in e4m3) and ::qmatmul_packed_mkn (weights bit-packed: fp4 two values
// per byte, fp6 four values in 3 bytes), computing
//   out (m, n) = x (m, k) @ (decode(w (n, k)) * scales (n, k/32)).T
// with scales fp32 powers of two (e8m0 content), 32 values of k each, and
// fp32 accumulation; out is bf16 or fp32.
//
// Both entry points are one template over the weight format F: only the
// tile loader differs (which bytes hold a quad of 4 values of k; the codec
// is lowbits.cuh, shared with flash_decode_quant.cu), and the expansion,
// scale multiply and accumulation are the same code in the same order, so
// the packed kernel is bit-exact with the container kernel on the same
// values (the reference's property, tests/test_lowbits.py).
//
// Bound: 2mnk operations.  Every expanded weight is exact in bf16, so the
// bf16 tensor cores (989 TFLOP/s) could do this work: at 2048^3 that is
// 17.4 us, well above the bytes (x, packed w, scales, out: ~16 MB for fp4,
// 4.8 us).  This kernel is the plain, right first version: a tiled
// shared-memory GEMM on the CUDA cores in fp32 FMA (67 TFLOP/s peak), so
// it sits at least 15x above the bound.  What the design does:
//   * one block per 64x64 output tile walks k in steps of 32 = one scale
//     block; each step stages x (bf16 or fp32 -> fp32) and the weights,
//     expanded from their bytes to fp32 and scaled as they are loaded (a
//     power-of-two multiply, exact), in shared memory; the packed bytes
//     are what is read from device memory;
//   * each of 256 threads keeps a 4x4 fp32 accumulator in registers;
//   * the ragged m (and n) edge is masked on load and store, where the
//     reference pads m to its tile.
// Not done (later work): wgmma on bf16 (or fp8 for the fp8 formats)
// operands, TMA/cp.async staging, a split-k or stream-k schedule for the
// small-m decode shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lowbits.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64, kBN = 64, kBK = 32;   // kBK = one scale block
constexpr int kPad = 4;                       // keeps float4 rows aligned

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Args {
  const void* x;
  const uint8_t* w;
  const float* scales;
  void* out;
  int m, n, k;
  long long ldx, ldw, lds, ldo;   // row strides: elements (bytes for w)
};

template <typename TX, typename TO, int F>
__global__ void __launch_bounds__(kThreads) qmatmul_kernel(Args a) {
  const TX* x = static_cast<const TX*>(a.x);
  TO* out = static_cast<TO*>(a.out);
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;      // 4x4 outputs per thread
  const int lr = tid / 4, lc = (tid % 4) * 8;  // loader: row, 8 values of k

  __shared__ __align__(16) float xs[kBK][kBM + kPad];
  __shared__ __align__(16) float ws[kBK][kBN + kPad];

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int xrow = m0 + lr, wrow = n0 + lr;
  const bool x_ok = xrow < a.m, w_ok = wrow < a.n;
  const TX* xr = x + static_cast<long long>(x_ok ? xrow : 0) * a.ldx;
  const uint8_t* wr = a.w + static_cast<long long>(w_ok ? wrow : 0) * a.ldw;
  const float* sr = a.scales + static_cast<long long>(w_ok ? wrow : 0) * a.lds;

  for (int k0 = 0; k0 < a.k; k0 += kBK) {
    // stage x: 8 values of one row, fp32, stored k-major
    float xv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) xv[i] = to_f(xr[k0 + lc + i]);
    // stage w: two quads of one row, expanded and scaled on the way in
    const uint32_t q0 = lowbits::load_quad<F>(wr, (k0 + lc) / 4);
    const uint32_t q1 = lowbits::load_quad<F>(wr, (k0 + lc) / 4 + 1);
    const float sc = sr[k0 / kBK];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float wv = lowbits::quad_value<F>(i < 4 ? q0 : q1, i % 4);
      xs[lc + i][lr] = x_ok ? xv[i] : 0.f;
      ws[lc + i][lr] = w_ok ? wv * sc : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty * 4 + i;
    if (r >= a.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c < a.n) store_f(&out[r * a.ldo + c], acc[i][j]);
    }
  }
}

template <typename TX, typename TO>
int dispatch_fmt(int fmt, const Args& a, cudaStream_t st) {
  const dim3 grid((a.n + kBN - 1) / kBN, (a.m + kBM - 1) / kBM);
  switch (fmt) {
    case 0: qmatmul_kernel<TX, TO, 0><<<grid, kThreads, 0, st>>>(a); break;
    case 1: qmatmul_kernel<TX, TO, 1><<<grid, kThreads, 0, st>>>(a); break;
    case 2: qmatmul_kernel<TX, TO, 2><<<grid, kThreads, 0, st>>>(a); break;
    case 3: qmatmul_kernel<TX, TO, 3><<<grid, kThreads, 0, st>>>(a); break;
    case 4: qmatmul_kernel<TX, TO, 4><<<grid, kThreads, 0, st>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// x_dtype / out_dtype: 0 = float32, 1 = bfloat16.  fmt: 0 e4m3fn, 1 e5m2
// (container bytes, w (n, k)), 2 fp6 e2m3, 3 fp6 e3m2 (w (n, 3k/4)), 4 fp4
// e2m1 (w (n, k/2)).  Row strides in elements (bytes for w); every
// matrix has a unit-stride last axis.  k must be a multiple of 32.
// Returns cudaGetLastError() after the launch (0 = ok).
extern "C" int repro_qmatmul(int x_dtype, int out_dtype, int fmt,
                             const void* x, const void* w,
                             const void* scales, void* out, int m, int n,
                             int k, long long ldx, long long ldw,
                             long long lds, long long ldo, void* stream) {
  if (m < 0 || n < 0 || k < 0 || k % kBK != 0 || m / kBM >= 65535 ||
      fmt < 0 || fmt > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  // fp8 / fp4 quads are loaded as one aligned word / half-word
  const int align = fmt <= 1 ? 4 : fmt == 4 ? 2 : 1;
  if (reinterpret_cast<uintptr_t>(w) % align || ldw % align)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (m == 0 || n == 0) return 0;
  Args a;
  a.x = x;
  a.w = static_cast<const uint8_t*>(w);
  a.scales = static_cast<const float*>(scales);
  a.out = out;
  a.m = m;
  a.n = n;
  a.k = k;
  a.ldx = ldx;
  a.ldw = ldw;
  a.lds = lds;
  a.ldo = ldo;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (x_dtype == 0 && out_dtype == 0)
    err = dispatch_fmt<float, float>(fmt, a, st);
  else if (x_dtype == 0 && out_dtype == 1)
    err = dispatch_fmt<float, __nv_bfloat16>(fmt, a, st);
  else if (x_dtype == 1 && out_dtype == 0)
    err = dispatch_fmt<__nv_bfloat16, float>(fmt, a, st);
  else if (x_dtype == 1 && out_dtype == 1)
    err = dispatch_fmt<__nv_bfloat16, __nv_bfloat16>(fmt, a, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}
