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
// The probe measures the tensor cores, so the operands come from shared
// memory, not from device memory at every step:
//   * one block of 4 warps a (batch entry, 32 x 32 tile of out); each
//     warp owns a 16 x 16 warp tile (two 16 x 8 fragments) of every one
//     of the ilp products: ilp independent accumulator sets, the paper's
//     ILP axis;
//   * the block copies the k-slices of its tile's x[b, t] rows and y[b, t]
//     columns, 64 bytes of k a stage (32 values, 16 for fp32), for all
//     ilp products with 16-byte cp.async, double-buffered, zero-filled
//     past m, n and k; each operand element is read from device memory
//     once a block, and y's broadcast strides need nothing special;
//   * bf16 / fp16 fragments come by ldmatrix (x4 for a 16 x 16 A, x4.trans
//     for the two B fragments of 16 n-contiguous columns: one ldmatrix
//     feeds two mma); TF32 fragments by 32-bit ld.shared; rows are padded
//     (80 and 160 bytes) so a fragment's rows fall on distinct banks.
// A 32 x 32 tile gives the timed shape (batch 16 x ilp 4, 128^3) 256
// blocks, every SM busy; shared memory is 2 stages x ilp x 5120 bytes.
//
// Bound: 2 * m * n * k * batch * ilp operations at the card's bf16 /
// TF32 tensor-core peak, or the operand and output bytes at the HBM
// rate; at the probe's 128^3 the bytes bound it (8.4 MB at batch 16 x
// ilp 4: 2.5 us), and a launch's fixed cost of a few microseconds is of
// the same size.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;    // 4 warps
constexpr int kBM = 32, kBN = 32;  // the block tile of out
constexpr int kRowB = 64;        // bytes of k a stage holds of an x row
constexpr int kStages = 2;

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

struct Strides {
  long long xb, xi, xm;  // x (batch, ilp, m, k), unit stride along k
  long long yb, yi, yk;  // y (batch, ilp, k, n), unit stride along n
  long long ob, oi, om;  // out (batch, ilp, m, n), unit stride along n
};

// shared-memory shape of one product's stage for input type IN
template <int IN>
struct Tile {
  static constexpr int kE = IN == kF32 ? 4 : 2;     // bytes a value
  static constexpr int kBK = kRowB / kE;            // values of k a stage
  static constexpr int kLdA = kRowB + 16;           // x row: 80 bytes
  static constexpr int kLdB = kBN * kE + (IN == kF32 ? 32 : 16);  // 80, 160
  static constexpr int kA = kBM * kLdA;
  static constexpr int kB = kBK * kLdB;
  static constexpr int kProduct = kA + kB;          // 5120 bytes
  static constexpr int kChB = kBN * kE / 16;        // 16-byte chunks a y row
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0) : "memory");
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

__device__ __forceinline__ uint32_t to_tf32(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(f));
  return r;
}

template <int IN>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  if (IN == kBF16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else if (IN == kF16) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// two values (v0 at column c, v1 at c + 1) of out, at element offset o
template <int OUT>
__device__ __forceinline__ void store2(void* out, long long o, float v0,
                                       float v1) {
  if (OUT == kF32)
    *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
        make_float2(v0, v1);
  else if (OUT == kBF16)
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                       o) = __floats2bfloat162_rn(v0, v1);
  else
    *reinterpret_cast<__half2*>(static_cast<__half*>(out) + o) =
        __floats2half2_rn(v0, v1);
}

// the copies of k-slice `step` of every product into buffer `buf`: one x
// chunk and one y chunk a thread a product
template <int IN, int ILP>
__device__ __forceinline__ void load_stage(uint8_t* smem, const uint8_t* x,
                                           const uint8_t* y, long long b,
                                           int m0, int n0, int m, int n,
                                           int k, const Strides& s,
                                           int step, int buf) {
  using T = Tile<IN>;
  constexpr int kE = T::kE;
  const int k0 = step * T::kBK;
  // x: kBM rows x 4 chunks; y: kBK rows x kChB chunks (both 128 a product)
  const int ra = threadIdx.x / 4, ca = threadIdx.x % 4;
  const int rb = threadIdx.x / T::kChB, cb = threadIdx.x % T::kChB;
  const int row = m0 + ra, kc = k0 + ca * (16 / kE);
  const bool ok_a = row < m && kc < k;
  const int kr = k0 + rb, col = n0 + cb * (16 / kE);
  const bool ok_b = kr < k && col < n;
#pragma unroll
  for (int t = 0; t < ILP; ++t) {
    uint8_t* sa = smem + (buf * ILP + t) * T::kProduct;
    const uint8_t* src_a =
        ok_a ? x + (b * s.xb + t * s.xi + row * s.xm + kc) * kE : x;
    cp_async16(sa + ra * T::kLdA + ca * 16, src_a, ok_a);
    const uint8_t* src_b =
        ok_b ? y + (b * s.yb + t * s.yi + kr * s.yk + col) * kE : y;
    cp_async16(sa + T::kA + rb * T::kLdB + cb * 16, src_b, ok_b);
  }
}

template <int IN, int OUT, int ILP>
__global__ void __launch_bounds__(kThreads)
    mma_probe_kernel(const uint8_t* __restrict__ x,
                     const uint8_t* __restrict__ y, void* __restrict__ out,
                     int m, int n, int k, Strides s) {
  using T = Tile<IN>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int tiles_n = (n + kBN - 1) / kBN;
  const int m0 = (blockIdx.x / tiles_n) * kBM;
  const int n0 = (blockIdx.x % tiles_n) * kBN;
  const long long b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp >> 1) * 16, wn = (warp & 1) * 16;  // warp tile
  const int g = lane >> 2, q = lane & 3;
  const int steps = (k + T::kBK - 1) / T::kBK;

  float acc[ILP][2][4];
#pragma unroll
  for (int t = 0; t < ILP; ++t)
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[t][f][r] = 0.f;

  // a ring of kStages k-slices, kStages - 1 of them in flight ahead of
  // the one in use; a copy group a slice (empty past the last)
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < steps)
      load_stage<IN, ILP>(smem, x, y, b, m0, n0, m, n, k, s, i, i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int st = 0; st < steps; ++st) {
    const int ahead = st + kStages - 1;
    if (ahead < steps)
      load_stage<IN, ILP>(smem, x, y, b, m0, n0, m, n, k, s, ahead,
                          ahead % kStages);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
    __syncthreads();                 // slice st has landed, for every warp
    const uint8_t* base = smem + (st % kStages) * ILP * T::kProduct;
    if constexpr (IN == kF32) {
#pragma unroll
      for (int ks = 0; ks < T::kBK / 8; ++ks)
#pragma unroll
        for (int t = 0; t < ILP; ++t) {
          const float* fa =
              reinterpret_cast<const float*>(base + t * T::kProduct);
          const float* fb = reinterpret_cast<const float*>(
              base + t * T::kProduct + T::kA);
          constexpr int la = T::kLdA / 4, lb = T::kLdB / 4;
          const float* r0 = fa + (wm + g) * la + ks * 8 + q;
          const uint32_t af[4] = {to_tf32(r0[0]), to_tf32(r0[8 * la]),
                                  to_tf32(r0[4]), to_tf32(r0[8 * la + 4])};
#pragma unroll
          for (int f = 0; f < 2; ++f) {
            const float* c = fb + (ks * 8 + q) * lb + wn + 8 * f + g;
            mma<IN>(acc[t][f], af, to_tf32(c[0]), to_tf32(c[4 * lb]));
          }
        }
    } else {
#pragma unroll
      for (int ks = 0; ks < T::kBK / 16; ++ks)
#pragma unroll
        for (int t = 0; t < ILP; ++t) {
          const uint8_t* sa = base + t * T::kProduct;
          uint32_t af[4], bf[4];
          ldmatrix_x4(af, sa + (wm + (lane & 15)) * T::kLdA +
                              (ks * 16 + (lane >> 4) * 8) * 2);
          ldmatrix_x4_trans(
              bf, sa + T::kA +
                      (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                          T::kLdB +
                      (wn + (lane >> 4) * 8) * 2);
          mma<IN>(acc[t][0], af, bf[0], bf[1]);
          mma<IN>(acc[t][1], af, bf[2], bf[3]);
        }
    }
    __syncthreads();             // slice st's buffer is refilled next
  }

  const int row = m0 + wm + g;   // m % 16: a warp's 16 rows are in or out
  if (row >= m) return;
#pragma unroll
  for (int t = 0; t < ILP; ++t)
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const int col = n0 + wn + 8 * f + 2 * q;   // n % 8: a fragment is
      if (col >= n) continue;                    // in or out
      const long long o = b * s.ob + t * s.oi + row * s.om + col;
      store2<OUT>(out, o, acc[t][f][0], acc[t][f][1]);
      store2<OUT>(out, o + 8 * s.om, acc[t][f][2], acc[t][f][3]);
    }
}

template <int IN, int OUT, int ILP>
int launch(const void* x, const void* y, void* out, int batch, int m, int n,
           int k, const Strides& s, cudaStream_t stream) {
  const int smem = kStages * ILP * Tile<IN>::kProduct;
  const auto kernel = mma_probe_kernel<IN, OUT, ILP>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((m + kBM - 1) / kBM) * ((n + kBN - 1) / kBN), batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(y), out,
      m, n, k, s);
  return 0;
}

template <int IN, int OUT>
int dispatch_ilp(int ilp, const void* x, const void* y, void* out, int batch,
                 int m, int n, int k, const Strides& s, cudaStream_t st) {
  switch (ilp) {
    case 1: return launch<IN, OUT, 1>(x, y, out, batch, m, n, k, s, st);
    case 2: return launch<IN, OUT, 2>(x, y, out, batch, m, n, k, s, st);
    case 3: return launch<IN, OUT, 3>(x, y, out, batch, m, n, k, s, st);
    case 4: return launch<IN, OUT, 4>(x, y, out, batch, m, n, k, s, st);
    case 5: return launch<IN, OUT, 5>(x, y, out, batch, m, n, k, s, st);
    case 6: return launch<IN, OUT, 6>(x, y, out, batch, m, n, k, s, st);
    case 7: return launch<IN, OUT, 7>(x, y, out, batch, m, n, k, s, st);
    case 8: return launch<IN, OUT, 8>(x, y, out, batch, m, n, k, s, st);
    default: return -1;
  }
}

}  // namespace

// in_dtype: 0 fp32, 1 bf16, 2 fp16; out_dtype: 0 fp32 or in_dtype.
// m % 16, n % 8 and k % 16 (k % 8 for fp32) must be 0, batch <= 65535;
// x's and y's strides are elements, multiples of 16 bytes (y's batch and
// ilp strides may be 0), their pointers 16-byte aligned, out contiguous
// along n with even strides; the wrapper (kernels/probe_mma.py plan)
// checks all of it.  Returns cudaGetLastError() after the launch (0 =
// ok), -1 for an unsupported dtype pair or ilp (1..8).
extern "C" int repro_mma_probe(int in_dtype, int out_dtype, int ilp,
                               const void* x, const void* y, void* out,
                               int batch, int m, int n, int k, long long xb,
                               long long xi, long long xm, long long yb,
                               long long yi, long long yk, long long ob,
                               long long oi, long long om, void* stream) {
  if (batch < 0 || batch > 65535 || m < 0 || n < 0 || k < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || m == 0 || n == 0) return 0;
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
