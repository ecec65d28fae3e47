// probe_dep_chain.cu — dependent-instruction chains timed with clock64,
// for Hopper (compiled for sm_90a), with a plain C entry point for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/probe_dep_chain.py::dep_chain
// and runs the chains of src/repro/core/probes/compute.py (_make_chain,
// _make_mixed1, _make_mixed2): the paper's §IV method.  Each thread
// carries ILP independent values through chain_len dependent operations:
//   fp32    x = fma.rn.f32(x, a, b)
//   int32   x = mad.lo.s32(x, a, b)            (wraps mod 2^32)
//   fp64    x = fma.rn.f64(x, a, b)
//   mixed1  xi = mad.lo.s32(xi, ai, bi); xf = fma.rn.f32(xf, af, bf)
//           (two independent chains interleaved: co-issue test)
//   mixed2  chain_len / 2 steps of
//             xf = xf * af + cvt.rn.f32.s32(xi)
//             xi = cvt.rzi.s32.f32(xf * 0.5) + xi
//           (one chain through both pipelines; the float->int convert
//           saturates once the values pass 2^31).  mul and add are
//           separate, rounded as the plain version rounds them, so the
//           values are identical while no convert saturates.
// Every operation is inline PTX in asm volatile, so nvcc can neither
// fold nor reorder the chain, and the chain's first value depends on the
// first clock read (State::depend), so ptxas cannot schedule it ahead of
// that read or hoist it out of a loop.  The chain is bracketed by two %clock64
// reads (and two %globaltimer reads outside them); each thread writes
// its values back, its cycles and nanoseconds, and its SM (%smid).
//
// Two kernels:
//   * timed_chain_kernel<W, STEPS>: the timing probes' kernel.  One value
//     per thread, STEPS a compile-time constant from REPRO_TIMED_STEPS, the
//     chain fully unrolled (as the reference's jnp chain is), so nothing
//     but the chain lies between the two clock reads: with STEPS 0 the
//     cycles are two back-to-back clock64 reads, the §IV.A timer
//     overhead.  Values start from the scalar parameters, which keeps a
//     load's latency out of the timed region, the constants are the
//     reference's, as immediates, and the chain runs twice,
//     timed the second time (the paper discards first-run latencies,
//     §IV.B): the first pass warms the instruction cache.
//   * dep_chain_kernel<W, ILP>: any chain length and ILP 1..8 values per
//     thread, read from memory (the public dep_chain, and chain lengths
//     outside REPRO_TIMED_STEPS), unrolled by kUnroll with the remainder
//     entered through a switch; its cycles include that loop control.
//
// Bound: a latency probe.  One thread's time is chain_len times the
// latency of the operation (the result); with many warps on an SM it is
// the pipeline's issue rate (completion latency).  Bytes are the values
// read once and written once, nothing else.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 8;
// the step counts timed_chain_kernel is built for: the Fig 2/3 ramp's
// chain lengths, Tab III's 256, and their halves (mixed2 steps)
#define REPRO_TIMED_STEPS(X)                                              \
  X(0) X(1) X(2) X(3) X(4) X(6) X(8) X(12) X(16) X(20) X(24) X(32) X(40) \
  X(48) X(64) X(128) X(256) X(512) X(1024)

enum Workload { kFp32 = 0, kInt32 = 1, kFp64 = 2, kMixed1 = 3, kMixed2 = 4 };

struct Params {
  int ai, bi;
  float af, bf;
  double ad, bd;
  int xi0;
  float xf0;
  double xd0;
  int zero;  // 0 at run time, unknown to the compiler
};

__device__ __forceinline__ long long clock64_() {
  long long c;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c) : : "memory");
  return c;
}

__device__ __forceinline__ long long globaltimer_() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) : : "memory");
  return t;
}

__device__ __forceinline__ int smid_() {
  int id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  return id;
}

// The reference's chain constants (compute._init_vals) as PTX immediates:
// a = 1.0000001, b = 1e-7 in fp32 and fp64, a = 3, b = 1 in int32.
#define REPRO_AF "0f3F800001"
#define REPRO_BF "0f33D6BF95"
#define REPRO_AD "0d3FF000001AD7F29B"
#define REPRO_BD "0d3E7AD7F29ABCAF48"

// IMM: the constants are immediates in the instruction (the timing
// kernel), else registers from Params (the public dep_chain's a, b).  An
// fp32 fma reading three registers issues at half rate when 32 warps
// share an SM (register-file ports), so the timed chain reads one.
template <int W, int ILP, bool IMM>
struct State {
  int xi[ILP];
  float xf[ILP];
  double xd[ILP];

  // Makes every value depend on the first clock read, leaving it as it
  // is (p.zero is 0): the compiler cannot then move the chain ahead of
  // the read, or out of a loop around it.  Costs one integer add before
  // the first operation of the chain.
  __device__ __forceinline__ void depend(long long c, const Params& p) {
    const int z = (int)c & p.zero;
#pragma unroll
    for (int t = 0; t < ILP; ++t) {
      xi[t] += z;
      xf[t] = __int_as_float(__float_as_int(xf[t]) + z);
      xd[t] = __longlong_as_double(__double_as_longlong(xd[t]) + z);
    }
  }

  __device__ __forceinline__ void fma_f(float& x, const Params& p) {
    if (IMM)
      asm volatile("fma.rn.f32 %0, %0, " REPRO_AF ", " REPRO_BF ";"
                   : "+f"(x));
    else
      asm volatile("fma.rn.f32 %0, %0, %1, %2;"
                   : "+f"(x) : "f"(p.af), "f"(p.bf));
  }

  __device__ __forceinline__ void mad_i(int& x, const Params& p) {
    if (IMM)
      asm volatile("mad.lo.s32 %0, %0, 3, 1;" : "+r"(x));
    else
      asm volatile("mad.lo.s32 %0, %0, %1, %2;"
                   : "+r"(x) : "r"(p.ai), "r"(p.bi));
  }

  __device__ __forceinline__ void step(const Params& p) {
#pragma unroll
    for (int t = 0; t < ILP; ++t) {
      if (W == kFp32) {
        fma_f(xf[t], p);
      } else if (W == kInt32) {
        mad_i(xi[t], p);
      } else if (W == kFp64) {
        if (IMM)
          asm volatile("fma.rn.f64 %0, %0, " REPRO_AD ", " REPRO_BD ";"
                       : "+d"(xd[t]));
        else
          asm volatile("fma.rn.f64 %0, %0, %1, %2;"
                       : "+d"(xd[t]) : "d"(p.ad), "d"(p.bd));
      } else if (W == kMixed1) {
        mad_i(xi[t], p);
        fma_f(xf[t], p);
      } else {  // kMixed2: one step covers two chain units
        if (IMM)
          asm volatile(
              "{\n\t.reg .f32 fi, fm, fh;\n\t.reg .s32 ih;\n\t"
              "cvt.rn.f32.s32 fi, %1;\n\t"
              "mul.rn.f32 fm, %0, " REPRO_AF ";\n\t"
              "add.rn.f32 %0, fm, fi;\n\t"
              "mul.rn.f32 fh, %0, 0f3F000000;\n\t"
              "cvt.rzi.s32.f32 ih, fh;\n\t"
              "add.s32 %1, ih, %1;\n\t}"
              : "+f"(xf[t]), "+r"(xi[t]));
        else
          asm volatile(
              "{\n\t.reg .f32 fi, fm, fh;\n\t.reg .s32 ih;\n\t"
              "cvt.rn.f32.s32 fi, %1;\n\t"
              "mul.rn.f32 fm, %0, %2;\n\t"
              "add.rn.f32 %0, fm, fi;\n\t"
              "mul.rn.f32 fh, %0, 0f3F000000;\n\t"
              "cvt.rzi.s32.f32 ih, fh;\n\t"
              "add.s32 %1, ih, %1;\n\t}"
              : "+f"(xf[t]), "+r"(xi[t]) : "f"(p.af));
      }
    }
  }
};

// value (t, thread) lies at t * n_threads + thread
template <int W, int ILP>
__global__ void dep_chain_kernel(int* __restrict__ xi, float* __restrict__ xf,
                                 double* __restrict__ xd, int from_memory,
                                 int n_threads, int steps, Params p,
                                 long long* __restrict__ cycles,
                                 long long* __restrict__ ns,
                                 int* __restrict__ smid) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= n_threads) return;
  State<W, ILP, false> s;
#pragma unroll
  for (int t = 0; t < ILP; ++t) {
    const long long i = (long long)t * n_threads + tid;
    s.xi[t] = (from_memory && xi) ? xi[i] : p.xi0;
    s.xf[t] = (from_memory && xf) ? xf[i] : p.xf0;
    s.xd[t] = (from_memory && xd) ? xd[i] : p.xd0;
  }
  const int rem = steps % kUnroll;
  const long long t0 = globaltimer_();
  const long long c0 = clock64_();
  s.depend(c0, p);
  switch (rem) {  // the remainder, entered once, unrolled
    case 7: s.step(p);  // fall through
    case 6: s.step(p);  // fall through
    case 5: s.step(p);  // fall through
    case 4: s.step(p);  // fall through
    case 3: s.step(p);  // fall through
    case 2: s.step(p);  // fall through
    case 1: s.step(p);  // fall through
    default: break;
  }
#pragma unroll 1
  for (int i = rem; i < steps; i += kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) s.step(p);
  }
  const long long c1 = clock64_();
  const long long t1 = globaltimer_();
#pragma unroll
  for (int t = 0; t < ILP; ++t) {
    const long long i = (long long)t * n_threads + tid;
    if (W == kInt32 || W == kMixed1 || W == kMixed2) {
      if (xi) xi[i] = s.xi[t];
    }
    if (W == kFp32 || W == kMixed1 || W == kMixed2) {
      if (xf) xf[i] = s.xf[t];
    }
    if (W == kFp64) {
      if (xd) xd[i] = s.xd[t];
    }
  }
  cycles[tid] = c1 - c0;
  ns[tid] = t1 - t0;
  smid[tid] = smid_();
}

template <int W, int STEPS>
__global__ void timed_chain_kernel(int* __restrict__ xi,
                                   float* __restrict__ xf,
                                   double* __restrict__ xd, int n_threads,
                                   Params p, long long* __restrict__ cycles,
                                   long long* __restrict__ ns,
                                   int* __restrict__ smid) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  State<W, 1, true> s;
  long long t0 = 0, t1 = 0, c0 = 0, c1 = 0;
  // two passes over the same code, the first untimed: its instruction
  // fetches warm the SM's instruction cache (an unrolled chain of 1024
  // steps is 16 KB of code), and the block's warps start the timed pass
  // together
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    s.xi[0] = p.xi0;
    s.xf[0] = p.xf0;
    s.xd[0] = p.xd0;
    __syncthreads();
    t0 = globaltimer_();
    c0 = clock64_();
    s.depend(c0, p);
#pragma unroll
    for (int i = 0; i < STEPS; ++i) s.step(p);
    c1 = clock64_();
    t1 = globaltimer_();
  }
  if (tid >= n_threads) return;
  if (xi) xi[tid] = s.xi[0];
  if (xf) xf[tid] = s.xf[0];
  if (xd) xd[tid] = s.xd[0];
  cycles[tid] = c1 - c0;
  ns[tid] = t1 - t0;
  smid[tid] = smid_();
}

template <int W, int ILP>
void launch(int* xi, float* xf, double* xd, int from_memory, int n_threads,
            int block, int steps, const Params& p, long long* cycles,
            long long* ns, int* smid, cudaStream_t stream) {
  const int grid = (n_threads + block - 1) / block;
  dep_chain_kernel<W, ILP><<<grid, block, 0, stream>>>(
      xi, xf, xd, from_memory, n_threads, steps, p, cycles, ns, smid);
}

template <int W>
int dispatch_ilp(int ilp, int* xi, float* xf, double* xd, int from_memory,
                 int n_threads, int block, int steps, const Params& p,
                 long long* cycles, long long* ns, int* sm, cudaStream_t s) {
  switch (ilp) {
    case 1: launch<W, 1>(xi, xf, xd, from_memory, n_threads, block, steps, p, cycles, ns, sm, s); break;
    case 2: launch<W, 2>(xi, xf, xd, from_memory, n_threads, block, steps, p, cycles, ns, sm, s); break;
    case 3: launch<W, 3>(xi, xf, xd, from_memory, n_threads, block, steps, p, cycles, ns, sm, s); break;
    case 4: launch<W, 4>(xi, xf, xd, from_memory, n_threads, block, steps, p, cycles, ns, sm, s); break;
    case 5: launch<W, 5>(xi, xf, xd, from_memory, n_threads, block, steps, p, cycles, ns, sm, s); break;
    case 6: launch<W, 6>(xi, xf, xd, from_memory, n_threads, block, steps, p, cycles, ns, sm, s); break;
    case 7: launch<W, 7>(xi, xf, xd, from_memory, n_threads, block, steps, p, cycles, ns, sm, s); break;
    case 8: launch<W, 8>(xi, xf, xd, from_memory, n_threads, block, steps, p, cycles, ns, sm, s); break;
    default: return -1;
  }
  return 0;
}

template <int W>
int dispatch_timed(int steps, int* xi, float* xf, double* xd, int n_threads,
                   int block, const Params& p, long long* cycles,
                   long long* ns, int* sm, cudaStream_t s) {
  const int grid = (n_threads + block - 1) / block;
  switch (steps) {
#define REPRO_CASE(N)                                                   \
  case N:                                                               \
    timed_chain_kernel<W, N><<<grid, block, 0, s>>>(xi, xf, xd, n_threads, \
                                                    p, cycles, ns, sm);  \
    break;
    REPRO_TIMED_STEPS(REPRO_CASE)
#undef REPRO_CASE
    default: return -2;
  }
  return 0;
}

template <int W>
int dispatch(int unrolled, int ilp, int* xi, float* xf, double* xd,
             int from_memory, int n_threads, int block, int steps,
             const Params& p, long long* c, long long* n, int* sm,
             cudaStream_t s) {
  if (unrolled) {
    if (ilp != 1 || from_memory) return -1;
    return dispatch_timed<W>(steps, xi, xf, xd, n_threads, block, p, c, n,
                             sm, s);
  }
  return dispatch_ilp<W>(ilp, xi, xf, xd, from_memory, n_threads, block,
                         steps, p, c, n, sm, s);
}

}  // namespace

// Writes the step counts timed_chain_kernel is built for (REPRO_TIMED_STEPS)
// to out, at most cap of them; returns how many there are.
extern "C" int repro_dep_chain_timed_steps(int* out, int cap) {
  static const int steps[] = {
#define REPRO_ITEM(N) N,
      REPRO_TIMED_STEPS(REPRO_ITEM)
#undef REPRO_ITEM
  };
  const int n = static_cast<int>(sizeof(steps) / sizeof(steps[0]));
  for (int i = 0; i < n && i < cap; ++i) out[i] = steps[i];
  return n;
}

// workload: 0 fp32, 1 int32, 2 fp64, 3 mixed1, 4 mixed2.  steps is the
// number of steps (chain_len, or chain_len / 2 for mixed2).  unrolled
// selects timed_chain_kernel (ilp 1, values from the parameters, steps
// from REPRO_TIMED_STEPS), else dep_chain_kernel.  Pointers the workload
// does not use may be null; zero must be 0; cycles, ns (int64) and smid
// (int32) hold one entry per thread.  Returns cudaGetLastError() after the launch (0 =
// ok), -1 for an unsupported workload, ilp or mode, -2 for a step count
// the unrolled kernel is not built for.
extern "C" int repro_dep_chain(int workload, int unrolled, int ilp,
                               int steps, int n_threads, int block,
                               int from_memory, void* xi, void* xf, void* xd,
                               int ai, int bi, float af, float bf, double ad,
                               double bd, int xi0, float xf0, double xd0,
                               int zero, void* cycles, void* ns, void* smid,
                               void* stream) {
  Params p{ai, bi, af, bf, ad, bd, xi0, xf0, xd0, zero};
  int* i = static_cast<int*>(xi);
  float* f = static_cast<float*>(xf);
  double* d = static_cast<double*>(xd);
  long long* c = static_cast<long long*>(cycles);
  long long* n = static_cast<long long*>(ns);
  int* sm = static_cast<int*>(smid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (workload) {
    case kFp32: rc = dispatch<kFp32>(unrolled, ilp, i, f, d, from_memory, n_threads, block, steps, p, c, n, sm, s); break;
    case kInt32: rc = dispatch<kInt32>(unrolled, ilp, i, f, d, from_memory, n_threads, block, steps, p, c, n, sm, s); break;
    case kFp64: rc = dispatch<kFp64>(unrolled, ilp, i, f, d, from_memory, n_threads, block, steps, p, c, n, sm, s); break;
    case kMixed1: rc = dispatch<kMixed1>(unrolled, ilp, i, f, d, from_memory, n_threads, block, steps, p, c, n, sm, s); break;
    case kMixed2: rc = dispatch<kMixed2>(unrolled, ilp, i, f, d, from_memory, n_threads, block, steps, p, c, n, sm, s); break;
    default: return -1;
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
