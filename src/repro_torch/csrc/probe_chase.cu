// probe_chase.cu — the pointer chase of the paper's §VI.A (Fig 6), for
// Hopper (compiled for sm_90a), with a plain C entry point for ctypes.
//
// Replaces the TPU kernel src/repro/kernels/probe_chase.py::chase and
// runs the walk of src/repro/core/probes/memory.py::_chase: starting
// from index 0, `steps` serialized loads idx = buf[idx * row_stride];
// the result is the final index.  row_stride 128 reads a (rows, 128)
// buffer's column 0 (the Pallas layout); row_stride 1 a flat chain.
//
// One block of kThreads threads:
//   1. warm-up, untimed: the block reads the whole buffer once, 16 bytes
//      a thread and kSweepUnroll loads in flight, with ld.global.ca, so
//      that a buffer that fits a cache level is resident there before
//      the timed walk (the paper discards first-run latencies, §IV.B;
//      L1 does not survive from one launch to the next, so the warm-up
//      is in the same launch);
//   2. thread 0 walks the chain from index 0, each load an ld.global.ca
//      in asm volatile whose address depends on the previous load, so
//      no load can be hoisted or overlapped; the walk is bracketed by
//      %clock64 (cycles of this SM) and %globaltimer (ns);
//   3. thread 0 writes [final index, cycles, ns].
//
// Bound: a latency probe; the walk's time is steps times the load-to-use
// latency of the level the buffer lives in (the result).  Bytes: the
// steps loads of 4 bytes; the warm-up reads the buffer once more.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kSweepUnroll = 8;

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

__device__ __forceinline__ int load_ca(const int* p) {
  int v;
  asm volatile("ld.global.ca.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ uint4 load_ca_v4(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.ca.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

// the row stride is 1 << SHIFT: the address is one shift and add off
// the index
template <int SHIFT>
__global__ void __launch_bounds__(kThreads)
chase_kernel(const int* __restrict__ buf, long long n_elems,
             long long steps, long long* __restrict__ out) {
  // 1. warm-up sweep of the whole buffer (16-byte loads, then the tail)
  unsigned acc = 0;
  const long long n_vec = n_elems / 4;
  const uint4* v = reinterpret_cast<const uint4*>(buf);
  const long long stride = (long long)kThreads * kSweepUnroll;
  for (long long base = threadIdx.x; base < n_vec; base += stride) {
    uint4 r[kSweepUnroll];
#pragma unroll
    for (int u = 0; u < kSweepUnroll; ++u) {
      const long long i = base + (long long)u * kThreads;
      r[u] = i < n_vec ? load_ca_v4(v + i) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kSweepUnroll; ++u) acc ^= r[u].x;
  }
  for (long long i = n_vec * 4 + threadIdx.x; i < n_elems; i += kThreads)
    acc ^= (unsigned)load_ca(buf + i);
  __syncthreads();
  if (threadIdx.x != 0) return;

  // 2. the timed walk from index 0
  unsigned idx = 0;
  const long long t0 = globaltimer_();
  const long long c0 = clock64_();
#pragma unroll 16
  for (long long s = 0; s < steps; ++s) {
    idx = (unsigned)load_ca(buf + ((size_t)idx << SHIFT));
  }
  const long long c1 = clock64_();
  const long long t1 = globaltimer_();
  out[0] = idx;
  out[1] = c1 - c0;
  out[2] = t1 - t0;
  // keeps the warm-up loads live; never true for a real buffer
  if (acc == 0x9e3779b9u && idx == 0xffffffffu) out[0] = acc;
}

}  // namespace

// buf: int32 chain, n_elems elements, 16-byte aligned, every entry a
// row index in [0, n_elems / row_stride); row_stride 1 or 128; out: 3
// int64.  Returns cudaGetLastError() after the launch (0 = ok), -1 for
// another row_stride.
extern "C" int repro_chase(const void* buf, long long n_elems,
                           long long row_stride, long long steps, void* out,
                           void* stream) {
  const int* b = static_cast<const int*>(buf);
  long long* o = static_cast<long long*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row_stride == 1)
    chase_kernel<0><<<1, kThreads, 0, s>>>(b, n_elems, steps, o);
  else if (row_stride == 128)
    chase_kernel<7><<<1, kThreads, 0, s>>>(b, n_elems, steps, o);
  else
    return -1;
  return static_cast<int>(cudaGetLastError());
}
