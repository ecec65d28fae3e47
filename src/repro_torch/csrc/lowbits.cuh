// lowbits.cuh — the low-precision codec on the device, shared by
// flash_decode_quant.cu and qmatmul.cu (the CUDA side of
// repro_torch/lowbits.py).
//
// Formats (the F template argument): 0 fp8 e4m3fn, 1 fp8 e5m2 (one byte a
// value), 2 fp6 e2m3, 3 fp6 e3m2 (four values in a little-endian 24-bit
// word of 3 bytes), 4 fp4 e2m1 (two values a byte, low nibble first).
// The unit of work is a quad: 4 consecutive values, whole bytes in every
// format (4, 3 or 2 bytes).  Every decode is exact.
//
// decode8 is the fast path for eight consecutive values: fp8 pairs go
// through the hardware's exact fp8 -> f16 conversion, fp6 / fp4 codes
// through a table of their 2^bits values in bf16 (exact: at most 3
// mantissa bits) that bf16_table fills from decode<F>.

#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace lowbits {

template <int F> struct Fmt;
template <> struct Fmt<0> { static constexpr int bits = 8, ebits = 4, mbits = 3, bias = 7; };
template <> struct Fmt<1> { static constexpr int bits = 8, ebits = 5, mbits = 2, bias = 15; };
template <> struct Fmt<2> { static constexpr int bits = 6, ebits = 2, mbits = 3, bias = 1; };
template <> struct Fmt<3> { static constexpr int bits = 6, ebits = 3, mbits = 2, bias = 3; };
template <> struct Fmt<4> { static constexpr int bits = 4, ebits = 2, mbits = 1, bias = 1; };

// one code -> its value: a normal code's float32 bit pattern is assembled
// from its fields, a subnormal one is m * 2^(1 - bias - mbits) (a
// multiply by a power of two, then the sign bit, so -0 stays -0); fp8's
// NaN / inf codes decode as such
template <int F>
__device__ __forceinline__ float decode(uint32_t c) {
  using T = Fmt<F>;
  const uint32_t m = c & ((1u << T::mbits) - 1);
  const uint32_t e = (c >> T::mbits) & ((1u << T::ebits) - 1);
  const uint32_t sign = ((c >> (T::mbits + T::ebits)) & 1u) << 31;
  if constexpr (F == 0) {
    if (e == 15 && m == 7) return __uint_as_float(sign | 0x7fc00000u);
  }
  if constexpr (F == 1) {
    if (e == 31) return __uint_as_float(sign | (m ? 0x7fc00000u : 0x7f800000u));
  }
  if (e == 0) {
    constexpr uint32_t kSubScale = (127 + 1 - T::bias - T::mbits) << 23;
    const float mag = static_cast<float>(m) * __uint_as_float(kSubScale);
    return __uint_as_float(__float_as_uint(mag) | sign);
  }
  const uint32_t biased = static_cast<uint32_t>(
      static_cast<int>(e) - T::bias + 127);
  return __uint_as_float(sign | (biased << 23) | (m << (23 - T::mbits)));
}

// e8m0 scale byte -> 2^(code - 127), assembled from its bits (the values
// of ldexpf(1, code - 127)): code 0 is the subnormal 2^-127 (the build
// uses no flush-to-zero), code 255 is +inf
__device__ __forceinline__ float e8m0(uint32_t code) {
  return __uint_as_float(code ? code << 23 : 0x00400000u);
}

// the bytes of quad `qd` of a code row, little-endian in one word.  fp8
// and fp4 quads are one aligned 4- or 2-byte load (the callers require
// the row and its quads to be aligned to the quad's size); fp6 quads are
// three byte loads.
template <int F>
__device__ __forceinline__ uint32_t load_quad(const uint8_t* row, int qd) {
  constexpr int kBytes = Fmt<F>::bits / 2;       // 4 values a quad
  const uint8_t* p = row + static_cast<long long>(qd) * kBytes;
  if constexpr (kBytes == 4) {
    return *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (kBytes == 2) {
    return *reinterpret_cast<const uint16_t*>(p);
  } else {
    return static_cast<uint32_t>(p[0]) |
           (static_cast<uint32_t>(p[1]) << 8) |
           (static_cast<uint32_t>(p[2]) << 16);
  }
}

// value i (0..3) of a quad word
template <int F>
__device__ __forceinline__ float quad_value(uint32_t w, int i) {
  constexpr int kBits = Fmt<F>::bits;
  return decode<F>((w >> (kBits * i)) & ((1u << kBits) - 1));
}

// the table decode8 reads for fp6 / fp4: entry c = the bf16 bits of
// decode<F>(c), filled by threads tid, tid + nthreads, ...
template <int F>
__device__ __forceinline__ void bf16_table(uint16_t* lut, int tid,
                                           int nthreads) {
  if constexpr (F >= 2) {
    for (int c = tid; c < (1 << Fmt<F>::bits); c += nthreads)
      lut[c] = static_cast<uint16_t>(__float_as_uint(decode<F>(c)) >> 16);
  }
}

// values 0..7 of the 8 codes at p (8, 6 or 4 bytes; fp8 8-byte, fp6 /
// fp4 2-byte aligned) into v; lut from bf16_table (unused for fp8)
template <int F>
__device__ __forceinline__ void decode8(const uint8_t* p, const uint16_t* lut,
                                        float (&v)[8]) {
  if constexpr (F <= 1) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint16_t pair =
          static_cast<uint16_t>((i < 2 ? u.x : u.y) >> (16 * (i & 1)));
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
    constexpr int kBits = Fmt<F>::bits;
    uint64_t w;
    if constexpr (kBits == 4) {
      w = *reinterpret_cast<const uint32_t*>(p);
    } else {
      const uint16_t* q = reinterpret_cast<const uint16_t*>(p);
      w = q[0] | (static_cast<uint64_t>(q[1]) << 16) |
          (static_cast<uint64_t>(q[2]) << 32);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = __uint_as_float(
          static_cast<uint32_t>(lut[(w >> (kBits * i)) & ((1u << kBits) - 1)])
          << 16);
  }
}

}  // namespace lowbits
