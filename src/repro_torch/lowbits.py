"""Bit-packed sub-byte storage and the e8m0 scale codec, in torch
(counterpart of ``repro.lowbits``).

* :class:`PackedSpec` / :data:`PACKED_FORMATS`: the bit layout and group
  geometry of each sub-byte format (fp4 e2m1: 2 values per byte; fp6
  e2m3 / e3m2: 4 values in 3 bytes).
* :func:`decode`: bit codes -> float32 by shift/mask arithmetic.
* :func:`quantize_values` / :func:`encode_codes`: round-to-nearest-even
  into a format's value set (saturating at its largest finite value)
  and field assembly.  The reference encodes on the host through
  ``ml_dtypes``; the port has no ``ml_dtypes`` (the machine with the
  card does not carry it), so :func:`pack` rides the arithmetic route,
  which the reference property-tests to be bit-identical.
* :func:`pack_codes` / :func:`unpack_codes`, :func:`pack` /
  :func:`unpack`: (de)packing along the last axis.  Bit order is
  little-endian within a group: value ``i`` of an fp4 pair sits in bits
  ``[4i, 4i+4)`` of its byte, an fp6 quad fills the 24 bits of its 3
  bytes in ascending order.
* :func:`e8m0_encode` / :func:`e8m0_decode` / :func:`e8m0_scale_code`:
  1-byte block scales, code ``c`` = 2^(c - 127), clamped to
  [2^-127, 2^127].

Everything is torch integer, shift, ``frexp`` and comparison arithmetic,
so the same function runs on CPU and CUDA tensors and gives the same
bytes on both.  Powers of two are assembled from their bit patterns
(:func:`_pow2`, :func:`e8m0_decode`), not from a transcendental, so they
are exact, e8m0's subnormal 2^-127 included.  The functions run eagerly
once per quantized cache write, so they avoid helper tensors (scalars
stay Python numbers) and host-to-device copies.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

__all__ = [
    "PackedSpec", "PACKED_FORMATS", "packed_spec", "is_packable",
    "packed_nbytes", "CUDA_FORMAT_ID", "decode", "quantize_values", "encode_codes", "pack",
    "pack_codes", "unpack", "unpack_codes", "E8M0_BIAS", "E8M0_MIN_EXP",
    "E8M0_MAX_EXP", "e8m0_encode", "e8m0_decode", "e8m0_scale_code",
]


@dataclasses.dataclass(frozen=True)
class PackedSpec:
    """Bit layout and group geometry of one sub-byte format:
    ``values_per_group`` values are stored in ``bytes_per_group``
    bytes."""

    name: str
    bits: int                # code width
    ebits: int               # exponent field width
    mbits: int               # mantissa field width
    bias: int                # exponent bias
    values_per_group: int
    bytes_per_group: int
    max_finite: float = 0.0  # largest finite magnitude (saturation point)

    @property
    def bytes_per_element(self) -> float:
        return self.bytes_per_group / self.values_per_group

    def packed_len(self, n: int) -> int:
        """Packed byte count for ``n`` values (tail group zero-padded)."""
        g = self.values_per_group
        return (n + g - 1) // g * self.bytes_per_group


PACKED_FORMATS: Dict[str, PackedSpec] = {
    "float4_e2m1fn": PackedSpec("float4_e2m1fn", 4, ebits=2, mbits=1,
                                bias=1, values_per_group=2,
                                bytes_per_group=1, max_finite=6.0),
    "float6_e2m3fn": PackedSpec("float6_e2m3fn", 6, ebits=2, mbits=3,
                                bias=1, values_per_group=4,
                                bytes_per_group=3, max_finite=7.5),
    "float6_e3m2fn": PackedSpec("float6_e3m2fn", 6, ebits=3, mbits=2,
                                bias=3, values_per_group=4,
                                bytes_per_group=3, max_finite=28.0),
}


# the F template argument of the device codec, csrc/lowbits.cuh
CUDA_FORMAT_ID = {"float8_e4m3fn": 0, "float8_e5m2": 1, "float6_e2m3fn": 2,
                  "float6_e3m2fn": 3, "float4_e2m1fn": 4}


def packed_spec(name: str) -> PackedSpec:
    try:
        return PACKED_FORMATS[name]
    except KeyError:
        raise KeyError(f"format {name!r} has no packed storage layout; "
                       f"packable: {sorted(PACKED_FORMATS)}") from None


def is_packable(name: str) -> bool:
    return name in PACKED_FORMATS


def packed_nbytes(n: int, fmt: str) -> int:
    """True storage bytes for ``n`` values of ``fmt`` (no scales)."""
    return packed_spec(fmt).packed_len(n)


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e as float32 for integer ``e`` in the normal range [-126, 127],
    built from its bit pattern: exact on any device."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def _frexp_exp(a: torch.Tensor) -> torch.Tensor:
    """The exponent of ``frexp`` (a = m * 2^e, m in [0.5, 1)), int32."""
    return torch.frexp(a)[1].to(torch.int32)


# --------------------------------------------------------------------- #
# value <-> code
# --------------------------------------------------------------------- #

def decode(codes: torch.Tensor, fmt: str) -> torch.Tensor:
    """Bit codes -> float32 values (shift/mask arithmetic only)."""
    spec = packed_spec(fmt)
    c = codes.to(torch.int32)
    m = c & ((1 << spec.mbits) - 1)
    e = (c >> spec.mbits) & ((1 << spec.ebits) - 1)
    s = c >> (spec.mbits + spec.ebits)
    frac = m.to(torch.float32) * 2.0 ** -spec.mbits
    # subnormal: frac * 2^(1-bias); normal: (1+frac) * 2^(e-bias)
    mag = torch.where(e == 0, frac * 2.0 ** (1 - spec.bias),
                      (1.0 + frac) * _pow2(e - spec.bias))
    return torch.where(s != 0, -mag, mag)


def quantize_values(values: torch.Tensor, fmt: str) -> torch.Tensor:
    """Round values into ``fmt``'s value set: RTNE on the format's
    mantissa grid, saturating at ``max_finite``.  float32, same shape."""
    spec = packed_spec(fmt)
    x = values.to(torch.float32)
    a = x.abs()
    # floor(log2(a)) via frexp (exact); a == 0 goes through 1.0
    e2 = _frexp_exp(torch.where(a > 0, a, 1.0))
    e = torch.clamp(e2 - 1, min=1 - spec.bias)     # subnormal floor
    quant = _pow2(e - spec.mbits)
    r = torch.round(a / quant) * quant             # round half to even
    r = torch.clamp(r, max=spec.max_finite)
    return torch.where(torch.signbit(x), -r, r)


def encode_codes(values: torch.Tensor, fmt: str) -> torch.Tensor:
    """Float values -> int32 bit codes: :func:`quantize_values`, then
    the sign/exponent/mantissa fields (-0.0 keeps its sign bit)."""
    spec = packed_spec(fmt)
    v = quantize_values(values, fmt)
    a = v.abs()
    e2 = _frexp_exp(torch.where(a > 0, a, 1.0))
    normal = a >= 2.0 ** (1 - spec.bias)           # smallest normal
    e = torch.where(normal, e2 - 1, 1 - spec.bias)
    # integer mantissa incl. the implicit bit: a * 2^(mbits - e)
    m = torch.round(a * _pow2(spec.mbits - e)).to(torch.int32)
    e_field = torch.where(normal, e + spec.bias, 0)
    m_field = m - normal.to(torch.int32) * (1 << spec.mbits)
    sign = torch.signbit(v).to(torch.int32)
    return ((sign << (spec.ebits + spec.mbits))
            | (e_field << spec.mbits) | m_field)


# --------------------------------------------------------------------- #
# pack / unpack along the last axis
# --------------------------------------------------------------------- #

def pack_codes(codes: torch.Tensor, fmt: str) -> torch.Tensor:
    """(..., n) integer codes -> (..., n*bits/8) uint8.  ``n`` must be a
    multiple of the group size (:func:`pack` pads first)."""
    spec = packed_spec(fmt)
    *lead, n = codes.shape
    g = spec.values_per_group
    if n % g:
        raise ValueError(f"pack_codes: n={n} not a multiple of the "
                         f"{fmt} group size {g}")
    grp = codes.to(torch.int32).reshape(*lead, n // g, g)
    if fmt == "float4_e2m1fn":
        by = (grp[..., 0] | (grp[..., 1] << 4))[..., None]
    else:                         # fp6: 4 codes -> 24 bits -> 3 bytes
        word = (grp[..., 0] | (grp[..., 1] << 6)
                | (grp[..., 2] << 12) | (grp[..., 3] << 18))
        by = torch.stack([word & 0xFF, (word >> 8) & 0xFF, word >> 16],
                         dim=-1)
    return by.reshape(*lead, -1).to(torch.uint8)


def unpack_codes(packed: torch.Tensor, fmt: str) -> torch.Tensor:
    """(..., nbytes) uint8 -> (..., values) int32 codes (padding
    included)."""
    spec = packed_spec(fmt)
    b = packed.to(torch.int32)
    *lead, nb = b.shape
    if fmt == "float4_e2m1fn":
        grp = torch.stack([b & 0xF, b >> 4], dim=-1)
    else:
        tri = b.reshape(*lead, nb // spec.bytes_per_group, 3)
        word = tri[..., 0] | (tri[..., 1] << 8) | (tri[..., 2] << 16)
        grp = torch.stack([word & 0x3F, (word >> 6) & 0x3F,
                           (word >> 12) & 0x3F, (word >> 18) & 0x3F],
                          dim=-1)
    return grp.reshape(*lead, -1)


def pack(values: torch.Tensor, fmt: str) -> torch.Tensor:
    """(..., n) float values -> (..., packed_len(n)) uint8.  Values are
    rounded to ``fmt`` first (exact when they already are ``fmt``
    values); a tail shorter than the group is zero-code padded."""
    spec = packed_spec(fmt)
    codes = encode_codes(values, fmt)
    pad = (-codes.shape[-1]) % spec.values_per_group
    if pad:
        codes = torch.nn.functional.pad(codes, (0, pad))
    return pack_codes(codes, fmt)


def unpack(packed: torch.Tensor, fmt: str, n: int) -> torch.Tensor:
    """(..., nbytes) uint8 -> (..., n) float32 (tail padding cut)."""
    return decode(unpack_codes(packed, fmt), fmt)[..., :n]


# --------------------------------------------------------------------- #
# e8m0 scale codec: code c is 2^(c - 127), c in [0, 254]
# --------------------------------------------------------------------- #

E8M0_BIAS = 127
E8M0_MIN_EXP = -127        # code 0
E8M0_MAX_EXP = 127         # code 254


def e8m0_encode(scales: torch.Tensor) -> torch.Tensor:
    """Power-of-two float32 scales -> uint8 e8m0 codes (clamped; the
    round trip is lossless for in-range powers of two)."""
    s = torch.clamp(scales.to(torch.float32), min=1e-45)
    exp = torch.clamp(_frexp_exp(s) - 1, E8M0_MIN_EXP, E8M0_MAX_EXP)
    return (exp + E8M0_BIAS).to(torch.uint8)


def e8m0_decode(codes: torch.Tensor) -> torch.Tensor:
    """uint8 e8m0 codes -> float32 scales 2^(code - 127): the code is
    the biased exponent field; code 0 is the subnormal 2^-127."""
    c = codes.to(torch.int32)
    return torch.where(c > 0, (c << 23).view(torch.float32), 2.0 ** -127)


def e8m0_scale_code(absmax: torch.Tensor, fmt_max: float) -> torch.Tensor:
    """Block absmax -> the e8m0 code of the smallest power-of-two scale
    with absmax / scale <= fmt_max: ceil(log2(absmax / fmt_max)),
    clamped to e8m0's exponent range.  The quotient is float32 as in
    the reference; its log2 is evaluated in float64 and rounded to
    float32, which is numpy's float32 ``log2`` on every input we tested
    (so this matches ``repro.lowbits`` on host arrays) and gives the
    same byte on the card and on the CPU.  (The reference's traced path
    evaluates log2 as log(x)/log(2) in float32, which can differ where
    the quotient lies within a few ulps above a power of two.)"""
    a = torch.clamp(absmax.to(torch.float32), min=1e-38)
    # a tensor divisor: a CUDA division by a Python scalar becomes a
    # multiply by its reciprocal, which rounds differently
    y = a / torch.full_like(a, fmt_max)
    exp = torch.ceil(torch.log2(y.to(torch.float64)).to(torch.float32))
    exp = torch.clamp(exp, E8M0_MIN_EXP, E8M0_MAX_EXP)
    return (exp + E8M0_BIAS).to(torch.uint8)
