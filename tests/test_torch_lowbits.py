"""The port's codec and format registry against the reference's, bit for
bit: ``repro_torch.lowbits`` vs ``repro.lowbits`` (numpy inputs, so the
reference runs its host path, ``ml_dtypes`` included) and
``repro_torch.compat``'s registry vs ``repro.compat.dtype_registry``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import compat as ref_compat  # noqa: E402
from repro import lowbits as ref  # noqa: E402

from repro_torch import compat, lowbits  # noqa: E402

PACKED = ("float4_e2m1fn", "float6_e2m3fn", "float6_e3m2fn")
FORMATS = ("float8_e4m3fn", "float8_e5m2") + PACKED


def _bits(a) -> np.ndarray:
    """float32 values as their bit patterns (so -0.0 != 0.0)."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.astype(np.float32).view(np.int32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _probe_values(fmt: str, seed: int) -> np.ndarray:
    """Every value of the format, both signs of zero, the midpoints
    between neighbours (ties), values past saturation, subnormal-range
    values and random values over many binades."""
    spec = ref.packed_spec(fmt)
    vals = ref.decode(np.arange(2 ** spec.bits), fmt).astype(np.float32)
    pos = np.unique(np.abs(vals))
    mids = (pos[1:] + pos[:-1]) / 2
    rng = np.random.default_rng(seed)
    rand = (rng.standard_normal(20000)
            * np.exp2(rng.integers(-12, 6, 20000))).astype(np.float32)
    extra = np.array([0.0, -0.0, spec.max_finite * 1.01, 1e30, -1e30,
                      1e-30, -1e-30, 1e-40], np.float32)
    return np.concatenate([vals, mids, -mids, pos * 1.0001, pos * 0.9999,
                           rand, extra]).astype(np.float32)


@pytest.mark.parametrize("fmt", PACKED)
def test_decode_every_code(fmt):
    codes = np.arange(2 ** ref.packed_spec(fmt).bits)
    np.testing.assert_array_equal(
        _bits(lowbits.decode(_t(codes), fmt)), _bits(ref.decode(codes, fmt)))


@pytest.mark.parametrize("fmt", PACKED)
def test_quantize_and_encode_match_reference(fmt):
    x = _probe_values(fmt, seed=len(fmt))
    np.testing.assert_array_equal(
        _bits(lowbits.quantize_values(_t(x), fmt)),
        _bits(ref.quantize_values(x, fmt)))
    codes = lowbits.encode_codes(_t(x), fmt).numpy()
    np.testing.assert_array_equal(codes, ref.encode(x, fmt).astype(np.int32))
    np.testing.assert_array_equal(codes, ref.encode_codes(x, fmt))


@pytest.mark.parametrize("fmt", PACKED)
def test_pack_unpack_bytes(fmt):
    spec = ref.packed_spec(fmt)
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 2 ** spec.bits, (3, 5, 48)).astype(np.int32)
    packed = lowbits.pack_codes(_t(codes), fmt)
    assert packed.dtype == torch.uint8
    np.testing.assert_array_equal(packed.numpy(),
                                  ref.pack_codes(codes, fmt))
    np.testing.assert_array_equal(
        lowbits.unpack_codes(packed, fmt).numpy(),
        ref.unpack_codes(packed.numpy(), fmt))
    # odd tail: zero-code padding on pack, sliced off on unpack
    x = (rng.standard_normal((4, 13)) * 3).astype(np.float32)
    got = lowbits.pack(_t(x), fmt)
    np.testing.assert_array_equal(got.numpy(), ref.pack(x, fmt))
    assert got.shape[-1] == spec.packed_len(13) == lowbits.packed_nbytes(
        13, fmt)
    np.testing.assert_array_equal(_bits(lowbits.unpack(got, fmt, 13)),
                                  _bits(ref.unpack(got.numpy(), fmt, 13)))
    with pytest.raises(ValueError):
        lowbits.pack_codes(_t(codes[..., :5]), fmt)


def test_e8m0_decode_every_code():
    """Codes 0..253 bit for bit (code 0 is the subnormal 2^-127).  At
    code 254 numpy's float32 exp2(127) is one ulp off 2^127; the port
    assembles the power of two exactly."""
    codes = np.arange(255, dtype=np.uint8)
    got = lowbits.e8m0_decode(_t(codes))
    np.testing.assert_array_equal(_bits(got)[:254],
                                  _bits(ref.e8m0_decode(codes))[:254])
    assert _bits(got[0:1])[0] == 1 << 22                # 2^-127
    assert float(got[254]) == 2.0 ** 127


def test_e8m0_encode_and_clamp_range():
    pows = np.exp2(np.arange(-149, 128, dtype=np.float64)).astype(np.float32)
    rng = np.random.default_rng(4)
    rand = np.abs(rng.standard_normal(5000)
                  * np.exp2(rng.integers(-140, 120, 5000))).astype(
                      np.float32)
    x = np.concatenate([pows, rand, [0.0, 1e-45, 3e38]]).astype(np.float32)
    got = lowbits.e8m0_encode(_t(x))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref.e8m0_encode(x))
    # lossless round trip over the representable range [2^-127, 2^127]
    inside = pows[22:]
    np.testing.assert_array_equal(
        _bits(lowbits.e8m0_decode(lowbits.e8m0_encode(_t(inside)))),
        _bits(inside))


@pytest.mark.parametrize("fmt", FORMATS)
def test_e8m0_scale_code(fmt):
    """Over a sweep of float32 bit patterns across the whole positive
    range, plus exact multiples of fmt_max by powers of two."""
    fmax = ref_compat.dtype_spec(fmt).max_finite
    sweep = np.arange(1, 0x7F7FFFFF, 4099, dtype=np.int64).astype(
        np.int32).view(np.float32)
    edges = (np.exp2(np.arange(-140, 100, dtype=np.float64)) * fmax
             ).astype(np.float32)
    x = np.concatenate([sweep, edges, [0.0]]).astype(np.float32)
    np.testing.assert_array_equal(
        lowbits.e8m0_scale_code(_t(x), fmax).numpy(),
        ref.e8m0_scale_code(x, fmax))


def test_registry_shared_fields():
    reg, want = compat.dtype_registry(), ref_compat.dtype_registry()
    assert compat.available_formats() == ref_compat.available_formats()
    for name, spec in reg.items():
        r = want[name]
        assert (spec.name, spec.bits, spec.max_finite, spec.packable) == (
            r.name, r.bits, r.max_finite, r.packable)
        for packed in (True, False):
            assert compat.storage_bytes_per_element(name, packed) == \
                ref_compat.storage_bytes_per_element(name, packed)
        if spec.packed is not None:
            a, b = spec.packed, r.packed
            assert (a.name, a.bits, a.ebits, a.mbits, a.bias,
                    a.values_per_group, a.bytes_per_group, a.max_finite) \
                == (b.name, b.bits, b.ebits, b.mbits, b.bias,
                    b.values_per_group, b.bytes_per_group, b.max_finite)
            # the e4m3 container holds every value of the format exactly
            # (the reference's JAX holds fp4 natively: compare by value)
            vals = lowbits.decode(torch.arange(2 ** a.bits), name)
            assert spec.container == torch.float8_e4m3fn and spec.emulated
            np.testing.assert_array_equal(
                _bits(vals.to(spec.container).float()), _bits(vals))
        else:
            assert spec.native and r.native
            assert spec.container == getattr(torch, name)


def test_resolve_dtype_refuses_what_torch_cannot_hold():
    assert compat.resolve_dtype("float8_e4m3fn") == torch.float8_e4m3fn
    for name in PACKED + ("int3",):
        with pytest.raises(ValueError):
            compat.resolve_dtype(name)
    with pytest.raises(KeyError):
        compat.dtype_spec("bfloat16")
