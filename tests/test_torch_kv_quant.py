"""The port's quantized KV cache against the reference's, on the CPU:
``quantize_kv`` bytes for the five formats, cache bytes and
``slot_pos`` after identical write sequences, and
``flash_decode_quant_plain`` against the reference's Pallas
``ops.flash_decode_quant`` (interpret mode, as tests/test_kv_quant.py
runs it) and its XLA oracle.  fp32, atol 1e-5 for the attention (the
summation orders differ), bit-identity for bytes.  Dequantized values
are compared within rtol 1e-6 (8 float32 ulps): the reference's traced
``e8m0_decode`` evaluates exp2 in float32 and misses 2^e by up to ~5
ulps for |e| beyond about 12 (the e5m2 scales), where the port's is
exact.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.kernels as ref_kernels  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_decode_quant import (  # noqa: E402
    flash_decode_quant_plain)
from repro_torch.models import attention as attn  # noqa: E402

FORMATS = ("float8_e4m3fn", "float8_e5m2", "float6_e2m3fn",
           "float6_e3m2fn", "float4_e2m1fn")
DEQ_RTOL = 1e-6


def _np(t):
    """A cache leaf as comparable bytes / values (float8 as its bytes)."""
    if isinstance(t, torch.Tensor):
        return (t.view(torch.uint8) if t.element_size() == 1 else t).numpy()
    a = np.asarray(t)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


def _acts(seed, shape):
    """Activations spread over several binades per scale block."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    return x * np.exp2(rng.integers(-3, 4, shape[:-1] + (1,))).astype(
        np.float32)


@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("fmt", FORMATS)
def test_quantize_kv_bytes(fmt, d):
    x = _acts(d, (3, 5, 2, d))
    stored, scales = attn.quantize_kv(torch.from_numpy(x), fmt)
    ref_stored, ref_scales = ref_attn.quantize_kv(jnp.asarray(x), fmt)
    assert stored.shape == ref_stored.shape
    np.testing.assert_array_equal(_np(stored), _np(ref_stored))
    np.testing.assert_array_equal(_np(scales), _np(ref_scales))
    np.testing.assert_allclose(
        attn.dequantize_kv(stored, scales, fmt, d).numpy(),
        np.asarray(ref_attn.dequantize_kv(ref_stored, ref_scales, fmt, d)),
        rtol=DEQ_RTOL, atol=0)


def test_kv_scale_block_matches_reference():
    for d in (1, 6, 16, 24, 48, 64, 96, 128, 256):
        assert attn.kv_scale_block(d) == ref_attn.kv_scale_block(d)


@pytest.mark.parametrize("fmt", FORMATS)
def test_cache_writes_bytes_and_slot_pos(fmt):
    """A chunk write with a padded tail into one row (a view), then decode
    writes with an inactive row past the ring's capacity: the same bytes
    and slot_pos as the reference's writes."""
    b, S, hkv, d = 2, 8, 2, 16
    cache = attn.init_kv_cache(b, S, hkv, d, torch.float32, "cpu",
                               kv_format=fmt)
    ref = ref_attn.init_kv_cache(b, S, hkv, d, jnp.float32, kv_format=fmt)
    assert attn.is_quantized_cache(cache)
    assert {n: tuple(t.shape) for n, t in cache.items()} == {
        n: tuple(t.shape) for n, t in ref.items()}
    k, v = _acts(1, (1, 5, hkv, d)), _acts(2, (1, 5, hkv, d))
    positions = np.arange(6, 11, dtype=np.int32)
    valid = np.arange(5) < 3
    row = {n: t[1:2] for n, t in cache.items()}            # a view of row 1
    attn.cache_write_chunk(row, torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(positions),
                           torch.from_numpy(valid), kv_format=fmt)
    ref_row = ref_attn.cache_write_chunk(
        {n: t[1:2] for n, t in ref.items()}, jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(positions), jnp.asarray(valid), kv_format=fmt)
    ref = {n: t.at[1:2].set(ref_row[n]) for n, t in ref.items()}
    for step, pos in enumerate(([3, 9], [4, 10], [5, 11])):
        kd, vd = _acts(10 + step, (b, 1, hkv, d)), _acts(20 + step,
                                                         (b, 1, hkv, d))
        active = np.asarray([step != 1, True])
        attn.cache_write_decode(cache, torch.from_numpy(kd),
                                torch.from_numpy(vd),
                                torch.tensor(pos, dtype=torch.int32),
                                torch.from_numpy(active), kv_format=fmt)
        ref = ref_attn.cache_write_decode(
            ref, jnp.asarray(kd), jnp.asarray(vd),
            jnp.asarray(pos, jnp.int32), kv_format=fmt,
            active=jnp.asarray(active))
    for n in ref:
        np.testing.assert_array_equal(_np(cache[n]), _np(ref[n]))
    for got, want in zip(attn.cache_kv(cache, fmt, d),
                         ref_attn.cache_kv(ref, fmt, d)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=DEQ_RTOL, atol=0)


def _ring_slot_pos(S, start, b):
    p = np.arange(start, start + S, dtype=np.int32)
    sp = np.empty(S, np.int32)
    sp[p % S] = p
    return np.broadcast_to(sp, (b, S)).copy()


CASES = {
    # name: (b, S, hq, hkv, d, slot_pos start (None = 0..S-1), pos,
    #        window, softcap, reference kernel bk)
    "plain": (2, 64, 4, 2, 32, None, [63, 30], None, None, 32),
    "window_softcap_ring": (2, 48, 4, 4, 32, 70, [117, 100], 24, 15.0, 32),
}


@pytest.mark.parametrize("fmt,case", [
    *((fmt, "window_softcap_ring") for fmt in FORMATS),
    ("float8_e4m3fn", "plain"), ("float4_e2m1fn", "plain")])
def test_flash_decode_quant_plain_matches_reference(fmt, case):
    b, S, hq, hkv, d, start, pos, window, softcap, bk = CASES[case]
    rng = np.random.default_rng(len(fmt) + S)
    q = rng.standard_normal((b, 1, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, S, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, S, hkv, d)).astype(np.float32)
    sp = (np.broadcast_to(np.arange(S, dtype=np.int32), (b, S)).copy()
          if start is None else _ring_slot_pos(S, start, b))
    k_q, k_s = attn.quantize_kv(torch.from_numpy(k), fmt)
    v_q, v_s = attn.quantize_kv(torch.from_numpy(v), fmt)
    cache = {"k_q": k_q, "k_s": k_s, "v_q": v_q, "v_s": v_s,
             "slot_pos": torch.from_numpy(sp)}
    ref_cache = {n: jnp.asarray(_np(t)) for n, t in cache.items()}
    if k_q.dtype != torch.uint8:                # fp8: the container dtype
        for n in ("k_q", "v_q"):
            ref_cache[n] = jnp.asarray(_np(cache[n]).view(jnp.dtype(fmt)))
    pos_t = torch.tensor(pos, dtype=torch.int32)
    got = ops.flash_decode_quant(torch.from_numpy(q), cache, pos_t, fmt=fmt,
                                 window=window, softcap=softcap)
    np.testing.assert_array_equal(
        got.numpy(),
        flash_decode_quant_plain(torch.from_numpy(q), cache, pos_t, fmt=fmt,
                                 window=window, softcap=softcap).numpy())
    want = ref_kernels.flash_decode_quant(
        jnp.asarray(q), ref_cache, jnp.asarray(pos, jnp.int32), fmt=fmt,
        window=window, softcap=softcap, bk=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    kc, vc = ref_attn.cache_kv(ref_cache, fmt, d)
    oracle = ref_attn.decode_attention(
        jnp.asarray(q), kc, vc, ref_cache["slot_pos"],
        jnp.asarray(pos, jnp.int32), window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), atol=1e-5,
                               rtol=0)
