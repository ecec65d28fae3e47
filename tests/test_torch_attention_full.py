"""The port's whole-sequence attention, its prefill cache write and the
whole-sequence SSD block against the reference's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances:

* the port's ``flash_attention`` (CPU: its plain version) against the
  reference's Pallas ``flash_attention`` in interpret mode and its
  oracle ``ref.attention_ref``, over the sweep and flags of
  ``tests/test_kernels.py``: that test's own tolerances, fp32 atol 2e-5,
  bf16 atol 2e-2;
* ``full_attention`` / ``chunked_attention`` / ``attention()`` against
  the reference's (fp32): atol 1e-5 (the same algorithm, summation
  order only), and chunked against full at atol 2e-5, the tolerance of
  ``tests/test_attention.py``;
* ``cache_write_prefill``: ``slot_pos`` and the stored bytes equal (dense,
  fp8 and fp4 codes and scales, on identical K/V).

The whole-sequence SSD block (``ssm_forward``) is held to the
reference's in ``tests/test_torch_forward.py``, beside the model.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.models import attention as ref_A  # noqa: E402

from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402

F32_ATOL, BF16_ATOL = 2e-5, 2e-2


def _qkv(seed, b=2, sq=64, skv=64, hq=4, hkv=2, d=16):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d))]


def _t(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _j(arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


def _close(got, want, atol):
    np.testing.assert_allclose(
        np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                   np.float32),
        np.asarray(want, np.float32), atol=atol, rtol=0)


# --------------------------------------------------------------------- #
# flash_attention (plain) against the Pallas kernel and its oracle
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,sq,skv,hq,hkv,d", [
    (1, 128, 128, 4, 4, 64),
    (2, 256, 256, 8, 2, 64),     # GQA 4:1
    (1, 128, 384, 4, 1, 128),    # MQA, rectangular, skv % bk != 0
    (1, 96, 128, 2, 2, 64),      # sq padding path
])
def test_flash_attention_sweep(dtype, b, sq, skv, hq, hkv, d):
    """tests/test_kernels.py::test_flash_attention_sweep."""
    arrays = _qkv(sq + skv + d, b, sq, skv, hq, hkv, d)
    calls = kfa.flash_attention_plain.calls
    launches = kfa.flash_attention.launches
    got = ops.flash_attention(*_t(arrays, getattr(torch, dtype)), causal=True)
    assert (kfa.flash_attention_plain.calls,
            kfa.flash_attention.launches) == (calls + 1, launches)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, sq, hq, d)
    jq = _j(arrays, getattr(jnp, dtype))
    atol = F32_ATOL if dtype == "float32" else BF16_ATOL
    _close(got, ref_ops.flash_attention(*jq, causal=True), atol)
    _close(got, ref.attention_ref(*jq, causal=True), atol)


@pytest.mark.parametrize("window,softcap,causal", [
    (64, None, True), (None, 30.0, True), (32, 20.0, True),
    (None, None, False)])
def test_flash_attention_flags(window, softcap, causal):
    """tests/test_kernels.py::test_flash_attention_flags."""
    arrays = _qkv(7, 1, 128, 128, 4, 2, 64)
    flags = dict(causal=causal, window=window, softcap=softcap)
    got = ops.flash_attention(*_t(arrays), **flags)
    _close(got, ref_ops.flash_attention(*_j(arrays), bq=64, bk=64, **flags),
           F32_ATOL)
    _close(got, ref.attention_ref(*_j(arrays), **flags), F32_ATOL)


@pytest.mark.parametrize("window", [None, 48])
def test_flash_attention_q_offset(window):
    """Queries at q_offset + arange(sq): the reference's full_attention
    with those q_positions, whatever the plain version's chunk."""
    arrays = _qkv(8, 2, 40, 96, 4, 2, 16)
    got = ops.flash_attention(*_t(arrays), q_offset=56, window=window,
                              chunk=16)
    want = ref_A.full_attention(*_j(arrays), window=window,
                                q_positions=56 + jnp.arange(40))
    _close(got, want, F32_ATOL)


# --------------------------------------------------------------------- #
# full / chunked / attention() against the reference
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("chunk", [8, 16, 32, 48, 64])
def test_chunked_equals_full_and_reference(chunk):
    """tests/test_attention.py::test_chunked_equals_full, and each side
    against the reference's."""
    arrays = _qkv(chunk)
    full = A.full_attention(*_t(arrays), causal=True)
    got = A.chunked_attention(*_t(arrays), causal=True, chunk=chunk)
    _close(got, full, F32_ATOL)
    _close(full, ref_A.full_attention(*_j(arrays), causal=True), 1e-5)
    _close(got, ref_A.chunked_attention(*_j(arrays), causal=True,
                                        chunk=chunk), 1e-5)


@pytest.mark.parametrize("window,softcap,causal", [
    (16, None, True), (None, 20.0, True), (8, 10.0, True),
    (None, None, False)])
def test_chunked_flags(window, softcap, causal):
    """tests/test_attention.py::test_chunked_flags."""
    arrays = _qkv(3)
    flags = dict(causal=causal, window=window, softcap=softcap)
    full = A.full_attention(*_t(arrays), **flags)
    got = A.chunked_attention(*_t(arrays), chunk=16, **flags)
    _close(got, full, F32_ATOL)
    _close(got, ref_A.chunked_attention(*_j(arrays), chunk=16, **flags),
           1e-5)
    _close(full, ref_A.full_attention(*_j(arrays), **flags), 1e-5)


def test_gqa_and_window_one():
    """tests/test_attention.py: GQA equals MHA over repeated K/V; with
    window 1 each query sees only itself."""
    q, k, v = _t(_qkv(4))
    want = A.full_attention(q, k.repeat_interleave(2, dim=2),
                            v.repeat_interleave(2, dim=2))
    _close(A.full_attention(q, k, v), want, 1e-5)
    q, k, v = _t(_qkv(5, hq=2, hkv=2))
    _close(A.full_attention(q, k, v, causal=True, window=1), v, 1e-5)


def test_full_attention_positions_and_key_padding():
    """q_positions / k_positions / k_valid, and a padded chunked run,
    against the reference."""
    arrays = _qkv(6, skv=40)
    rng = np.random.default_rng(6)
    k_valid = rng.random((2, 40)) > 0.3
    k_valid[:, 0] = True
    qp, kp = np.arange(64) + 10, np.arange(40) * 2
    got = A.full_attention(*_t(arrays), q_positions=torch.from_numpy(qp),
                           k_positions=torch.from_numpy(kp),
                           k_valid=torch.from_numpy(k_valid))
    want = ref_A.full_attention(*_j(arrays), q_positions=jnp.asarray(qp),
                                k_positions=jnp.asarray(kp),
                                k_valid=jnp.asarray(k_valid))
    _close(got, want, 1e-5)
    got = A.chunked_attention(*_t(arrays), chunk=16, causal=False,
                              k_valid=torch.from_numpy(k_valid))
    want = ref_A.chunked_attention(*_j(arrays), chunk=16, causal=False,
                                   k_valid=jnp.asarray(k_valid))
    _close(got, want, 1e-5)


@pytest.mark.parametrize("chunk", [32, 64])
def test_attention_dispatch(chunk):
    """Full up to ``chunk`` keys, chunked beyond, as the reference's."""
    arrays = _qkv(9, skv=64)
    got = A.attention(*_t(arrays), chunk=chunk, window=24)
    _close(got, ref_A.attention(*_j(arrays), chunk=chunk, window=24), 1e-5)


# --------------------------------------------------------------------- #
# cache_write_prefill
# --------------------------------------------------------------------- #

def _np(t):
    if isinstance(t, torch.Tensor):
        return t.view(torch.uint8).numpy() if t.element_size() == 1 \
            else t.numpy()
    a = np.asarray(t)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


@pytest.mark.parametrize("kv_format", [None, "float8_e4m3fn",
                                       "float4_e2m1fn"])
@pytest.mark.parametrize("s,cap", [(10, 16), (40, 16)])
def test_cache_write_prefill_bytes(kv_format, s, cap):
    """The stored bytes and slot_pos of the reference's write, with and
    without a ring wrap (s > capacity keeps the last ``cap``)."""
    rng = np.random.default_rng(s + cap)
    k = (rng.standard_normal((2, s, 2, 32)) * 3).astype(np.float32)
    v = (rng.standard_normal((2, s, 2, 32)) * 3).astype(np.float32)
    cache = A.init_kv_cache(2, cap, 2, 32, torch.float32, "cpu",
                            kv_format=kv_format)
    out = A.cache_write_prefill(cache, torch.from_numpy(k),
                                torch.from_numpy(v), kv_format=kv_format)
    assert out is cache
    want = jax.jit(ref_A.cache_write_prefill, static_argnums=3)(
        ref_A.init_kv_cache(2, cap, 2, 32, jnp.float32, kv_format=kv_format),
        jnp.asarray(k), jnp.asarray(v), kv_format)
    assert set(cache) == set(want)
    for name in want:
        np.testing.assert_array_equal(_np(cache[name]), _np(want[name]),
                                      err_msg=name)


def test_prefill_ring_cache_keeps_last_window():
    """tests/test_attention.py::test_prefill_ring_cache_keeps_last_window."""
    k = torch.arange(10, dtype=torch.float32).reshape(1, 10, 1, 1)
    cache = A.init_kv_cache(1, 4, 1, 1, torch.float32, "cpu")
    A.cache_write_prefill(cache, k, k)
    assert sorted(cache["slot_pos"][0].tolist()) == [6, 7, 8, 9]
    for slot in range(4):
        p = int(cache["slot_pos"][0, slot])
        assert p % 4 == slot
        assert float(cache["k"][0, slot, 0, 0]) == float(p)
