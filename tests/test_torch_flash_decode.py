"""The port's flash_decode on the CPU (its plain version) against the
reference's Pallas kernel (interpret mode) and its ``decode_attention``
oracle, over the cases of tests/test_kernel_flash_decode.py: MHA and GQA
ratios 1, 2, 8; window; softcap; ring-wrapped ``slot_pos``; ragged
``pos``; S not a multiple of the kernel's tile.  fp32, atol 2e-5.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.kernels as ref_kernels  # noqa: E402
from repro.models.attention import decode_attention  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_decode import flash_decode_plain  # noqa: E402


def _inputs(seed, b=2, S=256, hq=4, hkv=2, d=64, filled=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, hq, d), np.float32)
    k = rng.standard_normal((b, S, hkv, d), np.float32)
    v = rng.standard_normal((b, S, hkv, d), np.float32)
    sp = np.broadcast_to(np.arange(S, dtype=np.int32), (b, S)).copy()
    if filled is not None:
        sp[:, filled:] = -1
    return q, k, v, sp


def _ring(S, start, b):
    """Slots of a ring of capacity S holding positions start..start+S-1."""
    p = np.arange(start, start + S, dtype=np.int32)
    sp = np.empty(S, np.int32)
    sp[p % S] = p
    return np.broadcast_to(sp, (b, S)).copy()


CASES = {
    # name: (input kwargs, pos, window, softcap, reference kernel bk)
    "mha": (dict(hq=4, hkv=4), [255, 255], None, None, 128),
    "gqa2": (dict(hq=4, hkv=2), [255, 255], None, None, 64),
    "gqa8": (dict(hq=8, hkv=1), [255, 255], None, None, 128),
    "window": (dict(), [200, 200], 64, None, 64),
    "softcap": (dict(), [200, 200], None, 20.0, 64),
    "window_softcap": (dict(), [200, 200], 32, 10.0, 64),
    "ragged_pos": (dict(), [50, 250], None, None, 64),
    "partial_padded": (dict(S=200, filled=77), [76, 76], None, None, 128),
    "padded_window": (dict(S=200), [199, 199], 64, None, 128),
    "padded_softcap": (dict(S=200), [199, 199], None, 20.0, 128),
    "padded_both": (dict(S=130), [129, 129], 48, 12.0, 64),
    "ring": (dict(b=1, S=64, hq=2, hkv=2, d=32, ring=100), [163], 40, None,
             32),
    "ring_padded": (dict(S=96, hq=2, hkv=2, d=32, ring=150), [245, 200],
                    None, None, 64),
    "ring_padded_window": (dict(S=96, hq=2, hkv=2, d=32, ring=150),
                           [245, 200], 50, None, 64),
    "ring_padded_both": (dict(S=96, hq=2, hkv=2, d=32, ring=150),
                         [245, 200], 64, 18.0, 64),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_reference_kernel_and_oracle(name):
    kw, pos, window, softcap, bk = CASES[name]
    kw = dict(kw)
    ring = kw.pop("ring", None)
    q, k, v, sp = _inputs(sorted(CASES).index(name), **kw)
    if ring is not None:
        sp = _ring(sp.shape[1], ring, sp.shape[0])
    pos = np.asarray(pos, np.int32)

    got = ops.flash_decode(*map(torch.from_numpy, (q, k, v, sp, pos)),
                           window=window, softcap=softcap).numpy()
    ref_args = tuple(map(jnp.asarray, (q, k, v, sp, pos)))
    want_kernel = np.asarray(ref_kernels.flash_decode(
        *ref_args, window=window, softcap=softcap, bk=bk))
    want_oracle = np.asarray(decode_attention(
        *ref_args, window=window, softcap=softcap))
    np.testing.assert_allclose(got, want_kernel, atol=2e-5)
    np.testing.assert_allclose(got, want_oracle, atol=2e-5)


def test_strided_cache_view():
    """The kernel's wrapper takes the cache as a strided view of the
    period-stacked pool; the plain version gives the same result as on a
    contiguous copy."""
    q, k, v, sp = _inputs(7, S=64)
    pool_k = torch.from_numpy(np.stack([k, 2 * k, 3 * k]))
    pool_v = torch.from_numpy(np.stack([v, v, -v]))
    pos = torch.tensor([40, 63], dtype=torch.int32)
    args = (torch.from_numpy(q),)
    got = ops.flash_decode(*args, pool_k[1], pool_v[2],
                           torch.from_numpy(sp), pos)
    want = ops.flash_decode(*args, pool_k[1].contiguous(),
                            pool_v[2].contiguous(), torch.from_numpy(sp), pos)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_row_without_visible_slot_is_finite():
    """An inactive pool row (slot_pos all -1) rides along in the fused
    loop; its output must be finite, and the other row unchanged."""
    q, k, v, sp = _inputs(3, S=96)
    sp_empty = sp.copy()
    sp_empty[1] = -1
    pos = torch.tensor([95, 10], dtype=torch.int32)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    got = flash_decode_plain(*t, torch.from_numpy(sp_empty), pos)
    assert torch.isfinite(got).all()
    full = flash_decode_plain(*t, torch.from_numpy(sp), pos)
    torch.testing.assert_close(got[0], full[0])


def test_bf16_cache_with_f32_query():
    """fp32 activations over a bf16 cache (the launcher's float32
    precision on the bf16 config): output keeps q's dtype and matches
    the reference's promotion."""
    q, k, v, sp = _inputs(5, S=80)
    pos = np.asarray([79, 30], np.int32)
    kb = torch.from_numpy(k).to(torch.bfloat16)
    vb = torch.from_numpy(v).to(torch.bfloat16)
    got = ops.flash_decode(torch.from_numpy(q), kb, vb, torch.from_numpy(sp),
                           torch.from_numpy(pos))
    assert got.dtype == torch.float32
    want = decode_attention(jnp.asarray(q), jnp.asarray(kb.float().numpy(),
                                                        jnp.bfloat16),
                            jnp.asarray(vb.float().numpy(), jnp.bfloat16),
                            jnp.asarray(sp), jnp.asarray(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
