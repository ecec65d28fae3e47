"""The port's layers and plain attention against ``repro.models``, on
the same numpy-seeded fp32 inputs, atol 1e-5."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.models import attention as ref_attn  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402

from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import layers  # noqa: E402

ATOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=1e-5)


@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_rms_norm(eps):
    r = _rng(0)
    w = r.standard_normal(64).astype(np.float32)
    x = (3 * r.standard_normal((2, 5, 64))).astype(np.float32)
    _close(layers.rms_norm(torch.from_numpy(w), torch.from_numpy(x), eps),
           ref_layers.rms_norm(jnp.asarray(w), jnp.asarray(x), eps))


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_apply_rope(theta):
    r = _rng(1)
    x = r.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = r.integers(0, 900, (2, 7)).astype(np.int32)
    _close(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta),
           ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
           atol=2e-5)


@pytest.mark.parametrize("variant", ["gelu", "swiglu", "geglu"])
def test_apply_mlp(variant):
    r = _rng(2)
    p = {n: (0.1 * r.standard_normal(s)).astype(np.float32)
         for n, s in (("w1", (32, 48)), ("w2", (48, 32)), ("w3", (32, 48)))}
    x = r.standard_normal((3, 4, 32)).astype(np.float32)
    got = layers.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), variant)
    want = ref_layers.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x), variant)
    _close(got, want)


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_embed_unembed(softcap):
    r = _rng(3)
    w = r.standard_normal((50, 16)).astype(np.float32)
    tok = r.integers(0, 50, (2, 6)).astype(np.int32)
    _close(layers.embed(torch.from_numpy(w), torch.from_numpy(tok)),
           ref_layers.embed(jnp.asarray(w), jnp.asarray(tok)))
    u = r.standard_normal((16, 50)).astype(np.float32)
    x = r.standard_normal((2, 3, 16)).astype(np.float32)
    _close(layers.unembed(torch.from_numpy(u), torch.from_numpy(x), softcap),
           ref_layers.unembed(jnp.asarray(u), jnp.asarray(x), softcap))


def test_projections():
    r = _rng(4)
    d, h, hkv, hd = 32, 4, 2, 8
    p = {"wq": r.standard_normal((d, h, hd)), "wk": r.standard_normal(
        (d, hkv, hd)), "wv": r.standard_normal((d, hkv, hd)),
        "wo": r.standard_normal((h, hd, d))}
    p = {k: (0.2 * v).astype(np.float32) for k, v in p.items()}
    x = r.standard_normal((2, 5, d)).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    _close(attn.project_q(tp, tx), ref_attn.project_q(jp, jx))
    for got, want in zip(attn.project_kv(tp, tx), ref_attn.project_kv(jp, jx)):
        _close(got, want)
    o = r.standard_normal((2, 5, h, hd)).astype(np.float32)
    _close(attn.project_out(tp, torch.from_numpy(o)),
           ref_attn.project_out(jp, jnp.asarray(o)))


@pytest.mark.parametrize("window,softcap", [(None, None), (6, None),
                                            (None, 15.0), (9, 8.0)])
def test_cache_attention(window, softcap):
    """Chunk queries at ragged positions against a partly filled cache
    (GQA 4/2), position-computed causality."""
    r = _rng(5)
    b, sq, S, hq, hkv, d = 2, 5, 24, 4, 2, 16
    q = r.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = r.standard_normal((b, S, hkv, d)).astype(np.float32)
    v = r.standard_normal((b, S, hkv, d)).astype(np.float32)
    sp = np.where(np.arange(S) < 20, np.arange(S), -1).astype(np.int32)
    sp = np.stack([sp, np.roll(sp, 3)])
    qp = np.stack([np.arange(10, 15), np.arange(15, 20)]).astype(np.int32)
    got = attn.cache_attention(*map(torch.from_numpy, (q, k, v, sp, qp)),
                               window=window, softcap=softcap)
    want = ref_attn.cache_attention(*map(jnp.asarray, (q, k, v, sp, qp)),
                                    window=window, softcap=softcap)
    _close(got, want)


def test_cache_writes_match_reference():
    """Decode writes (with an inactive row) and a chunk write with a
    padded tail leave the same cache as the reference's writes."""
    r = _rng(6)
    b, S, hkv, d = 2, 8, 2, 4
    cache = attn.init_kv_cache(b, S, hkv, d, torch.float32, "cpu")
    ref = ref_attn.init_kv_cache(b, S, hkv, d, jnp.float32)
    k = r.standard_normal((1, 5, hkv, d)).astype(np.float32)
    v = r.standard_normal((1, 5, hkv, d)).astype(np.float32)
    positions = np.arange(6, 11, dtype=np.int32)
    valid = np.arange(5) < 3
    row = {n: t[1:2] for n, t in cache.items()}         # a view of row 1
    attn.cache_write_chunk(row, torch.from_numpy(k), torch.from_numpy(v),
                           torch.from_numpy(positions),
                           torch.from_numpy(valid))
    ref_row = ref_attn.cache_write_chunk(
        {n: t[1:2] for n, t in ref.items()}, jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(positions), jnp.asarray(valid))
    ref = {n: t.at[1:2].set(ref_row[n]) for n, t in ref.items()}
    kd = r.standard_normal((b, 1, hkv, d)).astype(np.float32)
    vd = r.standard_normal((b, 1, hkv, d)).astype(np.float32)
    pos = np.asarray([3, 9], np.int32)
    active = np.asarray([False, True])
    attn.cache_write_decode(cache, torch.from_numpy(kd), torch.from_numpy(vd),
                            torch.from_numpy(pos), torch.from_numpy(active))
    ref = ref_attn.cache_write_decode(ref, jnp.asarray(kd), jnp.asarray(vd),
                                      jnp.asarray(pos),
                                      active=jnp.asarray(active))
    for n in ("k", "v", "slot_pos"):
        np.testing.assert_array_equal(cache[n].numpy(), np.asarray(ref[n]))
