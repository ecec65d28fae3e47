"""The port's sampler against the reference's, on the CPU.

``repro_torch.serve.prng`` reproduces ``jax.random`` (threefry-2x32,
partitionable counters): keys, folds, 32-bit draws and uniforms must be
bit-identical; gumbel values within atol 2e-6, since ``log`` differs by
at most one ulp between torch and XLA (measured over 2^20 uniforms: at
most 5e-7 on the gumbel values).  ``serve.sampler`` must give the
reference's tokens on fixed logits, greedy and sampled, with and
without top-k, batched per-row keys and one shared key, and the engine
must give the JAX engine's sampled streams (the settings of
``tests/test_serve_fused.py::test_fused_loop_sampled_matches_per_step``)
for the dense and the SSM family, fused and per step.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint.checkpointer import _flatten  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.serve import ServeEngine as RefEngine  # noqa: E402
from repro.serve import sampler as ref_sampler  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve import ServeEngine, prng, sampler  # noqa: E402

SEEDS = [0, 3, 12345, 2**31 - 1, 2**32 - 1]
DATA = [0, 1, 5, 4095, 2**31 - 1]             # request ids and positions


def _u32(x):
    return np.asarray(x).astype(np.int64)


def _key(seed):
    return prng.prng_key(seed), jax.random.PRNGKey(seed)


def test_documented_vectors():
    assert prng.prng_key(3).tolist() == [0, 3]
    assert prng.fold_in(prng.prng_key(3), torch.tensor(5)).tolist() == [
        2464363587, 131619366]


@pytest.mark.parametrize("seed", SEEDS + [-1])
def test_prng_key_matches(seed):
    np.testing.assert_array_equal(prng.prng_key(seed).numpy(),
                                  _u32(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_matches(seed):
    """Both folds of the sampler's key schedule: (request id, position)
    over ids up to 2^31 - 1, as one batched call."""
    key, ref_key = _key(seed)
    ids = torch.tensor(DATA, dtype=torch.int32)
    got = prng.fold_in(prng.fold_in(key, ids)[:, None], ids[None, :])
    want = [[_u32(jax.random.fold_in(jax.random.fold_in(ref_key, a), b))
             for b in DATA] for a in DATA]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_threefry2x32_matches():
    """The raw hash on arbitrary words (the counters of a large flat
    index included, high word non-zero)."""
    from jax._src import prng as jax_prng
    rng = np.random.default_rng(0)
    k = rng.integers(0, 2**32, 2, dtype=np.uint32)
    x = rng.integers(0, 2**32, (2, 64), dtype=np.uint32)
    want = jax_prng.threefry2x32_p.bind(*(jnp.asarray(a) for a in (
        k[0], k[1], x[0], x[1])))
    got = prng.threefry2x32(*(torch.from_numpy(np.asarray(a, np.int64))
                              for a in (k[0], k[1], x[0], x[1])))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), _u32(b))


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (2, 512)])
@pytest.mark.parametrize("seed", [0, 2**31 - 1])
def test_random_bits_and_uniform_bit_identical(seed, shape):
    key, ref_key = _key(seed)
    key = prng.fold_in(key, torch.tensor(11))
    ref_key = jax.random.fold_in(ref_key, 11)
    np.testing.assert_array_equal(prng.random_bits(key, shape).numpy(),
                                  _u32(jax.random.bits(ref_key, shape)))
    for lo, hi in ((0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0)):
        got = prng.uniform(key, shape, lo, hi)
        want = np.asarray(jax.random.uniform(ref_key, shape, minval=lo,
                                             maxval=hi))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))


def test_per_row_keys_match_vmap():
    """Keys (b, 2) draw as ``jax.vmap`` over keys does."""
    ref_keys = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(3), i)
                          for i in range(4)])
    keys = torch.from_numpy(_u32(ref_keys))
    np.testing.assert_array_equal(
        prng.random_bits(keys, (9,)).numpy(),
        _u32(jax.vmap(lambda k: jax.random.bits(k, (9,)))(ref_keys)))


def test_gumbel_within_one_log_ulp():
    key, ref_key = _key(7)
    got = prng.gumbel(key, (1 << 16,)).numpy()
    want = np.asarray(jax.random.gumbel(ref_key, (1 << 16,)))
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


LOGITS = (np.random.default_rng(0).standard_normal((6, 512)) * 3).astype(
    np.float32)
ROW_SEED = np.array([0, 1, 2, 7, 2**31 - 1, 5], np.int32)
ROW_POS = np.array([3, 4, 10, 0, 99, 2**31 - 1], np.int32)


@pytest.mark.parametrize("temperature,top_k", [
    (0.0, 0), (0.8, 0), (0.8, 8), (1.3, 1), (0.5, 50)])
def test_sample_tokens_match_reference(temperature, top_k):
    """Per-row folded keys, one shared key, and the chunked form over (b,
    s) rows with per-position keys."""
    key, ref_key = _key(3)
    lg, seed, pos = (torch.from_numpy(a) for a in (LOGITS, ROW_SEED,
                                                    ROW_POS))
    got = sampler.sample_tokens(lg, key, temperature, top_k, slot_seed=seed,
                                pos=pos)
    want = ref_sampler.sample_tokens(jnp.asarray(LOGITS), ref_key,
                                     temperature, top_k,
                                     slot_seed=jnp.asarray(ROW_SEED),
                                     pos=jnp.asarray(ROW_POS))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        sampler.sample_token(lg, key, temperature, top_k).numpy(),
        np.asarray(ref_sampler.sample_token(jnp.asarray(LOGITS), ref_key,
                                            temperature, top_k)))

    lg3 = LOGITS.reshape(3, 2, 512)
    pos3 = ROW_POS.reshape(3, 2)
    got = sampler.sample_tokens_chunk(
        torch.from_numpy(lg3), key, temperature, top_k,
        slot_seed=seed[:3], pos=torch.from_numpy(pos3))
    want = ref_sampler.sample_tokens_chunk(
        jnp.asarray(lg3), ref_key, temperature, top_k,
        slot_seed=jnp.asarray(ROW_SEED[:3]), pos=jnp.asarray(pos3))
    assert got.shape == (3, 2) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        sampler.sample_tokens_chunk(torch.from_numpy(lg3), key, temperature,
                                    top_k).numpy(),
        np.asarray(ref_sampler.sample_tokens_chunk(
            jnp.asarray(lg3), ref_key, temperature, top_k)))


def test_chunk_equals_per_position_sampling():
    """The token at (request, position) is the same sampled alone or in
    a chunk: what speculation's verify pass relies on."""
    key = prng.prng_key(3)
    lg = torch.from_numpy(LOGITS.reshape(3, 2, 512))
    seed = torch.tensor([4, 9, 2**31 - 1], dtype=torch.int32)
    pos = torch.tensor([[10, 11], [0, 1], [7, 8]], dtype=torch.int32)
    chunk = sampler.sample_tokens_chunk(lg, key, 0.8, 8, slot_seed=seed,
                                        pos=pos)
    for j in range(2):
        torch.testing.assert_close(
            sampler.sample_tokens(lg[:, j], key, 0.8, 8, slot_seed=seed,
                                  pos=pos[:, j]), chunk[:, j])


def test_sampling_needs_a_key():
    with pytest.raises(ValueError, match="key"):
        sampler.sample_tokens(torch.from_numpy(LOGITS), None, 0.8)


def test_top_k_keeps_ties_at_the_cutoff():
    """Values equal to the k-th largest stay candidates, as in the
    reference's ``logits < cutoff`` filter."""
    lg = torch.tensor([[1.0, 3.0, 2.0, 2.0, 0.5]])
    out = sampler._top_k_filter(lg, 2)
    assert torch.isinf(out).tolist() == [[True, False, False, False, True]]


# --------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def families():
    """{family: (reference model, its params, the port's model, params)}
    from the reference's init, bridged."""
    out = {}
    for family, arch in (("dense", "gptneox-1b"), ("ssm", "mamba2-2.7b")):
        ref_model = ref_build_model(ref_get_config(arch).reduced())
        ref_params = ref_model.init(jax.random.PRNGKey(0))
        flat = {k: np.asarray(v) for k, v in _flatten(ref_params).items()}
        cfg = get_config(arch).reduced()
        out[family] = (ref_model, ref_params, build_model(cfg),
                       bridge.params_from_numpy(flat, cfg, "cpu"))
    return out


def _sampled_streams(engine, companion):
    engine.submit([4, 5, 6], max_new_tokens=7)
    if companion:
        engine.submit([9, 9], max_new_tokens=3)
    return [(r.request_id, r.tokens, r.status) for r in engine.run()]


@pytest.fixture(scope="module")
def reference_streams(families):
    """The JAX engine's sampled streams at temperature 0.8, top_k 8,
    seed 3, decode_block 5, batch 2 with a companion request."""
    return {f: _sampled_streams(RefEngine(
        m[0], m[1], batch=2, max_seq=64, temperature=0.8, top_k=8, seed=3,
        decode_block=5), True) for f, m in families.items()}


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_engine_sampled_streams_match_reference(families, reference_streams,
                                                family):
    """Fused (batch 2, K 5) and per-step (batch 1, K 1): token for token
    the JAX engine's, the companion request's stream too."""
    _, _, model, params = families[family]
    want = reference_streams[family]
    fused = ServeEngine(model, params, batch=2, max_seq=64, temperature=0.8,
                        top_k=8, seed=3, decode_block=5, device="cpu")
    assert (fused.temperature, fused.top_k) == (0.8, 8)
    assert _sampled_streams(fused, True) == want
    assert [len(t) for _, t, _ in want] == [7, 3]
    per_step = ServeEngine(model, params, batch=1, max_seq=64,
                           temperature=0.8, top_k=8, seed=3, decode_block=1,
                           device="cpu")
    assert _sampled_streams(per_step, False) == want[:1]


def test_engine_seed_and_request_change_the_stream(families):
    """Another engine seed, or the same prompt under another request id,
    samples another stream; the same seed repeats it after reset()."""
    _, _, model, params = families["dense"]

    def first(seed, pad):
        eng = ServeEngine(model, params, batch=2, max_seq=64,
                          temperature=0.8, seed=seed, decode_block=4,
                          device="cpu")
        for _ in range(pad):              # shifts the request id
            eng.submit([1], max_new_tokens=1)
        eng.submit([4, 5, 6], max_new_tokens=12)
        return eng.run()[-1].tokens, eng

    base, eng = first(3, 0)
    eng.reset()
    eng.submit([4, 5, 6], max_new_tokens=12)
    assert eng.run()[0].tokens == base
    assert first(4, 0)[0] != base
    assert first(3, 1)[0] != base
