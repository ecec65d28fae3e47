"""The port's gradient compression and ``prng.split`` against the
reference, on the CPU.

* ``prng.split`` equals ``jax.random.split`` bit for bit (threefry,
  partitionable scheme), and ``prng.uniform_range`` drawn in counter
  ranges equals one ``uniform`` draw;
* ``stochastic_round``, ``quantize`` and ``compressed_psum_tree`` at
  world 1 (a one-rank gloo group in this process) are bit-identical to
  the reference's under its one-device ``shard_map``, jitted as its
  trainer runs it (XLA turns a division by a constant into a product
  with its fp32 reciprocal; the port does the same), on the leaf set of
  ``tests/torch_dp_cases.py`` (1-D, 2-D, 3-D, all zero, an outlier row,
  every rank at +qmax / -qmax / alternating), also in blocks much
  smaller than a leaf;
* at world 2 and 4, gloo ranks (separate processes sharing a
  ``FileStore``) are bit-identical to the reference over 2 and 4 forced
  host devices in a subprocess, every rank the same, and the extreme
  leaves come back exactly;
* the packed int32 payload sums exactly at the lane bounds for worlds up
  to 32767 (the words summed as a collective would);
* stochastic rounding is unbiased (hypothesis, as
  ``tests/test_compression.py``).
"""

import functools
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import Mesh, PartitionSpec as P  # noqa: E402

import torch_dp_cases as cases  # noqa: E402
from repro.compat import has_hypothesis, shard_map  # noqa: E402
from repro.distributed import compression as ref  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.distributed import compression  # noqa: E402
from repro_torch.serve import prng  # noqa: E402


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A one-rank gloo group as the default group (a FileStore: no
    socket to rendezvous), destroyed after the module."""
    store = dist.FileStore(str(tmp_path_factory.mktemp("gloo") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
@pytest.mark.parametrize("n", [1, 2, 7, 300])
def test_split_matches_jax(seed, n):
    want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), n))
    got = prng.split(prng.prng_key(seed), n)
    assert got.dtype == torch.int64 and got.shape == (n, 2)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("piece", [1, 50, 407])
def test_uniform_range_equals_one_draw(piece):
    """A (37, 11) draw made in counter ranges of ``piece`` elements has
    the bits of one draw, which are ``jax.random.uniform``'s."""
    key = jax.random.fold_in(jax.random.PRNGKey(3), 5)
    tkey = prng.fold_in(prng.prng_key(3), torch.tensor(5))
    want = _bits(jax.random.uniform(key, (37, 11))).reshape(-1)
    assert np.array_equal(_bits(prng.uniform(tkey, (37, 11))).reshape(-1),
                          want)
    got = torch.cat([prng.uniform_range(tkey, s, min(piece, 407 - s))
                     for s in range(0, 407, piece)])
    np.testing.assert_array_equal(_bits(got.numpy()), want)


def _keys(step: int = cases.KEY_STEP):
    return (jax.random.fold_in(jax.random.PRNGKey(cases.KEY_SEED), step),
            prng.fold_in(prng.prng_key(cases.KEY_SEED), torch.tensor(step)))


def test_stochastic_round_and_quantize_match_reference():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((5, 7)) * 10).astype(np.float32)
    key, tkey = _keys()
    want = jax.jit(ref.stochastic_round)(jnp.asarray(x), key)
    got = compression.stochastic_round(torch.from_numpy(x), tkey)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    for qmax in (127, 63):
        q_want, s_want = jax.jit(ref.quantize, static_argnums=2)(
            jnp.asarray(x), key, qmax)
        q_got, s_got = compression.quantize(torch.from_numpy(x), tkey, qmax)
        assert q_got.dtype == torch.int8
        np.testing.assert_array_equal(q_got.numpy(), np.asarray(q_want))
        np.testing.assert_array_equal(_bits(s_got.numpy()), _bits(s_want))


def test_quantize_dequantize_error_bound():
    """The reference's bound (``tests/test_compression.py``): one scale
    at most."""
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (64, 64)).astype(np.float32) * 3)
    q, scale = compression.quantize(g, _keys()[1], qmax=127)
    assert float((q.float() * scale - g).abs().max()) <= float(scale) + 1e-6


@pytest.mark.parametrize("chunk", [compression.CHUNK, 64])
def test_compressed_psum_tree_world1_matches_reference(one_rank, chunk,
                                                       monkeypatch):
    """At world 1 under the reference's one-device ``shard_map``; at
    chunk 64 the 3-D leaf's rows (350 elements) are drawn in pieces and
    the others a few rows at a time."""
    monkeypatch.setattr(compression, "CHUNK", chunk)
    leaves = cases.leaf_set(0)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    key, tkey = _keys()
    run = jax.jit(functools.partial(
        shard_map, mesh=mesh, in_specs=(P(), P()), out_specs=P())(
            lambda g, k: ref.compressed_psum_tree(g, k, "data", 1)))
    want = bridge.flatten(jax.tree.map(np.asarray, run(leaves, key)))
    got = bridge.flatten(compression.compressed_psum_tree(
        jax.tree.map(torch.from_numpy, leaves), tkey, None, 1))
    assert list(got) == list(want)
    for k, w in want.items():
        np.testing.assert_array_equal(_bits(got[k].numpy()), _bits(w),
                                      err_msg=k)
    for k in ("extreme/pos", "extreme/neg", "extreme/alt"):
        np.testing.assert_array_equal(got[k].numpy(),
                                      bridge.flatten(leaves)[k])


@pytest.fixture(scope="module")
def multi_rank(tmp_path_factory):
    """The reference at worlds 2 and 4 (one subprocess, 4 forced host
    devices) and the port's gloo ranks at worlds 2 and 4, all started at
    once: {world: (the reference's leaves, [each rank's leaves])}."""
    tmp = str(tmp_path_factory.mktemp("dp"))
    ranks = [("port_compress", w, r, os.path.join(tmp, f"s{w}"),
              os.path.join(tmp, f"p{w}_{r}.npz"))
             for w in (2, 4) for r in range(w)]
    cases.run([("ref_compress", os.path.join(tmp, "ref"), 2, 4), *ranks])
    return {w: (dict(np.load(os.path.join(tmp, f"ref_{w}.npz"))),
                [dict(np.load(a[-1])) for a in ranks if a[1] == w])
            for w in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_ranks_match_reference(multi_rank, world):
    want, ranks = multi_rank[world]
    assert len(ranks) == world
    for r, got in enumerate(ranks):
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            np.testing.assert_array_equal(_bits(got[k]), _bits(w),
                                          err_msg=f"rank {r}: {k}")
    # every rank at +qmax, at -qmax, alternating: exact means
    leaves = cases._flat(cases.leaf_set(0))
    for k in ("extreme/pos", "extreme/neg", "extreme/alt", "blocks/zero"):
        np.testing.assert_array_equal(want[k], leaves[k])


@pytest.mark.parametrize("world", [1, 2, 4, 129, 258, 1000, 32767])
def test_packed_sum_exact_at_lane_bounds(world):
    """Each rank's q at +qmax, -qmax, 0 and mixed signs in both lanes:
    the summed words (added as the all-reduce adds them) unpack to the
    exact lane sums, which reach +-world * qmax."""
    qmax = min(127, max(1, 32767 // world))
    rows = torch.tensor([[qmax] * 4, [-qmax] * 4, [qmax, -qmax] * 2,
                         [-qmax, qmax, 0, qmax], [0, 0, 0, -qmax]],
                        dtype=torch.int16).reshape(-1)
    word = compression._pack(rows)
    total = torch.zeros_like(word)
    for _ in range(world if world <= 1000 else 1):
        total += word
    if world > 1000:
        total = word * world            # the same sum, in one product
    got = compression._unpack(total, rows.numel())
    assert torch.equal(got, rows.to(torch.int32) * world)
    assert int(got.abs().max()) == world * qmax <= 32767
    odd = compression._unpack(compression._pack(rows[:-1]), rows.numel() - 1)
    assert torch.equal(odd, rows[:-1].to(torch.int32))


if has_hypothesis():
    from hypothesis import given, settings, strategies as st

    @given(st.floats(-100.0, 100.0), st.integers(0, 1000))
    @settings(max_examples=30, deadline=None)
    def test_stochastic_round_unbiased(value, seed):
        keys = prng.split(prng.prng_key(seed), 256)
        x = torch.full((8,), value, dtype=torch.float32)
        est = float(compression.stochastic_round(x, keys).mean())
        assert abs(est - float(x[0])) < 0.15, (value, est)
else:
    @pytest.mark.skip(reason="optional dev extra: pip install repro[dev]")
    def test_stochastic_round_unbiased():
        pass
