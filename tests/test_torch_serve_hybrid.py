"""The MoE and hybrid decoders of the port against the reference, on the
CPU: jamba-v0.1-52b (attention + 7 SSM blocks a period, MoE on every
second block), kimi-k2-1t-a32b (MoE with a shared expert on every block)
and llama4-maverick-400b-a17b (dense and MoE blocks in turn), reduced.

Both packages run the reference's weights (carried across by
``repro_torch.bridge``) on the same tokens, made with numpy from a seed.

* Whole sequence: ``Model.forward`` logits within atol = rtol = 1e-4 of
  the reference's and the summed MoE aux losses within rtol 1e-5, at the
  default capacity factor 1.25 (tokens drop); prefill then teacher-forced
  decode against the forward within 5e-4
  (``tests/test_decode_consistency.py``'s bound), at capacity factor 8.0
  as there (with drops, routing legitimately depends on the grouping).
* Serving: greedy and sampled streams and statuses equal to the JAX
  ``ServeEngine``'s with dense, fp8 and fp4 KV, at capacity factor 1.25,
  where the padded prefill chunks drop tokens (their pad rows take
  expert capacity, as in the reference); admission logits within 1e-4.
  jamba's greedy streams run here with dense KV; at fp8 and fp4 they are
  held to the reference engine's at capacity factor 8.0 in
  ``tests/test_torch_serve_robust.py`` (fault isolation).
  The jamba ring wrap of ``tests/test_serve_unified.py::
  test_chunked_prefill_hybrid_ring_wrap`` (window 16, a 24-token prompt)
  equals the reference's stream and the port's own full-prompt prefill
  and decode.
* The weight bridge carries the MoE leaves in the reference's flat key
  order; jamba's cache mixes ring KV and SSM entries, and
  ``clear_slot`` empties both.
"""

import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint.checkpointer import _flatten  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.serve import ServeEngine as RefEngine  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import ssd_scan as kss  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

JAMBA, KIMI, LLAMA4 = ("jamba-v0.1-52b", "kimi-k2-1t-a32b",
                       "llama4-maverick-400b-a17b")
ARCHS = (JAMBA, KIMI, LLAMA4)
FP4, FP8 = "float4_e2m1fn", "float8_e4m3fn"
S, P = 48, 32
# two requests in 8-token chunks, one over three chunks with a ragged
# tail; 9 tokens = admission + two blocks of 4, so the reference
# compiles one decode block
REQUESTS = [(list(range(3, 22)), 9), ([9, 8, 7, 6, 5], 9)]
ENGINE = dict(batch=2, max_seq=64, decode_block=4, prefill_chunk=8)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's plain versions at these widths are a few microseconds
    an op: one intra-op thread runs them as fast as many, and keeps
    parallel test workers from spinning against each other.  The
    previous count is restored for the worker's next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pairs():
    """``get(arch)``: (reference model, its params, the port's model, its
    params) from ``repro``'s init under PRNGKey(0), built once per
    module."""
    memo = {}

    def get(arch):
        if arch not in memo:
            ref_model = ref_build_model(ref_get_config(arch).reduced())
            ref_params = ref_model.init(jax.random.PRNGKey(0))
            flat = {k: np.asarray(v) for k, v in _flatten(ref_params).items()}
            cfg = get_config(arch).reduced()
            memo[arch] = (ref_model, ref_params, build_model(cfg),
                          bridge.params_from_numpy(flat, cfg, "cpu"))
        return memo[arch]
    return get


def _serve(engine, requests):
    """(streams, admission logits) of ``requests`` [(prompt, max_new)]."""
    seen = []
    prefill = engine._prefill_into_slot

    def recording(slot, req):
        logits = prefill(slot, req)
        seen.append(np.asarray(logits))
        return logits

    engine._prefill_into_slot = recording
    for prompt, n in requests:
        engine.submit(prompt, max_new_tokens=n)
    return [(r.request_id, r.tokens, r.status) for r in engine.run()], seen


def _check(models, requests, engine_kw):
    """The port's engine against the reference's on the same script
    (``models``: a ``pairs`` entry): streams and statuses equal,
    admission logits within 1e-4.  Returns the port's streams."""
    ref_model, ref_params, model, params = models
    want, want_logits = _serve(RefEngine(ref_model, ref_params, **engine_kw),
                               requests)
    got, got_logits = _serve(
        ServeEngine(model, params, device="cpu", **engine_kw), requests)
    assert got == want
    assert all(s == "ok" for _, _, s in got)
    assert len(got_logits) == len(want_logits) == len(requests)
    for a, b in zip(got_logits, want_logits):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)
    return got


# --------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("arch,kv_format,temperature", [
    (arch, kv, t) for arch in ARCHS for kv in (None, FP8, FP4)
    for t in (0.0, 0.8) if arch != JAMBA or t or kv is None])
def test_streams_match_reference(pairs, monkeypatch, arch, kv_format,
                                 temperature):
    """Greedy and sampled (top_k 8, seed 3) streams at capacity factor
    1.25, where the padded chunks drop (token, expert) pairs: their pad
    rows take expert capacity, as in the reference.  jamba's greedy
    streams with quantized KV are held to the reference engine's by
    ``tests/test_torch_serve_robust.py::test_fault_isolation_per_family``
    (the survivor's and the recovered slot's streams, capacity factor
    8.0)."""
    dropped = []
    apply = moe.apply_moe

    def recording(p, x, cfg, subgroup=moe.MOE_SUBGROUP):
        y, aux = apply(p, x, cfg, subgroup)
        if x.shape[1] > 1:                          # a prefill chunk
            dropped.append(float(aux["moe_dropped"]))
        return y, aux

    monkeypatch.setattr(moe, "apply_moe", recording)
    got = _check(pairs(arch), REQUESTS,
                 dict(ENGINE, kv_format=kv_format, temperature=temperature,
                      top_k=8, seed=3))
    assert [len(t) for _, t, _ in got] == [9, 9]
    cfg = pairs(arch)[2].cfg
    assert cfg.moe_capacity_factor == 1.25
    assert len(dropped) == 4 * cfg.n_periods * sum(
        b.ffn == "moe" for b in cfg.block_pattern())
    assert max(dropped) > 0


def test_jamba_ring_wrap(pairs):
    """Window 16 under a 24-token prompt in chunks of 8: the attention
    ring wraps in the chunk writes while the SSM layers carry their
    state, at capacity factor 8.0 (no drops).  The stream equals the
    reference engine's and the port's full-prompt prefill + decode; the
    SSD runs through ``ssd_scan``'s plain version once per chunk per SSM
    layer."""
    over = dict(sliding_window=16, moe_capacity_factor=8.0)
    prompt = [int(1 + (i * 7) % 200) for i in range(24)]
    ref_model, ref_params, model, params = pairs(JAMBA)
    ref_model = ref_build_model(dataclasses.replace(ref_model.cfg, **over))
    model = build_model(dataclasses.replace(model.cfg, **over))
    n_ssm = sum(b.mixer == "ssm" for b in model.cfg.block_pattern())
    calls = kss.ssd_scan_plain.calls
    got = _check((ref_model, ref_params, model, params), [(prompt, 9)],
                 dict(batch=1, max_seq=64, decode_block=4, prefill_chunk=8))
    assert kss.ssd_scan_plain.calls - calls == 3 * n_ssm
    assert model.cfg.block_pattern()[0].window == 16
    logits, cache = model.prefill(params, {"tokens": torch.tensor([prompt])},
                                  64)
    want = [int(logits[0].argmax())]
    for pos in range(len(prompt), len(prompt) + 8):
        logits = model.decode_step(params, cache, torch.tensor([want[-1]]),
                                   torch.tensor([pos], dtype=torch.int32))
        want.append(int(logits[0].argmax()))
    assert got[0][1] == want


# --------------------------------------------------------------------- #
# the whole-sequence path and decode consistency
# --------------------------------------------------------------------- #

def _tokens(seed, vocab, s=S):
    return np.random.default_rng(seed).integers(0, vocab, (2, s)).astype(
        np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(pairs, arch):
    """Logits and the aux losses summed over the MoE layers, at capacity
    factor 1.25; one plain flash_attention call per attention layer."""
    ref_model, ref_params, model, params = pairs(arch)
    tokens = _tokens(1, model.cfg.vocab_size)
    want, want_aux = jax.jit(ref_model.forward)(ref_params,
                                                {"tokens": tokens})
    calls = kfa.flash_attention_plain.calls
    logits, aux = model.forward(params, {"tokens": torch.from_numpy(tokens)})
    n_attn = sum(b.mixer == "attn" for b in model.cfg.block_pattern())
    assert kfa.flash_attention_plain.calls - calls == (
        n_attn * model.cfg.n_periods)
    assert logits.shape == want.shape
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    assert set(aux) == set(want_aux)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(want_aux[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert float(aux["moe_dropped"]) > 0
    feats, aux_f = model.features(params, {"tokens": torch.from_numpy(
        tokens)})
    assert feats.shape == (2, S, model.cfg.d_model)
    assert all(torch.equal(aux_f[k], aux[k]) for k in aux)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_forward(pairs, arch):
    """``tests/test_decode_consistency.py::test_decode_matches_forward``
    on the port, capacity factor 8.0: prefill 32 tokens, then tokens
    32..47 teacher-forced, each step's logits within 5e-4 of the
    forward's."""
    _, _, model, params = pairs(arch)
    model = build_model(dataclasses.replace(model.cfg,
                                            moe_capacity_factor=8.0))
    tt = torch.from_numpy(_tokens(3, model.cfg.vocab_size))
    full, aux = model.forward(params, {"tokens": tt})
    assert float(aux["moe_dropped"]) == 0.0
    logits, cache = model.prefill(params, {"tokens": tt[:, :P]}, S + 8)
    errs = [(logits - full[:, P - 1]).abs().max().item()]
    for t in range(P, S):
        lg = model.decode_step(params, cache, tt[:, t],
                               torch.full((2,), t, dtype=torch.int32))
        errs.append((lg - full[:, t]).abs().max().item())
    assert max(errs) < 5e-4, f"decode diverges {max(errs):.2e}"


def test_hybrid_cache_mixes_entries(pairs):
    """jamba's cache holds a ring KV entry at the attention position and
    an ``ssm`` entry at the other seven; ``clear_slot`` reaches both."""
    _, _, model, params = pairs(JAMBA)
    cache = model.init_cache(2, 32, "cpu")
    kinds = [set(cache[f"pos{i}"]) for i in range(8)]
    assert kinds == [{"kv"}] + [{"ssm"}] * 7
    model.prefill_chunk(params, cache, torch.arange(1, 9), 1, 0, 8)
    assert (cache["pos0"]["kv"]["slot_pos"][:, 1] >= 0).any()
    assert cache["pos1"]["ssm"]["state"][:, 1].abs().sum() > 0
    model.clear_slot(cache, 1)
    assert (cache["pos0"]["kv"]["slot_pos"][:, 1] == -1).all()
    assert all(not t[:, 1].any() for i in range(1, 8)
               for t in cache[f"pos{i}"]["ssm"].values())


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_the_moe_leaves(pairs, arch):
    """The flat keys of the MoE and hybrid trees (``moe/{router, w1, w2,
    w3, shared/...}``, the SSM leaves, ``ln_ffn`` after an SSM mixer)
    come in ``checkpointer._flatten``'s order, and the round trip
    through numpy gives back the reference's values, the fp32 router
    included."""
    _, ref_params, model, params = pairs(arch)
    ref_flat = _flatten(ref_params)
    flat = bridge.flatten(params)
    assert list(flat) == list(ref_flat)
    assert any(k.endswith("moe/router") for k in flat)
    back = bridge.params_to_numpy(params)
    for k, v in ref_flat.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)
    if model.cfg.moe_shared_expert:
        assert any("/moe/shared/w1" in k for k in flat)
