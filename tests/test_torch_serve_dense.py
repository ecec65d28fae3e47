"""The dense-decoder family of the port against the reference, on the CPU:
gemma2-2b (local / global layers, both softcaps, GeGLU, head_dim 256,
tied embeddings), qwen2.5-3b (q/k/v biases, rope theta 1e6), llama3.2-3b
(rope theta 5e5) and gemma-2b (one KV head), all reduced.

Both packages run the reference's weights (carried across by
``repro_torch.bridge``) on the same tokens, made with numpy from a seed.

* Serving: greedy streams and statuses equal to the JAX ``ServeEngine``'s
  in the gemma2 cases of the reference's own tests: the local rings wrap
  inside a fused block (``tests/test_serve_fused.py::
  test_fused_loop_ring_wrap``), a 40-token prompt over the window of 32
  (``::test_chunked_prefill_window_wrap_matches_oracle``), fp4 KV on the
  local layers and fp8 on the global ones (``tests/test_serve_unified.py
  ::test_mixed_per_layer_kv_formats``) and the kv_format matrix of
  ``tests/test_serve_fused.py::test_fused_loop_matches_per_step``; one
  stream each for the other three models.  Admission logits within
  1e-4 (fp32, summation order), as ``tests/test_torch_serve.py`` holds
  them.
* Whole sequence: forward and prefill logits within atol = rtol = 1e-4
  of the reference's, the prefill's dense K/V within 1e-5 and
  ``slot_pos`` equal, quantized leaves byte for byte; prefill then
  teacher-forced decode against the forward within 5e-4
  (``tests/test_decode_consistency.py``'s bound), also on gemma2 far
  past its window; prefill then greedy decode gives the reference's
  stream.  These are ``tests/test_torch_forward.py``'s tolerances.
"""

import dataclasses
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

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import flash_decode as kfd  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

ARCHS = ("gemma2-2b", "qwen2.5-3b", "llama3.2-3b", "gemma-2b")
S, P = 48, 32                 # tokens, prompt: tests/test_decode_consistency
FP4, FP8 = "float4_e2m1fn", "float8_e4m3fn"


@pytest.fixture(scope="module")
def pairs():
    """``get(arch, key)``: (reference model, its params, the port's
    model, its params) from ``repro``'s init under PRNGKey(key), built
    once per module."""
    memo = {}

    def get(arch, key=0):
        if (arch, key) not in memo:
            ref_model = ref_build_model(ref_get_config(arch).reduced())
            ref_params = ref_model.init(jax.random.PRNGKey(key))
            flat = {k: np.asarray(v) for k, v in _flatten(ref_params).items()}
            cfg = get_config(arch).reduced()
            memo[arch, key] = (ref_model, ref_params, build_model(cfg),
                               bridge.params_from_numpy(flat, cfg, "cpu"))
        return memo[arch, key]
    return get


@pytest.fixture(scope="module")
def reference(pairs):
    """``run(arch, key, requests, **engine kwargs)``: the JAX engine's
    (streams, admission logits), each configuration served once."""
    memo = {}

    def run(arch, key, requests, **kw):
        tag = (arch, key, repr(requests), repr(sorted(kw.items())))
        if tag not in memo:
            ref_model, ref_params, _, _ = pairs(arch, key)
            memo[tag] = _serve(RefEngine(ref_model, ref_params, **kw),
                               requests)
        return memo[tag]
    return run


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


def _check(pairs, reference, arch, key, requests, ref_kw, **kw):
    """The port's engine (``ref_kw`` updated by ``kw``) against the
    reference's under ``ref_kw``: streams equal, admission logits within
    1e-4.  Returns the port's engine and streams."""
    _, _, model, params = pairs(arch, key)
    want, want_logits = reference(arch, key, requests, **ref_kw)
    engine = ServeEngine(model, params, device="cpu", **{**ref_kw, **kw})
    got, got_logits = _serve(engine, requests)
    assert got == want
    assert all(s == "ok" for _, _, s in got)
    assert len(got_logits) == len(want_logits) == len(requests)
    for a, b in zip(got_logits, want_logits):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)
    return engine, got


# --------------------------------------------------------------------- #
# gemma2 serving
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("decode_block", [8, 1])
def test_gemma2_ring_wrap_inside_fused_block(pairs, reference, decode_block):
    """10 + 45 positions through rings of 32 slots on the local layers:
    they wrap inside a fused block of 8 (and at every step of K 1)."""
    _, got = _check(pairs, reference, "gemma2-2b", 1,
                    [(list(range(1, 11)), 45)],
                    dict(batch=1, max_seq=64, decode_block=8,
                         prefill_chunk=8), decode_block=decode_block)
    assert len(got[0][1]) == 45


def test_gemma2_prompt_longer_than_window(pairs, reference):
    """A 40-token prompt in chunks of 8 over a window of 32: the chunk
    writes wrap the local ring and must not evict what the chunk's own
    earlier queries still see.  Also the port's own full-prompt prefill
    + decode oracle."""
    prompt = [int(1 + (i * 7) % 200) for i in range(40)]
    _, got = _check(pairs, reference, "gemma2-2b", 4, [(prompt, 6)],
                    dict(batch=1, max_seq=64, decode_block=4,
                         prefill_chunk=8))
    _, _, model, params = pairs("gemma2-2b", 4)
    logits, cache = model.prefill(params, {"tokens": torch.tensor([prompt])},
                                  64)
    want = [int(logits[0].argmax())]
    for pos in range(len(prompt), len(prompt) + 5):
        logits = model.decode_step(params, cache,
                                   torch.tensor([want[-1]]),
                                   torch.tensor([pos], dtype=torch.int32))
        want.append(int(logits[0].argmax()))
    assert got[0][1] == want


@pytest.mark.parametrize("decode_block", [4, 1])
def test_gemma2_mixed_kv_formats(pairs, reference, decode_block):
    """fp4 KV on the local (windowed) layers, fp8 on the global ones:
    the measured bytes per element differ by layer as the reference's do,
    and the streams are the reference's."""
    cfg = get_config("gemma2-2b").reduced()
    fmts = tuple(FP4 if blk.window else FP8 for blk in cfg.block_pattern())
    assert fmts == (FP4, FP8)
    engine, _ = _check(pairs, reference, "gemma2-2b", 3,
                       [([5, 4, 3, 2, 1], 8)],
                       dict(batch=1, max_seq=64, kv_format=fmts,
                            decode_block=4, prefill_chunk=8),
                       decode_block=decode_block)
    bpe = {name: d["bytes_per_elem"]
           for name, d in engine.kv_stats["per_layer"].items()}
    assert bpe["pos0"] < 0.7 < 1.0 < bpe["pos1"] <= 1.25
    assert [engine.model.cfg.kv_format_for(i) for i in (0, 1)] == list(fmts)


@pytest.mark.parametrize("decode_block", [7, 1])
@pytest.mark.parametrize("kv_format", [None, FP8, FP4])
def test_gemma2_kv_format_matrix(pairs, reference, kv_format, decode_block):
    """A request that finishes mid-block beside a longer one, with dense,
    fp8 and fp4 KV on every layer; fused K 7 and per-step K 1 against
    the reference's K 7."""
    _, got = _check(pairs, reference, "gemma2-2b", 0,
                    [([1, 2, 3, 4, 5, 6, 7], 12), ([9, 8, 7], 4)],
                    dict(batch=2, max_seq=64, kv_format=kv_format,
                         decode_block=7, prefill_chunk=4),
                    decode_block=decode_block)
    assert [len(t) for _, t, _ in got] == [12, 4]


@pytest.mark.parametrize("arch", ARCHS[1:])
def test_greedy_stream_matches_reference(pairs, reference, arch):
    """qwen2.5-3b (q/k/v biases), llama3.2-3b (3 q-heads per KV head in
    the full config, 2 reduced) and gemma-2b (MQA): two requests, one of
    them finishing mid-block, and the decode kernel's plain version
    once per layer per step."""
    _, _, model, _ = pairs(arch)
    calls = kfd.flash_decode_plain.calls
    engine, got = _check(pairs, reference, arch, 0,
                         [([3, 1, 4, 1, 5, 9, 2, 6], 10), ([2, 7], 3)],
                         dict(batch=2, max_seq=64, decode_block=5,
                              prefill_chunk=8))
    assert [len(t) for _, t, _ in got] == [10, 3]
    assert kfd.flash_decode_plain.calls - calls == (
        model.cfg.n_layers * engine.decode_steps)


# --------------------------------------------------------------------- #
# the whole-sequence path and decode consistency
# --------------------------------------------------------------------- #

def _tokens(seed, vocab, s=S):
    return np.random.default_rng(seed).integers(0, vocab, (2, s)).astype(
        np.int32)


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


def _bytes(t):
    if isinstance(t, torch.Tensor):
        return t.view(torch.uint8).numpy() if t.element_size() == 1 \
            else t.numpy()
    a = np.asarray(t)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(pairs, arch):
    """Logits, and one plain flash_attention call per layer."""
    ref_model, ref_params, model, params = pairs(arch)
    tokens = _tokens(1, model.cfg.vocab_size)
    want, _ = jax.jit(ref_model.forward)(ref_params, {"tokens": tokens})
    calls = kfa.flash_attention_plain.calls
    logits, _ = model.forward(params, {"tokens": torch.from_numpy(tokens)})
    assert kfa.flash_attention_plain.calls - calls == model.cfg.n_layers
    assert logits.shape == want.shape
    _close(logits, want, 1e-4, 1e-4)


@pytest.mark.parametrize("arch,kv_format", [
    ("gemma2-2b", None), ("gemma2-2b", (FP4, FP8)), ("qwen2.5-3b", None),
    ("llama3.2-3b", FP8), ("gemma-2b", None)])
def test_prefill_matches_reference(pairs, arch, kv_format):
    """Logits and every cache leaf of every position in the period (the
    local layer's ring of 32 slots holds the last 32 of the 32-token
    prompt; quantized leaves byte for byte)."""
    ref_model, ref_params, _, params = pairs(arch)
    over = ({"kv_formats": kv_format} if isinstance(kv_format, tuple)
            else {"kv_format": kv_format or ""})
    ref_model = ref_build_model(dataclasses.replace(ref_model.cfg, **over))
    model = build_model(dataclasses.replace(get_config(arch).reduced(),
                                            **over))
    tokens = _tokens(2, model.cfg.vocab_size)[:, :P]
    want, ref_cache = jax.jit(lambda p, b: ref_model.prefill(p, b, S + 8))(
        ref_params, {"tokens": tokens})
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(
        tokens)}, S + 8)
    _close(logits, want, 1e-4, 1e-4)
    assert set(cache) == set(ref_cache)
    for pos_name, entry in cache.items():
        kv, ref_kv = entry["kv"], ref_cache[pos_name]["kv"]
        assert set(kv) == set(ref_kv)
        for name in ref_kv:
            assert tuple(kv[name].shape) == ref_kv[name].shape, name
            if name in ("k", "v"):
                _close(kv[name], ref_kv[name], 1e-5, 1e-5)
            else:
                np.testing.assert_array_equal(
                    _bytes(kv[name]), _bytes(ref_kv[name]),
                    err_msg=f"{pos_name}/{name}")


def _greedy(step, logits, cache, n, start):
    stream, seen = [], []
    tok = logits.argmax(-1)
    for i in range(n):
        stream.append(np.asarray(tok).tolist())
        logits, cache = step(cache, tok, start + i)
        seen.append(np.asarray(logits))
        tok = logits.argmax(-1)
    return stream, seen


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_forward_and_reference(pairs, arch):
    """``tests/test_decode_consistency.py::test_decode_matches_forward``
    on the port (prefill 32 tokens, then tokens 32..47 teacher-forced,
    each step's logits against the forward's), and prefill + greedy
    decode against the reference's stream and logits."""
    ref_model, ref_params, model, params = pairs(arch)
    tokens = _tokens(3, model.cfg.vocab_size)
    tt = torch.from_numpy(tokens)
    full, _ = model.forward(params, {"tokens": tt})
    logits, cache = model.prefill(params, {"tokens": tt[:, :P]}, S + 8)
    errs = [(logits - full[:, P - 1]).abs().max().item()]
    for t in range(P, S):
        lg = model.decode_step(params, cache, tt[:, t],
                               torch.full((2,), t, dtype=torch.int32))
        errs.append((lg - full[:, t]).abs().max().item())
    assert max(errs) < 5e-4, f"decode diverges {max(errs):.2e}"

    ref_step = jax.jit(ref_model.decode_step)
    ref_logits, ref_cache = jax.jit(
        lambda p, b: ref_model.prefill(p, b, S + 8))(
        ref_params, {"tokens": tokens[:, :P]})
    want, want_logits = _greedy(
        lambda c, tok, pos: ref_step(ref_params, c, tok,
                                     jnp.full((2,), pos, jnp.int32)),
        ref_logits, ref_cache, S - P, P)
    logits, cache = model.prefill(params, {"tokens": tt[:, :P]}, S + 8)
    got, got_logits = _greedy(
        lambda c, tok, pos: (model.decode_step(
            params, c, tok, torch.full((2,), pos, dtype=torch.int32)), c),
        logits, cache, S - P, P)
    assert got == want
    for a, b in zip(got_logits, want_logits):
        _close(a, b, 1e-4, 1e-4)


def test_gemma2_decode_far_past_the_window(pairs):
    """``tests/test_decode_consistency.py::test_ring_buffer_long_decode``
    on the port: prefill 8 tokens, then decode to position 79 (more than
    twice the window of 32) teacher-forced; every step's logits within
    5e-4 of the port's forward, which is within 1e-4 of the
    reference's."""
    ref_model, ref_params, model, params = pairs("gemma2-2b")
    n = 80
    tokens = np.random.default_rng(5).integers(
        0, model.cfg.vocab_size, (1, n)).astype(np.int32)
    tt = torch.from_numpy(tokens)
    full, _ = model.forward(params, {"tokens": tt})
    want, _ = jax.jit(ref_model.forward)(ref_params, {"tokens": tokens})
    _close(full, want, 1e-4, 1e-4)
    _, cache = model.prefill(params, {"tokens": tt[:, :8]}, n)
    assert cache["pos0"]["kv"]["k"].shape[2] == 32       # the local ring
    assert cache["pos1"]["kv"]["k"].shape[2] == n
    errs = []
    for t in range(8, n):
        lg = model.decode_step(params, cache, tt[:, t],
                               torch.full((1,), t, dtype=torch.int32))
        errs.append((lg - full[:, t]).abs().max().item())
    assert max(errs) < 5e-4, f"ring cache diverges: {max(errs):.2e}"
