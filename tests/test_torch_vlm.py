"""The early-fusion VLM family of the port against the reference, on the
CPU: internvl2-2b reduced (2 layers, 4 q-heads over 2 KV heads, SwiGLU),
fp32, on the reference's weights (``tests/torch_modal_cases.py`` holds
the shared engines and scripts).  Patch embeddings go in front of the
token embeddings: ``Model.forward`` / ``prefill`` take them as
``batch["patches"]``, the engine streams them through the chunked
prefill as embedding chunks (``prefill_chunk(embeds=)``).

* Whole sequence: forward and prefill logits within atol = rtol = 1e-5
  of the reference's, the prefill ring within 1e-5 (``slot_pos`` and
  scales equal, codes within one step at a rounding boundary, as in
  ``tests/test_torch_encdec.py``); prefill then teacher-forced decode
  within 5e-4 of the port's own forward (the internvl2 case of
  ``tests/test_decode_consistency.py::test_decode_matches_forward``,
  here with text positions past the prompt to decode) and within 1e-5
  of the reference's decode.
* Serving: greedy streams equal to the JAX engine's with dense, fp8 and
  fp4 KV at K 7 and K 1, a request finishing mid-block; a request
  without patches beside one with; sampled streams; the patch prefix
  and a chunked prompt against the port's own full-prompt prefill +
  decode (``tests/test_serve_unified.py::
  test_chunked_prefill_vlm_patches_matches_oracle``); ``kv_stats``;
  ``submit`` refusing what the reference refuses; the VLM row of
  ``tests/test_serve_robust.py`` (a fault, cancel, deadlines).
* Speculation: n-gram drafting (``ServeEngine(spec=SpecConfig(...))``)
  at dense, fp8 and fp4 KV gives the reference's non-speculative
  streams and its speculative engine's ``spec_report``.
"""

import dataclasses

import torch_modal_cases as cases
from torch_modal_cases import (  # noqa: F401 (one_torch_thread: fixture)
    ENGINE, FP4, KV_FORMATS, N_LONG, N_SHORT, PA, PB, one_torch_thread)

import jax
import numpy as np
import pytest
import torch

from repro import serve as ref_serve
from repro.models import build_model as ref_build_model

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import flash_decode as kfd
from repro_torch.kernels import flash_decode_quant as kfdq
from repro_torch.models import model as model_lib
from repro_torch.models.model import build_model
from repro_torch.serve import ServeEngine

ARCH = "internvl2-2b"
N_PAT, S, P = 8, 40, 24        # patches, text tokens, prompt tokens


@pytest.fixture(scope="module")
def pair():
    return cases.build_pair(ARCH)


@pytest.fixture(scope="module")
def engines(pair):
    return cases.Engines(pair)


def _batch(cfg, seed, s=S):
    """patches (2, 8, d) N(0, 0.02^2) and tokens (2, s), from ``seed``."""
    rng = np.random.default_rng(seed)
    return {"patches": (rng.standard_normal((2, N_PAT, cfg.d_model),
                                            np.float32) * np.float32(0.02)),
            "tokens": rng.integers(0, cfg.vocab_size, (2, s)).astype(
                np.int32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# --------------------------------------------------------------------- #
# whole sequence
# --------------------------------------------------------------------- #

def test_forward_matches_reference(pair):
    """Logits over the 8 + 40 trunk within 1e-5; one plain
    flash_attention call per layer."""
    ref_model, ref_params, model, params = pair
    batch = _batch(model.cfg, 1)
    want, _ = jax.jit(ref_model.forward)(ref_params, batch)
    calls = kfa.flash_attention_plain.calls
    logits, _ = model.forward(params, _torch(batch))
    assert kfa.flash_attention_plain.calls - calls == model.cfg.n_layers
    assert logits.shape == want.shape == (2, N_PAT + S, model.cfg.vocab_size)
    cases.close(logits, want)


@pytest.mark.parametrize("kv_format", KV_FORMATS)
def test_prefill_matches_reference(pair, kv_format):
    """Logits and the ring: positions 0..31 hold 8 patches and 24
    tokens."""
    ref_model, ref_params, model, params = pair
    ref_model = ref_build_model(dataclasses.replace(
        ref_model.cfg, kv_format=kv_format or ""))
    model = build_model(dataclasses.replace(model.cfg,
                                            kv_format=kv_format or ""))
    batch = _batch(model.cfg, 2)
    batch["tokens"] = batch["tokens"][:, :P]
    want, ref_cache = jax.jit(
        lambda p, b: ref_model.prefill(p, b, N_PAT + S + 8))(ref_params,
                                                             batch)
    logits, cache = model.prefill(params, _torch(batch), N_PAT + S + 8)
    cases.close(logits, want)
    assert set(cache) == set(ref_cache) == {"pos0"}
    cases.check_ring(cache["pos0"]["kv"], ref_cache["pos0"]["kv"], "kv",
                     kv_format)
    assert (cache["pos0"]["kv"]["slot_pos"][..., :N_PAT + P]
            == torch.arange(N_PAT + P)).all()


def test_prefill_then_decode_matches_forward_and_reference(pair):
    """Prefill 8 patches + 24 tokens, then tokens 24..39 teacher-forced
    at trunk positions 32..47: each step within 5e-4 of the port's
    forward and within 1e-5 of the reference's decode step."""
    ref_model, ref_params, model, params = pair
    batch = _batch(model.cfg, 3)
    tt = _torch(batch)
    full, _ = model.forward(params, tt)
    logits, cache = model.prefill(
        params, dict(tt, tokens=tt["tokens"][:, :P]), N_PAT + S + 8)
    ref_logits, ref_cache = jax.jit(
        lambda p, b: ref_model.prefill(p, b, N_PAT + S + 8))(
        ref_params, dict(batch, tokens=batch["tokens"][:, :P]))
    cases.close(logits, ref_logits)
    step = cases.ref_decode_step(ref_model, ref_params)
    errs = [(logits - full[:, N_PAT + P - 1]).abs().max().item()]
    for t in range(P, S):
        pos = N_PAT + t
        lg = model.decode_step(params, cache, tt["tokens"][:, t],
                               torch.full((2,), pos, dtype=torch.int32))
        ref_lg, ref_cache = step(ref_cache, batch["tokens"][:, t], pos)
        cases.close(lg, ref_lg)
        errs.append((lg - full[:, pos]).abs().max().item())
    assert max(errs) < 5e-4, f"vlm decode diverges {max(errs):.2e}"


def test_batch_fields():
    """The reference's batch layout: a patch prefix of min(256, s // 2)
    positions, the rest tokens."""
    cfg = get_config(ARCH)
    assert model_lib.batch_fields(cfg, 2, 1024) == {
        "patches": ((2, 256, 2048), "bfloat16"),
        "tokens": ((2, 768), "int32")}
    assert model_lib.vlm_patches(48) == 24 and model_lib.VLM_PATCHES == 256
    batch = model_lib.make_batch(cfg.reduced(), 2, 48, 0, "cpu")
    assert batch["patches"].shape == (2, 24, 64)
    assert batch["tokens"].shape == (2, 24)


# --------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("decode_block", [7, 1])
@pytest.mark.parametrize("kv_format", KV_FORMATS)
def test_greedy_streams_match_reference(engines, kv_format, decode_block):
    """Two requests behind the 5-patch prefix, one ending inside a
    fused block; the decode kernel's plain version once a layer a
    step."""
    kern = kfdq.flash_decode_quant_plain if kv_format else \
        kfd.flash_decode_plain
    calls = kern.calls
    eng, got = cases.check_streams(engines, [(PA, N_LONG), (PB, N_SHORT)],
                                   decode_block=decode_block,
                                   kv_format=kv_format)
    assert [len(t) for _, t, _ in got] == [N_LONG, N_SHORT]
    assert kern.calls - calls == eng.model.cfg.n_layers * eng.decode_steps


def test_text_only_request_beside_a_patched_one(pair, engines):
    """A request without patches is a plain decoder prompt: beside one
    with patches, both streams are the reference's."""
    _, patches = cases.modal_inputs(pair[2].cfg)

    def script(eng):
        a = eng.submit(PA, max_new_tokens=N_LONG)
        b = eng.submit(PB, max_new_tokens=8, patches=patches)
        res = cases.by_id(eng.run())
        return [res[i].tokens for i in (a, b)]

    _, got, want = cases.both(engines, script)
    assert got == want and [len(t) for t in got] == [N_LONG, 8]


@pytest.mark.parametrize("decode_block", [7, 1])
def test_sampled_streams_match_reference(engines, decode_block):
    _, got = cases.check_streams(engines, [([4, 5, 6], 8), ([9, 9], 3)],
                                 decode_block=decode_block, temperature=0.8,
                                 top_k=8, seed=3)
    assert [len(t) for _, t, _ in got] == [8, 3]


def test_chunked_prefill_matches_oracle(pair, engines):
    """5 patches in one padded embedding chunk, then a 13-token prompt in
    chunks of 8 at trunk offset 5: the reference engine's stream and the
    port's own full-prompt prefill + greedy decode."""
    _, _, model, params = pair
    _, patches = cases.modal_inputs(model.cfg)
    prompt = [int(3 + (i * 5) % 250) for i in range(13)]
    _, got = cases.check_streams(engines, [(prompt, 8)])
    logits, cache = model.prefill(
        params, {"tokens": torch.tensor([prompt]),
                 "patches": torch.from_numpy(patches[None])}, 64)
    want = [int(logits[0].argmax())]
    start = len(patches) + len(prompt)
    for pos in range(start, start + 7):
        logits = model.decode_step(params, cache, torch.tensor([want[-1]]),
                                   torch.tensor([pos], dtype=torch.int32))
        want.append(int(logits[0].argmax()))
    assert got[0][1] == want


@pytest.mark.parametrize("kv_format", [None, FP4])
def test_kv_stats_match_reference(pair, kv_format):
    stats = cases.kv_stats_match(pair, kv_format)
    assert stats["cross_kv_bytes"] == 0 and set(stats["per_layer"]) == {
        "pos0"}


def test_submit_raises_where_the_reference_raises(pair):
    """Frames on a model that is not encoder-decoder, and a trunk
    (patches + prompt) that leaves no room in max_seq: the reference's
    ValueError, no id consumed; the engine holds no encoder state."""
    ref_model, ref_params, model, params = pair
    d = model.cfg.d_model
    ref = ref_serve.ServeEngine(ref_model, ref_params, **ENGINE)
    port = ServeEngine(model, params, device="cpu", **ENGINE)
    assert port.enc_len == 0 and "enc_out" not in port.cache
    bad = [dict(frames=np.zeros((4, d), np.float32)),
           dict(patches=np.zeros((60, d), np.float32))]
    for kw in bad:
        msgs = []
        for eng in (ref, port):
            with pytest.raises(ValueError) as err:
                eng.submit([1, 2, 3, 4], max_new_tokens=2, **kw)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    assert port.accounting()["submitted"] == 0


# --------------------------------------------------------------------- #
# robustness: the VLM row of tests/test_serve_robust.py
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("kv_format", KV_FORMATS)
def test_fault_isolation(engines, kv_format):
    cases.fault_isolation(engines, kv_format)


def test_cancel_inflight_and_queued(engines):
    cases.cancel_inflight_and_queued(engines)


def test_deadlines_with_virtual_clock(engines):
    cases.deadlines_with_virtual_clock(engines)


@pytest.mark.parametrize("kv_format", KV_FORMATS)
def test_ngram_speculation_matches_reference(engines, kv_format):
    """``ServeEngine(spec=SpecConfig(...))`` with n-gram drafting: the
    streams of the reference's non-speculative engine, and the reference
    speculative engine's ``spec_report``."""
    cases.ngram_spec_streams(engines, kv_format)
