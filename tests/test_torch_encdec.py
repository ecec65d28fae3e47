"""The encoder-decoder family of the port against the reference, on the
CPU: seamless-m4t-medium reduced (2 encoder and 2 decoder layers, MHA,
GELU MLP, a cross-attention in every decoder block), fp32, on the
reference's weights (``tests/torch_modal_cases.py`` holds the shared
engines and scripts).

* Whole sequence: ``Model.forward`` and ``Model.prefill`` logits within
  atol = rtol = 1e-5 of the reference's; the prefill cache (``enc_out``,
  every self- and cross-attention ring) within 1e-5, ``slot_pos`` and
  the e8m0 scales equal, quantized codes equal but where an fp32 input
  sits on a rounding boundary (at most 1 in 1000, one code apart: the
  second decoder layer's K/V come out of two fp32 programs that sum in
  different orders); prefill then teacher-forced
  decode within 5e-4 of the port's own forward
  (``tests/test_decode_consistency.py::test_encdec_decode_matches_forward``)
  and within 1e-5 of the reference's decode.
* ``lm_encode_slot`` of a padded request into a slot a longer source
  held before: the ``enc_out`` rows, cross ``slot_pos`` and cross-KV
  bytes the reference's, dense, fp8 and fp4.
* Serving: greedy streams equal to the JAX engine's with dense, fp8 and
  fp4 KV (the cross rings quantized too) at K 7 and K 1, a request
  finishing mid-block; sampled streams; the chunked prompt against the
  port's own full-prompt prefill + decode (``tests/test_serve_unified.py
  ::test_chunked_prefill_encdec_matches_oracle``); ``kv_stats`` with
  ``cross_kv_bytes`` and ``"pos{i}.cross"`` rows; ``submit`` refusing
  what the reference refuses; the enc-dec row of
  ``tests/test_serve_robust.py`` (a fault, cancel, deadlines).
* Speculation: n-gram drafting (``ServeEngine(spec=SpecConfig(...))``)
  at dense, fp8 and fp4 KV gives the reference's non-speculative
  streams and its speculative engine's ``spec_report``.
"""

import dataclasses

import torch_modal_cases as cases
from torch_modal_cases import (  # noqa: F401 (one_torch_thread: fixture)
    ENGINE, FP4, KV_FORMATS, N_LONG, N_SHORT, P, PA, PB, S,
    one_torch_thread)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as ref_serve
from repro.models import build_model as ref_build_model

from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import flash_decode as kfd
from repro_torch.kernels import flash_decode_quant as kfdq
from repro_torch.models.model import build_model
from repro_torch.serve import ServeEngine

ARCH = "seamless-m4t-medium"


@pytest.fixture(scope="module")
def pair():
    return cases.build_pair(ARCH)


@pytest.fixture(scope="module")
def engines(pair):
    return cases.Engines(pair)


def _models(pair, kv_format):
    """(reference model, port model) under ``kv_format``."""
    ref_model, _, model, _ = pair
    return (ref_build_model(dataclasses.replace(
                ref_model.cfg, kv_format=kv_format or "")),
            build_model(dataclasses.replace(model.cfg,
                                            kv_format=kv_format or "")))


def _batch(cfg, seed, s=S):
    """frames (2, s, d) N(0, 0.02^2) and tokens (2, s), from ``seed``."""
    rng = np.random.default_rng(seed)
    return {"frames": (rng.standard_normal((2, s, cfg.d_model), np.float32)
                       * np.float32(0.02)),
            "tokens": rng.integers(0, cfg.vocab_size, (2, s)).astype(
                np.int32)}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# --------------------------------------------------------------------- #
# whole sequence
# --------------------------------------------------------------------- #

def test_forward_matches_reference(pair):
    """Logits within 1e-5; one plain flash_attention call per encoder
    layer and two per decoder layer (self, cross)."""
    ref_model, ref_params, model, params = pair
    batch = _batch(model.cfg, 1)
    want, _ = jax.jit(ref_model.forward)(ref_params, batch)
    calls = kfa.flash_attention_plain.calls
    logits, aux = model.forward(params, _torch(batch))
    cfg = model.cfg
    assert kfa.flash_attention_plain.calls - calls == (
        cfg.n_encoder_layers + 2 * cfg.n_layers)
    assert logits.shape == want.shape == (2, S, cfg.vocab_size)
    cases.close(logits, want)
    feats, _ = model.features(params, _torch(batch))
    torch.testing.assert_close(feats @ model.unembed_weight(params), logits,
                               atol=0, rtol=0)


@pytest.mark.parametrize("kv_format", KV_FORMATS)
def test_prefill_matches_reference(pair, kv_format):
    """Logits, ``enc_out`` and every ring of the prefill cache: the
    cross rings hold the 32 source positions, quantized on the way in
    under the kv format, and the prompt attends them dequantized."""
    _, ref_params, _, params = pair
    ref_model, model = _models(pair, kv_format)
    batch = _batch(model.cfg, 2)
    batch["tokens"] = batch["tokens"][:, :P]
    want, ref_cache = jax.jit(lambda p, b: ref_model.prefill(p, b, S + 8))(
        ref_params, batch)
    logits, cache = model.prefill(params, _torch(batch), S + 8)
    cases.close(logits, want)
    assert set(cache) == set(ref_cache) == {"pos0", "enc_out"}
    cases.close(cache["enc_out"], ref_cache["enc_out"])
    for part in ("kv", "cross_kv"):
        cases.check_ring(cache["pos0"][part], ref_cache["pos0"][part], part,
                         kv_format)
    assert (cache["pos0"]["cross_kv"]["slot_pos"] == torch.arange(S)).all()


def test_prefill_then_decode_matches_forward_and_reference(pair):
    """Prefill 16 tokens over 32 frames, then tokens 16..31
    teacher-forced: each step's logits within 5e-4 of the port's forward
    and within 1e-5 of the reference's decode step; the cross rings are
    read, never written (``enc_out`` and ``cross_kv`` unchanged)."""
    ref_model, ref_params, model, params = pair
    batch = _batch(model.cfg, 3)
    tt = _torch(batch)
    full, _ = model.forward(params, tt)
    pre = dict(tt, tokens=tt["tokens"][:, :P])
    logits, cache = model.prefill(params, pre, S + 8)
    ref_logits, ref_cache = jax.jit(
        lambda p, b: ref_model.prefill(p, b, S + 8))(
        ref_params, dict(batch, tokens=batch["tokens"][:, :P]))
    cases.close(logits, ref_logits)
    cross = {k: t.clone() for k, t in cache["pos0"]["cross_kv"].items()}
    enc = cache["enc_out"].clone()
    step = cases.ref_decode_step(ref_model, ref_params)
    errs = [(logits - full[:, P - 1]).abs().max().item()]
    for t in range(P, S):
        lg = model.decode_step(params, cache, tt["tokens"][:, t],
                               torch.full((2,), t, dtype=torch.int32))
        ref_lg, ref_cache = step(ref_cache, batch["tokens"][:, t], t)
        cases.close(lg, ref_lg)
        errs.append((lg - full[:, t]).abs().max().item())
    assert max(errs) < 5e-4, f"enc-dec decode diverges {max(errs):.2e}"
    assert torch.equal(cache["enc_out"], enc)
    assert all(torch.equal(cache["pos0"]["cross_kv"][k], t)
               for k, t in cross.items())


@pytest.mark.parametrize("kv_format", KV_FORMATS)
def test_encode_slot_matches_reference(pair, kv_format):
    """A 14-frame source in slot 1, evicted, then a 9-frame source
    padded to enc_len 16 in its place: the ``enc_out`` rows (zero past
    the source), cross ``slot_pos`` (source positions, -1 after) and the
    cross rings' bytes, the evicted tenant's left in the tail, equal to
    the reference's ``lm_encode_slot`` (padded, masked) after its
    ``clear_slot``; slot 0 untouched."""
    _, ref_params, _, params = pair
    ref_model, model = _models(pair, kv_format)
    cfg, enc_len = model.cfg, 16
    rng = np.random.default_rng(4)
    frames = [rng.standard_normal((1, enc_len, cfg.d_model), np.float32)
              * np.float32(0.02) for _ in range(2)]
    ref_encode = jax.jit(ref_model.encode_slot)
    ref_clear = jax.jit(ref_model.clear_slot)
    ref_cache = ref_model.init_cache(2, 64, enc_len=enc_len)
    cache = model.init_cache(2, 64, "cpu", enc_len=enc_len)
    for f, src in zip(frames, (14, 9)):
        ref_cache = ref_encode(ref_params, ref_clear(ref_cache, 1),
                               jnp.asarray(f), 1, src)
        model.clear_slot(cache, 1)
        out = model.encode_slot(params, cache, torch.from_numpy(f), 1, src)
        assert out is cache
    cases.close(cache["enc_out"], ref_cache["enc_out"])
    assert (cache["enc_out"][1, 9:] == 0).all()
    assert (cache["enc_out"][0] == 0).all()
    ring = cache["pos0"]["cross_kv"]
    cases.check_ring(ring, ref_cache["pos0"]["cross_kv"], "cross_kv")
    assert ring["slot_pos"][:, 1].tolist() == [
        list(range(9)) + [-1] * 7] * cfg.n_periods
    assert (ring["slot_pos"][:, 0] == -1).all()


# --------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("decode_block", [7, 1])
@pytest.mark.parametrize("kv_format", KV_FORMATS)
def test_greedy_streams_match_reference(engines, kv_format, decode_block):
    """Two requests over the 9-frame source, one ending inside a fused
    block; each decode step runs the decode kernel's plain version twice
    a layer (self- and cross-attention)."""
    kern = kfdq.flash_decode_quant_plain if kv_format else \
        kfd.flash_decode_plain
    calls = kern.calls
    eng, got = cases.check_streams(engines, [(PA, N_LONG), (PB, N_SHORT)],
                                   decode_block=decode_block,
                                   kv_format=kv_format)
    assert [len(t) for _, t, _ in got] == [N_LONG, N_SHORT]
    assert kern.calls - calls == 2 * eng.model.cfg.n_layers * (
        eng.decode_steps)


@pytest.mark.parametrize("decode_block", [7, 1])
def test_sampled_streams_match_reference(engines, decode_block):
    """Temperature 0.8, top_k 8, seed 3: the keys fold (request,
    position), so the streams do not depend on the block size."""
    _, got = cases.check_streams(engines, [([4, 5, 6], 8), ([9, 9], 3)],
                                 decode_block=decode_block, temperature=0.8,
                                 top_k=8, seed=3)
    assert [len(t) for _, t, _ in got] == [8, 3]


def test_chunked_prefill_matches_oracle(pair, engines):
    """A 13-token prompt in chunks of 8 after the encode-once leg: the
    engine's stream is the reference engine's and the port's own
    full-prompt prefill over the unpadded frames, then greedy decode."""
    _, _, model, params = pair
    frames, _ = cases.modal_inputs(model.cfg)
    prompt = [int(3 + (i * 5) % 250) for i in range(13)]
    _, got = cases.check_streams(engines, [(prompt, 8)])
    logits, cache = model.prefill(
        params, {"tokens": torch.tensor([prompt]),
                 "frames": torch.from_numpy(frames[None])}, 64)
    want = [int(logits[0].argmax())]
    for pos in range(len(prompt), len(prompt) + 7):
        logits = model.decode_step(params, cache, torch.tensor([want[-1]]),
                                   torch.tensor([pos], dtype=torch.int32))
        want.append(int(logits[0].argmax()))
    assert got[0][1] == want


@pytest.mark.parametrize("kv_format", [None, FP4])
def test_kv_stats_match_reference(pair, kv_format):
    """The cross rings count into ``kv_bytes`` and ``cross_kv_bytes``,
    one ``"pos0.cross"`` row beside ``"pos0"``; fp4 cross rings are
    sub-byte."""
    stats = cases.kv_stats_match(pair, kv_format)
    assert set(stats["per_layer"]) == {"pos0", "pos0.cross"}
    assert 0 < stats["cross_kv_bytes"] < stats["kv_bytes"]
    if kv_format:
        assert stats["bytes_per_elem"] < 1.0


def test_submit_raises_where_the_reference_raises(pair):
    """No frames, frames that are not (s_src, d_model), a source longer
    than ``enc_len``, or patches on a model without a vision frontend:
    the port raises the reference's ValueError and consumes no id; a
    decoder-only model refuses frames.  ``enc_len`` defaults to
    ``max_seq``."""
    ref_model, ref_params, model, params = pair
    d = model.cfg.d_model
    ref = ref_serve.ServeEngine(ref_model, ref_params, enc_len=16, **ENGINE)
    port = ServeEngine(model, params, device="cpu", enc_len=16, **ENGINE)
    assert ServeEngine(model, params, device="cpu", **ENGINE).enc_len == 64
    bad = [dict(), dict(frames=np.zeros(d, np.float32)),
           dict(frames=np.zeros((17, d), np.float32)),
           dict(frames=np.zeros((4, d), np.float32),
                patches=np.zeros((2, d), np.float32))]
    for kw in bad:
        msgs = []
        for eng in (ref, port):
            with pytest.raises(ValueError) as err:
                eng.submit([1, 2], max_new_tokens=2, **kw)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
    assert port.accounting()["submitted"] == 0
    assert port.submit([1, 2], max_new_tokens=2,
                       frames=np.zeros((16, d), np.float32)) == 0
    dec = build_model(get_config("gptneox-1b").reduced())
    eng = ServeEngine(dec, dec.init(torch.Generator().manual_seed(0), "cpu"),
                      device="cpu", batch=1, max_seq=16)
    assert eng.enc_len == 0 and "enc_out" not in eng.cache
    with pytest.raises(ValueError, match="not encoder-decoder"):
        eng.submit([1, 2], frames=np.zeros((4, 64), np.float32))


# --------------------------------------------------------------------- #
# robustness: the enc-dec row of tests/test_serve_robust.py
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("kv_format", KV_FORMATS)
def test_fault_isolation(engines, kv_format):
    cases.fault_isolation(engines, kv_format)


def test_cancel_inflight_and_queued(engines):
    cases.cancel_inflight_and_queued(engines)


def test_deadlines_with_virtual_clock(engines):
    cases.deadlines_with_virtual_clock(engines)


def test_clear_slot_and_reset_empty_the_encoder_state(pair, engines):
    """After a run, ``clear_slot`` empties the slot's cross rings
    (slot_pos -1) and zeroes its ``enc_out`` row, leaving the other
    slot; ``reset()`` empties every slot."""
    _, port = engines.get()
    cases.submit(port, PA, 8)
    cases.submit(port, PB, 8)
    port.run()
    ring = port.cache["pos0"]["cross_kv"]["slot_pos"]
    assert (ring[:, :, :9] >= 0).all() and (port.cache["enc_out"] != 0).any()
    port.model.clear_slot(port.cache, 0)
    assert (ring[:, 0] == -1).all() and (ring[:, 1, :9] >= 0).all()
    assert (port.cache["enc_out"][0] == 0).all()
    assert (port.cache["enc_out"][1] != 0).any()
    port.reset()
    assert (ring == -1).all() and (port.cache["enc_out"] == 0).all()


@pytest.mark.parametrize("kv_format", KV_FORMATS)
def test_ngram_speculation_matches_reference(engines, kv_format):
    """``ServeEngine(spec=SpecConfig(...))`` with n-gram drafting: the
    streams of the reference's non-speculative engine, and the reference
    speculative engine's ``spec_report``."""
    cases.ngram_spec_streams(engines, kv_format)
