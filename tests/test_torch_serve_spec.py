"""Speculative serving of the port against the reference, on the CPU: the
twins of ``tests/test_serve_spec.py`` (and of
``tests/test_serve_robust.py::test_spec_kv_bitflip_survivor_isolation``)
for the attention (gptneox-1b), SSM (mamba2-2.7b) and hybrid
(jamba-v0.1-52b, capacity factor 8.0) families, reduced, on the
reference's weights (carried across by ``repro_torch.bridge``).

The contract is the reference's: speculation changes how many blocks a
stream takes, never the stream.  So every speculative stream of the port
here is held token for token to the reference's NON-speculative engine
on the same requests (greedy and sampled; n-gram, draft-model and
scripted ``draft_fn`` drafting; ring wrap, mid-block finishes, faults).
The reference's oracle engines decode one step a block (K 1), so each
compiles one decode executable, and one is built per setting and
``reset()`` between scripts.  For n-gram and ``draft_fn`` drafting the
port's ``spec_report`` equals the reference's speculative engine's.

The reference's self-draft test bounds the acceptance at >= 3.0 tokens a
block and its engine reaches 2.4 (the draft model's cache never sees the
bonus token of a fully accepted block); the twin here holds the port's
self-draft to the stream and prints both acceptances.
"""

import dataclasses
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import serve as ref_serve  # noqa: E402
from repro.checkpoint.checkpointer import _flatten  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AdmissionConfig, ServeEngine, SpecConfig)

ARCHS = {
    "attn": ("gptneox-1b", {}, 0),
    "ssm": ("mamba2-2.7b", {}, 0),
    "hybrid": ("jamba-v0.1-52b", {"moe_capacity_factor": 8.0}, 0),
    "ring": ("gemma2-2b", {}, 1),               # window 32, PRNGKey(1)
}
FP4, FP8 = "float4_e2m1fn", "float8_e4m3fn"
KV_FORMATS = [None, FP8, FP4]
PROMPTS = [[1, 2, 3, 4, 5, 6, 7], [9, 8, 7]]
SPEC = dict(draft_tokens=3, ngram_table=64)
SAMPLED = dict(temperature=0.8, top_k=8, seed=3)
# every attention-family engine here streams its prompts in chunks of 4
BASE = dict(batch=2, max_seq=64, prefill_chunk=4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the plain versions at these widths take
    microseconds an op, and parallel test workers must not spin against
    each other.  The previous count is restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """``get(family)``: (reference model, its params, the port's model,
    its params), built once per module."""
    memo = {}

    def get(family):
        if family not in memo:
            name, over, key = ARCHS[family]
            ref_cfg = dataclasses.replace(ref_get_config(name).reduced(),
                                          **over)
            ref_model = ref_build_model(ref_cfg)
            ref_params = ref_model.init(jax.random.PRNGKey(key))
            flat = {k: np.asarray(v) for k, v in _flatten(ref_params).items()}
            cfg = dataclasses.replace(get_config(name).reduced(), **over)
            memo[family] = (ref_model, ref_params, build_model(cfg),
                            bridge.params_from_numpy(flat, cfg, "cpu"))
        return memo[family]
    return get


@pytest.fixture(scope="module")
def oracle(models):
    """``get(family, **settings)``: the reference's non-speculative engine
    at K 1 with ``settings``, built once and ``reset()`` on later gets
    (with the admission config and clock put back)."""
    memo = {}

    def get(family, **kw):
        key = (family, tuple(sorted(kw.items())))
        if key in memo:
            memo[key].reset()
            memo[key].set_admission(None)
        else:
            ref_model, ref_params, _, _ = models(family)
            memo[key] = ref_serve.ServeEngine(ref_model, ref_params,
                                              decode_block=1, **kw)
        memo[key].set_clock(time.monotonic)
        return memo[key]
    return get


def _port(models, family, spec=SPEC, **kw):
    _, _, model, params = models(family)
    if isinstance(spec, dict):
        spec = SpecConfig(**spec)
    return ServeEngine(model, params, device="cpu", spec=spec, **kw)


def _serve(eng, requests):
    """Streams and statuses of ``requests`` [(prompt, max_new)], by id."""
    for prompt, n in requests:
        eng.submit(prompt, max_new_tokens=n)
    return [(r.tokens, r.status)
            for r in sorted(eng.run(), key=lambda r: r.request_id)]


def _by_id(results):
    return {r.request_id: r for r in results}


# --------------------------------------------------------------------- #
# streams: family x kv_format, sampled, batch, scheduler, ring, 1 token
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("family", ["attn", "ssm", "hybrid"])
@pytest.mark.parametrize("kv_format", KV_FORMATS)
def test_spec_greedy_matches_reference(models, oracle, family, kv_format):
    """Greedy n-gram speculation gives the reference's non-speculative
    streams, a slot finishing mid-block included."""
    requests = [(PROMPTS[0], 12), (PROMPTS[1], 5)]
    want = _serve(oracle(family, kv_format=kv_format, **BASE), requests)
    eng = _port(models, family, kv_format=kv_format, decode_block=6, **BASE)
    got = _serve(eng, requests)
    assert got == want
    assert [len(t) for t, _ in got] == [12, 5]
    assert all(s == "ok" for _, s in got)
    assert eng.spec_report()["blocks"] > 0


@pytest.mark.parametrize("family", ["attn", "ssm", "hybrid"])
def test_spec_sampled_matches_reference(models, oracle, family):
    """Sampled speculation: each verify row samples under the key of its
    own (request, position), so the streams are the reference's."""
    requests = [(PROMPTS[0], 9), (PROMPTS[1], 6)]
    want = _serve(oracle(family, **SAMPLED, **BASE), requests)
    got = _serve(_port(models, family, spec=dict(SPEC, draft_tokens=4),
                       decode_block=5, **SAMPLED, **BASE), requests)
    assert got == want


def test_spec_sampled_batch_composition_independent(models, oracle):
    """A sampled speculative stream beside a companion is the stream of
    the reference's batch-1 engine."""
    want = _serve(oracle("attn", **SAMPLED, **dict(BASE, batch=1)),
                  [([4, 5, 6], 7)])
    got = _serve(_port(models, "attn", decode_block=5, **SAMPLED, **BASE),
                 [([4, 5, 6], 7), ([9, 9], 3)])
    assert got[0] == want[0]


def test_spec_sampled_streams_scheduler_independent(models, oracle):
    """FIFO and shortest-prompt-first admit in different orders into
    different slots; the sampled speculative streams are the same, and
    the reference's FIFO non-speculative ones."""
    reqs = [([1, 2, 3, 4, 5, 6, 7], 6), ([8, 8], 6), ([5, 4, 3, 2], 6)]
    outs = {}
    for sched in ("fifo", "spf"):
        eng = _port(models, "attn", decode_block=4, **SAMPLED,
                    **dict(BASE, batch=1),
                    admission=AdmissionConfig(queue_limit=8,
                                              scheduler=sched))
        ids = [eng.submit(p, max_new_tokens=n) for p, n in reqs]
        res = _by_id(eng.run())
        outs[sched] = [res[i].tokens for i in ids]
    ref = oracle("attn", **SAMPLED, **dict(BASE, batch=1))
    ref.set_admission(AdmissionConfig(queue_limit=8))
    ids = [ref.submit(p, max_new_tokens=n) for p, n in reqs]
    res = _by_id(ref.run())
    assert outs["fifo"] == outs["spf"] == [res[i].tokens for i in ids]


def test_spec_ring_wrap_matches_reference(models, oracle):
    """gemma2's local rings (window 32) wrap inside verify blocks: 10 +
    45 positions, the streams the reference's."""
    settings = dict(batch=1, max_seq=64, prefill_chunk=8)
    requests = [(list(range(1, 11)), 45)]
    want = _serve(oracle("ring", **settings), requests)
    got = _serve(_port(models, "ring", decode_block=8, **settings), requests)
    assert got == want and len(got[0][0]) == 45


def test_spec_single_token_request(models, oracle):
    """max_new_tokens=1 is served by admission alone: the speculative
    blocks emit nothing for it."""
    requests = [([5, 4, 3], 1), ([2, 2, 2], 6)]
    want = _serve(oracle("attn", **BASE), requests)
    got = _serve(_port(models, "attn", decode_block=4, **BASE), requests)
    assert got == want
    assert [len(t) for t, _ in got] == [1, 6]


# --------------------------------------------------------------------- #
# scripted drafts
# --------------------------------------------------------------------- #

D, MAX_SEQ, VOCAB = 3, 64, 512
SCRIPT_REQUESTS = [(PROMPTS[0], 12), (PROMPTS[1], 9)]


@pytest.fixture(scope="module")
def script_oracle(oracle):
    """The reference's non-speculative streams and the (slot, position)
    table of them: tbl[slot, p] is the token sampled at position p (-7
    elsewhere, which no draft matches)."""
    streams = [t for t, _ in _serve(oracle("attn", **BASE), SCRIPT_REQUESTS)]
    tbl = np.full((2, MAX_SEQ), -7, np.int32)
    for slot, ((prompt, _), toks) in enumerate(zip(SCRIPT_REQUESTS,
                                                   streams)):
        tbl[slot, len(prompt):len(prompt) + len(toks)] = toks
    return streams, tbl


def _port_draft_fn(tbl, pattern):
    """Drafts of position p: the oracle's token where ``pattern`` [slot,
    p], else a wrong one (the reference test's ``draft_fn``, on the
    port's state dict)."""
    tbl, pat = torch.from_numpy(tbl), torch.from_numpy(pattern)

    def draft_fn(st):
        q = (st["pos"][:, None] + 1
             + torch.arange(D, dtype=torch.int32)[None, :]).clamp_max(
                 MAX_SEQ - 1).long()
        right = tbl.gather(1, q)
        return torch.where(pat.gather(1, q), right, (right + 1) % VOCAB)
    return draft_fn


def _ref_draft_fn(tbl, pattern):
    import jax.numpy as jnp
    tbl, pat = jnp.asarray(tbl), jnp.asarray(pattern)

    def draft_fn(st):
        q = jnp.minimum(st["pos"][:, None] + 1 + jnp.arange(D)[None, :],
                        MAX_SEQ - 1)
        rows = jnp.arange(2)[:, None]
        right = tbl[rows, q]
        return jnp.where(pat[rows, q], right,
                         (right + 1) % VOCAB).astype(jnp.int32)
    return draft_fn


def _run_scripted(models, script_oracle, pattern, with_reference=False):
    """The port's engine drafting by ``pattern``: the oracle streams, all
    ``ok``; with ``with_reference``, the reference's speculative engine
    on the same script too, and its ``spec_report``.  Returns the port's
    report."""
    streams, tbl = script_oracle
    settings = dict(BASE, decode_block=2 * (D + 1))
    eng = _port(models, "attn",
                spec=SpecConfig(draft_tokens=D, ngram_table=64,
                                draft_fn=_port_draft_fn(tbl, pattern)),
                **settings)
    got = _serve(eng, SCRIPT_REQUESTS)
    assert got == [(t, "ok") for t in streams]
    rep = eng.spec_report()
    if with_reference:
        ref_model, ref_params, _, _ = models("attn")
        ref = ref_serve.ServeEngine(
            ref_model, ref_params,
            spec=ref_serve.SpecConfig(draft_tokens=D, ngram_table=64,
                                      draft_fn=_ref_draft_fn(tbl, pattern)),
            **settings)
        assert _serve(ref, SCRIPT_REQUESTS) == got
        assert rep == ref.spec_report()
    return rep


def test_scripted_accept_all_and_reject_all(models, script_oracle):
    """Reject-all keeps one true token a block (mean accepted length
    1.0), accept-all whole blocks where the budget allows; both reports
    the reference's."""
    full = _run_scripted(models, script_oracle, np.ones((2, MAX_SEQ), bool),
                         with_reference=True)
    none = _run_scripted(models, script_oracle,
                         np.zeros((2, MAX_SEQ), bool), with_reference=True)
    assert none["mean_accepted_len"] == 1.0
    assert full["mean_accepted_len"] > 2.5
    assert full["blocks"] < none["blocks"]
    assert full["accepted_tokens"] == none["accepted_tokens"] == 19


def test_scripted_alternating_and_skew(models, script_oracle):
    alt = np.zeros((2, MAX_SEQ), bool)
    alt[:, ::2] = True
    _run_scripted(models, script_oracle, alt)
    skew = np.zeros((2, MAX_SEQ), bool)
    skew[0] = True                    # slot 0 races ahead, slot 1 crawls
    _run_scripted(models, script_oracle, skew)


# --------------------------------------------------------------------- #
# a fault inside a speculative block; n-gram acceptance; draft models
# --------------------------------------------------------------------- #

def test_spec_fault_matches_reference(models, oracle):
    """A logits fault armed to fire at the same absolute position (the
    engines have emitted different counts after one block) gives the
    reference's partial prefix and ``faulted`` status, the survivor the
    reference's stream."""
    def script(eng):
        a = eng.submit(PROMPTS[0], max_new_tokens=20)
        b = eng.submit(PROMPTS[1], max_new_tokens=20)
        eng.decode_loop()
        eng.inject_fault(a, "logits_nan",
                         delay=10 - len(eng.out_tokens[0]))
        res = _by_id(eng.run())
        assert eng.accounting()["balanced"] and eng.watchdog_report()["ok"]
        return {rid: (r.status, r.tokens) for rid, r in res.items()}

    want = script(oracle("attn", **BASE))
    got = script(_port(models, "attn", decode_block=6, **BASE))
    assert got == want
    assert got[0][0] == "faulted" and len(got[0][1]) == 10
    assert got[1][0] == "ok" and len(got[1][1]) == 20


def test_ngram_acceptance_on_repetitive_stream(models, oracle):
    """A cyclic prompt seeds the n-gram table: acceptance beats 1.0 token
    a block, the stream is the reference's non-speculative one, and
    ``spec_report`` is the reference's speculative engine's."""
    settings = dict(batch=1, max_seq=128, decode_block=8)
    spec = dict(draft_tokens=3, ngram_table=128)
    requests = [([1, 2, 3, 4] * 4, 40)]
    want = _serve(oracle("attn", batch=1, max_seq=128), requests)
    eng = _port(models, "attn", spec=spec, **settings)
    got = _serve(eng, requests)
    assert got == want and len(got[0][0]) == 40
    ref_model, ref_params, _, _ = models("attn")
    ref = ref_serve.ServeEngine(ref_model, ref_params,
                                spec=ref_serve.SpecConfig(**spec), **settings)
    assert _serve(ref, requests) == got
    rep = eng.spec_report()
    assert rep == ref.spec_report()
    assert rep["enabled"] and rep["blocks"] > 0
    assert rep["mean_accepted_len"] > 1.0


def test_draft_model_self_draft_stream(models, oracle):
    """The target drafting for itself: the stream is the reference's
    non-speculative one.  Its acceptance is printed beside the
    reference's own self-draft engine's (2.4 tokens a block on this
    script, under the reference test's bound of 3.0), and held to the
    stream, not to that bound."""
    settings = dict(batch=1, max_seq=64, prefill_chunk=4)
    requests = [(PROMPTS[0], 13)]
    want = _serve(oracle("attn", **settings), requests)
    ref_model, ref_params, model, params = models("attn")
    eng = _port(models, "attn",
                spec=SpecConfig(draft_tokens=3, ngram_table=64,
                                draft_model=model, draft_params=params),
                decode_block=8, **settings)
    assert _serve(eng, requests) == want
    ref = ref_serve.ServeEngine(
        ref_model, ref_params, decode_block=8,
        spec=ref_serve.SpecConfig(draft_tokens=3, ngram_table=64,
                                  draft_model=ref_model,
                                  draft_params=ref_params), **settings)
    assert _serve(ref, requests) == want
    got_len = eng.spec_report()["mean_accepted_len"]
    ref_len = ref.spec_report()["mean_accepted_len"]
    print(f"self-draft mean_accepted_len: port {got_len}, reference "
          f"{ref_len}")
    assert got_len > 1.0


def test_draft_model_random_weights_still_conformant(models, oracle):
    """An unrelated draft model mostly mis-predicts, so the rollback of
    its rejected writes runs all the time; the streams are untouched."""
    requests = [(PROMPTS[0], 12), (PROMPTS[1], 7)]
    want = _serve(oracle("attn", **BASE), requests)
    dcfg = dataclasses.replace(get_config("gptneox-1b").reduced(),
                               name="draft-tiny")
    dmodel = build_model(dcfg)
    dparams = dmodel.init(torch.Generator().manual_seed(9), "cpu")
    eng = _port(models, "attn",
                spec=SpecConfig(draft_tokens=3, ngram_table=64,
                                draft_model=dmodel, draft_params=dparams),
                decode_block=8, **BASE)
    assert _serve(eng, requests) == want
    assert eng.spec_report()["blocks"] > 0


def test_spec_kv_bitflip_survivor_isolation(models, oracle):
    """A bitflip over one slot's fp4 KV bytes on the speculative path
    finishes ``ok`` with a diverged stream whose prefix holds, while the
    other slot's stream is the uninjected run's, token for token; the
    uninjected speculative streams are the reference's non-speculative
    ones."""
    settings = dict(BASE, kv_format=FP4)
    pa, pb = [2, 7, 1, 8, 2, 8], [3, 1, 4, 1, 5]
    want = _serve(oracle("attn", **settings), [(pa, 12), (pb, 12)])
    clean = _port(models, "attn", decode_block=8, **settings)
    assert _serve(clean, [(pa, 12), (pb, 12)]) == want
    eng = _port(models, "attn", decode_block=8, **settings)
    a = eng.submit(pa, max_new_tokens=12)
    b = eng.submit(pb, max_new_tokens=12)
    eng.decode_loop()                      # admit + first verify blocks
    n_clean = len(eng.out_tokens[0])
    eng.inject_fault(a, "kv_bitflip")
    res = _by_id(eng.run())
    assert res[a].status == "ok" and len(res[a].tokens) == 12
    assert res[a].tokens != want[0][0]
    assert res[a].tokens[:n_clean] == want[0][0][:n_clean]
    assert (res[b].status, res[b].tokens) == (want[1][1], want[1][0])
    assert eng.spec_report()["blocks"] > 0
    assert eng.accounting()["balanced"]


# --------------------------------------------------------------------- #
# configuration, validation, state
# --------------------------------------------------------------------- #

def test_spec_config_and_draft_validation(models):
    _, _, model, params = models("attn")
    _, _, smodel, sparams = models("ssm")
    with pytest.raises(ValueError, match="draft_tokens"):
        SpecConfig(draft_tokens=0)
    with pytest.raises(ValueError, match="ngram_context"):
        SpecConfig(ngram_context=0)
    with pytest.raises(ValueError, match="ngram_table"):
        SpecConfig(ngram_table=0)
    with pytest.raises(ValueError, match="go together"):
        SpecConfig(draft_model=model)
    with pytest.raises(ValueError, match="decoder-only attention"):
        ServeEngine(model, params, batch=1, max_seq=64, device="cpu",
                    spec=SpecConfig(draft_model=smodel,
                                    draft_params=sparams))
    vlm = build_model(get_config("internvl2-2b").reduced())
    with pytest.raises(ValueError, match="decoder-only target"):
        ServeEngine(vlm, vlm.init(torch.Generator().manual_seed(1), "cpu"),
                    batch=1, max_seq=64, device="cpu",
                    spec=SpecConfig(draft_model=model, draft_params=params))
    vcfg = dataclasses.replace(get_config("gptneox-1b").reduced(),
                               name="draft-vocab", vocab_size=256)
    vmodel = build_model(vcfg)
    with pytest.raises(ValueError, match="vocab"):
        ServeEngine(model, params, batch=1, max_seq=64, device="cpu",
                    spec=SpecConfig(draft_model=vmodel,
                                    draft_params=vmodel.init(
                                        torch.Generator().manual_seed(2),
                                        "cpu")))
    with pytest.raises(NotImplementedError, match="mesh"):
        ServeEngine(model, params, batch=1, max_seq=64, device="cpu",
                    mesh=object(), spec=SpecConfig())


def test_spec_state_fields(models):
    """The speculation fields of the slot state exist exactly when
    speculation is on, with the reference's shapes."""
    _, _, model, params = models("attn")
    spec = SpecConfig(draft_tokens=3, ngram_context=3, ngram_table=64)
    eng = ServeEngine(model, params, batch=2, max_seq=64, spec=spec,
                      device="cpu")
    ref = ServeEngine(model, params, batch=2, max_seq=64, device="cpu")
    assert eng.state["spec_hist"].shape == (2, 3)
    assert eng.state["spec_ngram"].shape == (2, 64)
    assert eng.state["spec_accept"].shape == (2,)
    assert eng.state["spec_blocks"].shape == (2,)
    for f in ("spec_hist", "spec_ngram", "spec_accept", "spec_blocks"):
        assert f not in ref.state
    assert not ref.spec_report()["enabled"]
    # a tenant's counts: tokens committed and blocks run
    eng.submit([1, 2, 3, 4] * 3, max_new_tokens=9)
    eng.decode_loop(8)
    assert int(eng.state["spec_accept"][0]) == len(eng.out_tokens[0]) - 1
    assert int(eng.state["spec_blocks"][0]) == eng.spec_report()["blocks"]
