"""Serving robustness of the port against the reference, on the CPU: the
analogs of ``tests/test_serve_robust.py`` for the attention (gptneox-1b),
SSM (mamba2-2.7b) and hybrid (jamba-v0.1-52b, capacity factor 8.0)
families, reduced.

Each script runs through the port's ``ServeEngine`` and the reference's
on the reference's weights (carried across by ``repro_torch.bridge``),
and the statuses and token streams must be equal.  On top, what the
reference's tests pin, on the port:

* a fault in one slot finishes only that request (``faulted``), the
  survivor's stream is bit-identical to the port's uninjected run, and
  the slot serves the same prompt again to the uninjected stream;
* the sentinel detects ``logits_nan`` / ``logits_inf``, ``e8m0_overflow``
  and ``state_inf`` (mamba2; jamba's on the card, ``tests/
  test_torch_cuda.py``); a ``kv_bitflip`` stays silent (status ``ok``, the
  stream diverged from the uninjected run, token for token the
  reference's diverged stream);
* every submitted request ends in exactly one status: the ``balanced``
  identity holds through shed, deadline, cancel, fault and truncation;
* the traces are token for token the reference's, and a replay under
  the virtual clock gives the reference's report field for field.

The enc-dec and VLM rows run in ``tests/test_torch_encdec.py`` and
``tests/test_torch_vlm.py``; the speculative bitflip test of the
reference's file (``test_spec_kv_bitflip_survivor_isolation``) runs in
``tests/test_torch_serve_spec.py``.
"""

import dataclasses
import os
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
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
    STATUSES, AdmissionConfig, QueueFull, ServeEngine, bursty_trace,
    overload_ramp_trace, poisson_trace, replay, traffic)

ARCHS = {
    "attn": ("gptneox-1b", {}),
    "ssm": ("mamba2-2.7b", {}),
    "hybrid": ("jamba-v0.1-52b", {"moe_capacity_factor": 8.0}),
}
FP4, FP8 = "float4_e2m1fn", "float8_e4m3fn"


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
def models():
    """``get(family)``: (reference model, its params, the port's model,
    its params) from ``repro``'s init under PRNGKey(0), built once per
    module."""
    memo = {}

    def get(family):
        if family not in memo:
            name, over = ARCHS[family]
            ref_cfg = dataclasses.replace(ref_get_config(name).reduced(),
                                          **over)
            ref_model = ref_build_model(ref_cfg)
            ref_params = ref_model.init(jax.random.PRNGKey(0))
            flat = {k: np.asarray(v) for k, v in _flatten(ref_params).items()}
            cfg = dataclasses.replace(get_config(name).reduced(), **over)
            memo[family] = (ref_model, ref_params, build_model(cfg),
                            bridge.params_from_numpy(flat, cfg, "cpu"))
        return memo[family]
    return get


@pytest.fixture(scope="module")
def engines(models):
    """``get(family, clock=, admission=, **settings)``: (reference
    engine, port engine) of one family with the same settings, built
    once per (family, settings) and ``reset()`` on every later get, so
    the reference's compiled prefill and decode blocks are reused across
    scripts.  ``clock`` (a pair, one per engine) and ``admission`` are
    set on each get."""
    memo = {}

    def get(family, clock=(None, None), admission=None, **kw):
        key = (family, tuple(sorted(kw.items())))
        if key in memo:
            for eng in memo[key]:
                eng.reset()
        else:
            ref_model, ref_params, model, params = models(family)
            memo[key] = (ref_serve.ServeEngine(ref_model, ref_params, **kw),
                         ServeEngine(model, params, device="cpu", **kw))
        for eng, clk in zip(memo[key], clock):
            eng.set_clock(clk or time.monotonic)
            eng.set_admission(admission)
        return memo[key]
    return get


def _by_id(results):
    return {r.request_id: r for r in results}


def _view(results):
    """Comparable (id, status, tokens) of a result list, by id."""
    return sorted((r.request_id, r.status, list(r.tokens))
                  for r in results)


def _both(engines, family, script, **kw):
    """Run ``script(engine)`` on the reference's and the port's engine;
    the results must be equal.  Returns the port's engine and the
    script's value on each."""
    ref, port = engines(family, **kw)
    want, got = script(ref), script(port)
    assert _view(port.results) == _view(ref.results)
    acc, ref_acc = port.accounting(), ref.accounting()
    assert acc == ref_acc and acc["balanced"]
    return port, got, want


# --------------------------------------------------------------------- #
# fault isolation: poisoned slot out, survivors bit-identical, slot back
# --------------------------------------------------------------------- #

PA, PB = [1, 2, 3, 4, 5, 6, 7], [9, 8, 7]
ISO = dict(batch=2, max_seq=64, decode_block=4, prefill_chunk=8)
N_ISO = 13      # admission + blocks of 4 only: one decode block compiles


@pytest.mark.parametrize("kv_format", [None, FP8, FP4])
@pytest.mark.parametrize("family", list(ARCHS))
def test_fault_isolation_per_family(engines, family, kv_format):
    _, oracle = engines(family, kv_format=kv_format, **ISO)
    oracle.submit(PA, max_new_tokens=N_ISO)
    oracle.submit(PB, max_new_tokens=N_ISO)
    want = {r.request_id: r.tokens for r in oracle.run()}

    def script(eng):
        a = eng.submit(PA, max_new_tokens=N_ISO)
        b = eng.submit(PB, max_new_tokens=N_ISO)
        eng.decode_loop()                  # admit both, 1 + 4 tokens each
        eng.inject_fault(a, "logits_nan", delay=1)
        res = _by_id(eng.run())
        c = eng.submit(PA, max_new_tokens=N_ISO)   # the recovered slot
        res2 = _by_id(eng.run())
        return a, b, c, res, res2, eng.watchdog_report()["ok"]

    eng, (a, b, c, res, res2, watch_ok), _ = _both(
        engines, family, script, kv_format=kv_format, **ISO)
    assert res[a].status == "faulted"
    assert res[a].tokens == want[a][:6]
    assert res[b].status == "ok" and res[b].tokens == want[b]
    acc = eng.accounting()
    assert acc["faulted"] == 1 and acc["ok"] == 2
    assert res2[c].status == "ok" and res2[c].tokens == want[a]
    assert watch_ok
    assert not eng._armed          # the injector is off again


def test_logits_inf_detected(engines):
    def script(eng):
        a = eng.submit([3, 1, 4, 1, 5], max_new_tokens=10)
        eng.decode_loop()
        eng.inject_fault(a, "logits_inf", delay=0)
        return eng.run()[0]

    _, res, _ = _both(engines, "attn", script, batch=1, max_seq=64,
                      decode_block=4)
    assert res.status == "faulted"
    assert len(res.tokens) == 5            # admission + first block only


# --------------------------------------------------------------------- #
# cache-fault taxonomy: detected kinds fault, the silent gap stays pinned
# --------------------------------------------------------------------- #

def _cache_fault(kind):
    def script(eng):
        a = eng.submit([2, 7, 1, 8, 2, 8], max_new_tokens=12)
        eng.decode_loop()
        eng.inject_fault(a, kind)
        return eng.run()[0]
    return script


@pytest.mark.parametrize("kv_format", [FP8, FP4])
def test_e8m0_overflow_detected(engines, kv_format):
    """An overflowed scale byte (0xFF -> 2^128) decodes to inf: the
    sentinel sees it on the next attention read."""
    _, res, _ = _both(engines, "attn", _cache_fault("e8m0_overflow"),
                      batch=1, max_seq=64, kv_format=kv_format,
                      decode_block=4)
    assert res.status == "faulted" and len(res.tokens) < 12


def test_state_inf_detected_on_ssm(engines):
    """inf SSM state reaches the logits within a step; the recovered
    slot serves clean again (jamba's: the card test
    ``test_arming_and_cancel_make_no_sync``)."""
    def script(eng):
        res = _cache_fault("state_inf")(eng)
        eng.submit([2, 7, 1, 8, 2, 8], max_new_tokens=4)
        return res, eng.run()[-1]

    _, (res, again), _ = _both(engines, "ssm", script, batch=1, max_seq=64,
                               decode_block=4)
    assert res.status == "faulted" and len(res.tokens) < 12
    assert again.status == "ok"


def test_kv_bitflip_is_silent_corruption(engines):
    """The documented sentinel gap: XOR'd e8m0 scale bytes decode to
    wrong but finite scales, so the run finishes ``ok`` with a stream
    that diverges from the uninjected one, token for token as the
    reference's does."""
    _, oracle = engines("attn", batch=1, max_seq=64, kv_format=FP4,
                        decode_block=4)
    oracle.submit([2, 7, 1, 8, 2, 8], max_new_tokens=12)
    want = oracle.run()[0].tokens
    _, res, _ = _both(engines, "attn", _cache_fault("kv_bitflip"), batch=1,
                      max_seq=64, kv_format=FP4, decode_block=4)
    assert res.status == "ok" and len(res.tokens) == 12
    assert res.tokens != want
    assert res.tokens[:5] == want[:5]


def test_kv_bitflip_of_fp8_codes(engines):
    """A flip of the fp8 value codes, through a byte view of the fp8
    container: the port's statuses and streams are the reference's."""
    def script(eng):
        a = eng.submit([2, 7, 1, 8, 2, 8], max_new_tokens=12)
        eng.decode_loop()
        eng.inject_fault(a, "kv_bitflip", leaf="k_q", xor=0x41)
        return eng.run()[0]

    _both(engines, "attn", script, batch=1, max_seq=64, kv_format=FP8,
          decode_block=4)


def test_cache_faults_require_matching_cache(models):
    _, _, model, params = models("attn")
    dense = ServeEngine(model, params, device="cpu", batch=1, max_seq=64,
                        decode_block=4)
    a = dense.submit([1, 2, 3], max_new_tokens=32)
    dense.decode_loop()
    with pytest.raises(ValueError, match="quantized KV"):
        dense.inject_fault(a, "e8m0_overflow")
    with pytest.raises(ValueError, match="recurrent"):
        dense.inject_fault(a, "state_inf")
    with pytest.raises(ValueError, match="unknown fault kind"):
        dense.inject_fault(a, "cosmic_ray")
    with pytest.raises(ValueError, match="delay"):
        dense.inject_fault(a, "logits_nan", delay=-1)
    with pytest.raises(KeyError, match="not in flight"):
        dense.inject_fault(a + 1)


# --------------------------------------------------------------------- #
# cancellation
# --------------------------------------------------------------------- #

def test_cancel_inflight_and_queued(engines):
    def script(eng):
        a = eng.submit([1, 2, 3, 4], max_new_tokens=16)
        b = eng.submit([5, 6], max_new_tokens=16)
        eng.decode_loop()                  # a in flight, b queued
        out = [eng.cancel(b), eng.cancel(a), eng.cancel(a), eng.cancel(999)]
        with pytest.raises(ValueError, match="not in"):
            eng.cancel(a, status="vaporized")
        acc = eng.accounting()
        eng.submit([7, 8, 9], max_new_tokens=4)
        return a, b, out, acc, eng.run()[-1], eng.watchdog_report()["ok"]

    _, (a, b, out, acc, last, watch_ok), _ = _both(
        engines, "attn", script, batch=1, max_seq=64, decode_block=4)
    assert out == [True, True, False, False]
    assert acc["in_flight"] == 0 and acc["queued"] == 0 and acc["balanced"]
    assert last.status == "ok" and watch_ok


# --------------------------------------------------------------------- #
# admission control: bounded queue, policies, deadlines, scheduling
# --------------------------------------------------------------------- #

def test_submit_validates_max_new_tokens(models):
    _, _, model, params = models("attn")
    eng = ServeEngine(model, params, device="cpu", batch=1, max_seq=64)
    for bad in (0, -3):
        with pytest.raises(ValueError, match="max_new_tokens"):
            eng.submit([1, 2, 3], max_new_tokens=bad)
    assert eng.accounting()["submitted"] == 0
    a = eng.submit([1, 2, 3], max_new_tokens=1)
    res = _by_id(eng.run())
    assert res[a].status == "ok" and len(res[a].tokens) == 1


@pytest.mark.parametrize("policy,statuses", [
    ("reject", ["ok", "shed", "shed"]),
    ("shed_oldest", ["shed", "shed", "ok"])])
def test_admission_policies(engines, policy, statuses):
    def script(eng):
        ids = [eng.submit([1, 2, 3], max_new_tokens=4) for _ in range(3)]
        res = _by_id(eng.run())
        return [res[i].status for i in ids]

    _, got, _ = _both(engines, "attn", script, batch=1, max_seq=64,
                      decode_block=4,
                      admission=AdmissionConfig(queue_limit=1,
                                                policy=policy))
    assert got == statuses


def test_admission_block_policy(engines):
    """block: QueueFull raises and consumes nothing; the same id succeeds
    on retry after the queue drains."""
    def script(eng):
        a = eng.submit([1, 2, 3], max_new_tokens=4)
        with pytest.raises((QueueFull, ref_serve.QueueFull)):
            eng.submit([4, 5, 6], max_new_tokens=4)
        submitted = eng.accounting()["submitted"]
        eng.run()
        b = eng.submit([4, 5, 6], max_new_tokens=4)
        return a, b, submitted, _by_id(eng.run())[b].status

    _, (a, b, submitted, status), _ = _both(
        engines, "attn", script, batch=1, max_seq=64, decode_block=4,
        admission=AdmissionConfig(queue_limit=1, policy="block"))
    assert submitted == 1 and b == a + 1 and status == "ok"


def test_set_admission_reoffers_the_queue(engines):
    """Swapping the policy re-offers the queued requests: overflow of
    the new limit is shed."""
    def script(eng):
        for _ in range(4):
            eng.submit([1, 2, 3], max_new_tokens=4)
        eng.set_admission(AdmissionConfig(queue_limit=2))
        return eng.run()

    _both(engines, "attn", script, batch=1, max_seq=64, decode_block=4)


def test_shortest_prompt_first_scheduling(engines):
    def script(eng):
        long = eng.submit(list(range(1, 17)), max_new_tokens=4)
        mid = eng.submit(list(range(1, 9)), max_new_tokens=4)
        short = eng.submit([1, 2, 3], max_new_tokens=4)
        res = _by_id(eng.run())
        return [res[i].first_token_t for i in (short, mid, long)]

    now = [0.0]

    def tick():
        now[0] += 1.0
        return now[0]

    _, got, want = _both(engines, "attn", script, batch=1, max_seq=64,
                         decode_block=4, clock=(tick, tick),
                         admission=AdmissionConfig(scheduler="spf"))
    assert got[0] < got[1] < got[2]
    assert [t - got[0] for t in got] == [t - want[0] for t in want]


def test_deadlines_with_virtual_clock(engines):
    """An expired queued request never spends prefill, an expired
    in-flight request is cancelled with its partial tokens."""
    clocks = ([0.0], [0.0])

    def script(eng):
        now = clocks[isinstance(eng, ServeEngine)]
        a = eng.submit([1, 2, 3, 4], max_new_tokens=64)
        b = eng.submit([5, 6, 7], max_new_tokens=4)
        eng.decode_loop()                  # a in flight, b queued
        now[0] = 10.0                      # blow both deadlines
        eng.run()
        res = _by_id(eng.results)
        c = eng.submit([8, 9], max_new_tokens=4)
        return res[a], res[b], _by_id(eng.run())[c].status

    eng, (ra, rb, status_c), _ = _both(
        engines, "attn", script, batch=1, max_seq=64, decode_block=4,
        admission=AdmissionConfig(deadline_ms=100.0),
        clock=(lambda: clocks[0][0], lambda: clocks[1][0]))
    assert ra.status == "deadline_exceeded" and len(ra.tokens) >= 5
    assert rb.status == "deadline_exceeded" and rb.tokens == []
    assert status_c == "ok"
    assert eng.accounting()["deadline_exceeded"] == 2


def test_run_stall_guard(models, monkeypatch):
    """A queue that admission cannot make progress on raises instead of
    spinning."""
    _, _, model, params = models("attn")
    eng = ServeEngine(model, params, device="cpu", batch=1, max_seq=64)
    eng.submit([1, 2, 3], max_new_tokens=4)
    monkeypatch.setattr(eng.queue, "take", lambda now: (None, []))
    with pytest.raises(RuntimeError, match="stalled"):
        eng.run()


def test_truncated_status_and_flush(engines):
    """A step budget hit mid-generation flushes the partial stream as
    ``truncated`` and deactivates the slot on the device."""
    def script(eng):
        eng.submit([1, 2, 3], max_new_tokens=32)
        res = eng.run(max_steps=4)[0]
        return res, bool(np.array(eng.state["active"]).any())

    _, (res, active), _ = _both(engines, "attn", script, batch=1,
                                max_seq=64, decode_block=4)
    assert res.status == "truncated" and res.truncated
    assert 0 < len(res.tokens) < 32 and not active
    assert set(STATUSES) == {"ok", "truncated", "shed",
                             "deadline_exceeded", "faulted"}


# --------------------------------------------------------------------- #
# traffic harness: deterministic traces, exact accounting
# --------------------------------------------------------------------- #

def test_traces_equal_the_reference():
    """Arrival times, prompts, lengths and deadlines of every trace kind
    are the reference's, token for token."""
    for ours, theirs, kw in [
            (poisson_trace, ref_serve.poisson_trace,
             dict(n=12, rate=50.0, seed=5)),
            (bursty_trace, ref_serve.bursty_trace,
             dict(n_bursts=3, burst_size=4, gap_s=0.5, seed=3,
                  deadline_ms=20.0)),
            (overload_ramp_trace, ref_serve.overload_ramp_trace,
             dict(n=10, rate0=5.0, rate1=400.0, seed=1))]:
        a, b = ours(vocab_size=500, **kw), theirs(vocab_size=500, **kw)
        assert a.name == b.name and a.seed == b.seed
        assert [dataclasses.astuple(x) for x in a.arrivals] == [
            dataclasses.astuple(x) for x in b.arrivals]
    a = poisson_trace(n=12, rate=50.0, vocab_size=500, seed=5)
    assert a == poisson_trace(n=12, rate=50.0, vocab_size=500, seed=5)
    assert a != poisson_trace(n=12, rate=50.0, vocab_size=500, seed=6)
    assert all(x.t <= y.t for x, y in zip(a.arrivals, a.arrivals[1:]))
    assert sorted(traffic.TRACES) == ["bursty", "poisson", "ramp"]


def test_replay_overload_accounting(engines):
    """Virtual-clock replay of an overloaded bursty trace: exact status
    accounting, the same report on a second replay, and the reference's
    report field for field under both shedding policies."""
    ref, port = engines("attn", batch=2, max_seq=64,
                         decode_block=4, prefill_chunk=8)
    vocab = port.model.cfg.vocab_size
    kw = dict(n_bursts=2, burst_size=6, gap_s=0.5, vocab_size=vocab, seed=3,
              prompt_lens=(4, 8), output_lens=(4, 8))
    sc, ref_sc = bursty_trace(**kw), ref_serve.bursty_trace(**kw)
    for policy in ("reject", "shed_oldest"):
        adm = AdmissionConfig(queue_limit=2, policy=policy)
        ref_adm = ref_serve.AdmissionConfig(queue_limit=2, policy=policy)
        first = replay(port, sc, k=4, admission=adm, step_cost_s=1e-3)
        want = ref_serve.replay(ref, ref_sc, k=4, admission=ref_adm,
                                step_cost_s=1e-3)
        assert first.row() == want.row()
        assert first.accounting_ok and first.submitted == 12
        assert first.by_status.get("shed", 0) > 0
        assert _view(port.results) == _view(ref.results)
        assert replay(port, sc, k=4, admission=adm,
                      step_cost_s=1e-3) == first


def test_replay_deadline_trace(engines):
    ref, port = engines("attn", batch=2, max_seq=64,
                         decode_block=4, prefill_chunk=8)
    kw = dict(n=8, rate=200.0, vocab_size=port.model.cfg.vocab_size, seed=9,
              output_lens=(16,), deadline_ms=20.0)
    rep = replay(port, poisson_trace(**kw), k=4, step_cost_s=5e-3)
    want = ref_serve.replay(ref, ref_serve.poisson_trace(**kw), k=4,
                            step_cost_s=5e-3)
    assert rep.row() == want.row()
    assert rep.accounting_ok
    assert rep.by_status.get("deadline_exceeded", 0) > 0
    assert _view(port.results) == _view(ref.results)


# --------------------------------------------------------------------- #
# watchdog
# --------------------------------------------------------------------- #

def test_watchdog_flags_divergence(engines):
    ref, eng = engines("attn", batch=2, max_seq=64, decode_block=4)
    for e in (ref, eng):
        e.submit([1, 2, 3], max_new_tokens=16)
        e.decode_loop()
    assert eng.watchdog_report() == ref.watchdog_report()
    assert eng.watchdog_report()["ok"]
    # lost finish: host request on a deactivated device slot
    eng.state["active"].zero_()
    ref.state = dict(ref.state, active=jnp.zeros_like(ref.state["active"]))
    rep = eng.watchdog_report()
    assert not rep["ok"] and rep == ref.watchdog_report()
    assert any("lost finish" in f for f in rep["findings"])
    # orphan: device-active slot with no host request
    eng.state["active"].fill_(True)
    ref.state = dict(ref.state, active=jnp.ones_like(ref.state["active"]))
    rep = eng.watchdog_report()
    assert rep == ref.watchdog_report()
    assert any("orphaned" in f for f in rep["findings"])
    # stuck: active for 3 blocks without a token
    eng.state["active"][1] = False
    eng.slot_req[1] = None
    eng._slot_progress[0] = (len(eng.out_tokens[0]), eng.dispatches - 3)
    assert any("stuck" in f for f in eng.watchdog_report()["findings"])
