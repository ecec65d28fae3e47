"""Shared cases of ``tests/test_torch_encdec.py`` (seamless-m4t-medium)
and ``tests/test_torch_vlm.py`` (internvl2-2b): the port's engine and
whole-sequence path against the reference's, reduced, fp32, on the
reference's weights (carried across by ``repro_torch.bridge``).

Every engine here serves batch 2, max_seq 64, prefill chunks of 8 and
decode blocks of 7, and every script keeps the reference's fused loop at
K = 7 (a request's first token comes from admission, then blocks of 7),
so each reference engine compiles one decode block; one reference engine
per setting is built per module and ``reset()`` between scripts.  The
source frames and patch prefixes are the reference tests'
(``tests/test_serve_unified.py::_modal_inputs``: 9 frames, 5 patches,
N(0, 0.02^2) from ``RandomState(7)``).  The speculative rows
(:func:`ngram_spec_streams`) build their speculative engines, the port's
and the reference's, per call.
"""

import os
import time
from typing import Optional

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

from repro_torch import bridge, compat, lowbits  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve import ServeEngine, SpecConfig  # noqa: E402

FP4, FP8 = "float4_e2m1fn", "float8_e4m3fn"
KV_FORMATS = (None, FP8, FP4)
ENGINE = dict(batch=2, max_seq=64, decode_block=7, prefill_chunk=8)
PA, PB = [1, 2, 3, 4, 5, 6, 7], [9, 8, 7]
# 15 tokens = admission + two blocks of 7; 4 ends inside the first block
N_LONG, N_SHORT = 15, 4
S, P = 32, 16                 # tests/test_decode_consistency.py's enc-dec


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the plain versions at these widths take
    microseconds an op, and parallel test workers must not spin against
    each other.  The previous count is restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def build_pair(arch: str):
    """(reference model, its params, the port's model, its params) from
    ``repro``'s init under PRNGKey(0)."""
    ref_model = ref_build_model(ref_get_config(arch).reduced())
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten(ref_params).items()}
    cfg = get_config(arch).reduced()
    return (ref_model, ref_params, build_model(cfg),
            bridge.params_from_numpy(flat, cfg, "cpu"))


def modal_inputs(cfg, seed=7):
    """(frames, patches) of the family, as the reference's tests make
    them; the other is None."""
    rng = np.random.RandomState(seed)
    frames = patches = None
    if cfg.is_encoder_decoder:
        frames = rng.randn(9, cfg.d_model).astype(np.float32) * 0.02
    if cfg.frontend == "vision":
        patches = rng.randn(5, cfg.d_model).astype(np.float32) * 0.02
    return frames, patches


class Engines:
    """``get(clock=, admission=, **settings)``: (reference engine, port
    engine) with ``ENGINE`` updated by the settings, built once per
    setting and ``reset()`` on every later get."""

    def __init__(self, pair):
        self.pair = pair
        self.memo = {}

    def get(self, clock=(None, None), admission=None, **kw):
        kw = {**ENGINE, **kw}
        key = tuple(sorted(kw.items()))
        if key in self.memo:
            for eng in self.memo[key]:
                eng.reset()
        else:
            ref_model, ref_params, model, params = self.pair
            self.memo[key] = (
                ref_serve.ServeEngine(ref_model, ref_params, **kw),
                ServeEngine(model, params, device="cpu", **kw))
        for eng, clk in zip(self.memo[key], clock):
            eng.set_clock(clk or time.monotonic)
            eng.set_admission(admission)
        return self.memo[key]


def submit(eng, prompt, n, **kw):
    frames, patches = modal_inputs(eng.model.cfg)
    return eng.submit(prompt, max_new_tokens=n, frames=frames,
                      patches=patches, **kw)


def serve(eng, requests):
    """(streams [(id, tokens, status)], admission logits) of
    ``requests`` [(prompt, max_new)] with the family's modal inputs."""
    seen = []
    prefill = eng._prefill_into_slot

    def recording(slot, req):
        logits = prefill(slot, req)
        seen.append(np.asarray(logits))
        return logits

    eng._prefill_into_slot = recording
    try:
        for prompt, n in requests:
            submit(eng, prompt, n)
        return [(r.request_id, r.tokens, r.status) for r in eng.run()], seen
    finally:
        del eng._prefill_into_slot


def check_streams(engines, requests, decode_block=7, **kw):
    """The port's engine at ``decode_block`` against the reference's at
    K 7 on ``requests``: streams and statuses equal, admission logits
    within 1e-5.  Returns the port's engine and streams."""
    ref, _ = engines.get(**kw)
    want, want_logits = serve(ref, requests)
    port = engines.get(decode_block=decode_block, **kw)[1]
    got, got_logits = serve(port, requests)
    assert got == want
    assert all(s == "ok" for _, _, s in got)
    assert len(got_logits) == len(want_logits) == len(requests)
    for a, b in zip(got_logits, want_logits):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
    return port, got


def view(results):
    return sorted((r.request_id, r.status, list(r.tokens)) for r in results)


def both(engines, script, **kw):
    """``script(engine)`` on the reference's and the port's engine: the
    results and the accounting must be equal.  Returns the port's
    engine and the script's value on each."""
    ref, port = engines.get(**kw)
    want, got = script(ref), script(port)
    assert view(port.results) == view(ref.results)
    acc = port.accounting()
    assert acc == ref.accounting() and acc["balanced"]
    return port, got, want


def by_id(results):
    return {r.request_id: r for r in results}


# --------------------------------------------------------------------- #
# scripts shared by both families
# --------------------------------------------------------------------- #

def fault_isolation(engines, kv_format):
    """``tests/test_serve_robust.py::test_fault_isolation_per_family``:
    a ``logits_nan`` fault in one slot finishes only that request with
    the clean run's first 9 tokens, the survivor's stream is the clean
    run's, and the slot serves the same request again to the clean
    stream; every status and stream the reference's."""
    _, oracle = engines.get(kv_format=kv_format)
    submit(oracle, PA, N_LONG)
    submit(oracle, PB, N_LONG)
    want = {r.request_id: r.tokens for r in oracle.run()}

    def script(eng):
        a = submit(eng, PA, N_LONG)
        b = submit(eng, PB, N_LONG)
        eng.decode_loop()                  # admit both, 1 + 7 tokens each
        eng.inject_fault(a, "logits_nan", delay=1)
        res = by_id(eng.run())
        c = submit(eng, PA, N_LONG)        # the recovered slot
        res2 = by_id(eng.run())
        return a, b, c, res, res2, eng.watchdog_report()["ok"]

    eng, (a, b, c, res, res2, watch_ok), _ = both(engines, script,
                                                  kv_format=kv_format)
    assert res[a].status == "faulted" and res[a].tokens == want[a][:9]
    assert res[b].status == "ok" and res[b].tokens == want[b]
    acc = eng.accounting()
    assert acc["faulted"] == 1 and acc["ok"] == 2
    assert res2[c].status == "ok" and res2[c].tokens == want[a]
    assert watch_ok and not eng._armed


def cancel_inflight_and_queued(engines):
    """Three requests over two slots: the queued one cancels without a
    device step, an in-flight one with its partial tokens; the other
    finishes and the freed slot serves a new request."""
    def script(eng):
        a = submit(eng, PA, N_LONG)
        b = submit(eng, PB, N_LONG)
        c = submit(eng, [5, 6], N_LONG)
        eng.decode_loop()                  # a, b in flight, c queued
        out = [eng.cancel(c), eng.cancel(a), eng.cancel(a), eng.cancel(999)]
        acc = eng.accounting()
        d = submit(eng, [7, 8, 9], 8)
        res = by_id(eng.run())
        return (a, b, c, d, out, acc, res, eng.watchdog_report()["ok"])

    _, (a, b, c, d, out, acc, res, watch_ok), _ = both(engines, script)
    assert out == [True, True, False, False]
    assert acc["in_flight"] == 1 and acc["queued"] == 0 and acc["balanced"]
    assert res[c].status == "shed" and res[c].tokens == []
    assert res[a].status == "shed" and len(res[a].tokens) == 8
    assert res[b].status == res[d].status == "ok" and watch_ok


def deadlines_with_virtual_clock(engines):
    """An expired queued request never spends its encode or prefill, an
    expired in-flight one is cancelled with its partial tokens (admission
    and the first block give 8, the block that passes the deadline 7
    more)."""
    clocks = ([0.0], [0.0])

    def script(eng):
        now = clocks[isinstance(eng, ServeEngine)]
        a = submit(eng, PA, 40)
        b = submit(eng, PB, 40)
        c = submit(eng, [5, 6, 7], 8)
        eng.decode_loop()                  # a, b in flight, c queued
        now[0] = 10.0                      # past every deadline
        eng.run()
        res = by_id(eng.results)
        d = submit(eng, [8, 9], 8)
        return res[a], res[c], by_id(eng.run())[d].status

    eng, (ra, rc, status_d), _ = both(
        engines, script, admission=ref_serve.AdmissionConfig(
            deadline_ms=100.0),
        clock=(lambda: clocks[0][0], lambda: clocks[1][0]))
    assert ra.status == "deadline_exceeded" and len(ra.tokens) == 15
    assert rc.status == "deadline_exceeded" and rc.tokens == []
    assert status_d == "ok"
    assert eng.accounting()["deadline_exceeded"] == 3


SPEC = dict(draft_tokens=3, ngram_table=64)


def ngram_spec_streams(engines, kv_format):
    """n-gram speculation (3 drafts, a table of 64) on the family: the
    port's speculative streams are the reference's non-speculative ones
    at K 7, and the reference's speculative engine gives the same
    streams and the port's ``spec_report``."""
    requests = [(PA, N_LONG), (PB, N_SHORT)]
    want, _ = serve(engines.get(kv_format=kv_format)[0], requests)
    ref_model, ref_params, model, params = engines.pair
    settings = dict(ENGINE, kv_format=kv_format)
    port = ServeEngine(model, params, device="cpu",
                       spec=SpecConfig(**SPEC), **settings)
    got, _ = serve(port, requests)
    assert got == want
    assert all(s == "ok" for _, _, s in got)
    ref = ref_serve.ServeEngine(ref_model, ref_params,
                                spec=ref_serve.SpecConfig(**SPEC),
                                **settings)
    assert serve(ref, requests)[0] == want
    rep = port.spec_report()
    assert rep == ref.spec_report() and rep["blocks"] > 0
    return rep


def ref_decode_step(ref_model, ref_params):
    step = jax.jit(ref_model.decode_step)

    def run(cache, tok, pos):
        return step(ref_params, cache, jnp.asarray(tok),
                    jnp.full((tok.shape[0],), pos, jnp.int32))
    return run


def close(got, want, atol=1e-5, rtol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


def raw_bytes(t):
    if isinstance(t, torch.Tensor):
        return t.view(torch.uint8).numpy() if t.element_size() == 1 \
            else t.numpy()
    a = np.asarray(t)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


def codes_within_one_step(got, want, fmt: str, label: str) -> None:
    """Stored codes of ``fmt`` equal to the reference's but where an fp32
    input sits on a rounding boundary of the format: at most 1 in 1000
    codes differ, each with the same sign and by one code (the
    neighbouring magnitude).  Two fp32 programs that sum in different
    orders round a value on a boundary to either side."""
    a, b = (torch.from_numpy(raw_bytes(x).copy()).to(torch.int32)
            for x in (got, want))
    spec = compat.dtype_spec(fmt)
    if spec.packed is not None:
        a, b = (lowbits.unpack_codes(x.to(torch.uint8), fmt) for x in (a, b))
    sign = 1 << (spec.bits - 1)
    diff = a != b
    assert int(diff.sum()) <= max(1, diff.numel() // 1000), (
        f"{label}: {int(diff.sum())} of {diff.numel()} codes differ")
    a, b = a[diff], b[diff]
    assert ((a & sign) == (b & sign)).all(), f"{label}: a sign differs"
    assert ((a - b).abs() == 1).all(), f"{label}: codes {a} against {b}"


def check_ring(got: dict, want: dict, label: str,
               kv_format: Optional[str] = None) -> None:
    """A ring cache part against the reference's: ``slot_pos`` and the
    e8m0 scales byte for byte, dense K/V within 1e-5, quantized codes
    byte for byte, or with ``kv_format`` given within one step at a
    rounding boundary (:func:`codes_within_one_step`)."""
    assert set(got) == set(want), label
    for name in want:
        assert tuple(got[name].shape) == want[name].shape, (label, name)
        if name in ("k", "v"):
            close(got[name], want[name])
        elif kv_format and name in ("k_q", "v_q"):
            codes_within_one_step(got[name], want[name], kv_format,
                                  f"{label}/{name}")
        else:
            np.testing.assert_array_equal(raw_bytes(got[name]),
                                          raw_bytes(want[name]),
                                          err_msg=f"{label}/{name}")


def kv_stats_match(pair, kv_format):
    """``kv_stats`` of an engine equal the reference engine's: bytes
    (``cross_kv_bytes`` too), bytes per element and per token, and the
    per-layer names and widths (``"pos{i}.cross"`` for cross rings)."""
    ref_model, ref_params, model, params = pair
    ref = ref_serve.ServeEngine(ref_model, ref_params, kv_format=kv_format,
                                **ENGINE)
    port = ServeEngine(model, params, device="cpu", kv_format=kv_format,
                       **ENGINE)
    assert port.kv_stats == ref.kv_stats
    return port.kv_stats
