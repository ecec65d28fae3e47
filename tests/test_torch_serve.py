"""The port's ServeEngine against the reference's, on the CPU.

Both engines serve gptneox-1b reduced with the same weights (the
reference's init, carried across by ``repro_torch.bridge``) and the same
prompts.  Greedy token streams and statuses must be identical; the
admission (prefill) logits agree within 1e-4 and the pooled KV cache
within 1e-5 (fp32, different summation orders); ``slot_pos`` is equal.
"""

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
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve import ServeEngine, SpecConfig  # noqa: E402


@pytest.fixture(scope="module")
def models():
    ref_model = ref_build_model(ref_get_config("gptneox-1b").reduced())
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten(ref_params).items()}
    cfg = get_config("gptneox-1b").reduced()
    params = bridge.params_from_numpy(flat, cfg, "cpu")
    return ref_model, ref_params, build_model(cfg), params


def _engines(models, **kw):
    ref_model, ref_params, model, params = models
    return (RefEngine(ref_model, ref_params, **kw),
            ServeEngine(model, params, device="cpu", **kw))


def _record_admission_logits(eng):
    """Wrap the engine's prefill so each admission's logits are kept."""
    seen = []
    prefill = eng._prefill_into_slot

    def recording(slot, req):
        logits = prefill(slot, req)
        seen.append(np.asarray(logits))
        return logits

    eng._prefill_into_slot = recording
    return seen


def _streams(results):
    return [(r.request_id, r.tokens, r.status) for r in results]


@pytest.mark.parametrize("decode_block", [7, 1])
def test_greedy_streams_logits_and_cache_match_reference(models,
                                                          decode_block):
    """The replay of tests/test_serve_fused.py::
    test_fused_loop_matches_per_step (dense KV): a request that finishes
    mid-block beside a longer one, fused K=7 and per-step K=1."""
    engines = _engines(models, batch=2, max_seq=64,
                       decode_block=decode_block, prefill_chunk=4)
    logits = [_record_admission_logits(e) for e in engines]
    for eng in engines:
        eng.submit([1, 2, 3, 4, 5, 6, 7], max_new_tokens=12)
        eng.submit([9, 8, 7], max_new_tokens=4)
    ref, port = (_streams(e.run()) for e in engines)
    assert port == ref
    assert [len(t) for _, t, _ in port] == [12, 4]
    assert all(s == "ok" for _, _, s in port)

    assert len(logits[0]) == len(logits[1]) == 2
    for a, b in zip(*logits):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4)

    ref_kv = engines[0].cache["pos0"]["kv"]
    kv = engines[1].cache["pos0"]["kv"]
    for name in ("k", "v"):
        np.testing.assert_allclose(kv[name].numpy(), np.asarray(ref_kv[name]),
                                   atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(kv["slot_pos"].numpy(),
                                  np.asarray(ref_kv["slot_pos"]))


def test_truncation_matches_reference(models):
    """run(max_steps) flushes in-flight requests as ``truncated`` with
    the same partial tokens."""
    engines = _engines(models, batch=2, max_seq=64, decode_block=3,
                       prefill_chunk=4)
    for eng in engines:
        eng.submit([5, 6, 7, 8], max_new_tokens=20)
        eng.submit([11, 12], max_new_tokens=20)
    ref, port = (_streams(e.run(max_steps=5)) for e in engines)
    assert port == ref
    assert {s for _, _, s in port} == {"truncated"}
    assert not engines[1].state["active"].any()


def test_max_seq_finish_matches_reference(models):
    """A request stops at position max_seq - 1 before its token budget,
    with a third request queued behind a full pool."""
    engines = _engines(models, batch=2, max_seq=32, decode_block=5,
                       prefill_chunk=8)
    for eng in engines:
        eng.submit(list(range(3, 28)), max_new_tokens=30)   # 25 + 30 > 31
        eng.submit([4, 4, 4], max_new_tokens=6)
        eng.submit([7, 1, 9, 2], max_new_tokens=5)
    ref, port = (_streams(e.run()) for e in engines)
    assert port == ref
    assert len(port[0][1]) == 32 - 1 - 25 + 1 < 30
    assert [len(t) for _, t, _ in port[1:]] == [6, 5]


@pytest.mark.parametrize("kwargs", [
    {"mesh": object()}, {"mesh": object(), "spec": SpecConfig()},
    {"mesh": object(), "spec": object()}])
def test_later_slice_options_raise(models, kwargs):
    """Mesh serving is not ported, with or without speculation
    (speculation is, in ``tests/test_torch_serve_spec.py``; admission
    policies in ``tests/test_torch_serve_robust.py``)."""
    _, _, model, params = models
    with pytest.raises(NotImplementedError):
        ServeEngine(model, params, batch=1, max_seq=16, device="cpu",
                    **kwargs)


def test_cancel_and_inject_fault_raise(models):
    """Cancel and fault injection are ported (``tests/
    test_torch_serve_robust.py``); what they refuse raises: a fault
    against a request that is not in flight, a status that is not a
    terminal one.  A queued request cancels without a device step."""
    _, _, model, params = models
    eng = ServeEngine(model, params, batch=1, max_seq=16, device="cpu")
    rid = eng.submit([1, 2], max_new_tokens=2)
    with pytest.raises(KeyError, match="not in flight"):
        eng.inject_fault(rid)
    with pytest.raises(ValueError, match="not in"):
        eng.cancel(rid, status="gone")
    assert eng.cancel(rid) and eng.decode_steps == 0
    assert [(r.status, r.tokens) for r in eng.results] == [("shed", [])]


def test_submit_validation(models):
    _, _, model, params = models
    eng = ServeEngine(model, params, batch=1, max_seq=16, device="cpu")
    with pytest.raises(ValueError):
        eng.submit([1, 2], max_new_tokens=0)
    with pytest.raises(ValueError):
        eng.submit(list(range(16)), max_new_tokens=1)


def test_non_finite_logits_fault_the_slot(models):
    """The in-loop sentinel: a slot whose logits go non-finite finishes
    ``faulted`` with the tokens it had, is evicted, and the other slot's
    stream is the one it has alone."""
    _, _, model, params = models

    def serve(poison):
        eng = ServeEngine(model, params, batch=2, max_seq=64,
                          decode_block=4, prefill_chunk=4, device="cpu")
        eng.submit([1, 2, 3], max_new_tokens=8)
        eng.submit([4, 5, 6], max_new_tokens=8)
        if poison:
            eng._admit()
            # a NaN in slot 0's cache poisons its attention and logits
            eng.cache["pos0"]["kv"]["v"][:, 0, 1] = float("nan")
        return _streams(eng.run()), eng

    clean, _ = serve(False)
    hurt, eng = serve(True)
    assert hurt[0][2] == "faulted" and hurt[0][1] == clean[0][1][:1]
    assert hurt[1] == clean[1]
    assert (eng.cache["pos0"]["kv"]["slot_pos"][:, 0] == -1).all()
    assert torch.isnan(eng.cache["pos0"]["kv"]["v"][:, 0, 1]).all()
