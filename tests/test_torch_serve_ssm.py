"""The port's ServeEngine against the reference's on mamba2-2.7b reduced
(the SSM slice), on the CPU.

Both engines serve the same weights (the reference's init, carried
across by ``repro_torch.bridge``) and the same prompts.  Greedy token
streams and statuses must be identical.  The admission logits agree
within 1e-4, and the slot state after prefill (conv carries and the
fp32 SSD state) within 1e-5 (fp32; the summation orders differ).
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
from repro_torch.kernels import ssd_scan as kss  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

# the prompt of tests/test_serve_unified.py::
# test_chunked_prefill_ssm_state_carry: 20 tokens, chunks of 8 -> two
# full chunks and a partly valid tail
PROMPT_20 = [int(2 + (i * 11) % 300) for i in range(20)]


@pytest.fixture(scope="module")
def models():
    ref_model = ref_build_model(ref_get_config("mamba2-2.7b").reduced())
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten(ref_params).items()}
    cfg = get_config("mamba2-2.7b").reduced()
    params = bridge.params_from_numpy(flat, cfg, "cpu")
    return ref_model, ref_params, build_model(cfg), params


def _engines(models, **kw):
    ref_model, ref_params, model, params = models
    return (RefEngine(ref_model, ref_params, **kw),
            ServeEngine(model, params, device="cpu", **kw))


def _streams(results):
    return [(r.request_id, r.tokens, r.status) for r in results]


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


def _assert_ssm_pool_close(engines):
    """The conv carries and fp32 state of every pool row, port against
    reference, within 1e-5."""
    ref_ssm = engines[0].cache["pos0"]["ssm"]
    port_ssm = engines[1].cache["pos0"]["ssm"]
    assert set(port_ssm) == set(ref_ssm) == {"conv_x", "conv_b", "conv_c",
                                             "state"}
    for name, leaf in port_ssm.items():
        want = np.asarray(ref_ssm[name])
        assert leaf.shape == want.shape and leaf.dtype == torch.float32
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(leaf.numpy(), want, atol=1e-5, rtol=0)


def test_chunked_prefill_state_carry_matches_reference(models):
    """The 20-token, chunk-8 case of tests/test_serve_unified.py: conv
    tails and the SSD state carried across chunk boundaries, the tail
    chunk's invalid positions identity steps."""
    engines = _engines(models, batch=2, max_seq=64, decode_block=4,
                       prefill_chunk=8)
    for eng in engines:
        eng.submit(PROMPT_20, max_new_tokens=6)
    ref, port = (_streams(e.run()) for e in engines)
    assert port == ref
    assert len(port[0][1]) == 6 and port[0][2] == "ok"


@pytest.mark.parametrize("decode_block", [4, 1])
def test_slot_reuse_streams_match_reference(models, decode_block):
    """Batch 2, three requests of different lengths: the short request
    finishes first and its slot is evicted and reused by the third, so a
    stale carry or state would change the third stream (``clear_slot``
    must zero the recurrent row).  Fused K=4 and per-step K=1."""
    engines = _engines(models, batch=2, max_seq=64,
                       decode_block=decode_block, prefill_chunk=8)
    logits = [_record_admission_logits(e) for e in engines]
    for eng in engines:
        eng.submit(PROMPT_20, max_new_tokens=9)
        eng.submit([3, 4, 5], max_new_tokens=2)
        eng.submit([7, 1, 7, 1, 7, 1, 7, 1, 7, 1, 7], max_new_tokens=5)
    ref, port = (_streams(e.run()) for e in engines)
    assert port == ref
    assert [len(t) for _, t, _ in port] == [9, 2, 5]
    assert all(s == "ok" for _, _, s in port)
    # the third admission and the pool after the run see no stale state
    assert len(logits[0]) == len(logits[1]) == 3
    for a, b in zip(*logits):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4)
    _assert_ssm_pool_close(engines)


def test_slot_state_after_prefill_matches_reference(models):
    """Admission only: the admission logits, and the pool's conv carries
    and fp32 state for both slots (one prompt per slot, 20 and 5 tokens:
    the second ends with valid_len 5 in its only chunk)."""
    engines = _engines(models, batch=2, max_seq=64, decode_block=4,
                       prefill_chunk=8)
    logits = [_record_admission_logits(e) for e in engines]
    for eng in engines:
        eng.submit(PROMPT_20, max_new_tokens=4)
        eng.submit([9, 8, 7, 6, 5], max_new_tokens=4)
        eng._admit()
    for a, b in zip(*logits):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4)
    _assert_ssm_pool_close(engines)
    assert engines[1].kv_stats["kv_bytes"] == 0 == \
        engines[0].kv_stats["kv_bytes"]


def test_prefill_runs_the_ssd_scan_path(models):
    """Every prefill chunk of every layer goes through ``ssd_scan``: on
    CPU tensors that is its plain version (3 chunks x 2 layers), with no
    kernel launch."""
    _, _, model, params = models
    eng = ServeEngine(model, params, batch=1, max_seq=64, decode_block=4,
                      prefill_chunk=8, device="cpu")
    eng.submit(PROMPT_20, max_new_tokens=2)
    calls, launches = kss.ssd_scan_plain.calls, kss.ssd_scan.launches
    eng.run()
    assert kss.ssd_scan_plain.calls - calls == 3 * model.cfg.n_layers
    assert kss.ssd_scan.launches == launches


def test_reset_and_clear_slot_zero_the_recurrent_state(models):
    _, _, model, params = models
    eng = ServeEngine(model, params, batch=2, max_seq=64, decode_block=4,
                      prefill_chunk=8, device="cpu")
    eng.submit(PROMPT_20, max_new_tokens=3)
    eng.submit([5, 6, 7], max_new_tokens=3)
    eng._admit()
    part = eng.cache["pos0"]["ssm"]
    assert all(leaf[:, 1].abs().max() > 0 for leaf in part.values())
    model.clear_slot(eng.cache, 1)
    assert all((leaf[:, 1] == 0).all() for leaf in part.values())
    assert all(leaf[:, 0].abs().max() > 0 for leaf in part.values())
    eng.reset()
    assert all((leaf == 0).all() for leaf in part.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_hands_the_kernel_what_it_takes(models, monkeypatch, dtype):
    """Every ``ssd_scan`` call of the serving path passes the kernel's
    own input checks (``check_kernel_inputs``: shapes, dtypes,
    contiguity) on the CPU too, in fp32 and at the bf16 compute dtype of
    the full config (x and dt_a fp32, b / c bf16), ragged tail included."""
    import dataclasses
    from repro_torch.serve import quantize_params
    _, _, model, params = models
    cfg = dataclasses.replace(model.cfg, param_dtype=dtype,
                              compute_dtype=dtype)
    params, _ = quantize_params(params, dtype)
    seen = []
    plain = kss.ssd_scan_plain

    def checked(x, dt_a, b, c, chunk, initial_state=None):
        kss.check_kernel_inputs(x, dt_a, b, c, chunk, initial_state)
        seen.append((x.dtype, b.dtype))
        return plain(x, dt_a, b, c, chunk, initial_state)

    checked.calls = 0
    monkeypatch.setattr(kss, "ssd_scan_plain", checked)
    eng = ServeEngine(build_model(cfg), params, batch=2, max_seq=64,
                      decode_block=4, prefill_chunk=16, device="cpu")
    eng.submit(PROMPT_20, max_new_tokens=2)
    eng.run()
    bc = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert seen == [(torch.float32, bc)] * (2 * cfg.n_layers)
