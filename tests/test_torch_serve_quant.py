"""Quantized serving: the port's ServeEngine against the reference's on
gptneox-1b reduced (head_dim 16, so the KV scale block is 16), on the
CPU, with the reference's weights carried across by
``repro_torch.bridge``.

For ``kv_format`` in {fp8 e4m3, fp4} x ``weight_format`` in {None, fp4
packed}, plus ``kv_format`` fp6 e3m2 alone, at fused K=7: greedy streams
and statuses identical; admission logits within atol 1e-4 (fp32,
different summation orders); the quantized cache bytes and ``slot_pos``
identical; the weight store's bytes identical and ``weight_stats`` /
``kv_stats`` equal (bytes exactly, mse within rtol 1e-5).
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
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import flash_decode_quant as fdq  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402


@pytest.fixture(scope="module")
def models():
    ref_model = ref_build_model(ref_get_config("gptneox-1b").reduced())
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten(ref_params).items()}
    cfg = get_config("gptneox-1b").reduced()
    params = bridge.params_from_numpy(flat, cfg, "cpu")
    return ref_model, ref_params, build_model(cfg), params


def _np(t):
    """A leaf as comparable numpy: 1-byte dtypes as their bytes, bf16 as
    its float32 values."""
    if isinstance(t, torch.Tensor):
        if t.element_size() == 1:
            return t.view(torch.uint8).numpy()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    if a.dtype.name == "bfloat16":
        return a.astype(np.float32)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


def _assert_stats_equal(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        if key == "mse":
            np.testing.assert_allclose(got[key], value, rtol=1e-5)
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("kv_format,weight_format", [
    ("float8_e4m3fn", None), ("float4_e2m1fn", None),
    ("float8_e4m3fn", "float4_e2m1fn"), ("float4_e2m1fn", "float4_e2m1fn"),
    ("float6_e3m2fn", None)])
def test_quantized_serving_matches_reference(models, kv_format,
                                             weight_format):
    ref_model, ref_params, model, params = models
    kw = dict(batch=2, max_seq=64, decode_block=7, prefill_chunk=4,
              kv_format=kv_format, weight_format=weight_format)
    engines = (RefEngine(ref_model, ref_params, **kw),
               ServeEngine(model, params, device="cpu", **kw))
    logits = [[], []]
    for eng, seen in zip(engines, logits):
        prefill = eng._prefill_into_slot

        def recording(slot, req, prefill=prefill, seen=seen):
            out = prefill(slot, req)
            seen.append(np.asarray(out))
            return out

        eng._prefill_into_slot = recording
        eng.submit([1, 2, 3, 4, 5, 6, 7], max_new_tokens=12)
        eng.submit([9, 8, 7], max_new_tokens=4)
    before = fdq.flash_decode_quant.launches, fd.flash_decode.launches
    ref, port = ([(r.request_id, r.tokens, r.status) for r in e.run()]
                 for e in engines)
    assert port == ref
    assert [len(t) for _, t, _ in port] == [12, 4]
    assert all(s == "ok" for _, _, s in port)
    # the CPU takes the plain versions: no kernel launch is counted
    assert (fdq.flash_decode_quant.launches,
            fd.flash_decode.launches) == before
    for a, b in zip(*logits):
        np.testing.assert_allclose(b, a, atol=1e-4, rtol=1e-4)

    ref_eng, eng = engines
    for name, entry in ref_eng.cache.items():
        want = entry["kv"]
        got = eng.cache[name]["kv"]
        assert set(got) == set(want) == {"k_q", "k_s", "v_q", "v_s",
                                         "slot_pos"}
        for leaf in want:
            np.testing.assert_array_equal(_np(got[leaf]), _np(want[leaf]))
    _assert_stats_equal(eng.kv_stats, ref_eng.kv_stats)
    if weight_format is None:
        assert eng.weight_store is None and eng.weight_stats is None
        return
    _assert_stats_equal(eng.weight_stats, ref_eng.weight_stats)
    store = {}
    for key, value in bridge.flatten(eng.weight_store).items():
        if isinstance(value, tuple):            # "shape", flattened as
            store.update({f"{key}/{i}": x      # the reference does
                          for i, x in enumerate(value)})
        else:
            store[key] = value
    ref_store = _flatten(ref_eng.weight_store)
    assert set(store) == set(ref_store)
    for key, want in ref_store.items():
        got = store[key]
        if isinstance(got, torch.Tensor):
            np.testing.assert_array_equal(_np(got), _np(want), err_msg=key)
        else:
            assert got == want, key
    dense = bridge.flatten(eng.params)
    for key, want in _flatten(ref_eng.params).items():
        np.testing.assert_array_equal(_np(dense[key]), _np(want),
                                      err_msg=key)


def test_reset_clears_quantized_pool_and_kv_formats_tuple(models):
    """``reset()`` zeroes the codes and scales and empties ``slot_pos``;
    a tuple of formats becomes ``cfg.kv_formats``."""
    _, _, model, params = models
    eng = ServeEngine(model, params, batch=2, max_seq=32, device="cpu",
                      kv_format=("float4_e2m1fn",))
    assert eng.model.cfg.kv_formats == ("float4_e2m1fn",)
    assert eng.kv_stats["per_layer"]["pos0"]["format"] == "float4_e2m1fn"
    eng.submit([3, 1, 4, 1, 5], max_new_tokens=3)
    eng.run()
    kv = eng.cache["pos0"]["kv"]
    assert (kv["slot_pos"] >= 0).any() and kv["k_q"].any()
    eng.reset()
    assert (kv["slot_pos"] == -1).all()
    for leaf in ("k_q", "k_s", "v_q", "v_s"):
        assert not kv[leaf].any()
