"""The port's whole-sequence path against the reference's, on the CPU:
``Model.forward`` / ``Model.features`` (scoring) and ``Model.prefill``
followed by ``Model.decode_step`` (whole-prompt prefill, then greedy
decode), on gptneox-1b reduced (GQA 4/2) and mamba2-2.7b reduced.

Both packages run the same config with the reference's weights (carried
across by ``repro_torch.bridge``) on the same tokens, made with numpy
from a seed.  gptneox runs twice: with ``attn_chunk`` 1024 (the plain
attention takes ``full_attention``) and 16 on both sides (it takes
``chunked_attention``).  Tolerances (fp32, summation order only):

* forward and prefill logits atol = rtol = 1e-4, the tolerance
  ``tests/test_torch_serve.py`` holds admission logits to;
* the prefill cache: dense K/V atol = rtol = 1e-5, ``slot_pos`` equal,
  quantized codes and scales byte-identical; SSM conv carries and state
  atol 1e-5 (``tests/test_torch_ssm.py``'s block tolerance);
* prefill logits identical for dense and quantized KV (the prompt
  attends its own K/V before quantization), as
  ``tests/test_kv_quant.py::test_model_decode_quantized_kv_tracks_dense``;
* prefill then teacher-forced decode steps against the forward logits
  within 5e-4, ``tests/test_decode_consistency.py``'s bound; prefill then
  greedy decode gives the reference's token stream exactly.
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
from repro.models import ssm as ref_ssm  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.kernels import ssd_scan as kss  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

S, P = 48, 32                 # tokens, prompt: tests/test_decode_consistency
QUANT = ("float8_e4m3fn", "float4_e2m1fn")


@pytest.fixture(scope="module")
def weights():
    """{arch: (reference params, the port's)} from the reference's init."""
    out = {}
    for arch in ("gptneox-1b", "mamba2-2.7b"):
        ref_params = ref_build_model(ref_get_config(arch).reduced()).init(
            jax.random.PRNGKey(0))
        flat = {k: np.asarray(v) for k, v in _flatten(ref_params).items()}
        out[arch] = (ref_params, bridge.params_from_numpy(
            flat, get_config(arch).reduced(), "cpu"))
    return out


def _models(arch, **overrides):
    return (ref_build_model(dataclasses.replace(
                ref_get_config(arch).reduced(), **overrides)),
            build_model(dataclasses.replace(get_config(arch).reduced(),
                                            **overrides)))


def _tokens(seed, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (2, S)).astype(
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


def _greedy(step, logits, cache, n):
    """``n`` greedy tokens after the prefill logits: the stream, and the
    logits of every step."""
    stream, seen = [], []
    tok = logits.argmax(-1)
    for i in range(n):
        stream.append(np.asarray(tok).tolist())
        logits, cache = step(cache, tok, P + i)
        seen.append(np.asarray(logits))
        tok = logits.argmax(-1)
    return stream, seen


def _ref_step(ref_model, ref_params):
    step = jax.jit(ref_model.decode_step)

    def run(cache, tok, pos):
        return step(ref_params, cache, tok, jnp.full((2,), pos, jnp.int32))
    return run


def _port_step(model, params):
    def run(cache, tok, pos):
        out = model.decode_step(params, cache, tok,
                                torch.full((2,), pos, dtype=torch.int32))
        return out, cache
    return run


# --------------------------------------------------------------------- #
# gptneox-1b reduced
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("attn_chunk", [1024, 16])
def test_forward_matches_reference(weights, attn_chunk):
    ref_params, params = weights["gptneox-1b"]
    ref_model, model = _models("gptneox-1b", attn_chunk=attn_chunk)
    tokens = _tokens(1, model.cfg.vocab_size)
    want, ref_aux = jax.jit(ref_model.forward)(ref_params,
                                               {"tokens": tokens})
    calls = kfa.flash_attention_plain.calls
    launches = kfa.flash_attention.launches
    batch = {"tokens": torch.from_numpy(tokens)}
    logits, aux = model.forward(params, batch)
    assert (kfa.flash_attention_plain.calls - calls,
            kfa.flash_attention.launches) == (model.cfg.n_layers, launches)
    assert logits.dtype == torch.float32 and logits.shape == want.shape
    _close(logits, want, 1e-4, 1e-4)
    assert set(aux) == set(ref_aux) and not any(v.item() for v in
                                                aux.values())
    feats, _ = model.features(params, batch)
    torch.testing.assert_close(feats @ model.unembed_weight(params),
                               logits, atol=0, rtol=0)


@pytest.mark.parametrize("kv_format", [None, *QUANT])
@pytest.mark.parametrize("attn_chunk", [1024, 16])
def test_prefill_matches_reference(weights, attn_chunk, kv_format):
    """Logits and every cache leaf; quantized caches byte for byte, and
    their prefill logits equal to the dense model's."""
    ref_params, params = weights["gptneox-1b"]
    ref_model, model = _models("gptneox-1b", attn_chunk=attn_chunk,
                               kv_format=kv_format)
    tokens = _tokens(2, model.cfg.vocab_size)[:, :P]
    want, ref_cache = jax.jit(lambda p, b: ref_model.prefill(p, b, S + 8))(
        ref_params, {"tokens": tokens})
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(
        tokens)}, S + 8)
    assert logits.shape == want.shape == (2, model.cfg.vocab_size)
    _close(logits, want, 1e-4, 1e-4)
    kv, ref_kv = cache["pos0"]["kv"], ref_cache["pos0"]["kv"]
    assert set(kv) == set(ref_kv)
    for name in ref_kv:
        assert tuple(kv[name].shape) == ref_kv[name].shape, name
        if name in ("k", "v"):
            _close(kv[name], ref_kv[name], 1e-5, 1e-5)
        else:
            np.testing.assert_array_equal(_bytes(kv[name]),
                                          _bytes(ref_kv[name]), err_msg=name)
    if kv_format is not None:
        dense = _models("gptneox-1b", attn_chunk=attn_chunk)[1]
        torch.testing.assert_close(
            dense.prefill(params, {"tokens": torch.from_numpy(tokens)},
                          S + 8)[0], logits, atol=0, rtol=0)


@pytest.mark.parametrize("attn_chunk", [1024, 16])
def test_prefill_then_decode_matches_forward_and_reference(weights,
                                                           attn_chunk):
    """tests/test_decode_consistency.py::test_decode_matches_forward on
    the port (prefill P tokens, then decode tokens P..S-1 teacher-forced,
    each step's logits against the forward's), and prefill + greedy
    decode against the reference's stream."""
    ref_params, params = weights["gptneox-1b"]
    ref_model, model = _models("gptneox-1b", attn_chunk=attn_chunk)
    _consistency_and_stream(ref_model, ref_params, model, params, seed=3)


def _consistency_and_stream(ref_model, ref_params, model, params, seed):
    tokens = _tokens(seed, model.cfg.vocab_size)
    tt = torch.from_numpy(tokens)
    full, _ = model.forward(params, {"tokens": tt})
    logits, cache = model.prefill(params, {"tokens": tt[:, :P]}, S + 8)
    errs = [(logits - full[:, P - 1]).abs().max().item()]
    for t in range(P, S):
        lg = model.decode_step(params, cache, tt[:, t],
                               torch.full((2,), t, dtype=torch.int32))
        errs.append((lg - full[:, t]).abs().max().item())
    assert max(errs) < 5e-4, f"decode diverges {max(errs):.2e}"

    n = S - P
    ref_logits, ref_cache = jax.jit(
        lambda p, b: ref_model.prefill(p, b, S + 8))(
        ref_params, {"tokens": tokens[:, :P]})
    want, want_logits = _greedy(_ref_step(ref_model, ref_params),
                                ref_logits, ref_cache, n)
    logits, cache = model.prefill(params, {"tokens": tt[:, :P]}, S + 8)
    got, got_logits = _greedy(_port_step(model, params), logits, cache, n)
    assert got == want
    for a, b in zip(got_logits, want_logits):
        _close(a, b, 1e-4, 1e-4)


# --------------------------------------------------------------------- #
# mamba2-2.7b reduced
# --------------------------------------------------------------------- #

def test_mamba2_forward_and_prefill_match_reference(weights):
    """Forward logits, prefill logits and the prefill's SSM carries and
    state (every layer); the SSD core runs through the plain version
    once per layer and call."""
    ref_params, params = weights["mamba2-2.7b"]
    ref_model, model = _models("mamba2-2.7b")
    tokens = _tokens(4, model.cfg.vocab_size)
    tt = torch.from_numpy(tokens)
    want, _ = jax.jit(ref_model.forward)(ref_params, {"tokens": tokens})
    calls = kss.ssd_scan_plain.calls
    logits, _ = model.forward(params, {"tokens": tt})
    _close(logits, want, 1e-4, 1e-4)
    want, ref_cache = jax.jit(lambda p, b: ref_model.prefill(p, b, S + 8))(
        ref_params, {"tokens": tokens[:, :45]})
    logits, cache = model.prefill(params, {"tokens": tt[:, :45]}, S + 8)
    assert kss.ssd_scan_plain.calls - calls == 2 * model.cfg.n_layers
    _close(logits, want, 1e-4, 1e-4)
    assert set(cache) == set(ref_cache)
    for name, leaf in cache["pos0"]["ssm"].items():
        ref_leaf = ref_cache["pos0"]["ssm"][name]
        assert tuple(leaf.shape) == ref_leaf.shape, name
        _close(leaf, ref_leaf, 1e-5)


def test_mamba2_prefill_then_decode(weights):
    ref_params, params = weights["mamba2-2.7b"]
    ref_model, model = _models("mamba2-2.7b")
    _consistency_and_stream(ref_model, ref_params, model, params, seed=5)


@pytest.mark.parametrize("s", [2, 45])
def test_ssm_forward_matches_reference(weights, s):
    """The block alone on layer 0's weights: s = 45 is not a multiple of
    the chunk (32), so the SSD core pads it; s = 2 is shorter than the
    conv's k-1 = 3 carry, which is zero-padded on the left."""
    ref_params, params = weights["mamba2-2.7b"]
    ref_cfg = ref_get_config("mamba2-2.7b").reduced()
    cfg = get_config("mamba2-2.7b").reduced()
    ref_p = jax.tree.map(lambda a: a[0], ref_params["layers"]["pos0"]["ssm"])
    p = {k: v[0] for k, v in params["layers"]["pos0"]["ssm"].items()}
    x = np.random.default_rng(s).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    out_ref, st_ref = jax.jit(ref_ssm.ssm_forward, static_argnums=(2, 3))(
        ref_p, jnp.asarray(x), ref_cfg, True)
    out, st = ssm.ssm_forward(p, torch.from_numpy(x), cfg, return_state=True)
    _close(out, out_ref, 1e-5)
    assert set(st) == set(st_ref)
    for name, leaf in st.items():
        assert tuple(leaf.shape) == st_ref[name].shape
        assert str(leaf.dtype).removeprefix("torch.") == str(
            st_ref[name].dtype)
        _close(leaf, st_ref[name], 1e-5)
    torch.testing.assert_close(ssm.ssm_forward(p, torch.from_numpy(x), cfg),
                               out, atol=0, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_path_hands_the_kernel_what_it_takes(monkeypatch, weights,
                                                   dtype):
    """Every whole-sequence attention of forward and prefill passes the
    kernel's input checks (layout, strides, dtypes) on the CPU, where the
    wrapper runs the plain version: the card would launch on the same
    tensors."""
    _, params = weights["gptneox-1b"]
    model = _models("gptneox-1b", param_dtype=dtype, compute_dtype=dtype)[1]
    plain, seen = kfa.flash_attention_plain, []

    def checked(q, k, v, **flags):
        kfa.check_kernel_inputs(q, k, v, flags["window"], flags["q_offset"])
        seen.append(q.dtype)
        return plain(q, k, v, **flags)

    checked.calls = 0        # the plain version counts under its name
    monkeypatch.setattr(kfa, "flash_attention_plain", checked)
    cast = bridge.unflatten({k: v.to(getattr(torch, dtype))
                             for k, v in bridge.flatten(params).items()})
    tokens = torch.from_numpy(_tokens(6, model.cfg.vocab_size))
    model.forward(cast, {"tokens": tokens})
    model.prefill(cast, {"tokens": tokens[:, :P]}, S)
    assert seen == [getattr(torch, dtype)] * (2 * model.cfg.n_layers)
