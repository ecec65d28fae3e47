"""Gradients of the port's ``flash_attention`` on the CPU (its
``FlashAttentionFn`` with the plain backward) against ``jax.vjp`` of the
reference's XLA ``attention()``, which the reference's training path
differentiates, and ``flash_attention_bwd_plain`` against
``torch.autograd`` of ``flash_attention_plain``.

Cases: causal and not, GQA, a window, a softcap, ragged sq / skv, and
skv above the plain version's ``chunk`` (the online-softmax path).
Inputs and the output cotangent are N(0, 1), made with numpy from a
seed, fp32.  Tolerance rtol 1e-4, atol 1e-5 (fp32, summation order
only: the reference's grads come through its online softmax where the
port's plain backward recomputes P from a log-sum-exp).
"""

import math
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.models import attention as ref_attn  # noqa: E402

from repro_torch.kernels import flash_attention as kfa  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)
# (b, sq, skv, hq, hkv, d, flags)
CASES = {
    "causal_gqa": (2, 24, 24, 4, 2, 16, {}),
    "non_causal": (2, 20, 20, 4, 4, 16, dict(causal=False)),
    "window_softcap_gqa": (1, 32, 32, 4, 2, 16, dict(window=7, softcap=5.0)),
    "ragged_sq13_skv29_mqa": (2, 13, 29, 4, 1, 8, {}),
    "ragged_non_causal_sq29_skv13": (2, 29, 13, 2, 2, 8,
                                     dict(causal=False)),
    "chunked_skv40": (1, 40, 40, 4, 2, 8, dict(chunk=16)),
    "chunked_window_softcap": (1, 40, 40, 2, 1, 8,
                               dict(chunk=16, window=9, softcap=3.0)),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These small fp32 models run as fast on one intra-op thread, and
    one keeps parallel test workers from spinning against each other.
    The previous count is restored for the worker's next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, b, sq, skv, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d),
                      (b, sq, hq, d))]


def _torch_grads(fn, q, k, v, do, flags):
    q, k, v = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = fn(q, k, v, **flags)
    return [g.numpy() for g in torch.autograd.grad(
        out, (q, k, v), torch.from_numpy(do))]


@pytest.mark.parametrize("case", list(CASES))
def test_grads_match_reference(case):
    """dq, dk, dv of the port's flash_attention (CPU: the Function with
    the plain backward) against jax.vjp of the reference's attention()."""
    b, sq, skv, hq, hkv, d, flags = CASES[case]
    q, k, v, do = _inputs(list(CASES).index(case), b, sq, skv, hq, hkv, d)
    before = kfa.flash_attention_bwd_plain.calls
    got = _torch_grads(kfa.flash_attention, q, k, v, do, flags)
    assert kfa.flash_attention_bwd_plain.calls == before + 1

    def ref(q, k, v):
        return ref_attn.attention(q, k, v, **flags)

    _, vjp = jax.vjp(ref, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g, np.asarray(w), **TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_autograd_of_plain_forward(case):
    """The explicit formulas the kernel is held to, against autograd
    through the plain forward (the reference's dispatch in torch)."""
    b, sq, skv, hq, hkv, d, flags = CASES[case]
    q, k, v, do = _inputs(list(CASES).index(case) + 100, b, sq, skv, hq,
                          hkv, d)
    flags = dict(flags, scale=1.0 / math.sqrt(d))
    want = _torch_grads(kfa.flash_attention_plain, q, k, v, do, flags)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    fwd = {n: flags[n] for n in flags if n != "chunk"}
    o = kfa.flash_attention_plain(tq, tk, tv, **flags)
    got = kfa.flash_attention_bwd_plain(tq, tk, tv, o, tdo, **fwd)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=f"d{name}")


def test_no_grad_path_is_unchanged_and_q_offset_refuses_grad():
    """With grad disabled (or no input needing it) the forward runs as
    before, with no autograd node; a q_offset with a gradient raises."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(3, 1, 8, 8, 2, 2, 8))
    plain = kfa.flash_attention_plain(q, k, v, scale=1.0 / math.sqrt(8))
    out = kfa.flash_attention(q, k, v)
    assert out.grad_fn is None and torch.equal(out, plain)
    qg = q.clone().requires_grad_(True)
    with torch.no_grad():
        assert kfa.flash_attention(qg, k, v).grad_fn is None
    assert kfa.flash_attention(qg, k, v).grad_fn is not None
    with pytest.raises(NotImplementedError, match="q_offset"):
        kfa.flash_attention(qg, k, v, q_offset=4)
    assert kfa.flash_attention(qg.detach(), k, v, q_offset=4).shape == q.shape


def test_backward_dispatch_and_input_checks():
    """Only CPU tensors take the plain backward (meta raises, counting
    no launch); the kernel's input checks refuse what it does not
    take."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(4, 1, 8, 8, 4, 2, 8))
    before = kfa.flash_attention_bwd.launches
    meta = [t.to("meta") for t in (q, k, v, q, do)]
    with pytest.raises(ValueError, match="cuda"):
        kfa.flash_attention_bwd(*meta)
    assert kfa.flash_attention_bwd.launches == before
    kfa.check_bwd_inputs(q, k, v, q, do, None)
    with pytest.raises(TypeError):
        kfa.check_bwd_inputs(q, k, v, q, do.double(), None)
    with pytest.raises(ValueError, match="shapes"):
        kfa.check_bwd_inputs(q, k, v, q, do[:, :4], None)
    with pytest.raises(ValueError, match="unit-stride"):
        kfa.check_bwd_inputs(q, k, v, q,
                             do.transpose(2, 3).contiguous().transpose(2, 3),
                             None)
    with pytest.raises(ValueError, match="window"):
        kfa.check_bwd_inputs(q, k, v, q, do, 0)
