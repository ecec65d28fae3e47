"""The log-sum-exp that ``flash_attention``'s forward hands its backward,
on the CPU: the plain LSE (``attention_lse_plain``, what the forward
kernel stores) against one computed in numpy from the reference's own
scores and mask (``src/repro/models/attention.py`` ``_scores``,
``_mask_bias``) on the reduced configs' attention shapes;
``flash_attention_bwd_plain`` with the forward's LSE against the same
call computing its own; ``FlashAttentionFn`` saving the LSE and handing
it to the backward (one forward and one backward a layer, no statistics
pass); and a numpy transliteration of the backward kernel's schedule
(``csrc/flash_attention_bwd.cu``): the tiles it visits hold every
visible (query, key) pair.

Inputs are N(0, 1) made with numpy from a seed, fp32.  Tolerance of the
LSE: atol 1e-5 against float64 numpy (fp32 scores and exp / log, ~1e-6
relative at LSE ~5).
"""

import math
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.models import attention as ref_attn  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as kfa  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train import make_loss_fn  # noqa: E402

BF16 = torch.bfloat16
SMS = 132                                # an H100 SXM


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small fp32 shapes run as fast on one intra-op thread, and one keeps
    parallel test workers from spinning against each other.  The
    previous count is restored for the worker's next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shape(arch, **over):
    """(hq, hkv, d, flags) of a reduced config's attention (gemma2's
    local layers: its window and softcap)."""
    cfg = get_config(arch).reduced()
    flags = {}
    if cfg.attn_logit_softcap is not None:
        flags["softcap"] = cfg.attn_logit_softcap
    flags.update(over)
    return cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, flags


# name -> (b, sq, skv, hq, hkv, d, flags)
CASES = {
    "qwen2.5-3b": (2, 40, 40, *_shape("qwen2.5-3b")),
    "llama3.2-3b": (2, 33, 33, *_shape("llama3.2-3b")),
    "gemma-2b_mqa": (2, 40, 40, *_shape("gemma-2b")),
    "gemma2-2b_global": (2, 40, 40, *_shape("gemma2-2b")),
    "gemma2-2b_local": (2, 40, 40, *_shape(
        "gemma2-2b",
        window=get_config("gemma2-2b").reduced().sliding_window)),
    "non_causal_sq29_skv13": (2, 29, 13, *_shape("gptneox-1b",
                                                 causal=False)),
    "rows_with_no_key_sq40_skv10_window5": (1, 40, 10, 4, 2, 16,
                                            dict(window=5)),
}


def _inputs(seed, b, sq, skv, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d),
                      (b, sq, hq, d))]


def _ref_lse(q, k, flags):
    """float64 LSE (b, hq, sq) of the reference's fp32 scores over the
    visible keys, 0 for a row with none."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    s = ref_attn._scores(ref_attn._group(jnp.asarray(q), hkv),
                         jnp.asarray(k), 1.0 / math.sqrt(d),
                         flags.get("softcap"))
    bias = ref_attn._mask_bias(jnp.arange(sq), jnp.arange(skv),
                               flags.get("causal", True),
                               flags.get("window"))
    s = np.asarray(s, np.float64)                   # (b, hkv, g, sq, skv)
    ok = np.asarray(bias) == 0.0                    # (sq, skv)
    m = np.where(ok, s, -np.inf).max(-1, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    total = np.where(ok, np.exp(s - m), 0.0).sum(-1)
    lse = np.log(np.where(ok.any(-1), total, 1.0)) + m[..., 0]
    lse = np.where(ok.any(-1), lse, 0.0)
    return lse.reshape(b, hq, sq)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_lse_matches_the_reference_scores(case):
    b, sq, skv, hq, hkv, d, flags = CASES[case]
    q, k, _, _ = _inputs(list(CASES).index(case), b, sq, skv, hq, hkv, d)
    got = kfa.attention_lse_plain(torch.from_numpy(q), torch.from_numpy(k),
                                  **flags)
    assert got.dtype == torch.float32 and got.shape == (b, hq, sq)
    want = _ref_lse(q, k, flags)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    if "no_key" in case:
        assert (want == 0.0).any()


@pytest.mark.parametrize("case", list(CASES))
def test_flash_attention_lse_on_the_cpu_is_the_plain_pair(case):
    """``flash_attention_lse`` of CPU tensors: the plain forward's output
    and ``attention_lse_plain``, one call of each."""
    b, sq, skv, hq, hkv, d, flags = CASES[case]
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(
        list(CASES).index(case) + 50, b, sq, skv, hq, hkv, d))
    before = (kfa.flash_attention_plain.calls, kfa.attention_lse_plain.calls,
              kfa.flash_attention.launches)
    o, lse = kfa.flash_attention_lse(q, k, v, **flags)
    assert (kfa.flash_attention_plain.calls, kfa.attention_lse_plain.calls,
            kfa.flash_attention.launches) == (before[0] + 1, before[1] + 1,
                                              before[2])
    assert torch.equal(o, kfa.flash_attention(q, k, v, **flags))
    assert torch.equal(lse, kfa.attention_lse_plain(q, k, **flags))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_takes_the_forward_lse(case):
    """With the forward's LSE the plain backward gives the same bits as
    when it computes each row's LSE itself (rows with no visible key:
    P = 0 either way)."""
    b, sq, skv, hq, hkv, d, flags = CASES[case]
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(
        list(CASES).index(case) + 100, b, sq, skv, hq, hkv, d))
    o, lse = kfa.flash_attention_lse(q, k, v, **flags)
    given = kfa.flash_attention_bwd_plain(q, k, v, o, do, lse=lse, **flags)
    own = kfa.flash_attention_bwd_plain(q, k, v, o, do, **flags)
    via = kfa.flash_attention_bwd(q, k, v, o, do, lse=lse, **flags)
    for name, x, y, z in zip("qkv", given, own, via):
        assert torch.equal(x, y), f"d{name}"
        assert torch.equal(x, z), f"d{name}"


def test_function_saves_the_lse_and_the_backward_takes_it(monkeypatch):
    """``FlashAttentionFn`` saves (q, k, v, out, lse) with the forward's
    LSE; a reduced qwen2.5-3b loss and its gradients (block remat: each
    layer's forward runs twice) take one backward a layer, every one
    given the saved LSE, and the backward computes no LSE itself; no
    kernel launches on the CPU."""
    b, sq, skv, hq, hkv, d, flags = CASES["gemma2-2b_local"]
    q, k, v, do = (torch.from_numpy(x).requires_grad_(True)
                   for x in _inputs(7, b, sq, skv, hq, hkv, d))
    out = kfa.flash_attention(q, k, v, **flags)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5
    assert torch.equal(saved[4], kfa.attention_lse_plain(
        q.detach(), k.detach(), **flags))

    seen = []
    plain_bwd = kfa.flash_attention_bwd_plain

    def recording(*args, lse=None, **kw):
        seen.append(lse)
        return plain_bwd(*args, lse=lse, **kw)

    recording.calls = 0         # the plain version counts under its name
    monkeypatch.setattr(kfa, "flash_attention_bwd_plain", recording)
    cfg = get_config("qwen2.5-3b").reduced()
    assert cfg.remat == "block"
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    leaves = list(bridge.flatten(params).values())
    for t in leaves:
        t.requires_grad_(True)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32))
    counts = {"fwd": kfa.flash_attention_plain.calls,
              "lse": kfa.attention_lse_plain.calls,
              "launch": kfa.flash_attention.launches,
              "bwd_launch": kfa.flash_attention_bwd.launches}
    loss, _ = make_loss_fn(model)(params, {"tokens": tokens})
    lse_after_fwd = kfa.attention_lse_plain.calls
    torch.autograd.grad(loss, leaves, allow_unused=True)
    n = cfg.n_layers
    assert kfa.flash_attention_plain.calls - counts["fwd"] == 2 * n
    assert lse_after_fwd - counts["lse"] == n
    # the backward's LSE calls are the remat's re-run forwards, one a layer
    assert kfa.attention_lse_plain.calls - lse_after_fwd == n
    assert kfa.flash_attention.launches == counts["launch"]
    assert kfa.flash_attention_bwd.launches == counts["bwd_launch"]
    assert len(seen) == n
    assert all(lse is not None and lse.shape == (2, cfg.n_heads, 24)
               for lse in seen)


# ---- numpy transliterations of csrc/flash_attention_bwd.cu ------------ #

def _visible(sq, skv, causal, window):
    qp, kp = np.arange(sq)[:, None], np.arange(skv)[None, :]
    ok = np.ones((sq, skv), bool)
    if causal:
        ok &= qp >= kp
    if window is not None:
        ok &= qp - kp < window
    return ok


def _query_tiles(sq, k0, bk, bq, causal, window):
    q_begin, q_end = (k0 if causal else 0), sq
    if window is not None:
        q_end = min(q_end, k0 + bk - 1 + window)
    lo = q_begin // bq
    return lo, (-(-q_end // bq) if q_end > q_begin else lo)


def _key_tiles(skv, q0, bq, bk, causal, window):
    k_end = min(skv, q0 + bq) if causal else skv
    k_begin = max(0, q0 - window + 1) if window is not None else 0
    lo = k_begin // bk
    return lo, (-(-k_end // bk) if k_end > k_begin else lo)


def _tile_full(sq, skv, q_lo, q_hi, k_lo, k_hi, causal, window):
    return (q_hi < sq and k_hi < skv and (not causal or k_hi <= q_lo)
            and (window is None or q_hi - k_lo < window))


@pytest.mark.parametrize("sq,skv,causal,window", [
    (256, 256, True, None), (1000, 1000, False, None),
    (333, 333, True, 100), (70, 200, False, None), (200, 70, True, None),
    (150, 150, True, 7), (40, 10, True, 5), (129, 129, True, 1)])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_backward_tiles_hold_every_visible_pair(sq, skv, causal, window, d):
    """(B)'s key blocks visit q tiles [query_tiles), (C)'s q blocks key
    tiles [key_tiles), at the tiles ``bwd_plan`` gives bf16 at ``d``:
    every visible (query, key) pair lies in a visited tile of each pass,
    and a warp's tile that ``tile_full`` calls full (no per-element mask)
    holds visible pairs only."""
    z = torch.zeros((1, sq, 2, d), dtype=BF16)
    zk = torch.zeros((1, skv, 1, d), dtype=BF16)
    pl = kfa.bwd_plan(z, zk, zk, z, z, torch.zeros((1, 2, sq)), window,
                      SMS)
    ok = _visible(sq, skv, causal, window)
    seen_b = np.zeros_like(ok)
    for k0 in range(0, skv, pl.keys):
        lo, hi = _query_tiles(sq, k0, pl.keys, pl.q_tile, causal, window)
        seen_b[lo * pl.q_tile:hi * pl.q_tile, k0:k0 + pl.keys] = True
        for qt in range(lo, hi):
            q0 = qt * pl.q_tile
            for w_lo in range(k0, k0 + pl.keys, 16):   # a warp's 16 keys
                if _tile_full(sq, skv, q0, q0 + 63, w_lo, w_lo + 15,
                              causal, window):
                    assert ok[q0:q0 + 64, w_lo:w_lo + 16].all()
    seen_c = np.zeros_like(ok)
    for q0 in range(0, sq, pl.dq_rows):
        lo, hi = _key_tiles(skv, q0, pl.dq_rows, pl.dq_bk, causal, window)
        seen_c[q0:q0 + pl.dq_rows, lo * pl.dq_bk:hi * pl.dq_bk] = True
        for j in range(lo, hi):
            k0 = j * pl.dq_bk
            for w_lo in range(q0, q0 + pl.dq_rows, 16):
                if _tile_full(sq, skv, w_lo, w_lo + 15, k0,
                              k0 + pl.dq_bk - 1, causal, window):
                    assert ok[w_lo:w_lo + 16, k0:k0 + pl.dq_bk].all()
    assert not (ok & ~seen_b).any() and not (ok & ~seen_c).any()
