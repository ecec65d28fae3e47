"""The port's train step, data and CE against the reference's, on the CPU.

* ``make_train_step``: 3 steps at ``accum_steps`` 1 and 2 on qwen2.5-3b
  reduced, from the reference's initial train state (carried across by
  ``repro_torch.bridge``) on the same batches: the metrics (loss, ce,
  acc, grad_norm) within rtol 1e-5, and after each step every param
  within rtol 1e-4, atol 1e-6 (AdamW's step is lr-sized, ~1e-3 at this
  schedule, so atol 1e-6 is a thousandth of a step) but for at most 1
  element in 1000 of a leaf, which must lie within AdamW's bound (2 x
  the summed lr of the steps taken: an element whose gradient sits at
  the two packages' rounding takes a step of +-lr by its sign), ``m``
  and ``v`` within rtol 1e-4 and atol 1e-4 x the leaf's largest
  magnitude (from the second step on, the gradients' near-zero elements
  move with those rare steps), and the step count equal.  The K bias's
  params are the exception: its gradient is tiny (without RoPE a bias on
  every key shifts a query's scores by one constant, which the softmax
  ignores), elements of it sit at the rounding noise of the two
  packages' sums, and AdamW turns a gradient's sign into a step of +-lr
  whatever its size; they are held to AdamW's bound, 2 x the summed lr
  of the steps taken (their ``m`` and ``v`` to the common tolerance);
* ``chunked_cross_entropy`` against dense ``cross_entropy_loss``, value
  and gradients (rtol 1e-5);
* the loss falls on the affine task (the port alone, as
  ``tests/test_train.py`` does for the reference);
* ``pack_documents`` equals the reference's on seeded documents;
* ``SyntheticStream`` is deterministic, its steps and processes differ,
  its fields are ``batch_fields``', and its affine kind is the chain.
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
from repro.data import pack_documents as ref_pack  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.optim import Schedule as RefSchedule  # noqa: E402
from repro.train import make_train_step as ref_make_train_step  # noqa: E402
from repro.train import train_state_init as ref_train_state_init  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import (SyntheticConfig, SyntheticStream,  # noqa: E402
                              make_stream, pack_documents)
from repro_torch.models.model import batch_fields, build_model  # noqa: E402
from repro_torch.optim import AdamWConfig, Schedule  # noqa: E402
from repro_torch.train import (chunked_cross_entropy,  # noqa: E402
                               cross_entropy_loss, make_train_step,
                               train_state_init)

SCHED = dict(peak_lr=3e-3, warmup_steps=2, decay_steps=10)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These small fp32 models run as fast on one intra-op thread, and
    one keeps parallel test workers from spinning against each other.
    The previous count is restored for the worker's next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close_tree(label, got, want, rtol, atol_frac, atol=0.0, bound=None):
    """Each leaf within rtol / atol (atol at least ``atol_frac`` x the
    leaf's largest magnitude); with ``bound``, up to 1 element in 1000
    of a leaf may lie outside, within ``bound``."""
    assert set(got) == set(want), label
    for k, w in want.items():
        w = np.asarray(w, np.float32)
        g = np.asarray(got[k], np.float32)
        tol = max(atol, atol_frac * float(np.abs(w).max(initial=0.0)))
        out = np.abs(g - w) > tol + rtol * np.abs(w)
        if bound is not None and out.sum() <= w.size // 1000:
            np.testing.assert_allclose(g[out], w[out], rtol=0, atol=bound,
                                       err_msg=f"{label}: {k}")
            g = np.where(out, w, g)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=tol,
                                   err_msg=f"{label}: {k}")


@pytest.mark.parametrize("accum", [1, 2])
def test_train_steps_match_reference(accum):
    arch = "qwen2.5-3b"
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(), n_layers=2)
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=2)
    ref_model, model = ref_build_model(ref_cfg), build_model(cfg)
    ref_opt = RefAdamWConfig(schedule=RefSchedule(**SCHED))
    opt = AdamWConfig(schedule=Schedule(**SCHED))
    ref_state = ref_train_state_init(ref_model, ref_opt,
                                     jax.random.PRNGKey(0))
    state = bridge.train_state_from_numpy(
        {k: np.asarray(v) for k, v in _flatten(ref_state).items()}, cfg)
    ref_step = jax.jit(ref_make_train_step(ref_model, ref_opt,
                                           accum_steps=accum))
    step = make_train_step(model, opt, accum_steps=accum)
    rng = np.random.default_rng(accum)
    lr_sum = 0.0
    for i in range(3):
        tokens = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
        ref_state, ref_m = ref_step(ref_state,
                                    {"tokens": jnp.asarray(tokens)})
        state, m = step(state, {"tokens": torch.from_numpy(tokens)})
        for name in ("loss", "ce", "acc", "grad_norm", "moe_lb_loss"):
            np.testing.assert_allclose(float(m[name]), float(ref_m[name]),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {i}: {name}")
        got = bridge.train_state_to_numpy(state)
        want = {k: np.asarray(v) for k, v in _flatten(ref_state).items()}
        assert int(got.pop("opt/step")) == int(want.pop("opt/step")) == i + 1
        lr_sum += float(opt.schedule(i + 1))
        noise = {k for k in want
                 if k.startswith("params") and k.endswith("/attn/bk")}
        assert len(noise) == 1
        for k in noise:
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=2 * lr_sum,
                                       err_msg=f"step {i}: {k}")
        _close_tree(f"step {i} params",
                    {k: v for k, v in got.items()
                     if k.startswith("params") and k not in noise},
                    {k: v for k, v in want.items()
                     if k.startswith("params") and k not in noise},
                    rtol=1e-4, atol_frac=0.0, atol=1e-6, bound=2 * lr_sum)
        _close_tree(f"step {i} opt",
                    {k: v for k, v in got.items() if k.startswith("opt")},
                    {k: v for k, v in want.items() if k.startswith("opt")},
                    rtol=1e-4, atol_frac=1e-4)


@pytest.mark.parametrize("chunk", [7, 16, 64])
def test_chunked_ce_matches_dense(chunk):
    """Value and gradients (features, w) of the chunked CE against the
    dense CE over the whole logits, with a softcap and a mask."""
    rng = np.random.default_rng(chunk)
    b, s, d, v = 2, 33, 16, 50
    x = torch.from_numpy(rng.standard_normal((b, s, d), np.float32))
    w = torch.from_numpy(rng.standard_normal((d, v), np.float32))
    t = torch.from_numpy(rng.integers(0, v, (b, s)).astype(np.int32))
    mask = torch.from_numpy((rng.random((b, s)) > 0.2).astype(np.float32))
    out = []
    for chunked in (True, False):
        xg, wg = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        if chunked:
            ce, acc = chunked_cross_entropy(xg, wg, t, mask, softcap=5.0,
                                            chunk=chunk)
        else:
            logits = torch.tanh(torch.matmul(xg, wg) / 5.0) * 5.0
            ce, acc = cross_entropy_loss(logits, t, mask)
        out.append((ce.detach(), acc, torch.autograd.grad(ce, (xg, wg))))
    (ce1, acc1, g1), (ce2, acc2, g2) = out
    torch.testing.assert_close(ce1, ce2, rtol=1e-5, atol=1e-6)
    assert torch.equal(acc1, acc2)
    for a, b_ in zip(g1, g2):
        torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-7)


def test_loss_decreases_on_affine_task():
    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(), n_layers=2)
    model = build_model(cfg)
    opt = AdamWConfig(schedule=Schedule(peak_lr=1e-2, warmup_steps=5,
                                        decay_steps=100))
    state = train_state_init(model, opt, torch.Generator().manual_seed(0),
                             "cpu")
    stream = make_stream(cfg, 8, 32)
    step = make_train_step(model, opt)
    losses = []
    for i in range(40):
        state, metrics = step(state, stream.batch(i))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])
    assert float(metrics["acc"]) > 0.5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_documents_matches_reference(seed):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, 1000, n) for n in rng.integers(0, 70, 12)]
    for got, want in zip(pack_documents(docs, 32), ref_pack(docs, 32)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["affine", "uniform", "zipf"])
def test_synthetic_stream_deterministic_and_steps_differ(kind):
    cfg = get_config("qwen2.5-3b").reduced()
    data = SyntheticConfig(kind=kind, seed=3)
    a = SyntheticStream(cfg, 4, 16, data)
    b = SyntheticStream(cfg, 4, 16, data)
    assert torch.equal(a.batch(5)["tokens"], b.batch(5)["tokens"])
    assert not torch.equal(a.batch(5)["tokens"], a.batch(6)["tokens"])
    other = SyntheticStream(cfg, 4, 16, data, process_index=1,
                            process_count=2)
    assert other.batch(5)["tokens"].shape == (2, 16)
    tok = a.batch(0)["tokens"]
    assert tok.dtype == torch.int32 and tok.shape == (4, 16)
    assert int(tok.min()) >= 0 and int(tok.max()) < cfg.vocab_size
    if kind == "affine":
        v = min(data.affine_vocab, cfg.vocab_size)
        np.testing.assert_array_equal(
            tok[:, 1:].numpy(),
            (data.affine_a * tok[:, :-1].numpy() + data.affine_b) % v)


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-2b"])
def test_synthetic_stream_modal_fields(arch):
    cfg = get_config(arch).reduced()
    batch = SyntheticStream(cfg, 2, 24).batch(0)
    fields = batch_fields(cfg, 2, 24)
    assert set(batch) == set(fields)
    for name, (shape, dtype) in fields.items():
        assert tuple(batch[name].shape) == shape
        assert str(batch[name].dtype).removeprefix("torch.") == dtype
