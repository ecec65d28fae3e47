"""The port's training loss against the reference's, on the CPU:
``make_loss_fn``'s loss, metrics and every gradient leaf against
``jax.value_and_grad`` of the reference's, on seven reduced configs:
qwen2.5-3b (GQA, QKV bias, tied embeddings; a packed batch with a loss
mask), gemma2-2b (local / global windows, both softcaps),
kimi-k2-1t-a32b (MoE: the aux losses enter the loss), seamless-m4t-medium
(frames through the non-causal encoder, cross-attention),
internvl2-2b (a patch prefix; the loss reads the text positions only),
mamba2-2.7b (the SSD blocks) and jamba-v0.1-52b (SSD beside attention
and MoE).

Both packages run the same config with the reference's weights
(carried across by ``repro_torch.bridge``) on the same batch, made with
numpy from a seed.  The port's attention backward is the CPU plain
backward of ``flash_attention`` (the kernel's formulas), every block
rematerialised as on the card (``remat="block"``); the reference
differentiates its XLA ``attention()``; likewise the SSD scan's
backward is the CPU plain ``ssd_scan_bwd_plain`` (the formulas of its
kernel) where the reference differentiates its XLA ``ssd_chunked``.
Tolerances (fp32, summation
order only): loss and metrics rtol 1e-5; every gradient leaf rtol 1e-4
with atol 1e-5 x the leaf's largest magnitude.
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
from repro.train.step import make_loss_fn as ref_make_loss_fn  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pack_documents  # noqa: E402
from repro_torch.models.model import build_model, make_batch  # noqa: E402
from repro_torch.train import make_loss_fn  # noqa: E402

B, S = 2, 24
ARCHS = ("qwen2.5-3b", "gemma2-2b", "kimi-k2-1t-a32b", "seamless-m4t-medium",
         "internvl2-2b", "mamba2-2.7b", "jamba-v0.1-52b")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These small fp32 models run as fast on one intra-op thread, and
    one keeps parallel test workers from spinning against each other.
    The previous count is restored for the worker's next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(arch, cfg):
    """numpy batch: make_batch's fields; qwen takes two packed rows of
    four documents with their loss mask instead of its tokens."""
    batch = {k: v.numpy() for k, v in make_batch(cfg, B, S, 7, "cpu").items()}
    if arch == "qwen2.5-3b":
        rng = np.random.default_rng(8)
        docs = [rng.integers(0, cfg.vocab_size, n) for n in (10, 14, 7, 17)]
        tokens, mask, _ = pack_documents(docs, S)
        assert tokens.shape == (B, S)
        batch.update(tokens=tokens, loss_mask=mask)
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_metrics_and_grads_match_reference(arch):
    ref_cfg = ref_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    assert cfg.remat == "block"
    ref_model = ref_build_model(ref_cfg)
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten(ref_params).items()}
    params = bridge.params_from_numpy(flat, cfg, "cpu")
    leaves = bridge.flatten(params)
    for t in leaves.values():
        t.requires_grad_(True)
    batch = _batch(arch, cfg)

    (ref_loss, ref_metrics), ref_grads = jax.jit(jax.value_and_grad(
        ref_make_loss_fn(ref_model), has_aux=True))(
            ref_params, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics = make_loss_fn(build_model(cfg))(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)

    assert set(metrics) == set(ref_metrics)
    for name, value in metrics.items():
        np.testing.assert_allclose(float(value.detach()),
                                   float(ref_metrics[name]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=1e-5)
    ref_flat = _flatten(ref_grads)
    assert set(ref_flat) == set(leaves)
    for (key, p), g in zip(leaves.items(), grads):
        want = np.asarray(ref_flat[key])
        got = np.zeros_like(want) if g is None else g.numpy()
        np.testing.assert_allclose(
            got, want, rtol=1e-4, atol=1e-5 * max(np.abs(want).max(), 1e-30),
            err_msg=f"{arch}: grad of {key}")


def test_remat_changes_no_value():
    """cfg.remat "none" and "block" give the same loss and the same
    gradients bit for bit (block remat only re-runs the forward)."""
    cfg = get_config("qwen2.5-3b").reduced()
    batch = {k: torch.from_numpy(v) for k, v in _batch("qwen2.5-3b",
                                                        cfg).items()}
    out = []
    for remat in ("none", "block"):
        c = dataclasses.replace(cfg, remat=remat)
        model = build_model(c)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        leaves = list(bridge.flatten(params).values())
        for t in leaves:
            t.requires_grad_(True)
        loss, _ = make_loss_fn(model)(params, batch)
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_remat_only_where_a_gradient_is_wanted(monkeypatch):
    """Under grad mode, a forward whose weights and inputs need no grad
    (serving) runs no block through ``torch.utils.checkpoint``; with
    the weights requiring grad every block does, once a forward."""
    cfg = get_config("qwen2.5-3b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.from_numpy(_batch("qwen2.5-3b", cfg)["tokens"])}
    calls = []
    checkpoint = torch.utils.checkpoint.checkpoint
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **k: calls.append(1) or checkpoint(*a, **k))
    assert torch.is_grad_enabled()
    plain, _ = model.forward(params, batch)
    assert not calls and not plain.requires_grad
    for t in bridge.flatten(params).values():
        t.requires_grad_(True)
    logits, _ = model.forward(params, batch)
    assert len(calls) == cfg.n_layers
    assert torch.equal(logits.detach(), plain)
