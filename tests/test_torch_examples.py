"""The port's examples on the CPU: the training ones with few steps,
the serving ones against the reference on bridged weights.

* ``repro_torch.examples.quickstart.run``: trains the 2-layer qwen2.5-3b
  through the loop (a checkpoint on the way), serves the trained
  parameters greedily and prints its account; the losses finite;
* ``repro_torch.examples.train_100m.main`` twice on one ``--ckpt``: the
  second run resumes from the first's final checkpoint, and its last
  metrics are bit-identical to an uninterrupted run's (the schedule is in its
  warmup, so ``--steps`` does not change it).  The config is the
  example's family cut to a CPU size (the card runs it whole);
* parameters that require grad, as the train state holds them, serve the
  same stream as detached ones, and the engine's cache holds no autograd
  graph (``ServeEngine`` detaches what it is given);
* ``repro_torch.examples.serve_demo.run("cpu", part=TPU_V5E)`` on the
  reference's weights: each format's stored bytes equal, the rel-MSE
  within rtol 1e-5 (``tests/test_torch_serve_quant.py``'s tolerance) of
  the reference's ``quantize_params``, the watts equal to the
  reference's ``estimate`` of the reference example, and the fused and
  per-step streams equal (no JAX engine is built);
* ``repro_torch.examples.long_context.run`` at positions 24 and 40 for
  its three runs against the reference's jitted ``prefill`` /
  ``decode_step`` on the reference's weights: the cache's bytes and
  ``kv_cache_stats`` at each position equal, the greedy tokens equal;
* ``repro_torch.examples.characterize`` runs ``launch.characterize``.
"""

import dataclasses
import functools
import math
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from repro.checkpoint.checkpointer import _flatten  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import TPU_V5E as REF_TPU_V5E  # noqa: E402
from repro.core.energy import estimate as ref_estimate  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import kv_cache_stats as ref_kv_cache_stats  # noqa: E402
from repro.serve import quantize_params as ref_quantize_params  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.bridge import flatten, unflatten  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import TPU_V5E  # noqa: E402
from repro_torch.examples import (characterize, long_context,  # noqa: E402
                                  quickstart, serve_demo, train_100m)
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train import train_state_init  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quickstart_trains_checkpoints_and_serves(capsys):
    out = quickstart.run("cpu", steps=4, checkpoint_every=2)
    text = capsys.readouterr().out
    assert [h["step"] for h in out["history"]] == [0, 3]
    assert all(math.isfinite(h["loss"]) for h in out["history"])
    assert len(out["tokens"]) == len(out["want"]) == quickstart.N_NEW
    assert all(b == quickstart._affine(a)
               for a, b in zip(out["want"], out["want"][1:]))
    assert f"-> {out['hits']}/{quickstart.N_NEW} continuations correct" in text
    assert "qwen2.5-3b-reduced" in text


def test_train_100m_resumes_from_its_checkpoint(tmp_path, monkeypatch,
                                                capsys):
    small = dataclasses.replace(
        train_100m.CONFIG_100M, n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512)
    monkeypatch.setattr(train_100m, "CONFIG_100M", small)
    args = ["--batch", "2", "--seq", "16", "--device", "cpu"]
    first = train_100m.main(["--steps", "2", "--ckpt",
                             str(tmp_path / "a"), *args])
    resumed = train_100m.main(["--steps", "4", "--ckpt",
                               str(tmp_path / "a"), *args])
    text = capsys.readouterr().out
    straight = train_100m.main(["--steps", "4", "--ckpt",
                                str(tmp_path / "b"), *args])
    assert "[train] resumed from step 2" in text
    assert [h["step"] for h in first] == [0, 1]
    assert [h["step"] for h in resumed] == [3]       # logged: the last
    assert [h["step"] for h in straight] == [0, 3]
    assert first[0] == straight[0] and resumed[-1] == straight[-1]
    assert all(math.isfinite(h["loss"]) for h in straight)
    assert "done: loss" in text


def test_serving_params_that_require_grad():
    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(), n_layers=2)
    model = build_model(cfg)
    params = train_state_init(model, AdamWConfig(),
                              torch.Generator().manual_seed(0),
                              "cpu")["params"]
    assert all(t.requires_grad for t in flatten(params).values())
    streams = []
    for p in (params, unflatten({k: t.detach()
                                 for k, t in flatten(params).items()})):
        eng = ServeEngine(model, p, batch=2, max_seq=64, device="cpu")
        eng.submit([3, 4, 5, 6], max_new_tokens=6)
        streams.append(eng.run()[0].tokens)
        assert not any(t.requires_grad for t in flatten(eng.cache).values())
        assert not any(t.requires_grad
                       for t in flatten(eng.params).values())
    assert streams[0] == streams[1]


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """(the reference's params of ``arch`` reduced, from PRNGKey(0), the
    port's params bridged from them); a kv format changes no weight."""
    cfg = ref_get_config(arch).reduced()
    ref_params = ref_build_model(cfg).init(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten(ref_params).items()}
    return ref_params, bridge.params_from_numpy(
        flat, get_config(arch).reduced(), "cpu")


def test_serve_demo_matches_reference(capsys):
    ref_params, params = _weights(serve_demo.ARCH)
    rows = serve_demo.run("cpu", part=TPU_V5E, params=params)
    assert "tpu-v5e W (model)" in capsys.readouterr().out
    assert [r["format"] for r in rows] == list(serve_demo.FORMATS)
    full = ref_get_config(serve_demo.ARCH)
    base_bytes = sum(x.nbytes for x in jax.tree.leaves(ref_params))
    for row in rows:
        fmt = row["format"]
        _, q = ref_quantize_params(ref_params, fmt)
        assert row["quantized_bytes"] == q["quantized_bytes"], fmt
        np.testing.assert_allclose(row["mse"], q["mse"], rtol=1e-5,
                                   err_msg=fmt)
        hbm = full.active_param_count() * 2 * (
            q["quantized_bytes"] / max(base_bytes, 1))
        want = ref_estimate(REF_TPU_V5E,
                            flops=2.0 * full.active_param_count(),
                            dtype=fmt, bytes_by_level={"hbm": hbm},
                            seconds=hbm / REF_TPU_V5E.hbm.bandwidth_Bps)
        assert row["watts"] == want.total_watts, fmt
        assert dataclasses.asdict(row["estimate"]) == dataclasses.asdict(
            want), fmt
        assert row["fused"] == row["per_step"], fmt
        assert [len(t) for t in row["fused"]] == [serve_demo.N_NEW] * 8


@pytest.mark.parametrize("arch,kv_format", long_context.RUNS)
def test_long_context_matches_reference(arch, kv_format):
    cfg = ref_get_config(arch).reduced()
    if kv_format:
        cfg = dataclasses.replace(cfg, kv_format=kv_format)
    ref_model = ref_build_model(cfg)
    ref_params, params = _weights(arch)
    positions = (24, 40)
    got = long_context.run(arch, positions, kv_format, "cpu", params,
                           log=lambda _: None)
    max_seq = max(positions) + 8
    assert got["max_seq"] == max_seq
    _, cache = jax.jit(lambda p, b: ref_model.prefill(p, b, max_seq))(
        ref_params, {"tokens": jnp.ones((1, 16), jnp.int32)})
    step = jax.jit(ref_model.decode_step)
    tok, pos, tokens = jnp.zeros((1,), jnp.int32), 16, []
    for i, target in enumerate(positions):
        while pos < target:
            lg, cache = step(ref_params, cache, tok,
                             jnp.full((1,), pos, jnp.int32))
            tok = jnp.argmax(lg, -1).astype(jnp.int32)
            tokens.append(int(tok[0]))
            pos += 1
        assert got["cache_bytes"][i] == sum(
            x.nbytes for x in jax.tree.leaves(cache)), target
        assert got["kv"][i] == ref_kv_cache_stats(cache, cfg), target
    assert got["tokens"] == tokens
    assert all(got["finite"])


def test_characterize_example_runs_the_launcher(monkeypatch):
    from repro_torch.launch import characterize as launcher
    seen = []
    monkeypatch.setattr(launcher, "run", seen.append)
    assert characterize.main(["--device", "cpu"]) == 0
    assert seen == ["cpu"]
