"""The port's training examples on the CPU, with few steps.

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
  graph (``ServeEngine`` detaches what it is given).
"""

import dataclasses
import math

import pytest
import torch

from repro_torch.bridge import flatten, unflatten
from repro_torch.configs import get_config
from repro_torch.examples import quickstart, train_100m
from repro_torch.models.model import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.serve import ServeEngine
from repro_torch.train import train_state_init


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
