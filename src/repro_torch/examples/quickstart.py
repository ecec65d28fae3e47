"""Quickstart (counterpart of ``examples/quickstart.py``): train a tiny
qwen-family model on the synthetic affine task, checkpoint it, and serve
a few generations -- the whole stack in one run.

    PYTHONPATH=src python -m repro_torch.examples.quickstart    # the card
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

qwen2.5-3b reduced to 2 layers, AdamW (peak lr 1e-2, warmup 5, cosine
decay over 100), batches of 2 x 64 affine tokens, 60 steps through the
fault-tolerant loop with a checkpoint every 30 (in a temporary
directory), then the trained parameters served greedily: the model
should continue the chain t -> (5 t + 17) mod 97.
"""

from __future__ import annotations

import argparse
import dataclasses
import tempfile

import torch

from repro_torch.compat import resolve_device
from repro_torch.configs import get_config
from repro_torch.data import make_stream
from repro_torch.models.model import build_model
from repro_torch.optim import AdamWConfig, Schedule
from repro_torch.serve import ServeEngine
from repro_torch.train import (TrainLoopConfig, make_train_step,
                               run_train_loop, train_state_init)

BATCH, SEQ = 2, 64               # the reference's smoke_shape("train")
N_NEW = 8


def _affine(x: int) -> int:
    return (5 * x + 17) % 97


def run(device=None, steps: int = 60, checkpoint_every: int = 30) -> dict:
    """Train, checkpoint and serve as the module docstring says; returns
    {"history": the logged metrics, "tokens": the generated tokens,
    "want": the chain's continuation, "hits": how many agree}."""
    device = resolve_device(device)
    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(),
                              n_layers=2)
    model = build_model(cfg)
    print(f"model: {cfg.name} ({cfg.param_count()/1e6:.2f}M params)")

    opt = AdamWConfig(schedule=Schedule(peak_lr=1e-2, warmup_steps=5,
                                        decay_steps=100))
    state = train_state_init(model, opt,
                             torch.Generator(device=device).manual_seed(0),
                             device)
    stream = make_stream(cfg, BATCH, SEQ, device=device)
    step = make_train_step(model, opt)

    with tempfile.TemporaryDirectory() as ckdir:
        state, history = run_train_loop(
            step, state, stream,
            TrainLoopConfig(total_steps=steps,
                            checkpoint_every=checkpoint_every,
                            checkpoint_dir=ckdir, log_every=10))

    print("\nserving the trained model (greedy):")
    engine = ServeEngine(model, state["params"], batch=2, max_seq=96,
                         device=device)
    # the affine task: t_{i+1} = (5 t_i + 17) mod 97 -- the model should
    # continue the chain
    prompt = [3]
    x = 3
    for _ in range(15):
        x = _affine(x)
        prompt.append(x)
    engine.submit(prompt, max_new_tokens=N_NEW)
    result = engine.run()[0]
    want = []
    for _ in range(N_NEW):
        x = _affine(x)
        want.append(x)
    hits = sum(int(a == b) for a, b in zip(result.tokens, want))
    print(f"  prompt tail : {prompt[-4:]}")
    print(f"  generated   : {result.tokens}")
    print(f"  ground truth: {want}")
    print(f"  -> {hits}/{N_NEW} continuations correct")
    return {"history": history, "tokens": list(result.tokens),
            "want": want, "hits": hits}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    return run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
