"""End-to-end training example (counterpart of ``examples/train_100m.py``):
a ~100M-parameter llama-family model (96.5 M by ``param_count``) on the
synthetic affine task, with
checkpoint / restart, the straggler watchdog and metrics logging.

    PYTHONPATH=src python -m repro_torch.examples.train_100m --steps 300
    (interrupt it and run it again with the same --ckpt to watch it
    resume; --device cpu runs on the host)

AdamW with peak lr ``--lr``, warmup 30 and a cosine decay over
``--steps``; a checkpoint every ``max(steps // 5, 20)`` steps and at the
end, under ``--ckpt``.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.compat import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.data import SyntheticConfig, SyntheticStream
from repro_torch.models.model import build_model
from repro_torch.optim import AdamWConfig, Schedule
from repro_torch.train import (TrainLoopConfig, make_train_step,
                               run_train_loop, train_state_init)

# a small llama3-family config: 96.5 M params by param_count()
CONFIG_100M = ArchConfig(
    name="llama-100m",
    family="dense",
    n_layers=14,
    d_model=640,
    n_heads=10,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=16384,
    mlp_variant="swiglu",
    tie_embeddings=True,
)


def main(argv=None) -> list:
    """Train as the module docstring says; returns the logged metrics of
    this run (empty when the checkpoint is already at ``--steps``)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_100m_ckpt"))
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = CONFIG_100M
    model = build_model(cfg)
    print(f"training {cfg.name}: {cfg.param_count()/1e6:.1f}M params, "
          f"{args.steps} steps @ batch {args.batch} x seq {args.seq}")

    stream = SyntheticStream(cfg, args.batch, args.seq,
                             SyntheticConfig(kind="affine"), device=device)
    opt = AdamWConfig(
        schedule=Schedule(peak_lr=args.lr, warmup_steps=30,
                          decay_steps=args.steps))
    state = train_state_init(model, opt,
                             torch.Generator(device=device).manual_seed(0),
                             device)
    step = make_train_step(model, opt)

    state, history = run_train_loop(
        step, state, stream,
        TrainLoopConfig(total_steps=args.steps,
                        checkpoint_every=max(args.steps // 5, 20),
                        checkpoint_dir=args.ckpt, log_every=10))
    if history:
        print(f"done: loss {history[0]['loss']:.3f} -> "
              f"{history[-1]['loss']:.3f}, acc {history[-1]['acc']:.3f}")
    return history


if __name__ == "__main__":
    main()
