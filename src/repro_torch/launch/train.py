"""Training launcher (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --steps 200 --batch 8 --seq 256 --accum 2 --ckpt /tmp/ckpt

runs on the card (the default; it raises without one) at full width,
the parameters from ``init_lm`` seeded by a ``torch.Generator`` (seed
``--seed``), AdamW with the reference's schedule (warmup 20, cosine
decay over ``--steps``) and its ``m_dtype`` / ``factored_v`` choice
(bf16 ``m`` and a factored ``v`` for an FSDP config), a
:class:`~repro_torch.data.SyntheticStream` of ``--data`` batches, and
the fault-tolerant loop (checkpoint / restart under ``--ckpt``,
straggler watchdog, heartbeat).  ``--device cpu --reduced`` runs the
same path on the host with the kernels' plain versions.  ``--layers``
cuts the depth (whole periods; width is never cut).

Every family trains: attention through ``flash_attention`` and its
backward kernel, the SSD blocks of mamba2-2.7b and jamba-v0.1-52b
through ``ssd_scan`` and its backward kernel (``--arch mamba2-2.7b``
trains at full width and depth on one 80 GB card, ~32 GB of state).
jamba-v0.1-52b (13.3 B params a period of 8 layers, ~159 GB of training
state) trains at full width only once sharding lands (its config says
``fsdp``); on one card take ``--reduced``.

The reference's ``--production-mesh`` and ``--multi-pod`` wait for mesh
serving: one card, no mesh, here.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.compat import resolve_device
from repro_torch.configs import get_config
from repro_torch.data import SyntheticConfig, SyntheticStream
from repro_torch.models.model import build_model
from repro_torch.optim import AdamWConfig, Schedule
from repro_torch.train import (TrainLoopConfig, make_train_step,
                               run_train_loop, train_state_init)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        description="Train on one card (no mesh: the reference's "
                    "--production-mesh / --multi-pod wait for mesh "
                    "serving).")
    ap.add_argument("--arch", default="qwen2.5-3b",
                    help="any config; jamba-v0.1-52b trains at full width "
                         "only once sharding lands (one period is ~159 GB "
                         "of training state): take --reduced")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced (smoke) config for CPU runs")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (a multiple "
                         "of the block period)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--data", default="affine",
                    choices=["affine", "uniform", "zipf"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers is not None:
        if args.layers % len(cfg.block_pattern()):
            raise SystemExit(f"--layers {args.layers}: not whole periods "
                             f"of {len(cfg.block_pattern())} blocks")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = build_model(cfg)
    opt_cfg = AdamWConfig(
        schedule=Schedule(peak_lr=args.lr, warmup_steps=20,
                          decay_steps=args.steps),
        m_dtype="bfloat16" if cfg.fsdp else "float32",
        factored_v=cfg.fsdp)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = train_state_init(model, opt_cfg, gen, device)
    step_fn = make_train_step(model, opt_cfg, accum_steps=args.accum)
    stream = SyntheticStream(cfg, args.batch, args.seq,
                             SyntheticConfig(kind=args.data, seed=args.seed),
                             device=device)
    loop_cfg = TrainLoopConfig(
        total_steps=args.steps, checkpoint_dir=args.ckpt,
        checkpoint_every=max(args.steps // 4, 10))
    print(f"[train] {cfg.name} layers={cfg.n_layers} device={device} "
          f"batch={args.batch} seq={args.seq} accum={args.accum}")
    t0 = time.perf_counter()
    state, history = run_train_loop(step_fn, state, stream, loop_cfg)
    if history:
        print(f"[train] done: final loss {history[-1]['loss']:.4f} "
              f"({time.perf_counter() - t0:.1f} s)")
    return history


if __name__ == "__main__":
    main()
