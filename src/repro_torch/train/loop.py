"""Fault-tolerant training loop (counterpart of ``repro.train.loop``):
stream -> train step -> metrics, with resume from the latest checkpoint,
async snapshots every ``checkpoint_every`` steps and on a straggler
step, a heartbeat, and the history of logged metrics."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from repro_torch.checkpoint import Checkpointer
from repro_torch.distributed.elastic import Heartbeat, StepWatchdog


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    log_every: int = 10
    checkpoint_dir: Optional[str] = None
    async_checkpoint: bool = True
    straggler_deadline_factor: float = 3.0


def run_train_loop(
    train_step: Callable,
    state: Any,
    stream,                       # object with .batch(step)
    loop_cfg: TrainLoopConfig,
    on_metrics: Optional[Callable[[int, Dict[str, float]], None]] = None,
):
    """Runs to ``total_steps``; resumes from the latest checkpoint in
    ``checkpoint_dir`` if there is one (restored into ``state`` in
    place).  Returns (the final state, the history of logged metrics).
    Each step ends with a host read of its loss (the step's work is then
    done, as ``block_until_ready`` makes it in the reference), so the
    watchdog times whole steps."""
    ckpt = hb = None
    start_step = 0
    if loop_cfg.checkpoint_dir:
        ckpt = Checkpointer(loop_cfg.checkpoint_dir,
                            async_save=loop_cfg.async_checkpoint)
        restored = ckpt.restore_latest(like=state)
        if restored is not None:
            state, start_step = restored
            print(f"[train] resumed from step {start_step}")
        hb = Heartbeat(loop_cfg.checkpoint_dir)

    watchdog = StepWatchdog(loop_cfg.straggler_deadline_factor)
    history: List[Dict[str, float]] = []

    for step in range(start_step, loop_cfg.total_steps):
        watchdog.start_step(step)
        batch = stream.batch(step)
        state, metrics = train_step(state, batch)
        loss = float(metrics["loss"])
        event = watchdog.end_step()
        if event is not None:
            print(f"[train] straggler step {event.step}: "
                  f"{event.duration_s:.3f}s vs median {event.median_s:.3f}s"
                  f" — snapshotting")
            if ckpt:
                ckpt.save(state, step + 1, block=False)
        if hb:
            hb.beat(step)
        if step % loop_cfg.log_every == 0 or step == loop_cfg.total_steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["loss"] = loss
            history.append({"step": step, **m})
            if on_metrics:
                on_metrics(step, m)
            else:
                print(f"[train] step {step:5d} loss {m['loss']:.4f} "
                      f"acc {m['acc']:.3f} gnorm {m['grad_norm']:.2f}")
        if ckpt and (step + 1) % loop_cfg.checkpoint_every == 0:
            ckpt.save(state, step + 1, block=False)

    if ckpt:
        ckpt.save(state, loop_cfg.total_steps, block=True)
        ckpt.close()
    return state, history
