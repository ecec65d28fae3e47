"""Straggler watchdog and heartbeat (counterpart of
``repro.distributed.elastic``; ``remesh`` waits for the mesh).

* :class:`StepWatchdog` keeps a rolling median of step times; a step
  longer than ``deadline_factor`` x that median is a
  :class:`StragglerEvent` (the train loop snapshots on one).
* :class:`Heartbeat` is the per-process liveness file, replaced
  atomically every step; a supervisor restarts ranks whose heartbeat
  goes stale.
"""

from __future__ import annotations

import dataclasses
import os
import statistics
import time
from typing import Callable, List, Optional


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration_s: float
    median_s: float


class StepWatchdog:
    """Rolling-median step-time monitor with a deadline callback."""

    def __init__(self, deadline_factor: float = 3.0, window: int = 32,
                 on_straggler: Optional[Callable[[StragglerEvent], None]]
                 = None):
        self.deadline_factor = deadline_factor
        self.window = window
        self.on_straggler = on_straggler
        self.durations: List[float] = []
        self.events: List[StragglerEvent] = []
        self._t0: Optional[float] = None
        self._step = 0

    def start_step(self, step: int) -> None:
        self._step = step
        self._t0 = time.perf_counter()

    def end_step(self) -> Optional[StragglerEvent]:
        if self._t0 is None:
            raise RuntimeError("end_step without start_step")
        dur = time.perf_counter() - self._t0
        self._t0 = None
        event = None
        if len(self.durations) >= 4:
            med = statistics.median(self.durations[-self.window:])
            if dur > self.deadline_factor * med:
                event = StragglerEvent(self._step, dur, med)
                self.events.append(event)
                if self.on_straggler:
                    self.on_straggler(event)
        self.durations.append(dur)
        return event

    @property
    def median_s(self) -> float:
        return statistics.median(self.durations) if self.durations else 0.0


class Heartbeat:
    """Liveness file touched every step; supervisors watch its time."""

    def __init__(self, path: str, process_index: int = 0):
        self.path = os.path.join(path, f"heartbeat.{process_index}")
        os.makedirs(path, exist_ok=True)

    def beat(self, step: int) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write(f"{step} {time.time()}\n")
        os.replace(tmp, self.path)

    def last(self) -> Optional[tuple]:
        try:
            with open(self.path) as f:
                step, ts = f.read().split()
            return int(step), float(ts)
        except (FileNotFoundError, ValueError):
            return None

    def stale(self, timeout_s: float) -> bool:
        last = self.last()
        return last is None or (time.time() - last[1]) > timeout_s
