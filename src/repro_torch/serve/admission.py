"""Admission control for the serving engine: bounded queue, overload
policies, deadlines, and pluggable scheduling (the port's copy of
``repro.serve.admission``, which is host Python).

Overload behaviour is an explicit, *accounted* policy choice:

* **Bounded queue** — ``queue_limit`` caps queued (not in-flight)
  requests.  What happens at the cap is the ``policy``:

  - ``"reject"``      the NEW request is shed (finishes immediately with
                      ``status="shed"``, zero tokens) — classic
                      admission control; protects queued work.
  - ``"shed_oldest"`` the oldest queued request is shed and the new one
                      admitted — freshest-work-wins; bounds queueing
                      delay at the cost of wasted earlier arrivals.
  - ``"block"``       ``submit()`` raises :class:`QueueFull` — explicit
                      backpressure to the caller, who owns the retry
                      (the traffic harness re-offers on the next tick).

* **Deadlines** — a request can carry an absolute deadline (engine
  ``submit(deadline_ms=...)``, measured on the engine's clock).  Expired
  *queued* requests are dropped at admission time (no prefill is ever
  spent on them); expired *in-flight* requests are cancelled through the
  engine's one cancel state-write and finish as
  ``status="deadline_exceeded"`` with their partial tokens.

* **Scheduling** — ``scheduler`` picks which queued request a freed slot
  takes: ``"fifo"`` (arrival order) or ``"spf"`` (shortest-prompt-first:
  smallest decoder trunk wins; ties resolve FIFO).  SPF minimizes mean
  TTFT under mixed prompt lengths at the cost of long-prompt starvation
  — which the deadline mechanism then surfaces as explicit
  ``deadline_exceeded`` results instead of silent unbounded waiting.

Everything here is host-side bookkeeping: no policy decision reads a
device value, so one engine serves every (policy, scheduler, deadline)
combination with the same device work.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Deque, List, Optional, Tuple

POLICIES = ("reject", "shed_oldest", "block")
SCHEDULERS = ("fifo", "spf")


class QueueFull(RuntimeError):
    """Raised by ``submit()`` under ``policy="block"`` when the queue is
    at ``queue_limit`` — backpressure is the caller's to handle."""


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Admission/overload policy for a
    :class:`~repro_torch.serve.ServeEngine`.

    ``queue_limit=None`` with FIFO scheduling and no default deadline is
    exactly the pre-admission-control engine behaviour."""

    queue_limit: Optional[int] = None      # None = unbounded
    policy: str = "reject"                 # at the limit: see POLICIES
    scheduler: str = "fifo"                # freed-slot pick: fifo | spf
    deadline_ms: Optional[float] = None    # default per-request deadline

    def __post_init__(self) -> None:
        if self.policy not in POLICIES:
            raise ValueError(f"policy {self.policy!r} not in {POLICIES}")
        if self.scheduler not in SCHEDULERS:
            raise ValueError(
                f"scheduler {self.scheduler!r} not in {SCHEDULERS}")
        if self.queue_limit is not None and self.queue_limit < 1:
            raise ValueError("queue_limit must be >= 1 (or None)")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError("deadline_ms must be positive (or None)")


class AdmissionQueue:
    """Bounded request queue enforcing one :class:`AdmissionConfig`.

    Items are engine ``_Request`` objects (anything exposing
    ``request_id``, ``trunk_len`` and ``deadline_s``); the queue never
    touches device state."""

    def __init__(self, cfg: Optional[AdmissionConfig] = None):
        self.cfg = cfg or AdmissionConfig()
        self._q: Deque = collections.deque()

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)

    # -- enqueue -------------------------------------------------------- #
    def offer(self, req) -> Tuple[bool, List]:
        """Try to enqueue ``req``; returns ``(accepted, shed)``.

        ``shed`` lists requests the overload policy dropped — the new
        one under ``"reject"`` (then ``accepted`` is False), the oldest
        queued one under ``"shed_oldest"``.  ``"block"`` raises
        :class:`QueueFull` instead of shedding."""
        lim = self.cfg.queue_limit
        if lim is None or len(self._q) < lim:
            self._q.append(req)
            return True, []
        if self.cfg.policy == "reject":
            return False, [req]
        if self.cfg.policy == "shed_oldest":
            oldest = self._q.popleft()
            self._q.append(req)
            return True, [oldest]
        raise QueueFull(
            f"queue at limit {lim} (policy=block): retry after the "
            f"engine drains")

    # -- dequeue -------------------------------------------------------- #
    def take(self, now: float) -> Tuple[Optional[object], List]:
        """Pop the next admittable request per the scheduler; returns
        ``(request_or_None, expired)`` where ``expired`` are queued
        requests whose deadline passed before a slot freed up — they
        must be finished as ``deadline_exceeded`` without prefill."""
        expired: List = []
        while True:
            live = [r for r in self._q
                    if r.deadline_s is not None and now >= r.deadline_s]
            for r in live:
                self._q.remove(r)
                expired.append(r)
            if not self._q:
                return None, expired
            if self.cfg.scheduler == "spf":
                req = min(self._q, key=lambda r: r.trunk_len)
                self._q.remove(req)
            else:
                req = self._q.popleft()
            return req, expired

    def remove(self, request_id: int):
        """Pull a specific queued request (``cancel`` path); None if the
        id is not queued."""
        for r in self._q:
            if r.request_id == request_id:
                self._q.remove(r)
                return r
        return None

    def drain(self) -> List:
        """Empty the queue, returning the stranded requests (engine
        flush path: they finish as shed)."""
        out = list(self._q)
        self._q.clear()
        return out
