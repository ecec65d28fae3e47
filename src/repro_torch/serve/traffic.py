"""Traffic scenario harness: deterministic arrival traces replayed
through :class:`~repro_torch.serve.ServeEngine` (the port's copy of
``repro.serve.traffic``).

Seeded arrival traces (mixed prompt and output lengths from
``repro_torch.data.synthetic.host_prompt``) replay against an engine and
give a :class:`ScenarioReport` with TTFT and per-token p50 / p99,
goodput and exact status accounting.

Every random choice is seeded host numpy (``np.random.default_rng``), so
the same (scenario, seed) gives the same trace on every machine, token
for token the reference's.  The replay clock is injectable:

* ``step_cost_s=None`` (default): **wall mode**, arrivals are released
  against measured elapsed time and latencies are real;
* ``step_cost_s=x``: **virtual mode**, the clock advances ``x`` per
  fused decode step (or one ``x`` for a tick that could not dispatch).
  Fully deterministic: tests assert exact shed / deadline accounting.

The replay drives the same fused decode block as steady-state serving.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.data.synthetic import host_prompt
from repro_torch.serve.admission import AdmissionConfig, QueueFull


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One request in a trace: arrival time (seconds from scenario
    start) plus the request shape."""
    t: float
    prompt: List[int]
    max_new_tokens: int
    deadline_ms: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named, fully-determined arrival trace."""
    name: str
    seed: int
    arrivals: Sequence[Arrival]


def _mk_arrivals(name: str, seed: int, times: np.ndarray,
                 vocab_size: int, prompt_lens: Sequence[int],
                 output_lens: Sequence[int],
                 deadline_ms: Optional[float]) -> Scenario:
    rng = np.random.default_rng(seed ^ 0x5EED)
    arrivals = []
    for i, t in enumerate(times):
        plen = int(rng.choice(prompt_lens))
        olen = int(rng.choice(output_lens))
        arrivals.append(Arrival(
            t=float(t),
            prompt=host_prompt(plen, seed=seed * 100003 + i,
                               vocab_size=vocab_size),
            max_new_tokens=olen, deadline_ms=deadline_ms))
    return Scenario(name=name, seed=seed, arrivals=tuple(arrivals))


def poisson_trace(n: int, rate: float, vocab_size: int, seed: int = 0,
                  prompt_lens: Sequence[int] = (4, 8, 16, 24),
                  output_lens: Sequence[int] = (4, 8, 16),
                  deadline_ms: Optional[float] = None) -> Scenario:
    """``n`` arrivals with exponential inter-arrival gaps at ``rate``
    requests/second — the memoryless baseline every queueing result is
    stated against."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n)
    return _mk_arrivals(f"poisson_r{rate:g}", seed, np.cumsum(gaps),
                        vocab_size, prompt_lens, output_lens, deadline_ms)


def bursty_trace(n_bursts: int, burst_size: int, gap_s: float,
                 vocab_size: int, seed: int = 0,
                 prompt_lens: Sequence[int] = (4, 8, 16, 24),
                 output_lens: Sequence[int] = (4, 8, 16),
                 deadline_ms: Optional[float] = None) -> Scenario:
    """``n_bursts`` bursts of ``burst_size`` simultaneous arrivals,
    ``gap_s`` apart — the pattern that exposes queue-depth spikes and
    head-of-line blocking that a smooth Poisson average hides."""
    times = np.repeat(np.arange(n_bursts) * gap_s, burst_size)
    return _mk_arrivals(f"bursty_{n_bursts}x{burst_size}", seed, times,
                        vocab_size, prompt_lens, output_lens, deadline_ms)


def overload_ramp_trace(n: int, rate0: float, rate1: float,
                        vocab_size: int, seed: int = 0,
                        prompt_lens: Sequence[int] = (4, 8, 16, 24),
                        output_lens: Sequence[int] = (4, 8, 16),
                        deadline_ms: Optional[float] = None) -> Scenario:
    """Arrival rate ramping linearly from ``rate0`` to ``rate1``
    requests/second across ``n`` arrivals — crosses the capacity knee
    mid-trace, so one run measures underload, saturation, and overload
    (where the admission policy, not throughput, decides behaviour)."""
    rng = np.random.default_rng(seed)
    rates = np.linspace(rate0, rate1, n)
    gaps = rng.exponential(1.0, size=n) / rates
    return _mk_arrivals(f"ramp_r{rate0:g}-{rate1:g}", seed,
                        np.cumsum(gaps), vocab_size, prompt_lens,
                        output_lens, deadline_ms)


TRACES = {"poisson": poisson_trace, "bursty": bursty_trace,
          "ramp": overload_ramp_trace}


def _pct(xs: List[float], q: float) -> Optional[float]:
    return float(np.percentile(xs, q)) if xs else None


@dataclasses.dataclass
class ScenarioReport:
    """Replay outcome: tails, goodput, exact accounting."""
    scenario: str
    k: int
    policy: str
    scheduler: str
    submitted: int
    by_status: Dict[str, int]
    elapsed_s: float
    tokens_ok: int               # tokens of status="ok" results only
    tokens_total: int            # all delivered tokens incl. partials
    goodput_tok_s: float         # tokens_ok / elapsed
    ttft_p50: Optional[float]    # seconds, over results with a first
    ttft_p99: Optional[float]    # token (admitted at all)
    tpt_p50: Optional[float]     # per-token decode seconds, over "ok"
    tpt_p99: Optional[float]     # results with >= 2 tokens
    accounting_ok: bool          # submitted == sum(by_status)

    def row(self) -> Dict:
        """Flat dict of the report."""
        return dataclasses.asdict(self)


def replay(engine, scenario: Scenario, k: Optional[int] = None,
           admission: Optional[AdmissionConfig] = None,
           step_cost_s: Optional[float] = None,
           max_wall_s: float = 120.0,
           max_ticks: int = 100_000) -> ScenarioReport:
    """Replay ``scenario`` through ``engine`` and measure it.

    The engine is reset first; ``admission`` (if given) replaces its
    policy (host-side only).  ``step_cost_s=None`` uses real
    wall time; a float switches to the deterministic virtual clock
    (every decode tick charges ``step_cost_s * k``, or one
    ``step_cost_s`` when the tick could not dispatch — the clock always
    advances, so deadlines expire and the replay terminates).

    ``block``-policy arrivals that hit :class:`QueueFull` are re-offered
    on the next tick — the backpressure contract: the caller owns the
    retry.  If the wall/tick guard trips first, still-queued requests
    are drained as ``shed`` and in-flight ones flushed as ``truncated``
    so accounting stays exact; never-submitted arrivals (still pending
    or blocked) are simply not counted as submitted."""
    engine.reset()
    if admission is not None:
        engine.set_admission(admission)
    k = k or engine.decode_block
    virtual = step_cost_s is not None
    clock = _VirtualClock() if virtual else _WallClock()
    engine.set_clock(clock.now)

    pending = list(scenario.arrivals)       # trace order = time order
    blocked: List[Arrival] = []
    ticks = 0
    while pending or blocked or engine.queue or engine._any_active():
        ticks += 1
        if ticks > max_ticks or (not virtual
                                 and clock.now() > max_wall_s):
            break
        t = clock.now()
        due = [a for a in pending if a.t <= t]
        pending = [a for a in pending if a.t > t]
        retry, blocked = blocked, []
        for a in retry + due:
            try:
                engine.submit(a.prompt, a.max_new_tokens,
                              deadline_ms=a.deadline_ms)
            except QueueFull:
                blocked.append(a)
        if engine.queue or engine._any_active():
            d0 = engine.dispatches
            engine.decode_loop(k)
            if virtual:
                dispatched = engine.dispatches > d0
                clock.advance(step_cost_s * (k if dispatched else 1))
        elif pending:
            # idle gap: fast-forward (virtual) / nap (wall) to the
            # next arrival instead of busy-spinning submit checks
            nxt = min(a.t for a in pending)
            if virtual:
                clock.advance(max(nxt - clock.now(), step_cost_s))
            else:
                time.sleep(min(max(nxt - clock.now(), 0.0), 0.01))

    # guard tripped: drain to a fully-accounted terminal state
    for req in engine.queue.drain():
        engine._finish_unadmitted(req, "shed")
    if engine._any_active():
        engine.run(max_steps=0)             # flush partials: truncated

    elapsed = max(clock.now(), 1e-9)
    res = engine.results
    by_status: Dict[str, int] = {}
    for r in res:
        by_status[r.status] = by_status.get(r.status, 0) + 1
    ttfts = [r.ttft for r in res if r.ttft is not None]
    tpts = [(r.finish_t - r.first_token_t) / (len(r.tokens) - 1)
            for r in res
            if r.status == "ok" and r.first_token_t is not None
            and r.finish_t is not None and len(r.tokens) >= 2]
    tokens_ok = sum(len(r.tokens) for r in res if r.status == "ok")
    tokens_total = sum(len(r.tokens) for r in res)
    acc = engine.accounting()
    cfg = engine.queue.cfg
    return ScenarioReport(
        scenario=scenario.name, k=k, policy=cfg.policy,
        scheduler=cfg.scheduler, submitted=acc["submitted"],
        by_status=by_status, elapsed_s=elapsed, tokens_ok=tokens_ok,
        tokens_total=tokens_total, goodput_tok_s=tokens_ok / elapsed,
        ttft_p50=_pct(ttfts, 50), ttft_p99=_pct(ttfts, 99),
        tpt_p50=_pct(tpts, 50), tpt_p99=_pct(tpts, 99),
        accounting_ok=(acc["balanced"] and acc["in_flight"] == 0
                       and acc["queued"] == 0))


class _VirtualClock:
    """Deterministic replay clock: advances only when charged."""

    def __init__(self) -> None:
        self._t = 0.0

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        self._t += dt


class _WallClock:
    """Measured clock, zeroed at replay start."""

    def __init__(self) -> None:
        self._t0 = time.monotonic()

    def now(self) -> float:
        return time.monotonic() - self._t0
