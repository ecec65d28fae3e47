"""Timing infrastructure — the §IV.A "clock overhead" layer (counterpart
of ``repro.core.timing``).

The paper reads ``%clock64`` inside its kernels and first measures the
cost of the measurement itself (1 cycle on GB203, 2 on GH100).  The port
does the same on the card:

* :func:`measure_timer_overhead` on the card is two back-to-back
  ``clock64`` reads, taken from the ``dep_chain`` kernel at chain length
  0 (:func:`timer_overhead_cycles`), returned in seconds at the
  measured clock; on the CPU it is two ``perf_counter`` calls, as in the
  reference;
* :func:`measure_clock_hz` is the SM clock while a chain runs: its
  ``clock64`` cycles over its ``%globaltimer`` nanoseconds.  Cycles are
  never made from a nominal clock on the card;
* :func:`time_fn` times a region whose result lies on the card with
  CUDA events around each call after the warm-up (nothing is
  subtracted: the events time the device, not the host), and a host
  region with ``perf_counter`` minus the timer overhead, as the
  reference does.  ``_block`` is ``torch.cuda.synchronize`` on the card.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
import time
from typing import Any, Callable, Dict, Optional, Sequence, Union

import torch

from repro_torch.kernels.probe_dep_chain import run_chain


@dataclasses.dataclass(frozen=True)
class TimingResult:
    """Statistics of a timed region, in seconds (overhead already removed)."""

    median_s: float
    mean_s: float
    min_s: float
    std_s: float
    iters: int
    warmup: int
    overhead_s: float
    samples: tuple = ()

    def per(self, n: int) -> float:
        """Median time per inner operation when the region ran ``n`` ops."""
        return self.median_s / max(n, 1)

    @property
    def median_us(self) -> float:
        return self.median_s * 1e6

    @property
    def median_ns(self) -> float:
        return self.median_s * 1e9


_CARD: Dict[str, float] = {}    # device string -> measured figure


def _cuda(device: Union[None, str, torch.device]) -> Optional[torch.device]:
    if device is None:
        return None
    dev = torch.device(device)
    return dev if dev.type == "cuda" else None


def timer_overhead_cycles(device: Union[str, torch.device] = "cuda",
                          reps: int = 9) -> float:
    """§IV.A on the card: median cycles between two back-to-back
    ``clock64`` reads (the ``dep_chain`` kernel at chain length 0, one
    thread)."""
    samples = [float(run_chain("fp32", 0, 1, device=device).cycles.item())
               for _ in range(reps)]
    return statistics.median(samples)


def measure_clock_hz(device: Union[str, torch.device] = "cuda",
                     chain: int = 1 << 20, reps: int = 5) -> float:
    """The SM clock on the card: ``clock64`` cycles over ``globaltimer``
    ns of one thread's fp32 chain (~2 ms at 4 cycles an operation, long
    against the timer's granularity); median of ``reps``."""
    rates = []
    for _ in range(reps):
        r = run_chain("fp32", chain, 1, device=device)
        rates.append(r.cycles.item() / r.ns.item() * 1e9)
    return statistics.median(rates)


def clock_hz(device: Union[str, torch.device] = "cuda") -> float:
    """:func:`measure_clock_hz`, measured once per device."""
    key = f"clock:{torch.device(device)}"
    if key not in _CARD:
        _CARD[key] = measure_clock_hz(device)
    return _CARD[key]


def measure_timer_overhead(reps: int = 1000,
                           device: Union[None, str, torch.device] = None
                           ) -> float:
    """§IV.A: cost of an empty timed region, in seconds.  On the card
    (``device`` a CUDA device) two back-to-back ``clock64`` reads at the
    measured clock; otherwise two ``perf_counter`` calls."""
    dev = _cuda(device)
    if dev is not None:
        return timer_overhead_cycles(dev) / clock_hz(dev)
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        t1 = time.perf_counter()
        samples.append(t1 - t0)
    return statistics.median(samples)


_TIMER_OVERHEAD: Optional[float] = None


def timer_overhead() -> float:
    """The host timer's overhead, measured once (the reference's)."""
    global _TIMER_OVERHEAD
    if _TIMER_OVERHEAD is None:
        _TIMER_OVERHEAD = measure_timer_overhead()
    return _TIMER_OVERHEAD


def _block(x: Any) -> None:
    """Wait for ``x``: a card result waits for the device."""
    if _device_of(x) is not None:
        torch.cuda.synchronize()


def _device_of(x: Any) -> Optional[torch.device]:
    """The CUDA device of the first tensor found in ``x``, else None."""
    if isinstance(x, torch.Tensor):
        return x.device if x.device.type == "cuda" else None
    if isinstance(x, (tuple, list)):
        for v in x:
            d = _device_of(v)
            if d is not None:
                return d
    if isinstance(x, dict):
        return _device_of(list(x.values()))
    return None


def _stats(samples, iters, warmup, ovh, keep_samples) -> TimingResult:
    return TimingResult(
        median_s=statistics.median(samples),
        mean_s=statistics.fmean(samples),
        min_s=min(samples),
        std_s=statistics.pstdev(samples) if len(samples) > 1 else 0.0,
        iters=iters,
        warmup=warmup,
        overhead_s=ovh,
        samples=tuple(samples) if keep_samples else (),
    )


def time_fn(
    fn: Callable[..., Any],
    *args: Any,
    iters: int = 30,
    warmup: int = 3,
    keep_samples: bool = False,
    device: Union[None, str, torch.device] = None,
) -> TimingResult:
    """Time ``fn(*args)`` with warm-up exclusion.

    The region is on the card when ``device`` is a CUDA device or, with
    ``device`` None, when an argument or the warm-up's result is a CUDA
    tensor: each call is then bracketed by two CUDA events, queued behind
    a spin of the device (device time, no subtraction).  Otherwise the host clock brackets each call and
    :func:`timer_overhead` is subtracted, as in the reference.
    """
    dev = _cuda(device) or _device_of(args)
    out = None
    for _ in range(warmup):
        out = fn(*args)
        _block(out)
    if dev is None:
        dev = _device_of(out)
    samples = []
    if dev is not None:
        with torch.cuda.device(dev):
            torch.cuda.synchronize()
            for _ in range(iters):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                # queued behind a ~0.5 ms spin so the host's enqueueing
                # overlaps it: the events then time the device alone
                torch.cuda._sleep(1_000_000)
                start.record()
                fn(*args)
                end.record()
                end.synchronize()
                samples.append(start.elapsed_time(end) * 1e-3)
        return _stats(samples, iters, warmup, 0.0, keep_samples)
    ovh = timer_overhead()
    for _ in range(iters):
        t0 = time.perf_counter()
        _block(fn(*args))
        t1 = time.perf_counter()
        samples.append(max(t1 - t0 - ovh, 0.0))
    return _stats(samples, iters, warmup, ovh, keep_samples)


def to_cycles(seconds: float, clock_hz: float) -> float:
    """Convert wall seconds to the paper's unit (clock cycles)."""
    return seconds * clock_hz


def amortized_ns(total: TimingResult, baseline: TimingResult, n: int) -> float:
    """Per-op time of the *increment* between two regions:
    ``(T(chain=n) - T(chain=0)) / n``."""
    if n <= 0:
        return 0.0
    return max(total.median_s - baseline.median_s, 0.0) / n * 1e9


def geomean(xs: Sequence[float]) -> float:
    xs = [x for x in xs if x > 0]
    if not xs:
        return 0.0
    return math.exp(sum(math.log(x) for x in xs) / len(xs))
