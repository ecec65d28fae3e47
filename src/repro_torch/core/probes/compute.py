"""Execution-pipeline probes — paper §IV (Tab III, Fig 2/3); counterpart
of ``repro.core.probes.compute``.

* **True latency** — one thread's chain of *dependent* operations
  (``mad.lo.s32`` / ``fma.rn.f32`` / ``fma.rn.f64``): cycles until a
  result is usable by the next operation.
* **Completion latency** — ``_LANES`` = 4096 independent chains (4 blocks
  of 1024 threads, 32 warps on each SM): cycles an operation takes a
  thread once the SM's pipelines are shared.

On the card every workload runs in the ``dep_chain`` kernel
(``repro_torch.kernels.probe_dep_chain``) and is timed inside it by
``clock64``: cycles per operation are ``(C(n) - C(0)) / n_ops`` of the
median thread, and nanoseconds are those cycles at the clock measured by
``timing.clock_hz`` (cycles over ``globaltimer`` ns).  fp64 is native
there.  On the CPU the plain chains are timed on the host clock, as the
reference times its jnp chains, and converted with the model's nominal
clock.  The workloads, initial values and ``n_ops`` are the reference's.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List, Sequence

import torch

from repro_torch.core import timing
from repro_torch.core.device_model import (DeviceModel, detect_backend_model,
                                           torch_device)
from repro_torch.kernels.probe_dep_chain import run_chain

# Independent lanes for completion-latency/throughput probes.
_LANES = 4096

_WORKLOADS: Dict[str, dict] = {
    "int32": dict(kind="pure", dtype=torch.int32, ops_per_step=1),
    "fp32": dict(kind="pure", dtype=torch.float32, ops_per_step=1),
    "fp64": dict(kind="pure", dtype=torch.float64, ops_per_step=1),
    "mixed1": dict(kind="mixed1", dtype=None, ops_per_step=2),
    "mixed2": dict(kind="mixed2", dtype=None, ops_per_step=2),
}


@dataclasses.dataclass(frozen=True)
class LatencyResult:
    """One Tab III cell: per-instruction latency, ns and device cycles."""

    workload: str
    support: str                  # native | downcast | emulated
    true_ns: float
    completion_ns: float
    true_cycles: float
    completion_cycles: float


def _n_ops(workload: str, chain: int) -> int:
    spec = _WORKLOADS[workload]
    return spec["ops_per_step"] * chain if spec["kind"] != "pure" else chain


def chain_cycles(workload: str, chain: int, lanes: int, dev: torch.device,
                 iters: int, warmup: int = 2, stat=statistics.median
                 ) -> float:
    """Cycles of a ``lanes``-thread chain on the card: ``stat`` over the
    threads of one launch (median: a typical thread; max: the launch's
    span), median over ``iters`` launches after ``warmup``."""
    for _ in range(warmup):
        run_chain(workload, chain, lanes, device=dev)
    per_launch = []
    for _ in range(iters):
        cycles = run_chain(workload, chain, lanes, device=dev).cycles
        per_launch.append(stat(cycles.double().cpu().tolist()))
    return statistics.median(per_launch)


def _host_chain(workload: str, n: int, lanes: int):
    return lambda: run_chain(workload, n, lanes, device="cpu").values


def measure_latency(
    workload: str,
    device: DeviceModel | None = None,
    chain: int = 256,
    iters: int = 20,
) -> LatencyResult:
    """Measure one workload's true + completion latency (Tab III)."""
    device = device or detect_backend_model()
    dev = torch_device(device)
    n_ops = _n_ops(workload, chain)
    if dev.type == "cuda":
        clock = timing.clock_hz(dev)
        c = {lanes: chain_cycles(workload, chain, lanes, dev, iters)
             - chain_cycles(workload, 0, lanes, dev, iters)
             for lanes in (1, _LANES)}
        true_c, comp_c = (max(c[1], 0.0) / n_ops,
                          max(c[_LANES], 0.0) / n_ops)
        return LatencyResult(
            workload=workload, support="native",
            true_ns=true_c / clock * 1e9, completion_ns=comp_c / clock * 1e9,
            true_cycles=true_c, completion_cycles=comp_c)

    base1 = timing.time_fn(_host_chain(workload, 0, 1), iters=iters)
    full1 = timing.time_fn(_host_chain(workload, chain, 1), iters=iters)
    baseL = timing.time_fn(_host_chain(workload, 0, _LANES), iters=iters)
    fullL = timing.time_fn(_host_chain(workload, chain, _LANES), iters=iters)
    t_true = timing.amortized_ns(full1, base1, n_ops)
    t_comp = timing.amortized_ns(fullL, baseL, n_ops)
    clock = device.clock_hz
    return LatencyResult(
        workload=workload,
        support="native",
        true_ns=t_true,
        completion_ns=t_comp,
        true_cycles=t_true * 1e-9 * clock,
        completion_cycles=t_comp * 1e-9 * clock,
    )


def latency_table(device: DeviceModel | None = None,
                  workloads: Sequence[str] = tuple(_WORKLOADS),
                  chain: int = 256, iters: int = 20) -> List[LatencyResult]:
    """The full Tab III analogue."""
    device = device or detect_backend_model()
    return [measure_latency(w, device, chain, iters) for w in workloads]


@dataclasses.dataclass(frozen=True)
class RampPoint:
    """One Fig 2/3 point: dependent-chain length vs cycles & throughput."""

    chain_len: int
    total_ns: float
    total_cycles: float
    ops_per_cycle: float


def ilp_ramp(
    workload: str = "fp32",
    lengths: Sequence[int] = (1, 2, 4, 6, 8, 12, 16, 24, 32, 48, 64,
                              128, 256, 512, 1024),
    lanes: int = _LANES,
    device: DeviceModel | None = None,
    iters: int = 15,
) -> List[RampPoint]:
    """Fig 2/3 analogue: sweep chain length, report total time & throughput.

    ``lanes`` independent chains of ``n`` dependent ops each.  On the card
    the total is the launch's span in cycles (the slowest thread's
    ``clock64`` span, minus that of a chain of length 0) and throughput is
    every lane's operations over it; on the CPU it is the reference's
    wall-time difference at the nominal clock.
    """
    device = device or detect_backend_model()
    dev = torch_device(device)
    ops_per_step = _WORKLOADS[workload]["ops_per_step"]
    out: List[RampPoint] = []
    if dev.type == "cuda":
        clock = timing.clock_hz(dev)
        base = chain_cycles(workload, 0, lanes, dev, iters, stat=max)
        for n in lengths:
            cycles = max(chain_cycles(workload, n, lanes, dev, iters,
                                      stat=max) - base, 1e-3)
            n_ops = n * ops_per_step * lanes
            out.append(RampPoint(chain_len=n, total_ns=cycles / clock * 1e9,
                                 total_cycles=cycles,
                                 ops_per_cycle=n_ops / cycles))
        return out
    base = timing.time_fn(_host_chain(workload, 0, lanes), iters=iters)
    for n in lengths:
        t = timing.time_fn(_host_chain(workload, n, lanes), iters=iters)
        dt = max(t.median_s - base.median_s, 1e-12)
        n_ops = n * ops_per_step * lanes
        cycles = timing.to_cycles(dt, device.clock_hz)
        out.append(RampPoint(
            chain_len=n,
            total_ns=dt * 1e9,
            total_cycles=cycles,
            ops_per_cycle=n_ops / cycles if cycles > 0 else 0.0,
        ))
    return out


def fp64_emulation_factor(device: DeviceModel | None = None,
                          iters: int = 15) -> float:
    """§IV.C: how much slower is an fp64 chain than fp32 (per op,
    completion latency)?  The paper finds ~16x on GB203 (2 FP64 units per
    SM); Hopper has 64 per SM."""
    device = device or detect_backend_model()
    f32 = measure_latency("fp32", device, iters=iters)
    f64 = measure_latency("fp64", device, iters=iters)
    if f32.completion_ns <= 0:
        return 0.0
    return f64.completion_ns / f32.completion_ns
