"""Memory-subsystem probes — paper §VI (Fig 6-10); counterpart of
``repro.core.probes.memory``.

* :func:`pointer_chase` / :func:`chase_curve` — Fig 6: serialized random
  dependent loads over a swept working set.  On the card they run the
  ``chase`` kernel (``repro_torch.kernels.probe_chase``) over
  ``_permutation_chain(n)`` seen as an (n, 1) buffer; cycles per load
  come from ``clock64`` and ns from ``globaltimer`` inside the kernel,
  after its in-launch warm-up.  On the CPU the plain walk is timed on
  the host clock, as in the reference.
* :func:`stride_sweep` — Fig 7/8, :func:`stream_bandwidth` — Fig 10,
  :func:`concurrency_scaling` — Fig 9: plain torch ops (gather-sum,
  sum, fill, multiply), the counterparts of the reference's XLA ops,
  timed by ``timing.time_fn`` (CUDA events on the card).
* :func:`find_boundaries` — capacity estimates from the chase curve.
"""

from __future__ import annotations

import dataclasses
import functools
import statistics
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.core import timing
from repro_torch.core.device_model import (DeviceModel, detect_backend_model,
                                           torch_device)
from repro_torch.kernels.probe_chase import chase_timed


@dataclasses.dataclass(frozen=True)
class ChasePoint:
    working_set_bytes: int
    ns_per_load: float
    cycles_per_load: float


@functools.lru_cache(maxsize=16)
def _permutation_chain(n: int, seed: int = 0) -> np.ndarray:
    """Single-cycle random permutation (Sattolo) => the chase visits every
    element exactly once.  Bit-identical to the reference's: the swap
    indices are drawn in one call (numpy draws the same stream as one
    call per index) and swapped in a Python list."""
    rng = np.random.default_rng(seed)
    js = rng.integers(0, np.arange(n - 1, 0, -1)).tolist() if n > 1 else []
    idx = list(range(n))
    i = n - 1
    for j in js:
        idx[i], idx[j] = idx[j], idx[i]
        i -= 1
    idx = np.asarray(idx, dtype=np.int32)
    # idx is now a permutation; build "next" pointers following the cycle.
    nxt = np.empty(n, dtype=np.int32)
    nxt[idx[:-1]] = idx[1:]
    nxt[idx[-1]] = idx[0]
    nxt.setflags(write=False)
    return nxt


def pointer_chase(
    working_set_bytes: int,
    steps: int = 1 << 14,
    device: DeviceModel | None = None,
    iters: int = 7,
    seed: int = 0,
) -> ChasePoint:
    """Latency of one serialized random load within ``working_set_bytes``."""
    device = device or detect_backend_model()
    dev = torch_device(device)
    n = max(working_set_bytes // 4, 16)          # int32 elements
    buf = torch.from_numpy(_permutation_chain(n, seed).copy()).view(n, 1)
    buf = buf.to(dev)
    if dev.type == "cuda":
        chase_timed(buf, steps)                  # one launch of warm-up
        runs = [chase_timed(buf, steps) for _ in range(iters)]
        return ChasePoint(
            working_set_bytes=n * 4,
            ns_per_load=statistics.median(r.ns for r in runs) / steps,
            cycles_per_load=statistics.median(r.cycles for r in runs) / steps,
        )
    t = timing.time_fn(chase_timed, buf, steps, iters=iters)
    ns = t.median_s / steps * 1e9
    return ChasePoint(
        working_set_bytes=n * 4,
        ns_per_load=ns,
        cycles_per_load=ns * 1e-9 * device.clock_hz,
    )


def chase_curve(
    sizes: Sequence[int] = tuple(
        1 << p for p in range(12, 28)),          # 4 KiB .. 128 MiB
    steps: int = 1 << 14,
    device: DeviceModel | None = None,
    iters: int = 5,
) -> List[ChasePoint]:
    """Fig 6 analogue: the full hierarchy walk."""
    device = device or detect_backend_model()
    return [pointer_chase(s, steps, device, iters) for s in sizes]


def find_boundaries(curve: Sequence[ChasePoint],
                    jump: float = 1.4) -> List[int]:
    """Working-set sizes at which latency jumps by >= ``jump``x — the
    paper's "latency spikes correspond to cache boundaries"."""
    out = []
    for prev, cur in zip(curve, curve[1:]):
        if prev.ns_per_load > 0 and \
                cur.ns_per_load / prev.ns_per_load >= jump:
            out.append(prev.working_set_bytes)
    return out


# ---------------------------------------------------------------------------
# Strided access (Fig 7/8 — bank-conflict analogue)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StridePoint:
    stride: int
    concurrency: int
    ns_per_access: float


def _strided_reduce(x: torch.Tensor, stride: int, lanes: int,
                    accesses: int) -> torch.Tensor:
    # ``lanes`` independent streams each reading ``accesses`` elements at
    # ``stride`` spacing, as a gather
    base = torch.arange(lanes, device=x.device)[:, None]
    offs = torch.arange(accesses, device=x.device)[None, :] * stride
    idx = (base * accesses * stride + offs) % x.shape[0]
    return x[idx].sum()


def stride_sweep(
    strides: Sequence[int] = (1, 4),
    concurrencies: Sequence[int] = (1, 2, 4, 8, 16, 32),
    accesses: int = 4096,
    working_set_bytes: int = 1 << 22,
    iters: int = 7,
    device: DeviceModel | None = None,
) -> List[StridePoint]:
    """Fig 7/8 analogue: latency vs concurrency for unit vs skewed stride."""
    dev = torch_device(device or detect_backend_model())
    n = working_set_bytes // 4
    x = torch.arange(n, dtype=torch.float32, device=dev)
    out = []
    for s in strides:
        for c in concurrencies:
            t = timing.time_fn(_strided_reduce, x, s, c, accesses,
                               iters=iters)
            out.append(StridePoint(
                stride=s, concurrency=c,
                ns_per_access=t.median_s / (c * accesses) * 1e9,
            ))
    return out


# ---------------------------------------------------------------------------
# Streaming bandwidth (Fig 10)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BandwidthResult:
    mode: str                 # read | write | copy
    nbytes: int
    gbps: float


def stream_bandwidth(
    nbytes: int = 1 << 28,
    modes: Sequence[str] = ("read", "write", "copy"),
    iters: int = 7,
    device: DeviceModel | None = None,
) -> List[BandwidthResult]:
    """Fig 10 analogue: ``sum`` reads n floats, ``fill_`` writes them,
    ``mul(x, 1.0, out=y)`` reads and writes them."""
    dev = torch_device(device or detect_backend_model())
    n = nbytes // 4
    x = torch.ones((n,), dtype=torch.float32, device=dev)
    out: List[BandwidthResult] = []
    for mode in modes:
        if mode == "read":
            t = timing.time_fn(torch.sum, x, iters=iters)
            moved = n * 4
        elif mode == "write":
            buf = torch.zeros((n,), dtype=torch.float32, device=dev)
            t = timing.time_fn(buf.fill_, 1.0, iters=iters, device=dev)
            moved = n * 4
            del buf
        else:
            y = torch.empty_like(x)
            t = timing.time_fn(lambda: torch.mul(x, 1.0, out=y),
                               iters=iters, device=dev)
            moved = 2 * n * 4
            del y
        out.append(BandwidthResult(mode, moved,
                                   moved / t.median_s / 1e9))
    return out


# ---------------------------------------------------------------------------
# Concurrency scaling (Fig 9)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConcurrencyPoint:
    streams: int
    ns_per_stream_access: float
    aggregate_gbps: float


def _multi_stream(x: torch.Tensor, streams: int) -> torch.Tensor:
    return x.reshape(streams, -1).sum(dim=1).sum()


def concurrency_scaling(
    streams_list: Sequence[int] = (1, 2, 4, 8, 16, 32),
    total_bytes: int = 1 << 26,
    iters: int = 7,
    device: DeviceModel | None = None,
) -> List[ConcurrencyPoint]:
    """Fig 9 analogue: fixed total traffic split across N concurrent
    streams; graceful saturation vs contention collapse."""
    dev = torch_device(device or detect_backend_model())
    n = total_bytes // 4
    out = []
    for s in streams_list:
        m = (n // s) * s
        x = torch.ones((m,), dtype=torch.float32, device=dev)
        t = timing.time_fn(_multi_stream, x, s, iters=iters)
        accesses_per_stream = m // s
        out.append(ConcurrencyPoint(
            streams=s,
            ns_per_stream_access=t.median_s / accesses_per_stream * 1e9,
            aggregate_gbps=m * 4 / t.median_s / 1e9,
        ))
    return out
