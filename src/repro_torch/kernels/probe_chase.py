"""Pointer chase (counterpart of ``repro.kernels.probe_chase``, and of
``repro.core.probes.memory._chase``): the paper's §VI.A (Fig 6).

The kernel is CUDA C++ (``repro_torch/csrc/probe_chase.cu``), built for
sm_90a at first use and bound with ctypes (see ``_build``).  One block
reads the whole buffer once (untimed warm-up), then one thread makes
``steps`` serialized loads ``idx = buf[idx, 0]`` from index 0, timed by
``%clock64`` and ``%globaltimer``.

* :func:`chase`: the reference's contract, buf (rows, 128) int32 with
  ``buf[i, 0]`` the next row -> the final index (a 0-d int32 tensor).
  The same kernel takes a flat chain, (n,) or (n, 1).
* :func:`chase_timed`: the same walk, returning the final index and, on
  the card, the walk's cycles and nanoseconds.
* :func:`make_chase_buffer` / :func:`chase_reference`: the reference's
  input (bit-identical numpy permutation) and its numpy oracle.

CPU tensors take the plain version (:func:`chase_plain`); CUDA tensors
launch the kernel, or raise.  ``chase.launches`` counts kernel launches
of either entry point; ``chase_plain.calls`` counts plain calls.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]


@dataclasses.dataclass(frozen=True)
class ChaseRun:
    """The final index and, from the kernel, the timed walk's cycles
    (clock64 of its SM) and nanoseconds (globaltimer); None for the plain
    version."""

    index: int
    cycles: Optional[int] = None
    ns: Optional[int] = None


def chase_cycle(rows: int, seed: int = 0) -> np.ndarray:
    """The reference's single cycle over ``rows`` (``make_chase_buffer``
    before the broadcast): ``nxt[cur] = p`` along a seeded permutation of
    1..rows-1, then back to 0.  int32 (rows,)."""
    rng = np.random.default_rng(seed)
    perm = (rng.permutation(rows - 1) + 1).astype(np.int32)
    nxt = np.zeros(rows, np.int32)
    if rows > 1:
        nxt[0] = perm[0]
        nxt[perm[:-1]] = perm[1:]
        nxt[perm[-1]] = 0
    return nxt


def make_chase_buffer(rows: int, seed: int = 0) -> torch.Tensor:
    """Random single-cycle permutation broadcast across 128 lanes: a
    (rows, 128) int32 tensor on the CPU."""
    nxt = chase_cycle(rows, seed)
    return torch.from_numpy(np.broadcast_to(nxt[:, None], (rows, 128)).copy())


def chase_reference(buf, steps: int) -> int:
    idx = 0
    col = np.asarray(buf)[:, 0]
    for _ in range(steps):
        idx = int(col[idx])
    return idx


def _column(buf: torch.Tensor) -> torch.Tensor:
    if buf.dim() == 1:
        return buf
    if buf.dim() == 2 and buf.shape[1] in (1, 128):
        return buf[:, 0]
    raise ValueError(f"chase takes a (rows, 128), (n, 1) or (n,) buffer, "
                     f"not {tuple(buf.shape)}")


def chase_plain(buf: torch.Tensor, steps: int) -> torch.Tensor:
    """``steps`` times ``idx = buf[idx, 0]`` from 0, in torch indexing
    (one indexing op per step, on the buffer's device)."""
    chase_plain.calls += 1
    col = _column(buf).long()
    idx = torch.zeros((), dtype=torch.int64, device=buf.device)
    for _ in range(steps):
        idx = col[idx]
    return idx.to(torch.int32)


def _launch(buf: torch.Tensor, steps: int) -> torch.Tensor:
    """[final index, cycles, ns] (int64, on the card)."""
    if buf.dtype != torch.int32 or not buf.is_contiguous():
        raise ValueError(f"chase kernel takes a contiguous int32 buffer, "
                         f"got {buf.dtype}, strides {buf.stride()}")
    _column(buf)
    if buf.data_ptr() % 16:
        raise ValueError("chase kernel needs a 16-byte aligned buffer")
    row_stride = buf.shape[1] if buf.dim() == 2 else 1
    lib = _build.load("probe_chase")
    fn = lib.repro_chase
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    out = torch.empty(3, dtype=torch.int64, device=buf.device)
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        err = fn(buf.data_ptr(), buf.numel(), row_stride, steps,
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"chase kernel launch failed: CUDA error {err}")
    chase.launches += 1
    return out


def _check_device(buf: torch.Tensor, name: str) -> None:
    if buf.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on 'cuda' (kernel) or 'cpu' (plain "
                         f"version), not {buf.device}")


def chase(buf: torch.Tensor, steps: int) -> torch.Tensor:
    """buf (rows, 128) int32 -- buf[i, 0] = next row (or a flat chain).
    Returns the final index as a 0-d int32 tensor on buf's device."""
    _check_device(buf, "chase")
    if buf.device.type == "cpu":
        return chase_plain(buf, steps)
    return _launch(buf, steps)[0].to(torch.int32)


def chase_timed(buf: torch.Tensor, steps: int) -> ChaseRun:
    """The walk of :func:`chase` with its cycles and ns on the card (the
    host waits for the result)."""
    _check_device(buf, "chase_timed")
    if buf.device.type == "cpu":
        return ChaseRun(int(chase_plain(buf, steps)))
    idx, cycles, ns = _launch(buf, steps).tolist()
    return ChaseRun(idx, cycles, ns)


chase.launches = 0
chase_plain.calls = 0
