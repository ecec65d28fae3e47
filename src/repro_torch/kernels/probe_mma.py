"""Tensor-core probe (counterpart of ``repro.kernels.probe_mma``, and of
``repro.core.probes.matmul._mm_ilp``): the paper's §V.B/§V.D (Fig 4/5).

The kernel is CUDA C++ (``repro_torch/csrc/probe_mma.cu``), built for
sm_90a at first use and bound with ctypes (see ``_build``): ``mma.sync``
m16n8k16 for bf16 / fp16 inputs and m16n8k8 TF32 for fp32 inputs, fp32
accumulators, each warp holding ``ilp`` independent accumulator sets
(one per product) over operands the block stages in shared memory.
:func:`plan` checks a call's inputs and returns the launch (block tile,
stages, grid, shared memory); it reads shapes, dtypes, strides and
addresses only, so the CPU tests reach it.

* :func:`mma_probe`: the reference's contract, x (ilp, m, k) @ y (k, n)
  -> (ilp, m, n) in x's dtype.  ``bm``, ``bn``, ``bk`` are checked as
  the reference checks them (they must divide m, n, k); the kernel's own
  block tile is :data:`BLOCK_TILE`, so they do not change what it runs.
* :func:`mma_products`: a (batch, ilp, m, k) @ b (batch, ilp, k, n) ->
  (batch, ilp, m, n) fp32, the ``_mm_ilp`` products before their sum.

CPU tensors take the plain version (:func:`mma_probe_plain`: fp32
matmul, then the output dtype); CUDA tensors launch the kernel, or
raise.  ``mma_probe.launches`` counts kernel launches of either entry
point; ``mma_probe_plain.calls`` counts plain calls.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ARGTYPES = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
             + [ctypes.c_longlong] * 9 + [ctypes.c_void_p])
# csrc/probe_mma.cu: the block tile of out (rows, columns), the bytes of
# k a stage holds of an x row, the stages, the threads and the bytes of
# one product's stage (x rows of 80 bytes, y rows of 80 or 160)
BLOCK_TILE = (32, 32)
STAGE_ROW_BYTES = 64
STAGES = 2
THREADS = 128
PRODUCT_STAGE_BYTES = 5120
MAX_BATCH = 65535


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernel runs a call: a block per (block tile of out, batch
    entry), ``bk`` values of k a stage, ``smem_bytes`` of shared memory a
    block."""
    bm: int
    bn: int
    bk: int
    stages: int
    threads: int
    grid: Tuple[int, int]
    smem_bytes: int


def plan(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> Plan:
    """Checks a (batch, ilp, m, k) @ b (batch, ilp, k, n) -> ``out_dtype``,
    raising on what the kernel does not take, and returns its launch.
    b's batch and ilp strides may be 0 (a broadcast y)."""
    if a.ndim != 4 or b.ndim != 4:
        raise ValueError(f"mma_probe: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}: both (batch, ilp, ., .)")
    batch, ilp, m, k = a.shape
    n = b.shape[3]
    if (tuple(b.shape[:3]) != (batch, ilp, k) or a.dtype != b.dtype
            or a.device != b.device):
        raise ValueError(f"mma_probe: a {tuple(a.shape)} {a.dtype}, b "
                         f"{tuple(b.shape)} {b.dtype}")
    if a.dtype not in _DTYPE_CODE or out_dtype not in (torch.float32,
                                                       a.dtype):
        raise TypeError(f"mma_probe kernel takes fp32 (TF32), bf16 or fp16 "
                        f"inputs and fp32 or the input dtype out, not "
                        f"{a.dtype} -> {out_dtype}")
    kstep = 8 if a.dtype == torch.float32 else 16
    if m % 16 or n % 8 or k % kstep:
        raise ValueError(f"mma_probe kernel needs m % 16, n % 8, k % "
                         f"{kstep} == 0 (m={m}, n={n}, k={k})")
    if not 1 <= ilp <= 8:
        raise ValueError(f"mma_probe kernel takes ilp 1..8, not {ilp}")
    if batch > MAX_BATCH:
        raise ValueError(f"mma_probe kernel takes batch <= {MAX_BATCH}, "
                         f"not {batch}")
    if a.stride(3) != 1 or b.stride(3) != 1:
        raise ValueError("mma_probe kernel needs unit-stride k in a and n "
                         "in b")
    vec = 16 // a.element_size()
    for name, t in (("a", a), ("b", b)):
        if (any(s % vec or s < 0 for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(f"mma_probe kernel copies {name} in 16-byte "
                             f"pieces: its strides {t.stride()} must be "
                             f"multiples of 16 bytes and its data 16-byte "
                             f"aligned")
    bm, bn = BLOCK_TILE
    tiles = -(-m // bm) * -(-n // bn)
    return Plan(bm=bm, bn=bn, bk=STAGE_ROW_BYTES // a.element_size(),
                stages=STAGES, threads=THREADS, grid=(tiles, batch),
                smem_bytes=STAGES * ilp * PRODUCT_STAGE_BYTES)


def mma_probe_plain(x: torch.Tensor, y: torch.Tensor,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """x (..., m, k) @ y (..., k, n) in fp32 (TF32 off on the card), cast
    to ``out_dtype``."""
    mma_probe_plain.calls += 1
    return torch.matmul(x.float(), y.float()).to(out_dtype)


def _launch(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype
            ) -> torch.Tensor:
    """a (batch, ilp, m, k) @ b (batch, ilp, k, n), b's batch and ilp
    strides possibly 0 -> (batch, ilp, m, n) ``out_dtype``."""
    plan(a, b, out_dtype)
    batch, ilp, m, k = a.shape
    n = b.shape[3]
    out = torch.empty((batch, ilp, m, n), dtype=out_dtype, device=a.device)
    lib = _build.load("probe_mma")
    fn = lib.repro_mma_probe
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(_DTYPE_CODE[a.dtype], _DTYPE_CODE[out_dtype], ilp,
                 a.data_ptr(), b.data_ptr(), out.data_ptr(), batch, m, n, k,
                 a.stride(0), a.stride(1), a.stride(2),
                 b.stride(0), b.stride(1), b.stride(2),
                 out.stride(0), out.stride(1), out.stride(2), stream)
    if err != 0:
        raise RuntimeError(f"mma_probe kernel launch failed: error {err}")
    mma_probe.launches += 1
    return out


def _check_device(t: torch.Tensor, name: str) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on 'cuda' (kernel) or 'cpu' (plain "
                         f"version), not {t.device}")


def mma_probe(x: torch.Tensor, y: torch.Tensor, *, bm: int = 128,
              bn: int = 128, bk: int = 128, ilp: int = 1) -> torch.Tensor:
    """x (ilp, m, k) @ y (k, n) -> (ilp, m, n) in x's dtype, fp32
    accumulation."""
    ilp_, m, k = x.shape
    n = y.shape[1]
    if ilp_ != ilp or y.shape[0] != k or m % bm or n % bn or k % bk:
        raise ValueError(f"mma_probe: x {tuple(x.shape)}, y "
                         f"{tuple(y.shape)}, ilp={ilp}, tile ({bm}, {bn}, "
                         f"{bk})")
    _check_device(x, "mma_probe")
    if x.device.type == "cpu":
        return mma_probe_plain(x, y, x.dtype)
    return _launch(x[None], y.expand(1, ilp, k, n), x.dtype)[0]


def mma_products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (batch, ilp, m, k) @ b (batch, ilp, k, n) -> (batch, ilp, m, n)
    fp32: ``batch * ilp`` independent products."""
    _check_device(a, "mma_products")
    if a.device.type == "cpu":
        return mma_probe_plain(a, b, torch.float32)
    return _launch(a, b, torch.float32)


mma_probe.launches = 0
mma_probe_plain.calls = 0
