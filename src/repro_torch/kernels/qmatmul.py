"""Block-scaled low-precision matmul (counterpart of
``repro.kernels.qmatmul`` and of ``ops.qmatmul`` / ``ops.qmatmul_packed``
/ ``quantize_for_qmatmul`` / ``pack_for_qmatmul``).

Hopper has fp8 tensor cores but none for fp6 or fp4, so, as on the TPU,
these formats are storage: weights stay quantized in device memory with
e8m0 (power-of-two) block scales, 32 values of k per scale, and are
expanded inside the kernel on their way into the product.

* :func:`qmatmul`: x (m, k) @ dequant(qw (n, k) in the registry
  container, scales (n, k/32) fp32).T -> (m, n);
* :func:`qmatmul_packed`: the same with ``pw`` (n, k*bits/8) uint8
  bit-packed fp4 / fp6, bit-exact with :func:`qmatmul` on the same
  values (one kernel template; only the staged code bytes differ).

The kernel is CUDA C++ (``repro_torch/csrc/qmatmul.cu``), built at first
use and bound with ctypes.  For bf16 x it stages x, the weight bytes
and the scales in shared memory by TMA (``cp.async`` where a stride is
not 16-byte aligned), expands the weights to bf16 there (exact) and
multiplies on the tensor cores with ``wgmma``.  :func:`plan`, and only
it, picks the path for bf16 x: "wide" 128 x 128 tiles for m > 64,
"narrow" (A and B swapped, one block per 128 weight rows) for m <= 64,
with k split over several blocks when that leaves SMs idle, the splits
summed in a fixed order by a second kernel that the wrapper launches
into a workspace it allocates (no atomics).  fp32 x runs the CUDA-core
kernel, since a tensor-core product would round x.

Each wrapper dispatches on the device of its tensors: CPU tensors take
the plain version, CUDA tensors launch the kernel or raise.
``qmatmul.launches`` and ``qmatmul_packed.launches`` count calls that
launched the kernel (one a call, split or not).

The serving engine does not call these: its weight store is blocked
along each leaf's last axis (the output axis of ``wq``, ``w1``, ``w2``),
not along k, so the engine keeps the reference's dense copy; these are
the entry points of the block-scaled GEMM benchmark (Tab VII).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch import compat, lowbits
from repro_torch.kernels import _build
from repro_torch.serve.quant import (
    BLOCK, dequantize_blockwise, quantize_blockwise)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_CONTAINER_FMT = {torch.float8_e4m3fn: "float8_e4m3fn",
                  torch.float8_e5m2: "float8_e5m2"}
_ARGTYPES = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
             + [ctypes.c_longlong] * 4 + [ctypes.c_void_p])
_NARROW_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                    + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 4
                    + [ctypes.c_int, ctypes.c_void_p])
_REDUCE_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 2
                    + [ctypes.c_int] * 2 + [ctypes.c_longlong]
                    + [ctypes.c_int, ctypes.c_void_p])
# the narrow kernel's most rows of x (qmatmul.cu kNarrowM, which its
# entry checks) and weight rows a block; the tensor-core kernels' k step
NARROW_M, NARROW_ROWS, K_STEP = 64, 128, 64


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the tensor-core kernel computes one call with bf16 x.
    ``path``: "wide" (``repro_qmatmul``) or "narrow"
    (``repro_qmatmul_narrow``); ``splits``: ranges of k of the narrow
    path, each summed by its own blocks; ``workspace``: the (splits, m,
    n) fp32 partial sums a split call needs, else None."""
    path: str
    splits: int
    workspace: Optional[Tuple[int, int, int]]


def plan(m: int, n: int, k: int, sms: int) -> Plan:
    """m <= 64 takes the narrow path.  It splits k when its ``ceil(n /
    128)`` blocks leave some of the ``sms`` SMs idle: into as many ranges
    as two blocks an SM can hold at once, each range at least 4 steps of
    64 values of k."""
    if m > NARROW_M:
        return Plan("wide", 1, None)
    tiles = -(-n // NARROW_ROWS)
    steps = -(-k // K_STEP)
    splits = 1
    if tiles < sms:
        splits = max(1, min(2 * sms // tiles, steps // 4))
    return Plan("narrow", splits, (splits, m, n) if splits > 1 else None)


def quantize_for_qmatmul(w: torch.Tensor, fmt: str
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """w (k, n) -> (qw (n, k) quantized along k, scales (n, k/32)),
    both row-major."""
    return quantize_blockwise(w.T.contiguous(), fmt)


def pack_for_qmatmul(w: torch.Tensor, fmt: str
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """w (k, n) -> (pw (n, k*bits/8) uint8 bit-packed, scales (n, k/32)):
    the quantization of :func:`quantize_for_qmatmul`, then packed along
    k.  ``fmt`` must be packable (fp4 / fp6)."""
    qw, scales = quantize_for_qmatmul(w, fmt)
    return lowbits.pack(qw.to(torch.float32), fmt), scales


def qmatmul_plain(x: torch.Tensor, qw: torch.Tensor, scales: torch.Tensor,
                  out_dtype=torch.bfloat16) -> torch.Tensor:
    """The reference's ``qmatmul_ref``: dequantize fully in fp32, then
    ``x.float() @ w.T``, cast to ``out_dtype``."""
    w = dequantize_blockwise(qw, scales, torch.float32)
    return torch.matmul(x.to(torch.float32), w.T).to(out_dtype)


def qmatmul_packed_plain(x: torch.Tensor, pw: torch.Tensor,
                         scales: torch.Tensor, fmt: str,
                         out_dtype=torch.bfloat16) -> torch.Tensor:
    """Unpack, then :func:`qmatmul_plain`."""
    return qmatmul_plain(x, lowbits.unpack(pw, fmt, x.shape[1]), scales,
                         out_dtype)


def _launch(fmt: str, x, w, scales, n: int, out_dtype, what: str):
    m, k = x.shape
    if k % BLOCK:
        raise ValueError(f"{what}: k={k} is not a multiple of {BLOCK}")
    if tuple(scales.shape) != (n, k // BLOCK) or w.shape[0] != n:
        raise ValueError(f"{what}: weights {tuple(w.shape)} / scales "
                         f"{tuple(scales.shape)} do not fit x "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: x and out must be float32 or bfloat16 "
                        f"(x {x.dtype}, out {out_dtype})")
    if scales.dtype != torch.float32:
        raise TypeError(f"{what}: scales must be float32, not "
                        f"{scales.dtype}")
    for name, t in (("x", x), ("weights", w), ("scales", scales)):
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} needs a unit-stride last axis "
                             f"(strides {t.stride()})")
        if t.device != x.device:
            raise ValueError(f"{what}: {name} is on {t.device}, x on "
                             f"{x.device}")
    # the CUDA-core kernel loads an fp8 / fp4 quad (4 values of k) as
    # one aligned word; the tensor-core kernel copies what it is given
    align = {8: 4, 4: 2}.get(compat.dtype_spec(fmt).bits, 1)
    if w.data_ptr() % align or w.stride(0) % align:
        raise ValueError(f"{what}: weight rows must be {align}-byte aligned")
    lib = _build.load("qmatmul")
    # fp32 x: repro_qmatmul runs the CUDA-core kernel (by x's dtype)
    pl = (plan(m, n, k, compat.sm_count(x.device.index))
          if x.dtype == torch.bfloat16 else None)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if pl is None or pl.path == "wide":
            fn = lib.repro_qmatmul
            fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
            err = fn(_DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype],
                     lowbits.CUDA_FORMAT_ID[fmt],
                     x.data_ptr(), w.data_ptr(), scales.data_ptr(),
                     out.data_ptr(), m, n, k, x.stride(0), w.stride(0),
                     scales.stride(0), out.stride(0), stream)
        else:
            part = (None if pl.workspace is None else
                    torch.empty(pl.workspace, dtype=torch.float32,
                                device=x.device))
            fn = lib.repro_qmatmul_narrow
            fn.argtypes, fn.restype = _NARROW_ARGTYPES, ctypes.c_int
            err = fn(_DTYPE_CODE[out_dtype], lowbits.CUDA_FORMAT_ID[fmt],
                     x.data_ptr(), w.data_ptr(), scales.data_ptr(),
                     out.data_ptr(),
                     None if part is None else part.data_ptr(), m, n, k,
                     x.stride(0), w.stride(0), scales.stride(0),
                     out.stride(0), pl.splits, stream)
            if err == 0 and part is not None:
                fn = lib.repro_qmatmul_reduce
                fn.argtypes, fn.restype = _REDUCE_ARGTYPES, ctypes.c_int
                err = fn(_DTYPE_CODE[out_dtype], part.data_ptr(),
                         out.data_ptr(), m, n, out.stride(0), pl.splits,
                         stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
    return out


def wgmma_unit_tile(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The check of ``csrc/wgmma.cuh``: ``a (64, k) @ b (128, k).T`` in
    fp32 for bf16 CUDA tensors, k in 16, 32, 48, 64, by one warpgroup's
    four m64n128k16 products at advancing descriptors over tiles stored
    swizzled (zeros past k)."""
    k = a.shape[1]
    if (a.shape != (64, k) or b.shape != (128, k) or k not in (16, 32, 48, 64)
            or a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16
            or a.device.type != "cuda" or b.device != a.device):
        raise ValueError(f"wgmma_unit_tile: needs bf16 CUDA a (64, k), "
                         f"b (128, k), k in 16..64 by 16; got "
                         f"{tuple(a.shape)} {a.dtype}, {tuple(b.shape)} "
                         f"{b.dtype} on {a.device}")
    a, b = a.contiguous(), b.contiguous()
    d = torch.empty((64, 128), dtype=torch.float32, device=a.device)
    fn = _build.load("qmatmul").repro_wgmma_unit
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), d.data_ptr(), k,
                 torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wgmma_unit_tile launch failed: CUDA error "
                           f"{err}")
    return d


def _check_device(x: torch.Tensor, what: str) -> None:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on 'cuda' (kernel) or 'cpu' (plain "
                         f"version), not {x.device}")


def qmatmul(x: torch.Tensor, qw: torch.Tensor, scales: torch.Tensor, *,
            out_dtype=torch.bfloat16) -> torch.Tensor:
    """x (m, k) @ dequant(qw (n, k), scales (n, k/32)).T -> (m, n) at
    ``out_dtype``; ``qw`` is a float8 container (fp8, or fp6 / fp4 values
    held in e4m3).  ``m`` may be ragged."""
    _check_device(x, "qmatmul")
    if x.device.type == "cpu":
        return qmatmul_plain(x, qw, scales, out_dtype)
    if qw.dtype not in _CONTAINER_FMT or qw.ndim != 2 \
            or qw.shape[1] != x.shape[1]:
        raise TypeError(f"qmatmul: qw must be (n, k) float8, got "
                        f"{tuple(qw.shape)} {qw.dtype}")
    out = _launch(_CONTAINER_FMT[qw.dtype], x, qw, scales, qw.shape[0],
                  out_dtype, "qmatmul")
    qmatmul.launches += 1
    return out


def qmatmul_packed(x: torch.Tensor, pw: torch.Tensor, scales: torch.Tensor,
                   fmt: str, *, out_dtype=torch.bfloat16) -> torch.Tensor:
    """x (m, k) @ dequant(unpack(pw), scales).T with ``pw`` (n,
    k*bits/8) uint8 from :func:`pack_for_qmatmul`; bit-exact with
    :func:`qmatmul` on the same quantized values."""
    _check_device(x, "qmatmul_packed")
    if x.device.type == "cpu":
        return qmatmul_packed_plain(x, pw, scales, fmt, out_dtype)
    spec = compat.dtype_spec(fmt).packed
    if spec is None:
        raise ValueError(f"qmatmul_packed: {fmt} has no packed layout")
    if pw.dtype != torch.uint8 or pw.shape[1] != spec.packed_len(x.shape[1]):
        raise TypeError(f"qmatmul_packed: pw must be (n, "
                        f"{spec.packed_len(x.shape[1])}) uint8 for {fmt}, "
                        f"got {tuple(pw.shape)} {pw.dtype}")
    out = _launch(fmt, x, pw, scales, pw.shape[0], out_dtype,
                  "qmatmul_packed")
    qmatmul_packed.launches += 1
    return out


qmatmul.launches = 0
qmatmul_packed.launches = 0
