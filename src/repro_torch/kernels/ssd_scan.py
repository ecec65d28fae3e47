"""Mamba-2 SSD chunked scan (counterpart of
``repro.kernels.ssd_scan.ssd_scan_bhsp`` and its model-layout wrapper
``repro.kernels.ops.ssd_scan``).

The kernel is CUDA C++ (``repro_torch/csrc/ssd_scan.cu``), built for
sm_90a at first use and bound with ctypes (see ``_build``).  It reads
the model layout as the reference's wrapper takes it: x (bt, s, h, p),
dt_a (bt, s, h), b and c (bt, s, n), contiguous.

:func:`ssd_scan` pads s to the chunk with an identity tail (dt_a = 0,
x = 0: decay 1, no input) and dispatches on the device of its tensors:
on the CPU it runs :func:`ssd_scan_plain` (``models.ssm.ssd_chunked``);
on a CUDA device it launches the kernel, or raises.  There is no
fallback from one to the other.  ``ssd_scan.launches`` counts kernel
launches and nothing else; ``ssd_scan_plain.calls`` counts calls of the
plain version.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
             + [ctypes.c_void_p])
MAX_P, MAX_N, MAX_CHUNK = 64, 128, 1024   # csrc/ssd_scan.cu's limits


def ssd_scan_plain(x: torch.Tensor, dt_a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, chunk: int,
                   initial_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: ``models.ssm.ssd_chunked``
    on inputs already padded to a multiple of ``chunk``; y at x's
    dtype, the state fp32."""
    # models.ssm imports this module for ssd_scan, so the plain version
    # is looked up at call time
    from repro_torch.models.ssm import ssd_chunked
    ssd_scan_plain.calls += 1
    y, state = ssd_chunked(x, dt_a, b, c, chunk, initial_state)
    return y.to(x.dtype), state


ssd_scan_plain.calls = 0


def check_kernel_inputs(x, dt_a, b, c, chunk, initial_state) -> None:
    """Raise on what the kernel does not take: shapes, its limits,
    dtypes, a non-contiguous tensor, tensors on two devices.  s must
    already be padded to a multiple of ``chunk``."""
    bt, s, h, p = x.shape
    n = b.shape[-1]
    if tuple(dt_a.shape) != (bt, s, h) or tuple(b.shape) != (bt, s, n) \
            or c.shape != b.shape:
        raise ValueError(f"shapes: x {tuple(x.shape)} dt_a "
                         f"{tuple(dt_a.shape)} b {tuple(b.shape)} c "
                         f"{tuple(c.shape)}")
    if initial_state is not None and \
            tuple(initial_state.shape) != (bt, h, p, n):
        raise ValueError(f"initial_state {tuple(initial_state.shape)} is "
                         f"not {(bt, h, p, n)}")
    if p > MAX_P or n > MAX_N or chunk > MAX_CHUNK or s % chunk:
        raise ValueError(f"kernel takes p <= {MAX_P}, n <= {MAX_N}, "
                         f"chunk <= {MAX_CHUNK} dividing s (p={p}, n={n}, "
                         f"chunk={chunk}, s={s})")
    if x.dtype not in _DTYPE_CODE or b.dtype not in _DTYPE_CODE \
            or c.dtype != b.dtype or dt_a.dtype != torch.float32 \
            or (initial_state is not None
                and initial_state.dtype != torch.float32):
        raise TypeError(f"kernel takes x and b / c in float32 or bfloat16 "
                        f"(b and c alike), dt_a and initial_state float32; "
                        f"got x {x.dtype}, dt_a {dt_a.dtype}, b {b.dtype}, "
                        f"c {c.dtype}")
    tensors = [("x", x), ("dt_a", dt_a), ("b", b), ("c", c)]
    if initial_state is not None:
        tensors.append(("initial_state", initial_state))
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous "
                             f"(strides {t.stride()})")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _kernel(x, dt_a, b, c, chunk, initial_state):
    check_kernel_inputs(x, dt_a, b, c, chunk, initial_state)
    bt, s, h, p = x.shape
    n = b.shape[-1]
    lib = _build.load("ssd_scan")
    fn = lib.repro_ssd_scan
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    y = torch.empty_like(x)
    state = torch.empty((bt, h, p, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPE_CODE[x.dtype], _DTYPE_CODE[b.dtype],
                 x.data_ptr(), dt_a.data_ptr(), b.data_ptr(), c.data_ptr(),
                 0 if initial_state is None else initial_state.data_ptr(),
                 y.data_ptr(), state.data_ptr(), bt, s, h, p, n, chunk,
                 stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error "
                           f"{err}")
    ssd_scan.launches += 1
    return y, state


def ssd_scan(x: torch.Tensor, dt_a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, chunk: int = 256,
             initial_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model-layout SSD: x (bt, s, h, p) pre-discretized (x * dt), dt_a
    (bt, s, h), b / c (bt, s, n); ``initial_state`` (bt, h, p, n) fp32
    seeds the scan (zeros when omitted).  s is padded to the chunk with
    an identity tail.  Returns (y (bt, s, h, p) at x's dtype,
    final_state (bt, h, p, n) fp32).  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    s = x.shape[1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt_a = F.pad(dt_a, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    if x.device.type == "cpu":
        y, state = ssd_scan_plain(x, dt_a, b, c, chunk, initial_state)
    elif x.device.type == "cuda":
        y, state = _kernel(x, dt_a, b, c, chunk, initial_state)
    else:
        raise ValueError(f"ssd_scan runs on 'cuda' (kernel) or 'cpu' "
                         f"(plain version), not {x.device}")
    return (y[:, :s] if pad else y), state


ssd_scan.launches = 0
