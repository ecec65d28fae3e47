"""Flash attention over a whole sequence (counterpart of
``repro.kernels.flash_attention.flash_attention_bhsd`` and its
model-layout wrapper ``repro.kernels.ops.flash_attention``).

The kernel is CUDA C++ (``repro_torch/csrc/flash_attention.cu``), built
for sm_90a at first use and bound with ctypes (see ``_build``).  It reads
the model layout q (b, sq, hq, d), k / v (b, skv, hkv, d) through their
strides and masks ragged sq and skv itself: no transposed or padded
copies.  bf16 runs on the tensor cores (fp32 accumulation), fp32 on the
CUDA cores in fp32.

:func:`flash_attention` dispatches on the device of its tensors: on the
CPU it runs :func:`flash_attention_plain` (``models.attention.attention``,
the reference's XLA dispatch: full attention up to ``chunk`` keys,
online softmax over KV chunks beyond; full attention at the query
positions when ``q_offset`` is set); on a CUDA device it launches the
kernel, or raises.  There is no fallback from one to the other.
``flash_attention.launches`` counts kernel launches and nothing else;
``flash_attention_plain.calls`` counts calls of the plain version.

A row with no visible key (possible only with ``q_offset`` or a window)
comes out as zeros from the kernel and as the mean of V from the plain
version, as in the reference's Pallas kernel and XLA path; the model
never produces such a row (causal rows always see themselves).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.models.attention import attention, full_attention

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}    # elements per 16 bytes
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 12
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
MAX_D = 256                                     # csrc/flash_attention.cu


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          scale: Optional[float] = None, q_offset: int = 0,
                          chunk: int = 1024) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the reference's
    ``attention()`` dispatch (fp32 scores masked to -1e30, ``p`` cast to
    v's dtype before PV), chunked over ``chunk`` keys when skv is
    longer; with a ``q_offset``, ``full_attention`` at those query
    positions (the reference's dispatch places queries at 0)."""
    flash_attention_plain.calls += 1
    if q_offset:
        return full_attention(
            q, k, v, causal=causal, window=window, softcap=softcap,
            scale=scale,
            q_positions=q_offset + torch.arange(q.shape[1], device=q.device))
    return attention(q, k, v, causal=causal, window=window, softcap=softcap,
                     scale=scale, chunk=chunk)


flash_attention_plain.calls = 0


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: Optional[int], q_offset: int) -> None:
    """Raise on what the kernel does not take: shapes, head_dim above
    ``MAX_D`` or not a multiple of 16 bytes, dtypes, a head_dim that is
    not the unit-stride axis, strides or pointers off 16 bytes, tensors
    on two devices, a window below 1 or a negative ``q_offset``."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"shapes: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hkv < 1 or hq % hkv:
        raise ValueError(f"shapes: q {tuple(q.shape)} k {tuple(k.shape)}: "
                         f"batch and head_dim must agree, hq % hkv == 0")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"kernel takes q, k, v all float32 or all "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    vec = _VEC[q.dtype]
    if d > MAX_D or d % vec:
        raise ValueError(f"kernel takes head_dim <= {MAX_D}, a multiple of "
                         f"{vec} for {q.dtype} (got {d})")
    if window is not None and window < 1 or q_offset < 0:
        raise ValueError(f"window must be >= 1 and q_offset >= 0 (window="
                         f"{window}, q_offset={q_offset})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: head_dim must be the unit-stride "
                             f"axis (strides {t.stride()})")
        if any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: strides {t.stride()} and the data "
                             f"pointer must be multiples of 16 bytes")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def _kernel(q, k, v, causal, window, softcap, scale, q_offset):
    check_kernel_inputs(q, k, v, window, q_offset)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), b, sq, skv, hq, hkv, d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], scale, bool(causal), window is not None,
                 window or 0, softcap is not None, softcap or 0.0, q_offset,
                 stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None, q_offset: int = 0,
                    chunk: int = 1024) -> torch.Tensor:
    """Whole-sequence attention in the model layout: q (b, sq, hq, d),
    k / v (b, skv, hkv, d) -> (b, sq, hq, d) at q's dtype.  Queries sit
    at positions ``q_offset + arange(sq)``, keys at ``arange(skv)``.
    ``chunk`` is the plain version's KV block (the kernel tiles by
    itself).  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, scale=scale,
                                     q_offset=q_offset, chunk=chunk)
    if q.device.type == "cuda":
        return _kernel(q, k, v, causal, window, softcap, scale, q_offset)
    raise ValueError(f"flash_attention runs on 'cuda' (kernel) or 'cpu' "
                     f"(plain version), not {q.device}")


flash_attention.launches = 0
