"""Flash-decoding: one-token attention against a ring KV cache
(counterpart of ``repro.kernels.flash_decode.flash_decode_bhd``).

The kernel is CUDA C++ (``repro_torch/csrc/flash_decode.cu``), built for
sm_90a at first use and bound with ctypes (see ``_build``).  It takes
the model's cache layout (b, S, hkv, d) as it lies, through its strides.

:func:`flash_decode` dispatches on the device of its tensors: on the CPU
it runs :func:`flash_decode_plain`; on a CUDA device it launches the
kernel, or raises.  There is no fallback from one to the other.
``flash_decode.launches`` counts kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.models.attention import decode_attention

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
             + [ctypes.c_longlong] * 11
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_void_p])


def flash_decode_plain(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, slot_pos: torch.Tensor,
                       pos: torch.Tensor, *, window: Optional[int] = None,
                       softcap: Optional[float] = None,
                       scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the reference's
    ``decode_attention`` arithmetic (fp32 scores masked to -1e30,
    softmax, ``p`` cast to the cache dtype before PV).  q (b, 1, hq, d),
    cache (b, S, hkv, d), slot_pos (b, S), pos (b,) -> (b, 1, hq, d)."""
    return decode_attention(q, k_cache, v_cache, slot_pos, pos,
                            window=window, softcap=softcap, scale=scale)


def _kernel(q, k_cache, v_cache, slot_pos, pos, window, softcap, scale):
    b, one, hq, d = q.shape
    _, S, hkv, _ = k_cache.shape
    if one != 1 or v_cache.shape != k_cache.shape or k_cache.shape[0] != b \
            or k_cache.shape[3] != d:
        raise ValueError(f"shapes: q {tuple(q.shape)} k "
                         f"{tuple(k_cache.shape)} v {tuple(v_cache.shape)}")
    if tuple(slot_pos.shape) != (b, S) or tuple(pos.shape) != (b,):
        raise ValueError(f"slot_pos {tuple(slot_pos.shape)} / pos "
                         f"{tuple(pos.shape)} do not match b={b}, S={S}")
    if hq % hkv or d > 256:
        raise ValueError(f"kernel needs hq % hkv == 0 and d <= 256 "
                         f"(hq={hq}, hkv={hkv}, d={d})")
    if k_cache.dtype != v_cache.dtype or q.dtype not in _DTYPE_CODE \
            or k_cache.dtype not in _DTYPE_CODE \
            or (q.dtype == torch.bfloat16 and k_cache.dtype != q.dtype):
        raise TypeError(f"kernel takes q/cache dtypes (f32, f32), "
                        f"(bf16, bf16) or (f32, bf16); got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    if slot_pos.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("slot_pos and pos must be int32")
    if not slot_pos.stride(1) == 1 or not pos.is_contiguous():
        raise ValueError("slot_pos needs a unit-stride slot axis and pos "
                         "must be contiguous")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: head_dim must be the unit-stride "
                             f"axis (strides {t.stride()})")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    lib = _build.load("flash_decode")
    fn = lib.repro_flash_decode
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    out = torch.empty((b, 1, hq, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_cache.dtype],
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            slot_pos.data_ptr(), pos.data_ptr(), out.data_ptr(),
            b, S, hq, hkv, d,
            q.stride(0), q.stride(2),
            k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
            v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
            slot_pos.stride(0), out.stride(0), out.stride(2),
            scale, window is not None, window or 0,
            softcap is not None, softcap or 0.0, stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{err}")
    flash_decode.launches += 1
    return out


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, slot_pos: torch.Tensor,
                 pos: torch.Tensor, *, window: Optional[int] = None,
                 softcap: Optional[float] = None,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention: q (b, 1, hq, d), cache (b, S, hkv, d) (any
    strides with a unit-stride head_dim), slot_pos (b, S) int32, pos (b,)
    int32 -> (b, 1, hq, d) at q's dtype.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, slot_pos, pos,
                                  window=window, softcap=softcap,
                                  scale=scale)
    if q.device.type == "cuda":
        return _kernel(q, k_cache, v_cache, slot_pos, pos, window, softcap,
                       scale)
    raise ValueError(f"flash_decode runs on 'cuda' (kernel) or 'cpu' "
                     f"(plain version), not {q.device}")


flash_decode.launches = 0
