"""Flash-decoding over a quantized ring KV cache (counterpart of
``repro.kernels.flash_decode.flash_decode_quant_bhd`` and
``repro.kernels.ops.flash_decode_quant``).

The kernel is CUDA C++ (``repro_torch/csrc/flash_decode_quant.cu``),
built for sm_90a at first use and bound with ctypes (see ``_build``).
It reads the packed codes and e8m0 scale bytes of the model's cache
layout (b, S, hkv, stored_d) as they lie, through their strides, stages
them in shared memory and expands each quad of values to fp32 in
registers.  Its schedule is the dense kernel's: :func:`plan` checks the
inputs and chooses the split count and the copy widths (codes, scales)
through ``flash_decode``'s ``schedule`` and ``copy_width``.

:func:`flash_decode_quant` dispatches on the device of its tensors: on
the CPU it runs :func:`flash_decode_quant_plain`; on a CUDA device it
launches the kernel, or raises.  There is no fallback from one to the
other.  ``flash_decode_quant.launches`` counts kernel launches and
nothing else; ``flash_decode_quant_plain.calls`` counts calls of the
plain version.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch import compat, lowbits
from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode import (
    Plan, copy_width, ptr_or_none, schedule, scratch)
from repro_torch.models.attention import cache_kv, decode_attention

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 10
             + [ctypes.c_int] * 10
             + [ctypes.c_void_p, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_float, ctypes.c_void_p])


def flash_decode_quant_plain(q: torch.Tensor, kv_cache: dict,
                             pos: torch.Tensor, *, fmt: str,
                             window: Optional[int] = None,
                             softcap: Optional[float] = None,
                             scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, the reference engine's
    XLA route: the cache dequantized to q's dtype (``cache_kv``), then
    ``decode_attention`` (p cast to that dtype before PV)."""
    flash_decode_quant_plain.calls += 1
    k, v = cache_kv(kv_cache, fmt, q.shape[-1], out_dtype=q.dtype)
    return decode_attention(q, k, v, kv_cache["slot_pos"], pos,
                            window=window, softcap=softcap, scale=scale)


def plan(q: torch.Tensor, kv_cache: dict, pos: torch.Tensor, fmt: str,
         sms: int) -> Plan:
    """Checks a call's inputs, raising on what the kernel does not take,
    and returns how the kernel runs it on a card of ``sms`` SMs (widths:
    codes, then scales).  Reads shapes, dtypes, strides and addresses
    only, on any device."""
    kq, ks, vq, vs, sp = (kv_cache[n] for n in ("k_q", "k_s", "v_q", "v_s",
                                                "slot_pos"))
    b, one, hq, d = q.shape
    _, S, hkv, stored_d = kq.shape
    spec = compat.dtype_spec(fmt)
    want_d = (d // spec.packed.values_per_group * spec.packed.bytes_per_group
              if spec.packed is not None else d)
    if (one != 1 or kq.shape[0] != b or stored_d != want_d
            or vq.shape != kq.shape or vs.shape != ks.shape
            or ks.shape[:3] != kq.shape[:3] or d % ks.shape[3]):
        raise ValueError(f"shapes: q {tuple(q.shape)} k_q {tuple(kq.shape)}"
                         f" k_s {tuple(ks.shape)} v_q {tuple(vq.shape)} "
                         f"v_s {tuple(vs.shape)} for {fmt}")
    blk = d // ks.shape[3]
    if tuple(sp.shape) != (b, S) or tuple(pos.shape) != (b,):
        raise ValueError(f"slot_pos {tuple(sp.shape)} / pos "
                         f"{tuple(pos.shape)} do not match b={b}, S={S}")
    if hq % hkv or d > 256 or d % 4 or blk % 4:
        raise ValueError(f"kernel needs hq % hkv == 0, d <= 256, d and the "
                         f"scale block multiples of 4 (hq={hq}, hkv={hkv}, "
                         f"d={d}, blk={blk})")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"kernel takes q in float32 or bfloat16, not "
                        f"{q.dtype}")
    if (kq.dtype != spec.container if spec.packed is None
            else kq.dtype != torch.uint8) or vq.dtype != kq.dtype \
            or ks.dtype != torch.uint8 or vs.dtype != torch.uint8:
        raise TypeError(f"codes/scales dtypes {kq.dtype}/{ks.dtype} do not "
                        f"hold {fmt}")
    if sp.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("slot_pos and pos must be int32")
    for name, t in (("q", q), ("k_q", kq), ("k_s", ks), ("v_q", vq),
                    ("v_s", vs), ("slot_pos", sp), ("pos", pos)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the last axis must have unit stride "
                             f"(strides {t.stride()})")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    # the rows are staged whole, so any alignment works: the copies are
    # as wide as the addresses, strides and row bytes allow
    widths = (copy_width((kq, vq), stored_d), copy_width((ks, vs), d // blk))
    return schedule(b, S, hq, hkv, d, sms, widths)


def _kernel(q, kv, pos, fmt, window, softcap, scale):
    lib = _build.load("flash_decode_quant")
    pl = plan(q, kv, pos, fmt, compat.sm_count(q.device.index))
    kq, ks, vq, vs, sp = (kv[n] for n in ("k_q", "k_s", "v_q", "v_s",
                                          "slot_pos"))
    b, _, hq, d = q.shape
    _, S, hkv, _ = kq.shape
    blk = d // ks.shape[3]
    fn = lib.repro_flash_decode_quant
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    out = torch.empty((b, 1, hq, d), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 17)(
        q.stride(0), q.stride(2),
        kq.stride(0), kq.stride(1), kq.stride(2),
        ks.stride(0), ks.stride(1), ks.stride(2),
        vq.stride(0), vq.stride(1), vq.stride(2),
        vs.stride(0), vs.stride(1), vs.stride(2),
        sp.stride(0), out.stride(0), out.stride(2))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device)
        ws, counters = scratch(pl, q.device, stream)
        err = fn(
            _DTYPE_CODE[q.dtype], lowbits.CUDA_FORMAT_ID[fmt], q.data_ptr(),
            kq.data_ptr(), ks.data_ptr(), vq.data_ptr(),
            vs.data_ptr(), sp.data_ptr(), pos.data_ptr(), out.data_ptr(),
            ptr_or_none(ws), ptr_or_none(counters), b, S, hq, hkv, d, blk,
            pl.g_per_block, pl.splits, *pl.widths,
            ctypes.cast(strides, ctypes.c_void_p),
            scale, window is not None, window or 0, softcap is not None,
            softcap or 0.0, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode_quant kernel launch failed: CUDA "
                           f"error {err}")
    flash_decode_quant.launches += 1
    return out


def flash_decode_quant(q: torch.Tensor, kv_cache: dict, pos: torch.Tensor,
                       *, fmt: str, window: Optional[int] = None,
                       softcap: Optional[float] = None,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention over a quantized cache: q (b, 1, hq, d), the
    cache dict of ``init_kv_cache(kv_format=fmt)`` (``k_q``/``v_q`` (b,
    S, hkv, stored_d), ``k_s``/``v_s`` (b, S, hkv, d/blk), ``slot_pos``
    (b, S) int32; any strides with a unit-stride last axis), pos (b,)
    int32 -> (b, 1, hq, d) at q's dtype.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_decode_quant_plain(q, kv_cache, pos, fmt=fmt,
                                        window=window, softcap=softcap,
                                        scale=scale)
    if q.device.type == "cuda":
        return _kernel(q, kv_cache, pos, fmt, window, softcap, scale)
    raise ValueError(f"flash_decode_quant runs on 'cuda' (kernel) or 'cpu' "
                     f"(plain version), not {q.device}")


flash_decode_quant.launches = 0
flash_decode_quant_plain.calls = 0
