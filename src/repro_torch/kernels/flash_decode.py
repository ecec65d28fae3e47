"""Flash-decoding: one-token attention against a ring KV cache
(counterpart of ``repro.kernels.flash_decode.flash_decode_bhd``).

The kernel is CUDA C++ (``repro_torch/csrc/flash_decode.cu``, with the
schedule it shares with ``flash_decode_quant`` in
``csrc/flash_decode_split.cuh``), built for sm_90a at first use and
bound with ctypes (see ``_build``).  It takes the model's cache layout
(b, S, hkv, d) as it lies, through its strides.

:func:`plan` runs every input check and alone chooses how the kernel
runs a call: the q-heads a block, how many blocks split the S axis
round-robin (:func:`splits_for`, from the shapes and the SM count, never
from ``pos``, which stays on the card) and the width of the K/V copies
(:func:`copy_width`).  A split call combines its splits in the same
launch, through a workspace and arrival counters the wrapper provides
(:func:`scratch`).  Both this module's and ``flash_decode_quant``'s
wrappers use these.

:func:`flash_decode` dispatches on the device of its tensors: on the CPU
it runs :func:`flash_decode_plain`; on a CUDA device it launches the
kernel, or raises.  There is no fallback from one to the other.
``flash_decode.launches`` counts kernel launches (one a call, split or
not) and nothing else; ``flash_decode_plain.calls`` counts calls of the
plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, Iterable, Optional, Tuple

import torch

from repro_torch import compat
from repro_torch.kernels import _build
from repro_torch.models.attention import decode_attention

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
             + [ctypes.c_longlong] * 11
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float, ctypes.c_void_p])
# the kernels' slots a tile and most q-heads a block
# (csrc/flash_decode_split.cuh kTile, kMaxG)
TILE, MAX_G = 32, 8
# blocks an SM that the split count aims at: the kernels are built for
# four (128 registers a thread) and the dense kernel's 53 KB of shared
# memory at the serving shape allows four
BLOCKS_PER_SM = 4


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernel runs one call.  ``g_per_block``: q-heads a block;
    ``blocks_per_row``: blocks of one batch row and split (hkv times the
    chunks of a GQA group); ``splits``: blocks that share the S axis,
    round-robin by tile; ``widths``: bytes a copy (K/V; quantized: codes,
    then scales); ``workspace``: the fp32 (b, hq, splits, d + 2) partial
    results of a split call, else None."""
    g_per_block: int
    blocks_per_row: int
    splits: int
    widths: Tuple[int, ...]
    workspace: Optional[Tuple[int, int, int, int]]


def splits_for(b: int, blocks_per_row: int, S: int, sms: int) -> int:
    """Blocks to split the S axis over: as many as keep the grid within
    one wave of ``BLOCKS_PER_SM`` blocks on each of the ``sms`` SMs (a
    second wave would wait for the first), never more than the tiles of
    S, and 1 where the (b, kv-head) blocks fill that wave already."""
    tiles = -(-S // TILE)
    fit = BLOCKS_PER_SM * sms // max(1, b * blocks_per_row)
    return max(1, min(tiles, fit))


def copy_width(tensors: Iterable[torch.Tensor], row_bytes: int) -> int:
    """The widest copy, 16, 8, 4, 2 or 1 bytes, that divides every
    tensor's address and the strides of its three outer axes in bytes,
    and ``row_bytes``: the kernels copy 16, 8 and 4 bytes by
    ``cp.async``, 2 and 1 by a load and a store."""
    vals = [row_bytes]
    for t in tensors:
        vals.append(t.data_ptr())
        vals += [st * t.element_size() for st in t.stride()[:3]]
    width = 16
    while any(v % width for v in vals):
        width //= 2
    return width


def schedule(b: int, S: int, hq: int, hkv: int, d: int, sms: int,
             widths: Tuple[int, ...]) -> Plan:
    """The plan of a call of checked shapes."""
    ratio = hq // hkv
    g = min(ratio, MAX_G)
    per_row = hkv * -(-ratio // g)
    splits = splits_for(b, per_row, S, sms)
    return Plan(g, per_row, splits, widths,
                (b, hq, splits, d + 2) if splits > 1 else None)


_COUNTERS: Dict[Tuple[int, int], torch.Tensor] = {}


def scratch(pl: Plan, device: torch.device, stream: torch.cuda.Stream):
    """(workspace, counters) of a split call, else (None, None).  The
    workspace comes from ``torch.empty``.  The int32 arrival counters are
    zeroed once, when first allocated for the (device, stream), and every
    launch leaves them at 0, so a call launches nothing else."""
    if pl.workspace is None:
        return None, None
    ws = torch.empty(pl.workspace, dtype=torch.float32, device=device)
    need = pl.workspace[0] * pl.blocks_per_row
    key = (device.index, stream.cuda_stream)
    counters = _COUNTERS.get(key)
    if counters is None or counters.numel() < need:
        counters = _COUNTERS[key] = torch.zeros(
            max(need, 1024), dtype=torch.int32, device=device)
    return ws, counters


def ptr_or_none(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def flash_decode_plain(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor, slot_pos: torch.Tensor,
                       pos: torch.Tensor, *, window: Optional[int] = None,
                       softcap: Optional[float] = None,
                       scale: Optional[float] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the reference's
    ``decode_attention`` arithmetic (fp32 scores masked to -1e30,
    softmax, ``p`` cast to the cache dtype before PV).  q (b, 1, hq, d),
    cache (b, S, hkv, d), slot_pos (b, S), pos (b,) -> (b, 1, hq, d)."""
    flash_decode_plain.calls += 1
    return decode_attention(q, k_cache, v_cache, slot_pos, pos,
                            window=window, softcap=softcap, scale=scale)


def plan(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
         slot_pos: torch.Tensor, pos: torch.Tensor, sms: int) -> Plan:
    """Checks a call's inputs, raising on what the kernel does not take,
    and returns how the kernel runs it on a card of ``sms`` SMs.  Reads
    shapes, dtypes, strides and addresses only, on any device."""
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
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("slot_pos", slot_pos), ("pos", pos)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    width = copy_width((k_cache, v_cache), d * k_cache.element_size())
    return schedule(b, S, hq, hkv, d, sms, (width,))


def _kernel(q, k_cache, v_cache, slot_pos, pos, window, softcap, scale):
    lib = _build.load("flash_decode")
    pl = plan(q, k_cache, v_cache, slot_pos, pos,
              compat.sm_count(q.device.index))
    b, _, hq, d = q.shape
    _, S, hkv, _ = k_cache.shape
    fn = lib.repro_flash_decode
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    out = torch.empty((b, 1, hq, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device)
        ws, counters = scratch(pl, q.device, stream)
        err = fn(
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_cache.dtype],
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            slot_pos.data_ptr(), pos.data_ptr(), out.data_ptr(),
            ptr_or_none(ws), ptr_or_none(counters), b, S, hq, hkv, d,
            pl.g_per_block, pl.splits, pl.widths[0],
            q.stride(0), q.stride(2),
            k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
            v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
            slot_pos.stride(0), out.stride(0), out.stride(2),
            scale, window is not None, window or 0,
            softcap is not None, softcap or 0.0, stream.cuda_stream)
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
flash_decode_plain.calls = 0
