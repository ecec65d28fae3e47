"""Attention: projections, grouped-query softmax attention against a ring
KV cache, and the cache write paths (counterpart of
``repro.models.attention``, dense cache only).

The cache layout is the reference's: ``k``/``v`` (b, S, hkv, d) at the
cache dtype plus ``slot_pos`` (b, S) int32, the absolute position each
slot holds (-1 = empty).  Visibility is computed from positions
(``0 <= slot_pos <= q_pos``, and ``> q_pos - window`` for local layers),
so one rule covers decode, chunked prefill and ring wrap-around.

Unlike the reference, whose arrays are immutable, the write paths here
update the cache tensors **in place** (``index_put_`` on pool rows) and
return the same dict: the serving pool is about 1 GB at full width, and
a functional copy per step would double it.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.models import layers
from repro_torch.models.layers import dense_init, mm
from repro_torch.models.slotstate import mask_rows

NEG_INF = -1.0e30


# --------------------------------------------------------------------- #
# Projections
# --------------------------------------------------------------------- #

def init_attention(cfg, dtype, generator: torch.Generator, device,
                   lead=()) -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init((*lead, d, h, hd), dtype, generator, device,
                         fan_in=d),
        "wk": dense_init((*lead, d, hkv, hd), dtype, generator, device,
                         fan_in=d),
        "wv": dense_init((*lead, d, hkv, hd), dtype, generator, device,
                         fan_in=d),
        "wo": dense_init((*lead, h, hd, d), dtype, generator, device,
                         fan_in=h * hd),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((*lead, h, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((*lead, hkv, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((*lead, hkv, hd), dtype=dtype, device=device)
    return p


def _proj_in(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul over the flattened heads."""
    d, h, k = w.shape
    return mm(x, w.reshape(d, h * k)).unflatten(-1, (h, k))


def project_q(p: dict, x: torch.Tensor) -> torch.Tensor:
    q = _proj_in(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    return q


def project_kv(p: dict, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    k, v = _proj_in(x, p["wk"]), _proj_in(x, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    return k, v


def project_out(p: dict, o: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd")."""
    h, k, d = p["wo"].shape
    return mm(o.flatten(-2), p["wo"].reshape(h * k, d))


# --------------------------------------------------------------------- #
# Core softmax-attention maths (grouped-query layout)
# --------------------------------------------------------------------- #

def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(b, s, hq, d) -> (b, s, n_kv, group, d)."""
    b, s, hq, d = q.shape
    return q.reshape(b, s, n_kv, hq // n_kv, d)


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float,
            cap: Optional[float]) -> torch.Tensor:
    """q (b,sq,h,g,d) x k (b,sk,h,d) -> fp32 logits (b,h,g,sq,sk).

    The reference keeps operands at their dtype and accumulates in fp32;
    widening the operands to fp32 first gives the same products (bf16 ->
    fp32 is exact)."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale
    return layers.softcap(s, cap)


def cache_attention(q: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, slot_pos: torch.Tensor,
                    q_positions: torch.Tensor, *,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention of ``sq`` query tokens against a (ring) cache.

    q: (b, sq, hq, d); k_cache/v_cache: (b, S, hkv, d);
    slot_pos: (b, S) int32, -1 empty; q_positions: (b, sq) int32.
    Returns (b, sq, hq, d) at q.dtype.  ``p`` is cast to the cache dtype
    before the PV product, as in the reference."""
    b, sq, hq, d = q.shape
    hkv = k_cache.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = _scores(_group(q, hkv), k_cache, scale, softcap)   # (b,h,g,sq,S)
    sp = slot_pos[:, None, :]                              # (b, 1, S)
    qp = q_positions[:, :, None]                           # (b, sq, 1)
    ok = (sp >= 0) & (sp <= qp)                            # (b, sq, S)
    if window is not None:
        ok &= sp > qp - window
    s = torch.where(ok[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(b, sq, hq, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, slot_pos: torch.Tensor,
                     pos: torch.Tensor, *, window: Optional[int] = None,
                     softcap: Optional[float] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One-token attention (sq=1 :func:`cache_attention`); pos: (b,)."""
    return cache_attention(q, k_cache, v_cache, slot_pos, pos[:, None],
                           window=window, softcap=softcap, scale=scale)


# --------------------------------------------------------------------- #
# KV-cache plumbing
# --------------------------------------------------------------------- #

def cache_capacity(max_seq: int, window: Optional[int]) -> int:
    return min(max_seq, window) if window else max_seq


def init_kv_cache(batch: int, capacity: int, n_kv: int, head_dim: int,
                  dtype: torch.dtype, device, kv_format: Optional[str] = None,
                  lead=()) -> dict:
    """Dense ring cache: ``k``/``v`` at ``dtype`` and ``slot_pos`` = -1.
    ``lead`` prepends stacking axes (the period axis)."""
    if kv_format is not None:
        raise NotImplementedError(
            f"kv_format={kv_format!r}: quantized KV caches arrive with the "
            f"kv_format slice (flash_decode_quant)")
    shape = (*lead, batch, capacity, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "slot_pos": torch.full((*lead, batch, capacity), -1,
                                   dtype=torch.int32, device=device)}


def cache_write_decode(cache: dict, k: torch.Tensor, v: torch.Tensor,
                       pos: torch.Tensor,
                       active: Optional[torch.Tensor] = None) -> dict:
    """Write one (b, 1, hkv, d) k/v at per-row slot ``pos % capacity``,
    in place.  Rows where ``active`` is False keep their slot contents
    and ``slot_pos`` (inactive pool rows ride along in the fused loop)."""
    sp = cache["slot_pos"]
    b, cap = sp.shape
    rows = torch.arange(b, device=sp.device)
    slot = (pos % cap).long()
    sp[rows, slot] = mask_rows(active, pos.to(torch.int32), sp[rows, slot])
    for name, new in (("k", k[:, 0]), ("v", v[:, 0])):
        pool = cache[name]
        pool[rows, slot] = mask_rows(active, new.to(pool.dtype),
                                     pool[rows, slot])
    return cache


def cache_write_chunk(cache: dict, k: torch.Tensor, v: torch.Tensor,
                      positions: torch.Tensor, valid: torch.Tensor) -> dict:
    """Bulk-write a prompt chunk (b, s, hkv, d) at absolute ``positions``
    (s,) into the (ring) cache, in place.  ``valid`` (s,) masks the
    padded tail (masked slots keep their contents and slot_pos).
    Positions must map to distinct slots (s <= capacity)."""
    sp = cache["slot_pos"]
    b, s = k.shape[0], k.shape[1]
    slots = (positions % sp.shape[1]).long()
    vmask = valid.expand(b, s)
    sp[:, slots] = mask_rows(vmask, positions.to(torch.int32).expand(b, s),
                             sp[:, slots])
    for name, new in (("k", k), ("v", v)):
        pool = cache[name]
        pool[:, slots] = mask_rows(vmask, new.to(pool.dtype),
                                   pool[:, slots])
    return cache
