"""Attention: projections, grouped-query softmax attention against a ring
KV cache, whole-sequence attention (``full_attention``,
``chunked_attention`` and the ``attention()`` dispatch: the plain
version of the ``flash_attention`` kernel), and the cache write paths
(counterpart of ``repro.models.attention``).

The cache layout is the reference's: ``k``/``v`` (b, S, hkv, d) at the
cache dtype plus ``slot_pos`` (b, S) int32, the absolute position each
slot holds (-1 = empty).  A quantized cache (``kv_format``) holds
``k_q``/``v_q`` codes (b, S, hkv, stored_d) and ``k_s``/``v_s`` 1-byte
e8m0 block scales (b, S, hkv, d/blk) instead of ``k``/``v``; K/V are
quantized on write (:func:`quantize_kv`, plain torch ops, as the
reference does it in XLA).  Visibility is computed from positions
(``0 <= slot_pos <= q_pos``, and ``> q_pos - window`` for local layers),
so one rule covers decode, chunked prefill and ring wrap-around.  The
speculative commit writes per-row positions (:func:`cache_write_rows`);
a draft model's rejected writes are undone by a pointer move
(:func:`cache_rollback`).

Unlike the reference, whose arrays are immutable, the write paths here
update the cache tensors **in place** (``index_put_`` on pool rows) and
return the same dict: the serving pool is about 1 GB at full width, and
a functional copy per step would double it.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import compat, lowbits
from repro_torch.models import layers
from repro_torch.models.layers import dense_init, mm
from repro_torch.models.slotstate import mask_rows

NEG_INF = -1.0e30
_FLOAT8 = (torch.float8_e4m3fn, torch.float8_e5m2)


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
# Whole-sequence attention (the plain version of the flash_attention
# kernel: kernels.flash_attention runs it for CPU tensors)
# --------------------------------------------------------------------- #

def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    """Additive fp32 bias (sq, sk): 0 where visible, -1e30 elsewhere."""
    ok = torch.ones((q_pos.shape[-1], k_pos.shape[-1]), dtype=torch.bool,
                    device=q_pos.device)
    if causal:
        ok &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        ok &= q_pos[:, None] - k_pos[None, :] < window
    return torch.zeros(ok.shape, dtype=torch.float32,
                       device=ok.device).masked_fill(~ok, NEG_INF)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: Optional[int] = None,
                   softcap: Optional[float] = None,
                   scale: Optional[float] = None,
                   q_positions: Optional[torch.Tensor] = None,
                   k_positions: Optional[torch.Tensor] = None,
                   k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """O(sq * sk)-memory attention.  q (b, sq, hq, d), k / v (b, sk, hkv,
    d) -> (b, sq, hq, d) at q's dtype.  Positions default to
    ``arange``; ``k_valid`` (b, sk) bool masks per-row key padding.  A
    row with no visible key gets the mean of V (softmax of equal
    -1e30 scores), as in the reference."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = _scores(_group(q, hkv), k, scale, softcap)         # (b,h,g,sq,sk)
    q_pos = (torch.arange(sq, device=q.device) if q_positions is None
             else q_positions)
    k_pos = (torch.arange(sk, device=q.device) if k_positions is None
             else k_positions)
    s = s + _mask_bias(q_pos, k_pos, causal, window)
    if k_valid is not None:
        s = torch.where(k_valid[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return o.reshape(b, sq, hq, d).to(q.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      softcap: Optional[float] = None,
                      scale: Optional[float] = None, chunk: int = 1024,
                      k_valid: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Online softmax over KV chunks of ``chunk`` keys: O(sq * chunk)
    live scores.  The KV axis is padded to the chunk and the padding
    masked.  fp32 m / l / acc; ``p`` is cast to v's dtype before PV; a
    row with no visible key gets the mean of V, as in
    :func:`full_attention`."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    pad = (-sk) % chunk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        if k_valid is not None:
            k_valid = F.pad(k_valid, (0, pad), value=False)
    if k_valid is None:
        k_valid = torch.ones((b, sk + pad), dtype=torch.bool,
                             device=q.device)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = _group(q, hkv)                                    # (b,sq,h,g,d)
    q_pos = torch.arange(sq, device=q.device)
    f32 = torch.float32
    m = torch.full((b, hkv, hq // hkv, sq), NEG_INF, dtype=f32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((*m.shape, d), dtype=f32, device=q.device)
    for c0 in range(0, sk + pad, chunk):
        k_i, v_i = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        k_pos = c0 + torch.arange(chunk, device=q.device)
        s = _scores(qg, k_i, scale, softcap)               # (b,h,g,sq,c)
        bias = _mask_bias(q_pos, k_pos, causal, window)
        s = s + bias.masked_fill(~(k_pos < sk)[None, :], NEG_INF)
        s = torch.where(k_valid[:, None, None, None, c0:c0 + chunk], s,
                        NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p.to(v_i.dtype).float(), v_i.float())
        m = m_new
    l = torch.where(l == 0.0, 1.0, l)
    o = (acc / l[..., None]).permute(0, 3, 1, 2, 4)       # (b,sq,h,g,d)
    return o.reshape(b, sq, hq, d).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None,
              scale: Optional[float] = None, chunk: int = 1024,
              k_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatch: :func:`chunked_attention` when the KV axis is longer
    than ``chunk``, else :func:`full_attention`."""
    if k.shape[1] <= chunk:
        return full_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap, scale=scale, k_valid=k_valid)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale, chunk=chunk,
                             k_valid=k_valid)


# --------------------------------------------------------------------- #
# KV-cache plumbing
# --------------------------------------------------------------------- #

def cache_capacity(max_seq: int, window: Optional[int]) -> int:
    return min(max_seq, window) if window else max_seq


def kv_scale_block(head_dim: int) -> int:
    """Scale-block size along head_dim: 32 (the mxfp block) when it
    divides, else the largest power-of-two divisor (reduced configs run
    head_dim 16)."""
    for blk in (32, 16, 8, 4, 2, 1):
        if head_dim % blk == 0:
            return blk
    return 1


def quantize_kv(x: torch.Tensor, kv_format: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., d) activations -> (stored, scale_codes): fp8 ``stored`` is
    (..., d) in the container dtype, fp4/fp6 (..., d*bits/8) uint8
    packed codes; ``scale_codes`` (..., d/kv_scale_block(d)) uint8
    e8m0."""
    spec = compat.dtype_spec(kv_format)
    *lead, d = x.shape
    blk = kv_scale_block(d)
    xb = x.to(torch.float32).reshape(*lead, d // blk, blk)
    s_codes = lowbits.e8m0_scale_code(xb.abs().amax(dim=-1),
                                      spec.max_finite)
    vals = (xb / lowbits.e8m0_decode(s_codes)[..., None]).reshape(*lead, d)
    if spec.packed is not None:
        if d % spec.packed.values_per_group:
            raise ValueError(
                f"head_dim {d} not a multiple of {kv_format}'s pack "
                f"group ({spec.packed.values_per_group})")
        stored = lowbits.pack_codes(
            lowbits.encode_codes(vals, kv_format), kv_format)
    else:
        stored = vals.to(spec.container)
    return stored, s_codes


def dequantize_kv(stored: torch.Tensor, scale_codes: torch.Tensor,
                  kv_format: str, head_dim: int,
                  out_dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`: -> (..., head_dim) values."""
    spec = compat.dtype_spec(kv_format)
    if spec.packed is not None:
        vals = lowbits.decode(lowbits.unpack_codes(stored, kv_format),
                              kv_format)
    else:
        vals = stored.to(torch.float32)
    *lead, d = vals.shape
    blk = kv_scale_block(head_dim)
    scales = lowbits.e8m0_decode(scale_codes)
    out = vals.reshape(*lead, d // blk, blk) * scales[..., None]
    return out.reshape(*lead, d).to(out_dtype)


def init_kv_cache(batch: int, capacity: int, n_kv: int, head_dim: int,
                  dtype: torch.dtype, device, kv_format: Optional[str] = None,
                  lead=()) -> dict:
    """Ring cache: dense ``k``/``v`` at ``dtype``, or (``kv_format``)
    ``k_q``/``v_q`` codes and ``k_s``/``v_s`` e8m0 scales (fp4: 0.5 +
    1/32 B/elem); ``slot_pos`` = -1.  ``lead`` prepends stacking axes
    (the period axis)."""
    sp = torch.full((*lead, batch, capacity), -1, dtype=torch.int32,
                    device=device)
    if kv_format is None:
        shape = (*lead, batch, capacity, n_kv, head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device),
                "slot_pos": sp}
    spec = compat.dtype_spec(kv_format)
    if spec.packed is not None:
        ps = spec.packed
        stored_d = head_dim // ps.values_per_group * ps.bytes_per_group
        stored_dtype = torch.uint8
    else:
        stored_d, stored_dtype = head_dim, spec.container
    n_blk = head_dim // kv_scale_block(head_dim)
    zq = (*lead, batch, capacity, n_kv, stored_d)
    zs = (*lead, batch, capacity, n_kv, n_blk)
    return {"k_q": torch.zeros(zq, dtype=stored_dtype, device=device),
            "k_s": torch.zeros(zs, dtype=torch.uint8, device=device),
            "v_q": torch.zeros(zq, dtype=stored_dtype, device=device),
            "v_s": torch.zeros(zs, dtype=torch.uint8, device=device),
            "slot_pos": sp}


def is_quantized_cache(cache: dict) -> bool:
    return "k_q" in cache


def cache_kv(cache: dict, kv_format: Optional[str], head_dim: int,
             out_dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense (k, v) of a cache, dequantized when it is stored quantized
    (the chunked prefill's history; decode reads the codes in the
    ``flash_decode_quant`` kernel instead)."""
    if not is_quantized_cache(cache):
        return cache["k"], cache["v"]
    if kv_format is None:
        raise ValueError("a quantized cache needs its kv_format")
    return (dequantize_kv(cache["k_q"], cache["k_s"], kv_format, head_dim,
                          out_dtype),
            dequantize_kv(cache["v_q"], cache["v_s"], kv_format, head_dim,
                          out_dtype))


def _raw(t: torch.Tensor) -> torch.Tensor:
    """A float8 tensor as its bytes (a view): the writes move bytes and
    need no float8 arithmetic on either device."""
    return t.view(torch.uint8) if t.dtype in _FLOAT8 else t


def _payload(cache: dict, k: torch.Tensor, v: torch.Tensor,
             kv_format: Optional[str]) -> dict:
    """The pool leaves a write updates and their new values: quantized
    on the way in for a quantized cache, cast to the cache dtype
    otherwise."""
    if is_quantized_cache(cache):
        if kv_format is None:
            raise ValueError("a quantized cache needs its kv_format")
        k_q, k_s = quantize_kv(k, kv_format)
        v_q, v_s = quantize_kv(v, kv_format)
        return {"k_q": k_q, "k_s": k_s, "v_q": v_q, "v_s": v_s}
    return {"k": k.to(cache["k"].dtype), "v": v.to(cache["v"].dtype)}


def cache_write_decode(cache: dict, k: torch.Tensor, v: torch.Tensor,
                       pos: torch.Tensor,
                       active: Optional[torch.Tensor] = None, *,
                       kv_format: Optional[str] = None) -> dict:
    """Write one (b, 1, hkv, d) k/v at per-row slot ``pos % capacity``,
    in place.  Rows where ``active`` is False keep their slot contents
    and ``slot_pos`` (inactive pool rows ride along in the fused loop)."""
    sp = cache["slot_pos"]
    b, cap = sp.shape
    rows = torch.arange(b, device=sp.device)
    slot = (pos % cap).long()
    sp[rows, slot] = mask_rows(active, pos.to(torch.int32), sp[rows, slot])
    for name, new in _payload(cache, k[:, 0], v[:, 0], kv_format).items():
        pool = _raw(cache[name])
        pool[rows, slot] = mask_rows(active, _raw(new), pool[rows, slot])
    return cache


def cache_write_chunk(cache: dict, k: torch.Tensor, v: torch.Tensor,
                      positions: torch.Tensor, valid: torch.Tensor, *,
                      kv_format: Optional[str] = None) -> dict:
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
    for name, new in _payload(cache, k, v, kv_format).items():
        pool = _raw(cache[name])
        pool[:, slots] = mask_rows(vmask, _raw(new), pool[:, slots])
    return cache


def cache_write_rows(cache: dict, k: torch.Tensor, v: torch.Tensor,
                     positions: torch.Tensor,
                     valid: Optional[torch.Tensor] = None, *,
                     kv_format: Optional[str] = None) -> dict:
    """Write (b, s, hkv, d) k/v at per-row absolute ``positions`` (b, s)
    into the (ring) cache, in place: the speculative commit.  ``valid``
    (b, s) masks rejected draft tails and inactive rows (masked entries
    keep their contents and slot_pos).  Per row, positions must map to
    distinct slots (s <= capacity).  A quantized cache encodes on the way
    in."""
    sp = cache["slot_pos"]
    b, cap = sp.shape
    rows = torch.arange(b, device=sp.device)[:, None]
    slots = (positions % cap).long()
    sp[rows, slots] = mask_rows(valid, positions.to(torch.int32),
                                sp[rows, slots])
    for name, new in _payload(cache, k, v, kv_format).items():
        pool = _raw(cache[name])
        pool[rows, slots] = mask_rows(valid, _raw(new), pool[rows, slots])
    return cache


def cache_rollback(cache: dict, positions: torch.Tensor,
                   reject: torch.Tensor) -> dict:
    """Invalidate rejected speculative writes, in place: a pointer move,
    no payload traffic.  positions (b, s) were written; ``reject`` (b, s)
    marks the writes to undo.  A slot is cleared (slot_pos -1) only while
    it still holds the rejected position, so a slot overwritten since, or
    never written (an inactive row), is left alone.  Takes a
    period-stacked ``slot_pos`` (n_p, b, cap) too."""
    sp = cache["slot_pos"]
    slots = (positions % sp.shape[-1]).long()
    rows = torch.arange(positions.shape[0], device=sp.device)[:, None]
    if sp.dim() == 2:
        cur = sp[rows, slots]                              # (b, s)
        hit = reject & (cur == positions)
        sp[rows, slots] = torch.where(hit, -1, cur)
    else:
        cur = sp[:, rows, slots]                           # (n_p, b, s)
        hit = reject[None] & (cur == positions[None])
        sp[:, rows, slots] = torch.where(hit, -1, cur)
    return cache


def cache_write_prefill(cache: dict, k: torch.Tensor, v: torch.Tensor,
                        kv_format: Optional[str] = None) -> dict:
    """Bulk-write a whole prompt's K/V (b, s, hkv, d), positions 0..s-1,
    into the (ring) cache, in place.  Keeps the last ``capacity``
    positions at slots ``p % capacity`` (distinct, so the scatter is a
    permutation); a quantized cache encodes the kept span on the way
    in."""
    sp = cache["slot_pos"]
    b, cap = sp.shape
    s = k.shape[1]
    take = min(s, cap)
    positions = torch.arange(s - take, s, dtype=torch.int32,
                             device=sp.device)
    slots = (positions % cap).long()
    sp[:, slots] = positions.expand(b, take)
    for name, new in _payload(cache, k[:, s - take:], v[:, s - take:],
                              kv_format).items():
        _raw(cache[name])[:, slots] = _raw(new)
    return cache
