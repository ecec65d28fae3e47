"""Gradient compression (counterpart of ``repro.distributed.compression``):
the int8 stochastic-rounding mean of a gradient over a
``torch.distributed`` process group, which takes the place of the
reference's ``shard_map`` axis.

The scheme of the reference, op for op in fp32 as XLA compiles it under
``jit`` (the reference's trainer is jitted), so that the same inputs and
key give the same bits:

1. ``qmax = min(127, max(1, 32767 // world))``; the scale is
   ``max |g| / qmax`` per leading row of a leaf of two or more axes and
   per tensor for a vector, floored at 1e-30, then the largest of the
   ranks' scales (a ``MAX`` all-reduce);
2. ``q = clip(stochastic_round(g / scale), -qmax, qmax)``, with
   ``stochastic_round(x) = floor(x) + (uniform(key, x.shape) < x -
   floor(x))``;
3. the sum of the ranks' ``q``, exact in integers;
4. ``q_sum * scale / world``, cast back to the leaf's dtype.

XLA folds a division by a constant into a product with the constant's
fp32 reciprocal, so steps 1 and 4 divide by ``qmax`` and ``world`` that
way (``compat.reciprocal``); ``g / scale`` divides.

:func:`compressed_psum_tree` gives each leaf the key of its place in
``bridge.flatten``'s order (sorted keys at each level, as
``jax.tree.flatten`` orders a dict) from ``prng.split``.

**The wire.**  The reference sums int16, 2 B an element; neither gloo
nor NCCL reduces a 16-bit integer.  So the payload crosses as int32
words of two signed lanes: element ``2i`` in the low half, ``2i + 1``
in the high, ``w = lo + 65536 * hi``.  Each lane's sum over the ranks
lies within ``+-world * qmax <= 32767``, so the summed word ``S =
S_lo + 65536 * S_hi`` lies within ``+-(32767 * 65537) < 2^31``: no
int32 overflow, and the lanes come back exactly as ``S_lo = ((S +
32768) & 0xFFFF) - 32768`` and ``S_hi = (S - S_lo) >> 16``.  Still 2 B
an element.

**Memory.**  A leaf is quantized a block at a time (whole rows of at
most ``CHUNK`` elements, or ``CHUNK``-element pieces of one longer row),
each block's uniforms drawn for its range of the leaf's counters
(``prng.uniform_range``: the bits of one whole draw), so that the int64
threefry temporaries stay a block's size (~0.5 GB each) on a
311M-element embedding; qwen2.5-3b's 3.09 B gradients take 73 blocks of
~190 eager kernels each.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.bridge import flatten, unflatten
from repro_torch.compat import reciprocal
from repro_torch.serve import prng

CHUNK = 1 << 26          # elements quantized (and drawn) at a time
SCALE_FLOOR = 1e-30
LANE = 1 << 16


def stochastic_round(x: torch.Tensor, key: torch.Tensor,
                     start: int = 0) -> torch.Tensor:
    """Unbiased randomized rounding to the nearest integers: ``floor(x)
    + (u < frac)``, ``u`` elements ``[start, start + x.numel())`` of the
    flattened ``uniform(key, ...)`` (``start`` 0: the reference's
    ``uniform(key, x.shape)``).  Keys (*k, 2) round ``x`` once each:
    (*k, *x.shape)."""
    floor = torch.floor(x)
    frac = x - floor
    u = prng.uniform_range(key, start, x.numel())
    return floor + (u.reshape(key.shape[:-1] + x.shape) < frac)


def quantize(g: torch.Tensor, key: torch.Tensor, qmax: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 payload, fp32 scale) with one scale for the tensor;
    stochastic rounding keeps E[q * scale] = g."""
    scale = (torch.amax(torch.abs(g)).to(torch.float32)
             * reciprocal(qmax, g.device))
    scale = torch.clamp(scale, min=SCALE_FLOOR)
    q = stochastic_round(g.to(torch.float32) / scale, key)
    return torch.clamp(q, -qmax, qmax).to(torch.int8), scale


def _rows(g: torch.Tensor) -> torch.Tensor:
    """``g`` in fp32 as (rows, row length): a row a leading index for
    two or more axes (the reference's per-row scale), one row for a
    vector or a scalar."""
    g = g.to(torch.float32)
    return g.reshape(g.shape[0], -1) if g.dim() >= 2 else g.reshape(1, -1)


def _blocks(rows: int, row_len: int, chunk: int
            ) -> Iterator[Tuple[int, int, int, int]]:
    """(r0, r1, c0, c1) blocks covering a (rows, row_len) leaf in counter
    order: whole rows of at most ``chunk`` elements, or pieces of
    ``chunk`` elements of one longer row."""
    if row_len >= chunk:
        for r in range(rows):
            for c0 in range(0, row_len, chunk):
                yield r, r + 1, c0, min(c0 + chunk, row_len)
    else:
        step = chunk // row_len
        for r0 in range(0, rows, step):
            yield r0, min(r0 + step, rows), 0, row_len


def _pack(q: torch.Tensor) -> torch.Tensor:
    """Flat int16 ``q`` -> int32 words of two lanes (a zero lane pads an
    odd count)."""
    if q.numel() % 2:
        q = torch.cat([q, q.new_zeros(1)])
    word = q[1::2].to(torch.int32).mul_(LANE)
    return word.add_(q[0::2])


def _unpack(word: torch.Tensor, n: int) -> torch.Tensor:
    """Summed words -> the flat int32 lane sums, ``n`` of them."""
    lo = (word + LANE // 2).bitwise_and_(LANE - 1).sub_(LANE // 2)
    hi = word.sub_(lo).bitwise_right_shift_(16)
    return torch.stack([lo, hi], dim=-1).reshape(-1)[:n]


def compressed_psum(g: torch.Tensor, key: torch.Tensor,
                    group: Optional[dist.ProcessGroup], world: int
                    ) -> torch.Tensor:
    """Mean of ``g`` over ``group`` (``None``: the default group) with an
    int8-quantized payload: two collectives, the scales' ``MAX`` and the
    packed payload's ``SUM``.  ``world`` is the group's size, as the
    reference is given its axis size; ``qmax`` keeps ``world * qmax``
    within the int16 lanes."""
    if world != dist.get_world_size(group):
        raise ValueError(f"world {world} != the group's size "
                         f"{dist.get_world_size(group)}")
    qmax = min(127, max(1, 32767 // max(world, 1)))
    g2 = _rows(g)
    # max |g| a row, without an |g|-sized temporary
    scale = torch.maximum(torch.amax(g2, dim=1, keepdim=True),
                          torch.neg(torch.amin(g2, dim=1, keepdim=True)))
    scale = torch.clamp(scale * reciprocal(qmax, g.device),
                        min=SCALE_FLOOR)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    rows, row_len = g2.shape
    q = torch.empty(g2.shape, dtype=torch.int16, device=g.device)
    for r0, r1, c0, c1 in _blocks(rows, row_len, CHUNK):
        x = g2[r0:r1, c0:c1] / scale[r0:r1]
        x = stochastic_round(x, key, r0 * row_len + c0)
        q[r0:r1, c0:c1] = torch.clamp(x, -qmax, qmax)
        del x
    word = _pack(q.reshape(-1))
    del q
    dist.all_reduce(word, op=dist.ReduceOp.SUM, group=group)
    q_sum = _unpack(word, g.numel()).reshape(rows, row_len)
    out = q_sum.to(torch.float32).mul_(scale).mul_(
        reciprocal(world, g.device))
    return out.reshape(g.shape).to(g.dtype)


def compressed_psum_tree(grads: dict, key: torch.Tensor,
                         group: Optional[dist.ProcessGroup], world: int
                         ) -> dict:
    """:func:`compressed_psum` of every leaf of the nested dict
    ``grads``, leaf ``i`` of ``bridge.flatten``'s order under key ``i``
    of ``prng.split(key, n_leaves)``; returns a tree of the same
    structure."""
    flat = flatten(grads)
    keys = prng.split(key, len(flat))
    return unflatten({name: compressed_psum(g, keys[i], group, world)
                      for i, (name, g) in enumerate(flat.items())})
