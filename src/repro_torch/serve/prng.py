"""The threefry-2x32 PRNG of ``jax.random``, bit for bit, on torch tensors.

The reference samples through ``jax.random`` (``PRNGKey``, ``fold_in``,
``categorical``) with ``jax_threefry_partitionable`` on, the default of
the JAX it pins.  This module is the port's own copy of those functions,
so that a sampled token stream depends on (engine seed, request,
position, logits) exactly as the reference's does:

* :func:`threefry2x32`: the Threefry-2x32 hash, 20 rounds in five
  groups of four, rotations (13, 15, 26, 6) and (17, 29, 16, 24), the
  key schedule ``(k1, k2, k1 ^ k2 ^ 0x1BD11BDA)`` injected after every
  group with the group's index added to the second word;
* :func:`prng_key`: ``PRNGKey(seed)`` = ``[0, seed]`` (the seed's low 32
  bits; its high word is 0 for any seed below 2^32);
* :func:`fold_in`: ``threefry2x32(key, (0, data))``, ``data`` taken mod
  2^32 as ``jnp.uint32`` takes an int32;
* :func:`split`: ``jax.random.split(key, n)`` of the partitionable
  scheme: key ``i`` is the pair of output words for the counter (high,
  low) of the 64-bit ``i``;
* :func:`random_bits`: 32-bit draws of the partitionable scheme: the
  counter of element ``i`` of the flattened shape is the pair (high,
  low) of the 64-bit ``i``, and the draw is the xor of the two output
  words;
* :func:`uniform`: the draw's top 23 bits as the mantissa of a float in
  [1, 2), minus 1, then ``f * (maxval - minval) + minval`` floored at
  ``minval``;
* :func:`uniform_range`: elements ``[start, start + count)`` of the
  flattened :func:`uniform` draw, whatever its shape (an element's bits
  depend only on the key and its flat index), so that a large draw can
  be made a range at a time with the bits of one draw;
* :func:`gumbel`: ``-log(-log(uniform(tiny, 1)))``, ``jax.random``'s
  "low" mode;
* :func:`categorical`: ``argmax(gumbel + logits)``, the first index on
  ties.

A key is an int64 tensor ``(..., 2)`` holding two uint32 words; leading
axes hold independent keys, as ``jax.vmap`` over keys would.  The
32-bit arithmetic runs in int64, masked to 32 bits after every add and
left shift, so each right shift is logical and no add overflows.  Every
function works on the device of its inputs and reads nothing back to
the host.  ``log`` is the one operation that is not exact: torch's and
XLA's differ by at most one ulp, so gumbel values agree within a few
1e-7 and a sampled token differs only where two candidates' sums lie
within that distance.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

MASK = 0xFFFFFFFF
KS_PARITY = 0x1BD11BDA
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """Threefry-2x32 of the counters (x1, x2) under the key (k1, k2): all
    int64 tensors of uint32 values, broadcast together.  Returns the two
    output words, int64."""
    ks = (k1, k2, k1 ^ k2 ^ KS_PARITY)
    a = (x1 + ks[0]) & MASK
    b = (x2 + ks[1]) & MASK
    for group in range(5):
        for r in ROTATIONS[group % 2]:
            a = (a + b) & MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(group + 1) % 3]) & MASK
        b = (b + ks[(group + 2) % 3] + (group + 1)) & MASK
    return a, b


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: int64 (2,) = [0, seed mod 2^32]."""
    if not -2**31 <= seed < 2**32:
        raise ValueError(f"seed {seed} outside [-2^31, 2^32)")
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` of each ``data`` element into ``key``:
    key (*k, 2), data (*d) integer, broadcast -> keys (*broadcast, 2)."""
    d = data.to(torch.int64) & MASK
    a, b = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([a, b], dim=-1)


def split(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.split(key, n)``: key (2,) -> int64 (n, 2)."""
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    a, b = threefry2x32(key[0], key[1], idx >> 32, idx & MASK)
    return torch.stack([a, b], dim=-1)


def _counter_bits(key: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The 32-bit draws of the flat indices ``idx`` (int64) under each
    key of ``key`` (*k, 2): int64 (*k, *idx.shape)."""
    lead = key.shape[:-1] + (1,) * idx.dim()
    a, b = threefry2x32(key[..., 0].reshape(lead), key[..., 1].reshape(lead),
                        idx >> 32, idx & MASK)
    return a ^ b


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) for each key of ``key``
    (*k, 2): int64 (*k, *shape) holding the 32-bit draws."""
    shape = tuple(shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=key.device).reshape(shape)
    return _counter_bits(key, idx)


def _bits_to_uniform(bits: torch.Tensor, device, minval: float,
                     maxval: float) -> torch.Tensor:
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    # filled on the device: a tensor made from a host value would copy
    # it across and synchronize the stream
    lo = torch.full((), minval, dtype=torch.float32, device=device)
    hi = torch.full((), maxval, dtype=torch.float32, device=device)
    return torch.maximum(lo, (f - 1.0) * (hi - lo) + lo)


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32, per key of ``key`` (*k, 2):
    (*k, *shape) in [minval, maxval)."""
    return _bits_to_uniform(random_bits(key, shape), key.device, minval,
                            maxval)


def uniform_range(key: torch.Tensor, start: int, count: int
                  ) -> torch.Tensor:
    """Elements ``[start, start + count)`` of the flattened ``uniform(key,
    shape)`` in [0, 1), for any ``shape`` of at least ``start + count``
    elements: (*k, count), the same bits as the whole draw's."""
    idx = torch.arange(start, start + count, dtype=torch.int64,
                       device=key.device)
    return _bits_to_uniform(_counter_bits(key, idx), key.device, 0.0, 1.0)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low") in float32, per key of ``key``
    (*k, 2): (*k, *shape)."""
    return -torch.log(-torch.log(uniform(key, shape, TINY, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` over the last axis, per key: key (*k,
    2) samples from its slice of logits (*k, *rest, v) -> (*k, *rest)
    int64.  A single key (2,) over logits (b, v) is the reference's
    shared-key call; keys (b, 2) over (b, v) its ``vmap`` over rows."""
    g = gumbel(key, logits.shape[key.dim() - 1:])
    return torch.argmax(g + logits, dim=-1)
