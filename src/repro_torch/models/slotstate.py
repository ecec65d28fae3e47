"""Per-slot decode-state protocol (counterpart of
``repro.models.slotstate``, the ring-KV part of this slice).

The serving cache is a dict of ``pos{i}`` layer entries whose leaves
carry the period axis first: ``(n_periods, batch, ...)``.  Three rules:

1. **Slot addressing.**  Inside the per-layer loop a leaf is
   ``(batch, ...)``; :func:`take_row` returns one slot's row as a size-1
   *view*, so writes into it land in the pool directly (the reference
   needs ``put_row`` to write the row back; in place, nothing does).
2. **Eviction** (:func:`clear_slot`): ring parts mark the slot empty
   (``slot_pos = -1``); payload bytes stay and position masking makes
   them unreachable.
3. **Decode-step advancement**: ring KV is masked by the ``active``
   predicate at the write site (``cache_write_decode(active=...)``) and
   updated in place, so the reference's ``decode_advance`` has nothing
   left to do for it.  Recurrent and read-only parts, which need it,
   arrive with the SSM and enc-dec slices.
"""

from __future__ import annotations

from typing import Optional

import torch


def mask_rows(mask: Optional[torch.Tensor], new: torch.Tensor,
              old: torch.Tensor) -> torch.Tensor:
    """Select ``new`` where ``mask`` (leading-dims bool) else ``old``."""
    if mask is None:
        return new
    m = mask.reshape(mask.shape + (1,) * (new.ndim - mask.ndim))
    return torch.where(m, new, old)


def take_row(tree: dict, slot: int) -> dict:
    """One slot's row (kept as a size-1 axis) of every leaf of a part
    tree whose slot axis is 0 — views into the pool."""
    return {name: leaf[slot:slot + 1] for name, leaf in tree.items()}


def clear_slot(cache: dict, slot: int) -> dict:
    """Evict pool row ``slot`` from the whole cache (rule 2), in place."""
    for entry in cache.values():
        for part, tree in entry.items():
            if "slot_pos" not in tree:
                raise NotImplementedError(
                    f"cache part {part!r} has no ring bookkeeping; "
                    f"recurrent parts arrive with the SSM slice")
            tree["slot_pos"][:, slot] = -1
    return cache
