"""Fault injection for the serving stack, paired with the in-loop
sentinel that detects the detectable class (counterpart of
``repro.serve.faults``).

=================  ==============================  =====================
fault kind         mechanism                       detected by
=================  ==============================  =====================
``logits_nan``     NaN written over one slot's     sentinel (non-finite
                   logits row at an armed          reduce in the fused
                   position (the slot's device     decode step)
                   state ``fault_pos`` /
                   ``fault_kind``)
``logits_inf``     same, with +inf                 sentinel
``e8m0_overflow``  every e8m0 K-scale byte of the  sentinel: code 0xFF
                   slot's ring KV set to the       decodes to 2^128 =
                   overflow code 0xFF              inf in fp32
``kv_bitflip``     XOR over the slot's packed KV   usually NOT: an XOR'd
                   bytes: scale bytes (``k_s``,    e8m0 code is a wrong
                   default) or code bytes          but finite scale, and
                   (``k_q``)                       code flips decode
                                                   finite (silent
                                                   corruption)
``state_inf``      the slot's recurrent state      sentinel: inf state
                   row (SSM conv carries and       reaches the logits
                   state) set to +inf              within a step
=================  ==============================  =====================

The cache poisoners write the slot's cache leaves **in place**, on the
device the cache lives on (the reference returns a new cache tree from
a jitted function); ``slot`` is a host int and each write fills or XORs
a view of the slot's rows, so no write copies a host value to the card
or reads a device value.  A detected slot stops advancing within the same decode block,
finishes ``faulted`` at the block boundary and is re-initialised through
``clear_slot``; every other slot's stream is bit-identical to an
uninjected run.

The gap, as in the reference: a ``kv_bitflip`` that decodes to a finite
wrong value passes the sentinel.  The tests pin the miss (status ``ok``,
tokens diverged from the uninjected run).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import torch

# in-loop fault codes carried in the engine's device slot state
# (state["fault_kind"]); 0 = disarmed
FAULT_NAN = 1
FAULT_INF = 2
LOGITS_FAULTS = {"logits_nan": FAULT_NAN, "logits_inf": FAULT_INF}

# e8m0 code 0xFF decodes to 2^(255-127) = 2^128 -> inf in fp32: the
# stored image of an overflowed quantizer input (encodes clamp to 254,
# so 255 appears only through corruption)
E8M0_OVERFLOW_CODE = 255

CACHE_FAULTS = ("e8m0_overflow", "kv_bitflip", "state_inf")
FAULT_KINDS = tuple(LOGITS_FAULTS) + CACHE_FAULTS


def _entries(cache: dict) -> Iterator[Tuple[str, dict]]:
    """The layer entries of a slot-state cache in sorted order (the
    reference's pytree order); a bare top-level tensor (``enc_out``) is
    no layer entry."""
    for name in sorted(cache):
        if isinstance(cache[name], dict):
            yield name, cache[name]


def _ring_parts(cache: dict) -> Iterator[Tuple[str, str, dict]]:
    """``(entry, part, tree)`` for every ring part (has a ``slot_pos``
    leaf) of a slot-state cache, self-attention KV first, then the
    cross-attention rings."""
    for pref in (lambda p: p == "kv", lambda p: p != "kv"):
        for name, entry in _entries(cache):
            for part, tree in entry.items():
                if "slot_pos" in tree and pref(part):
                    yield name, part, tree


def _recurrent_parts(cache: dict) -> Iterator[Tuple[str, str, dict]]:
    for name, entry in _entries(cache):
        for part, tree in entry.items():
            if "slot_pos" not in tree:
                yield name, part, tree


def overflow_e8m0_scales(cache: dict, slot: int) -> dict:
    """Every ``k_s`` byte of the slot in the first quantized ring part
    becomes 0xFF (scale 2^128 = inf), in place."""
    for _, _, tree in _ring_parts(cache):
        if "k_s" in tree:
            tree["k_s"][:, slot].fill_(E8M0_OVERFLOW_CODE)
            return cache
    raise ValueError(
        "e8m0_overflow needs a quantized KV cache (no ring part with "
        "k_s scale bytes found) — use kv_format=... or a logits fault")


def flip_kv_bytes(cache: dict, slot: int, leaf: str = "k_s",
                  xor: int = 0xFF) -> dict:
    """XOR the slot's bytes of ``leaf`` in the first quantized ring part
    that has it, in place: ``k_s`` flips e8m0 scale bytes, ``k_q``
    packed value codes (an fp8 container is flipped through a uint8
    view of its bytes)."""
    for _, _, tree in _ring_parts(cache):
        if leaf in tree:
            tree[leaf].view(torch.uint8)[:, slot].bitwise_xor_(xor)
            return cache
    raise ValueError(
        f"kv_bitflip needs a quantized ring KV part with a {leaf!r} "
        f"leaf — use kv_format=... or a logits fault")


def poison_recurrent_state(cache: dict, slot: int) -> dict:
    """The slot's row of every leaf of the first recurrent part (SSM
    conv carries and state) becomes +inf, in place."""
    for _, _, tree in _recurrent_parts(cache):
        for t in tree.values():
            t[:, slot].fill_(float("inf"))
        return cache
    raise ValueError(
        "state_inf needs a recurrent cache part (SSM/hybrid arch) — "
        "use a KV or logits fault")


CACHE_POISONERS = {
    "e8m0_overflow": overflow_e8m0_scales,
    "kv_bitflip": flip_kv_bytes,
    "state_inf": poison_recurrent_state,
}
