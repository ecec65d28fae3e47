"""Weight bridge between the reference's parameter pytree and the port's.

Both packages keep the same nested-dict layout (same keys, same shapes),
so a tree crosses as a flat ``{"a/b/c": array}`` dict keyed as
``repro.checkpoint.checkpointer._flatten`` keys it: "/"-joined dict keys,
visited in sorted order.  Arrays cross as numpy.

A bf16 leaf of the reference reaches numpy as ``ml_dtypes.bfloat16``,
which ``torch.from_numpy`` refuses; it goes through float32 (exact for
bf16 values) and is cast back to bfloat16 on the torch side.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer


def flatten(tree: dict, prefix: str = "") -> Dict[str, object]:
    """Nested dict -> {"a/b/c": leaf}, keys in sorted order."""
    out: Dict[str, object] = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def unflatten(flat: Dict[str, object]) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        *parents, name = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = leaf
    return tree


def _to_tensor(arr: np.ndarray, device, dtype: Optional[torch.dtype]
               ) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
        dtype = dtype or torch.bfloat16
    # a copy: the tensor must not share (read-only) memory with the source
    t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(flat: Dict[str, np.ndarray], cfg: ArchConfig,
                      device="cpu", dtype: Optional[torch.dtype] = None
                      ) -> dict:
    """The reference's flattened params -> the port's parameter tree on
    ``device`` (at ``dtype`` when given, else each leaf's own dtype).
    Raises when the key set or a shape differs from what the port's
    model for ``cfg`` expects."""
    want = {k: tuple(v.shape) for k, v in flatten(
        transformer.init_lm(cfg, None, "meta")).items()}
    got = {k: tuple(np.shape(v)) for k, v in flat.items()}
    if set(want) != set(got):
        raise ValueError(
            f"param keys differ: missing {sorted(set(want) - set(got))}, "
            f"unexpected {sorted(set(got) - set(want))}")
    bad = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    if bad:
        raise ValueError(f"param shapes differ (got, want): {bad}")
    return unflatten({k: _to_tensor(v, device, dtype)
                      for k, v in flat.items()})


def params_to_numpy(params: dict) -> Dict[str, np.ndarray]:
    """The port's parameter tree -> flat numpy dict.  bf16 leaves come
    out as float32 arrays holding the same values."""
    out = {}
    for k, t in flatten(params).items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[k] = t.numpy()
    return out
