"""Serving precision (counterpart of the float branch of
``repro.serve.quant.quantize_params``): cast every parameter leaf with
``ndim >= 2`` to the serving dtype.  The blockwise fp8/fp6/fp4 formats
arrive with the weight-store slice."""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.compat import resolve_dtype

CAST_FORMATS = ("float32", "bfloat16")


def _map(tree: dict, fn) -> dict:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _leaves(tree: dict):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def quantize_params(params: dict, fmt: str) -> Tuple[dict, dict]:
    """Returns (params', stats) with the reference's stats keys."""
    if fmt not in CAST_FORMATS:
        raise NotImplementedError(
            f"format {fmt!r}: blockwise low-precision weights arrive with "
            f"the weight-store slice; this slice casts to {CAST_FORMATS}")
    dtype = resolve_dtype(fmt)
    cast = _map(params, lambda w: w.to(dtype) if w.ndim >= 2 else w)
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(cast))
    return cast, {"format": fmt, "quantized_bytes": nbytes,
                  "n_quantized": 0, "mse": 0.0,
                  "bytes_per_element": torch.finfo(dtype).bits // 8}
