"""Blockwise low-precision weight quantization (counterpart of
``repro.serve.quant``).

Every format is *storage* precision: weights are held quantized with
e8m0 (power-of-two) block scales, ``BLOCK`` = 32 elements per scale
along the last axis, and dequantized to ``compute_dtype`` for the dense
projections, as the reference's engine does.

* :func:`quantize_blockwise` / :func:`dequantize_blockwise`: values in
  the registry container (``compat.dtype_spec``), fp32 power-of-two
  scales;
* :func:`quantize_params`: the float cast, or fake-quant (quantize then
  dequantize) with byte accounting at the true packed width;
* :func:`quantize_tree` / :func:`dequantize_tree`: the stored weight
  tree.  A quantizable leaf becomes ``{"q", "scales", "scale_fmt",
  "fmt", "shape", "packed"}``: ``q`` is bit-packed uint8 (fp4 / fp6,
  ``packed=True``) or the container tensor; ``scales`` is the 1-byte
  e8m0 store.  The reference packs on the host with numpy; the port
  packs on the tensors' device with ``repro_torch.lowbits``, to the same
  bytes.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch import compat, lowbits

BLOCK = 32   # elements per scale block (the mxfp block)
CAST_FORMATS = ("float32", "bfloat16", "float16")
_QUANTIZABLE = ("w1", "w2", "w3", "wq", "wk", "wv", "wo", "embed",
                "unembed", "wz", "wx", "out_proj")


def _e8m0_scale(absmax: torch.Tensor, fmt_max: float) -> torch.Tensor:
    """2^ceil(log2(absmax / fmt_max)), clamped to e8m0's range: the
    scale rule and the 1-byte storage rule are one codec."""
    return lowbits.e8m0_decode(lowbits.e8m0_scale_code(absmax, fmt_max))


def quantize_blockwise(w: torch.Tensor, fmt: str
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize along the last axis in blocks of ``BLOCK``: (q (..., n)
    in the format's container, scales (..., n/BLOCK) fp32 powers of
    two)."""
    spec = compat.dtype_spec(fmt)
    *lead, n = w.shape
    if n % BLOCK:
        raise ValueError(f"last dim {n} % {BLOCK} != 0")
    wb = w.to(torch.float32).reshape(*lead, n // BLOCK, BLOCK)
    scales = _e8m0_scale(wb.abs().amax(dim=-1), spec.max_finite)
    vals = wb / scales[..., None]
    if spec.emulated:                       # fp6 / fp4: codec rounding
        vals = lowbits.quantize_values(vals, fmt)
    return vals.to(spec.container).reshape(*lead, n), scales


def dequantize_blockwise(q: torch.Tensor, scales: torch.Tensor,
                         out_dtype=torch.bfloat16) -> torch.Tensor:
    *lead, n = q.shape
    block = n // scales.shape[-1]
    qb = q.to(torch.float32).reshape(*lead, n // block, block)
    return (qb * scales[..., None]).reshape(*lead, n).to(out_dtype)


# --------------------------------------------------------------------- #
# Weight-only quantization of a parameter tree
# --------------------------------------------------------------------- #

def _map_with_path(tree: dict, fn: Callable, path=()) -> dict:
    return {k: _map_with_path(v, fn, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), v) for k, v in tree.items()}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _TreeStats:
    """MSE and byte accounting shared by the tree quantizers.  The
    squared-error sums stay on the device until :meth:`mse`."""

    def __init__(self):
        self.n_q = 0
        self.q_bytes = 0
        self.w_bytes = 0
        self.w_elems = 0
        self._err = []
        self._ref = []

    def passthrough(self, leaf: torch.Tensor) -> None:
        self.q_bytes += _nbytes(leaf)

    def quantized(self, deq: torch.Tensor, leaf: torch.Tensor,
                  stored_bytes: int) -> None:
        self.n_q += 1
        self.q_bytes += stored_bytes
        self.w_elems += leaf.numel()
        ref = leaf.to(torch.float32)
        self._err.append((deq.to(torch.float32) - ref).square().sum())
        self._ref.append(ref.square().sum())

    def mse(self) -> float:
        if not self._err:
            return 0.0
        num = torch.stack(self._err).sum().item()
        den = torch.stack(self._ref).sum().item()
        return num / max(den, 1e-30)


def _quantizable(path, leaf: torch.Tensor) -> bool:
    return (leaf.ndim >= 2 and leaf.shape[-1] % BLOCK == 0
            and path[-1] in _QUANTIZABLE)


def quantize_params(params: dict, fmt: str,
                    compute_dtype=torch.bfloat16) -> Tuple[dict, dict]:
    """The float formats cast every leaf with ``ndim >= 2``.  The
    low-precision formats quantize-dequantize every quantizable leaf to
    ``compute_dtype`` (fake-quant), with ``quantized_bytes`` counted at
    the true packed width plus one e8m0 byte per block.  Returns
    (params', stats) with the reference's stats keys."""
    if fmt in CAST_FORMATS:
        dtype = compat.resolve_dtype(fmt)
        stats = _TreeStats()

        def cast(_, w):
            w = w.to(dtype) if w.ndim >= 2 else w
            stats.passthrough(w)
            return w

        out = _map_with_path(params, cast)
        return out, {"format": fmt, "quantized_bytes": stats.q_bytes,
                      "n_quantized": 0, "mse": 0.0,
                      "bytes_per_element": torch.finfo(dtype).bits // 8}

    bpe = compat.storage_bytes_per_element(fmt, packed=True)
    stats = _TreeStats()

    def visit(path, leaf):
        if not _quantizable(path, leaf):
            stats.passthrough(leaf)
            return leaf
        q, s = quantize_blockwise(leaf, fmt)
        deq = dequantize_blockwise(q, s, compute_dtype)
        stats.quantized(deq, leaf, int(leaf.numel() * bpe) + s.numel())
        return deq

    out = _map_with_path(params, visit)
    return out, {"format": fmt, "quantized_bytes": int(stats.q_bytes),
                 "n_quantized": stats.n_q, "bytes_per_element": bpe,
                 "mse": stats.mse()}


def quantize_tree(params: dict, fmt: str, packed: bool = True
                  ) -> Tuple[dict, dict]:
    """Quantize a parameter tree into its stored form (see the module
    docstring).  Stats report the measured bytes of what is stored."""
    do_pack = packed and lowbits.is_packable(fmt)
    stats = _TreeStats()

    def visit(path, leaf):
        if not _quantizable(path, leaf):
            stats.passthrough(leaf)
            return leaf
        q, s = quantize_blockwise(leaf, fmt)
        deq = dequantize_blockwise(q, s, torch.float32)
        if do_pack:
            q = lowbits.pack(q.to(torch.float32), fmt)
        s_codes = lowbits.e8m0_encode(s)
        stats.quantized(deq, leaf, _nbytes(q) + _nbytes(s_codes))
        stats.w_bytes += _nbytes(q)
        return {"q": q, "scales": s_codes, "scale_fmt": "e8m0",
                "fmt": fmt, "shape": tuple(leaf.shape), "packed": do_pack}

    store = _map_with_path(params, visit)
    return store, {"format": fmt, "packed": do_pack,
                   "quantized_bytes": int(stats.q_bytes),
                   "n_quantized": stats.n_q,
                   "weight_bytes": int(stats.w_bytes),
                   "mse": stats.mse(),
                   "bytes_per_element": (
                       stats.w_bytes / stats.w_elems if stats.w_elems
                       else compat.storage_bytes_per_element(
                           fmt, packed=do_pack))}


def _is_qleaf(x) -> bool:
    return isinstance(x, dict) and set(x) >= {"q", "scales", "fmt"}


def dequantize_tree(store: dict, compute_dtype=torch.bfloat16) -> dict:
    """Dense ``compute_dtype`` params from a :func:`quantize_tree`
    store (unpacking packed leaves, decoding e8m0 scales)."""

    def leaf(x):
        if not _is_qleaf(x):
            return x
        q = x["q"]
        if x.get("packed"):
            q = lowbits.unpack(q, x["fmt"], x["shape"][-1]).reshape(
                x["shape"])
        s = x["scales"]
        if x.get("scale_fmt") == "e8m0":
            s = lowbits.e8m0_decode(s)
        return dequantize_blockwise(q, s, compute_dtype)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) and not _is_qleaf(v)
                else leaf(v) for k, v in tree.items()}

    return walk(store)
