"""Low-precision format probes — paper §V.A-C (Tab IV/V/VI); counterpart
of ``repro.core.probes.precision``, without ``ml_dtypes``.

The paper enumerates the FP4/FP6/FP8 ``mma`` variants each card accepts
and which pipeline each lowers to.  Here the formats come from the
port's ``compat`` registry (fp8 e4m3 / e5m2 as torch's own float8
dtypes; fp6 e2m3 / e3m2 and fp4 e2m1 as values rounded by
``repro_torch.lowbits`` into an e4m3 container).  :func:`support_matrix`
reports what the device does with each: on a card of compute capability
8.9 or later fp8 runs natively on the tensor cores, while fp6 / fp4 have
no tensor-core path before Blackwell and are expanded to bf16 first (the
Hopper gap the paper studies); on the host every format is converted.
The reference's HLO inspection is XLA-only and has no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import compat, lowbits
from repro_torch.core.device_model import DeviceModel, detect_backend_model

# The paper's Tab V rows (short name -> canonical registry name).
_COMPAT_NAME = {
    "e2m1": "float4_e2m1fn",
    "e2m3": "float6_e2m3fn",
    "e3m2": "float6_e3m2fn",
    "e4m3": "float8_e4m3fn",
    "e5m2": "float8_e5m2",
}
FORMATS: Dict[str, compat.DTypeSpec] = {
    short: compat.dtype_spec(name) for short, name in _COMPAT_NAME.items()}

# Format metadata (bits, max finite value) — Tab IV/V support matrix.
FORMAT_INFO: Dict[str, Dict[str, float]] = {
    short: dict(bits=spec.bits, max=spec.max_finite)
    for short, spec in FORMATS.items()}


@dataclasses.dataclass(frozen=True)
class FormatSupport:
    """One Tab IV/V row: how a format actually executes on this device."""

    fmt: str
    bits: int
    max_finite: float
    representable: bool           # cast round-trip of [1.0, -0.5] works
    native_dot: bool              # the tensor cores take it as it is
    lowers_via_convert: bool      # expanded to a wider type first
    pipeline: str
    compat_name: str = ""         # canonical compat registry name


def to_format(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """``x`` rounded into ``fmt`` (short or registry name), in the
    format's container dtype: a cast for fp8, the codec's RTNE rounding
    (saturating) for fp6 / fp4."""
    name = _COMPAT_NAME.get(fmt, fmt)
    spec = compat.dtype_spec(name)
    x = x.to(torch.float32)
    if spec.emulated:
        x = lowbits.quantize_values(x, name)
    return x.to(spec.container)


def _native_fp8(device: DeviceModel) -> bool:
    if device.kind != "gpu":
        return False
    return torch.cuda.get_device_capability() >= (8, 9)


def support_matrix(device: DeviceModel | None = None) -> List[FormatSupport]:
    """What each paper format runs as on ``device`` (default: the card)."""
    device = device or detect_backend_model()
    fp8_native = _native_fp8(device)
    out = []
    for short, spec in FORMATS.items():
        x = torch.tensor([1.0, -0.5])
        representable = bool(torch.equal(to_format(x, short).float(), x))
        if spec.native and fp8_native:
            native, pipeline = True, "native fp8 tensor core (mma/wgmma)"
        elif device.kind == "gpu":
            native = False
            pipeline = (f"expand to bf16 -> bf16 tensor core "
                        f"(compat: {'native' if spec.native else 'emulated'}"
                        f" {spec.container})")
        else:
            native, pipeline = False, "host: convert to fp32"
        out.append(FormatSupport(
            fmt=short,
            bits=int(spec.bits),
            max_finite=float(spec.max_finite),
            representable=representable,
            native_dot=native,
            lowers_via_convert=not native,
            pipeline=pipeline,
            compat_name=_COMPAT_NAME[short],
        ))
    return out


# ---------------------------------------------------------------------------
# Numerics: cast error + MXFP block scaling (e8m0), §V.C precision tradeoffs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CastError:
    fmt: str
    rel_err_mean: float
    rel_err_max: float
    overflow_frac: float


def cast_error(fmt: str, x: Optional[np.ndarray] = None,
               seed: int = 0, n: int = 1 << 14) -> CastError:
    """Round-trip x -> fmt -> fp32 relative error on ~N(0,1) data."""
    if x is None:
        x = np.random.default_rng(seed).normal(size=n).astype(np.float32)
    xt = torch.from_numpy(np.asarray(x, np.float32))
    q = to_format(xt, fmt).float().numpy()
    finite = np.isfinite(q)
    denom = np.maximum(np.abs(x), 1e-6)
    rel = np.abs(q - x) / denom
    return CastError(
        fmt=fmt,
        rel_err_mean=float(rel[finite].mean()) if finite.any() else np.inf,
        rel_err_max=float(rel[finite].max()) if finite.any() else np.inf,
        overflow_frac=float(1.0 - finite.mean()),
    )


def block_quantize(x: torch.Tensor, fmt: str, block: int = 32
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MXFP-style block quantization: e8m0 power-of-two scale per block
    (``lowbits.e8m0_scale_code``: 2^ceil(log2(absmax / fmax))).

    Returns ``(q, scales)`` with ``q`` in the format's container over the
    last axis blocked by ``block``.
    """
    assert x.shape[-1] % block == 0, (x.shape, block)
    fmax = FORMAT_INFO[fmt]["max"]
    xb = x.to(torch.float32).reshape(*x.shape[:-1], x.shape[-1] // block,
                                     block)
    absmax = xb.abs().amax(dim=-1, keepdim=True)
    scale = lowbits.e8m0_decode(lowbits.e8m0_scale_code(absmax, fmax))
    q = to_format(xb / scale, fmt)
    return q.reshape(x.shape), scale.squeeze(-1)


def block_dequantize(q: torch.Tensor, scales: torch.Tensor, block: int = 32,
                     out_dtype=torch.float32) -> torch.Tensor:
    qb = q.to(out_dtype).reshape(*q.shape[:-1], q.shape[-1] // block, block)
    return (qb * scales[..., None]).reshape(q.shape)


def block_roundtrip_error(fmt: str, shape=(64, 256), block: int = 32,
                          seed: int = 0) -> float:
    """Mean relative error of quantize->dequantize with e8m0 block scales
    on N(0, 16) data from a seeded ``torch.Generator``."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g) * 4.0
    q, s = block_quantize(x, fmt, block)
    y = block_dequantize(q, s, block)
    rel = (y - x).abs() / x.abs().clamp(min=1e-6)
    return float(rel.mean())
