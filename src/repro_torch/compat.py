"""Device and dtype resolution and the low-precision format registry of
the port (counterpart of the device/dtype part of ``repro.compat``).

Entry points run on the card unless the caller names the CPU:
:func:`resolve_device` maps ``None`` to ``cuda`` and raises when there
is no CUDA device, so a run meant for the card never continues on the
host by accident.

The registry (:func:`dtype_registry`) says how each of the paper's
formats is held: fp8 e4m3 / e5m2 in torch's own float8 dtypes; fp6 and
fp4, which torch cannot hold, as their values in a ``float8_e4m3fn``
container (every e2m3 / e3m2 / e2m1 value is exact in e4m3), rounded by
``repro_torch.lowbits.quantize_values``, with a bit-packed layout for
storage.  It is the reference's fallback ladder with the ``ml_dtypes``
host rounding replaced by the codec's arithmetic.

:func:`divide_` divides by a count as XLA compiles the reference's
``x / n`` and ``pmean`` under ``jit``: a product with the fp32
reciprocal.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import shutil
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.lowbits import PackedSpec, is_packable
from repro_torch.lowbits import packed_spec as _lowbits_packed_spec

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16,
           "float8_e4m3fn": torch.float8_e4m3fn,
           "float8_e5m2": torch.float8_e5m2}


def resolve_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device that is not present raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch sees no CUDA device "
            f"(torch {torch.__version__}); pass device='cpu' explicitly "
            f"to run the plain versions on the host")
    return dev


def reciprocal(n: int, device) -> torch.Tensor:
    """``1 / n`` rounded to fp32 (0-d, on ``device``): the factor XLA
    multiplies by where the reference divides by the constant ``n``."""
    return torch.reciprocal(torch.full((), float(n), dtype=torch.float32,
                                       device=device))


def divide_(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t / n`` in place, as XLA compiles it under ``jit``: ``t``
    widened to fp32, times :func:`reciprocal` ``(n)``, rounded back to
    ``t``'s dtype (a bf16 ``t`` too: XLA widens it before the product).
    Returns ``t``."""
    r = reciprocal(n, t.device)
    if t.dtype == torch.float32:
        return t.mul_(r)
    return t.copy_(t.to(torch.float32).mul_(r))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (the kernels'
    wrappers size their grids by it)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def resolve_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    """A dtype torch holds natively; fp6/fp4 names raise (they live in
    the registry's container, see :func:`dtype_spec`)."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}: torch holds "
                         f"{sorted(_DTYPES)}") from None


# --------------------------------------------------------------------- #
# Low-precision format registry
# --------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class DTypeSpec:
    """How one paper format is stored in the port.  ``container`` is the
    torch dtype that holds its values; ``native`` means the container IS
    the format; otherwise values are rounded to the format
    (``lowbits.quantize_values``) before entering the container."""

    name: str
    bits: int                # true format width (storage accounting)
    max_finite: float        # largest finite magnitude
    container: torch.dtype
    native: bool
    packed: Optional[PackedSpec] = None   # sub-byte bit-packed layout

    @property
    def emulated(self) -> bool:
        return not self.native

    @property
    def packable(self) -> bool:
        return self.packed is not None


@functools.lru_cache(maxsize=None)
def dtype_registry() -> Dict[str, DTypeSpec]:
    """name -> :class:`DTypeSpec` for the five formats."""
    table = [("float8_e4m3fn", 8, 448.0, torch.float8_e4m3fn),
             ("float8_e5m2", 8, 57344.0, torch.float8_e5m2),
             ("float6_e2m3fn", 6, 7.5, None),
             ("float6_e3m2fn", 6, 28.0, None),
             ("float4_e2m1fn", 4, 6.0, None)]
    return {name: DTypeSpec(
        name=name, bits=bits, max_finite=fmax,
        container=native or torch.float8_e4m3fn, native=native is not None,
        packed=_lowbits_packed_spec(name) if is_packable(name) else None)
        for name, bits, fmax, native in table}


def dtype_spec(name: str) -> DTypeSpec:
    try:
        return dtype_registry()[name]
    except KeyError:
        raise KeyError(f"unknown low-precision format {name!r}; known: "
                       f"{sorted(dtype_registry())}") from None


def available_formats() -> Tuple[str, ...]:
    return tuple(dtype_registry())


def storage_bytes_per_element(name: str, packed: bool = True) -> float:
    """True storage B/elem: the packed layout when there is one, else
    the container's width."""
    spec = dtype_spec(name)
    if packed and spec.packed is not None:
        return spec.packed.bytes_per_element
    return float(torch.finfo(spec.container).bits // 8)


def nvcc_path() -> Optional[str]:
    """The CUDA compiler the kernel builds use, or None."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    return cand if os.path.exists(cand) else None


def report() -> str:
    """One-paragraph capability header: torch/CUDA versions, the device,
    and whether the kernel compiler is present."""
    lines = [f"torch {torch.__version__} (CUDA {torch.version.cuda})"]
    if torch.cuda.is_available():
        lines.append(f"device: {torch.cuda.get_device_name(0)} "
                     f"x{torch.cuda.device_count()} "
                     f"(sm_{''.join(map(str, torch.cuda.get_device_capability(0)))})")
    else:
        lines.append("device: no CUDA device")
    lines.append(f"nvcc: {nvcc_path() or 'not found'}")
    return "\n".join(lines)
