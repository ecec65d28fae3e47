"""Device and dtype resolution for the port (counterpart of the
device/dtype part of ``repro.compat``).

Entry points run on the card unless the caller names the CPU:
:func:`resolve_device` maps ``None`` to ``cuda`` and raises when there
is no CUDA device, so a run meant for the card never continues on the
host by accident.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional, Union

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


def resolve_dtype(name: Union[str, torch.dtype]) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; this slice supports "
                         f"{sorted(_DTYPES)}") from None


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
