"""Analytical energy / power model (counterpart of ``repro.core.energy``)
— the paper's §V.C (Tab VI) and §VII (Fig 12, Tab VIII).

The paper measures wall power with ``nvidia-smi`` while sustained mma
loops run at each precision (Tab VI), while a GEMM grows (Fig 12) and
while a transformer serves (Tab VIII).  The reference had no power
reading and replaced the measurement with this first-order model:

    E = flops * e_flop(dtype) + sum_level bytes_level * e_byte(level)
        + P_idle * t

The port keeps the model as the reference has it: the same constants,
the same fallbacks for an unknown dtype or memory level, the same clamp
at the part's power limit and the same float operations in the same
order, so that for the same ``DeviceModel`` fields it gives the
reference's floats exactly.  The per-op energies are order-of-magnitude
constants (Horowitz, ISSCC'14, scaled to a ~5 nm class node; HBM ~3.5
pJ/bit); the model's ordering (lower precision, less energy an op;
memory energy dominating ops of low arithmetic intensity) is its
content, its watts are estimates.  On the card the port reads the
power itself (:mod:`repro_torch.core.nvml`) and holds it beside this
model (``chip_smoke.py`` phase 2r).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

from repro_torch.core.device_model import DeviceModel

# pJ per FLOP (MAC counted as 2 FLOPs) on the matrix pipeline, by dtype:
# fp32 : bf16 : fp8 : fp6 : fp4 ~ 4 : 1 : 0.5 : 0.4 : 0.25.
ENERGY_PER_FLOP_PJ: Dict[str, float] = {
    "float64": 20.0,
    "float32": 4.0,
    "tf32": 2.4,
    "bfloat16": 1.0,
    "float16": 1.0,
    "int8": 0.4,
    "float8_e4m3fn": 0.5,
    "float8_e5m2": 0.5,
    "float6_e2m3fn": 0.4,
    "float6_e3m2fn": 0.4,
    "float4_e2m1fn": 0.25,
    "int32": 0.8,
}

# pJ per byte moved, by memory level (register ~0.1, VMEM/L1 ~1, HBM ~28
# (= 3.5 pJ/bit), interconnect ~80).
ENERGY_PER_BYTE_PJ: Dict[str, float] = {
    "vreg": 0.1,
    "l1": 1.0,
    "vmem": 1.0,
    "l2": 4.0,
    "l3": 8.0,
    "hbm": 28.0,
    "ici": 80.0,
}


@dataclasses.dataclass(frozen=True)
class EnergyEstimate:
    joules: float
    seconds: float
    dynamic_watts: float
    total_watts: float            # dynamic + idle
    breakdown: Mapping[str, float]

    @property
    def perf_per_watt(self) -> float:
        """FLOP/s per watt given the flops recorded in the breakdown."""
        fl = self.breakdown.get("_flops", 0.0)
        if self.seconds <= 0 or self.total_watts <= 0:
            return 0.0
        return (fl / self.seconds) / self.total_watts


def estimate(
    device: DeviceModel,
    *,
    flops: float,
    dtype: str,
    bytes_by_level: Optional[Mapping[str, float]] = None,
    seconds: Optional[float] = None,
) -> EnergyEstimate:
    """Energy for a region executing ``flops`` at ``dtype`` and moving
    ``bytes_by_level`` bytes.  ``seconds`` (measured or roofline-predicted)
    converts to power; if omitted, the device's compute roofline is used."""
    e_flop = ENERGY_PER_FLOP_PJ.get(dtype, ENERGY_PER_FLOP_PJ["bfloat16"])
    breakdown: Dict[str, float] = {"_flops": flops}
    joules = flops * e_flop * 1e-12
    breakdown["compute"] = joules
    for level, nbytes in (bytes_by_level or {}).items():
        e = nbytes * ENERGY_PER_BYTE_PJ.get(level, 28.0) * 1e-12
        breakdown[level] = e
        joules += e
    if seconds is None:
        peak = device.peak_flops_for(dtype)
        seconds = flops / peak if peak else 0.0
    dynamic = joules / seconds if seconds > 0 else 0.0
    total = dynamic + device.idle_watts
    # sustained draw cannot exceed the part's power limit (the paper's
    # Fig 12 plateaus are this governor)
    if device.peak_watts:
        total = min(total, device.peak_watts)
    return EnergyEstimate(
        joules=joules,
        seconds=seconds,
        dynamic_watts=dynamic,
        total_watts=total,
        breakdown=breakdown,
    )


def matmul_energy(
    device: DeviceModel, m: int, n: int, k: int, dtype: str,
    seconds: Optional[float] = None,
) -> EnergyEstimate:
    """Tab VI / Fig 12 analogue: energy of one ``m x n x k`` matmul."""
    flops = 2.0 * m * n * k
    elem = {"float64": 8, "float32": 4, "tf32": 4}.get(dtype, None)
    if elem is None:
        elem = {"bfloat16": 2, "float16": 2}.get(dtype, 1)
    hbm_bytes = float(elem) * (m * k + k * n) + 4.0 * m * n  # fp32 out
    vmem_bytes = 3.0 * hbm_bytes                              # staging reuse
    return estimate(
        device, flops=flops, dtype=dtype,
        bytes_by_level={"hbm": hbm_bytes, "vmem": vmem_bytes},
        seconds=seconds,
    )
