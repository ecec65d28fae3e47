"""Hardware device models (counterpart of ``repro.core.device_model``).

The paper (Jarmusch et al., 2025) characterizes GH100 (Hopper, H100
PCIe) and GB203 (Blackwell, RTX 5080) with microbenchmarks and tabulates
execution units (Tab I), caches (Tab II), latencies (Tab III), datatype
support (Tab IV/V) and power (Tab VI/VIII).  ``TPU_V5E``, ``GH100``,
``GB203``, ``HOST_CPU`` and ``REGISTRY`` are the reference's, field for
field; ``GH100`` stays the paper's column to compare against.

:func:`detect_backend_model` returns a model of the part the port runs
on: on a CUDA device it reads ``torch.cuda.get_device_properties``
(name, SM count, L2 size) and picks the part (:data:`H100_SXM` or the
paper's PCIe ``GH100``), and raises for a card it does not know;
``"cpu"`` gives ``HOST_CPU``.  :data:`PAPER_GH100` holds the paper's
measured Hopper figures that the probes reproduce.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch import compat


@dataclasses.dataclass(frozen=True)
class MemoryLevel:
    """One level of the memory hierarchy.

    The paper's Tab II rows (L1/shared, L2, global); ``bandwidth_Bps`` is
    aggregate per chip, ``latency_cycles`` is a load-to-use latency in
    core cycles (the unit the paper reports).
    """

    name: str
    capacity_bytes: int
    bandwidth_Bps: float
    latency_cycles: float
    software_managed: bool = False


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """A characterized (or published) device.

    ``peak_flops`` maps dtype name -> FLOP/s for the *matrix* pipeline
    (tensor core / MXU); ``vector_flops`` is the scalar/vector pipeline.
    """

    name: str
    vendor: str
    kind: str                      # "tpu" | "gpu" | "cpu"
    clock_hz: float
    peak_flops: Dict[str, float]   # matrix pipeline, by dtype name
    vector_flops: Dict[str, float]
    memory: Tuple[MemoryLevel, ...]
    interconnect_Bps: float = 0.0
    link_Bps: float = 0.0
    num_links: int = 0
    matrix_tile: Tuple[int, int] = (0, 0)
    idle_watts: float = 0.0
    peak_watts: float = 0.0

    def level(self, name: str) -> MemoryLevel:
        for lvl in self.memory:
            if lvl.name == name:
                return lvl
        raise KeyError(f"{self.name} has no memory level {name!r}")

    @property
    def hbm(self) -> MemoryLevel:
        """The last (largest, off-core) memory level."""
        return self.memory[-1]

    def peak_flops_for(self, dtype: str) -> float:
        """Matrix-pipeline peak for ``dtype``; falls back to bf16, then
        to the widest supported precision (the paper's QMMA-fallback
        observation)."""
        if dtype in self.peak_flops:
            return self.peak_flops[dtype]
        if "bfloat16" in self.peak_flops:
            return self.peak_flops["bfloat16"]
        return max(self.peak_flops.values())


# ---------------------------------------------------------------------------
# Published target models (the reference's)
# ---------------------------------------------------------------------------

TPU_V5E = DeviceModel(
    name="tpu-v5e",
    vendor="google",
    kind="tpu",
    clock_hz=940e6,
    peak_flops={
        "bfloat16": 197e12,
        "float32": 98.5e12,
        "int8": 394e12,
    },
    vector_flops={"float32": 3.9e12, "int32": 3.9e12, "float64": 0.0},
    memory=(
        MemoryLevel("vreg", 32 * 1024, 0.0, 1.0, software_managed=True),
        MemoryLevel("vmem", 128 * 1024 * 1024, 22.0e12, 20.0,
                    software_managed=True),
        MemoryLevel("hbm", 16 * 1024**3, 819e9, 450.0),
    ),
    interconnect_Bps=200e9,
    link_Bps=50e9,
    num_links=4,
    matrix_tile=(128, 128),
    idle_watts=60.0,
    peak_watts=220.0,
)

# GH100 (H100 PCIe) — the paper's Hopper column (Tab I/II + §VI).
GH100 = DeviceModel(
    name="gh100-h100-pcie",
    vendor="nvidia",
    kind="gpu",
    clock_hz=1.755e9,
    peak_flops={
        "float8_e4m3fn": 1513e12, "float8_e5m2": 1513e12,
        "float16": 756e12, "bfloat16": 756e12,
        "float32": 378e12,          # tf32 tensor core
        "float64": 51e12,           # FP64 tensor core
        "int8": 1513e12,
    },
    vector_flops={"float32": 51.2e12, "int32": 25.6e12, "float64": 25.6e12},
    memory=(
        # Paper Tab II: 256 KB unified L1/shared per SM, 50 MB L2 in 2
        # partitions, 80 GB HBM2e.  Pointer-chase latencies: L1 30-40 cyc,
        # L2 ~273 cyc, global ~658.7 cyc.
        MemoryLevel("l1", 256 * 1024, 128e12, 35.0, software_managed=True),
        MemoryLevel("l2", 50 * 1024**2, 12e12, 273.0),
        MemoryLevel("hbm", 80 * 1024**3, 2000e9, 658.7),
    ),
    interconnect_Bps=64e9,          # PCIe gen5 x16
    link_Bps=64e9,
    num_links=1,
    matrix_tile=(16, 8),            # mma.m16n8k* fragment (per warp)
    idle_watts=45.0,
    peak_watts=350.0,
)

# GB203 (GeForce RTX 5080) — the paper's Blackwell column.
GB203 = DeviceModel(
    name="gb203-rtx5080",
    vendor="nvidia",
    kind="gpu",
    clock_hz=2.617e9,
    peak_flops={
        "float4_e2m1fn": 900e12,
        "float6_e2m3fn": 450e12, "float6_e3m2fn": 450e12,
        "float8_e4m3fn": 450e12, "float8_e5m2": 450e12,
        "float16": 225e12, "bfloat16": 225e12,
        "float32": 112e12,
        "float64": 0.88e12,
        "int8": 450e12,
    },
    vector_flops={"float32": 56e12, "int32": 56e12, "float64": 0.44e12},
    memory=(
        MemoryLevel("l1", 128 * 1024, 96e12, 35.0, software_managed=True),
        MemoryLevel("l2", 65 * 1024**2, 10e12, 358.0),
        MemoryLevel("hbm", 16 * 1024**3, 960e9, 876.7),
    ),
    interconnect_Bps=64e9,
    link_Bps=64e9,
    num_links=1,
    matrix_tile=(16, 8),
    idle_watts=30.0,
    peak_watts=360.0,
)

# Host CPU: nominal constants so downstream paths are total functions.
HOST_CPU = DeviceModel(
    name="host-cpu",
    vendor="generic",
    kind="cpu",
    clock_hz=3.0e9,
    peak_flops={"float32": 200e9, "bfloat16": 200e9, "float64": 100e9},
    vector_flops={"float32": 200e9, "int32": 100e9, "float64": 100e9},
    memory=(
        MemoryLevel("l1", 32 * 1024, 400e9, 4.0),
        MemoryLevel("l2", 1 * 1024**2, 200e9, 14.0),
        MemoryLevel("l3", 32 * 1024**2, 100e9, 50.0),
        MemoryLevel("hbm", 32 * 1024**3, 25e9, 250.0),
    ),
    interconnect_Bps=10e9,
    link_Bps=10e9,
    num_links=1,
    matrix_tile=(8, 8),
    idle_watts=20.0,
    peak_watts=120.0,
)

REGISTRY: Dict[str, DeviceModel] = {
    m.name: m for m in (TPU_V5E, GH100, GB203, HOST_CPU)
}


# ---------------------------------------------------------------------------
# Parts the port runs on (NVIDIA data sheets, dense rates, full power
# limit).  Latencies in cycles are the paper's GH100 pointer-chase
# figures (the same SM and cache design) until a probe measures them.
# ---------------------------------------------------------------------------

def _hopper(name: str, clock_hz: float, sms: int, hbm_Bps: float,
            hbm_bytes: int, bf16: float, nvlink_Bps: float, links: int,
            watts: float) -> DeviceModel:
    # TF32 at half the bf16 rate, the FP64 tensor core at 67 TFLOP/s for
    # 989 bf16 (the SXM data sheet's ratios)
    tf32, fp64_tc = bf16 / 2, 67e12 * bf16 / 989e12
    per_sm_clock = sms * clock_hz
    return DeviceModel(
        name=name, vendor="nvidia", kind="gpu", clock_hz=clock_hz,
        peak_flops={
            "float8_e4m3fn": 2 * bf16, "float8_e5m2": 2 * bf16,
            "float16": bf16, "bfloat16": bf16, "float32": tf32,
            "float64": fp64_tc, "int8": 2 * bf16,
        },
        # 128 FP32, 64 INT32 and 64 FP64 lanes per SM, 2 flops per FMA
        vector_flops={"float32": 256 * per_sm_clock,
                      "int32": 128 * per_sm_clock,
                      "float64": 128 * per_sm_clock},
        memory=(
            MemoryLevel("l1", 256 * 1024, 128 * per_sm_clock, 35.0,
                        software_managed=True),
            MemoryLevel("l2", 50 * 1024**2, 12e12, 273.0),
            MemoryLevel("hbm", hbm_bytes, hbm_Bps, 658.7),
        ),
        interconnect_Bps=nvlink_Bps, link_Bps=nvlink_Bps / max(links, 1),
        num_links=links, matrix_tile=(16, 8), idle_watts=70.0,
        peak_watts=watts)


# H100 SXM5: 132 SMs at 1.98 GHz boost, 80 GB HBM3 at 3.35 TB/s, 989
# TFLOP/s bf16, 18 NVLink links (900 GB/s), 700 W.
H100_SXM = _hopper("h100-sxm5", 1.98e9, 132, 3.35e12, 80 * 1024**3,
                   989e12, 900e9, 18, 700.0)
PARTS: Dict[str, DeviceModel] = {m.name: m for m in (H100_SXM, GH100)}


# The paper's measured Hopper figures (GH100, H100 PCIe at 1.755 GHz,
# HBM2e), in cycles where the paper gives cycles: Tab III as
# (true, completion) per workload; the §IV.A clock64 overhead; the Fig 6
# pointer-chase plateaus; the Fig 4/5 saturation point; the Fig 10
# read/write bandwidth ratio; the Tab IV pipelines.
PAPER_GH100 = {
    "tab3_cycles": {"int32": (4.0, 16.69), "fp32": (4.0, 7.86),
                    "mixed1": (31.62, 16.0), "mixed2": (43.54, 20.0),
                    "fp64": (8.04, 13.0)},
    "clock_overhead_cycles": 2.0,
    "chase_cycles": {"l1": (30.0, 40.0), "l2": 273.0, "hbm": 658.7},
    "saturation": {"ilp": 5, "warps": 29},
    "read_write_ratio": 7.2,
    "tab4_pipeline": {"e2m1": "unsupported", "e2m3": "unsupported",
                      "e3m2": "unsupported", "e4m3": "HMMA",
                      "e5m2": "HMMA"},
}


def get_device_model(name: str) -> DeviceModel:
    try:
        return REGISTRY.get(name) or PARTS[name]
    except KeyError:
        raise KeyError(
            f"unknown device model {name!r}; known: "
            f"{sorted(set(REGISTRY) | set(PARTS))}") from None


def part_for(name: str, sms: int, l2_bytes: int) -> DeviceModel:
    """The model of a CUDA part from its properties: the H100 SXM or the
    paper's PCIe ``GH100``.  Raises for any other card: its peaks would
    be guesses, and the probes' bounds come from them."""
    lname = name.lower()
    if "h100" in lname and "pcie" in lname and sms == 114:
        return GH100
    if "h100" in lname and sms == 132 and l2_bytes == 50 * 2**20 \
            and "nvl" not in lname:
        return H100_SXM
    raise ValueError(
        f"no device model for {name!r} ({sms} SMs, L2 {l2_bytes} B); "
        f"known parts: {sorted(PARTS)}")


def detect_backend_model(device: Union[None, str, torch.device] = None
                         ) -> DeviceModel:
    """The model of the device the port runs on: the card (``None``
    means ``cuda``; raises when there is none) or, for ``"cpu"``,
    ``HOST_CPU``."""
    dev = compat.resolve_device(device)
    if dev.type == "cpu":
        return HOST_CPU
    p = torch.cuda.get_device_properties(dev)
    return part_for(p.name, p.multi_processor_count,
                    getattr(p, "L2_cache_size", 0))


def torch_device(model: DeviceModel, index: Optional[int] = None
                 ) -> torch.device:
    """Where a probe for ``model`` runs: a GPU model on the card, the
    host model on the CPU."""
    if model.kind == "gpu":
        return compat.resolve_device("cuda" if index is None
                                     else f"cuda:{index}")
    if model.kind == "cpu":
        return torch.device("cpu")
    raise ValueError(f"{model.name}: the port runs on a GPU or the host, "
                     f"not a {model.kind}")

