"""Matrix-unit probes — paper §V (Fig 4/5) and §VII.A (Fig 11, Tab VII);
counterpart of ``repro.core.probes.matmul``.

The paper sweeps ``mma`` tile shapes, precisions and (warp count x ILP)
to find the tensor-core saturation point.  :func:`measure_matmul` runs
its ``batch x ilp`` independent products through the ``mma_probe``
kernel (``repro_torch.kernels.probe_mma``: ``mma.sync``, each warp
holding ``ilp`` accumulator fragments, warps across blocks the warp
count), then sums them, as ``_mm_ilp`` does; on the CPU the products are
the plain fp32 matmul.  The tile's alignment is judged against the
device model's ``matrix_tile`` (the 16 x 8 mma fragment on the card).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch import compat
from repro_torch.core import timing
from repro_torch.core.device_model import (DeviceModel, detect_backend_model,
                                           torch_device)
from repro_torch.kernels.probe_mma import mma_products


@dataclasses.dataclass(frozen=True)
class MatmulPoint:
    m: int
    n: int
    k: int
    dtype: str
    batch: int                 # "warp count" analogue (parallel tiles)
    ilp: int                   # independent chains per dispatch
    runtime_ms: float
    tflops: float              # (2*M*N*K*batch*ilp)/runtime — paper Eq. 2
    aligned: bool              # all dims multiples of the matrix tile


def _aligned(m: int, n: int, k: int, tile: int) -> bool:
    return m % tile == 0 and n % tile == 0 and k % tile == 0


def _mm_ilp(a: torch.Tensor, b: torch.Tensor, ilp: int) -> torch.Tensor:
    """``ilp`` independent matmul chains over batched operands.

    a: (batch, ilp, m, k), b: (batch, ilp, k, n).  Each (batch, ilp) cell
    is an independent fp32-accumulated product; the sum forces completion
    of all of them.  -> (batch,) fp32.  Dimensions off the kernel's
    fragment (m % 16, n % 8, k % 16) are zero-padded first, which leaves
    the sum as it is.
    """
    assert a.shape[1] == ilp, (a.shape, ilp)
    m, k = a.shape[2:]
    n = b.shape[3]
    pm, pn, pk = (-m) % 16, (-n) % 8, (-k) % 16
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = F.pad(b, (0, pn, 0, pk))
    return mma_products(a, b).sum(dim=(1, 2, 3))


def measure_matmul(
    m: int, n: int, k: int,
    dtype: str = "bfloat16",
    batch: int = 1,
    ilp: int = 1,
    device: DeviceModel | None = None,
    iters: int = 10,
) -> MatmulPoint:
    device = device or detect_backend_model()
    dev = torch_device(device)
    dt = compat.resolve_dtype(dtype)
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((batch, ilp, m, k), generator=g, device=dev).to(dt)
    b = torch.randn((batch, ilp, k, n), generator=g, device=dev).to(dt)
    t = timing.time_fn(_mm_ilp, a, b, ilp, iters=iters)
    flops = 2.0 * m * n * k * batch * ilp
    return MatmulPoint(
        m=m, n=n, k=k, dtype=dtype, batch=batch, ilp=ilp,
        runtime_ms=t.median_s * 1e3,
        tflops=flops / t.median_s / 1e12,
        aligned=_aligned(m, n, k, device.matrix_tile[0] or 128),
    )


def tile_sweep(
    dtype: str = "bfloat16",
    shapes: Optional[Sequence[tuple]] = None,
    device: DeviceModel | None = None,
    iters: int = 10,
) -> List[MatmulPoint]:
    """§V.B analogue: aligned vs misaligned tile shapes.

    Misaligned shapes are zero-padded to the mma fragment inside the timed
    region (``_mm_ilp``), as the reference's compiler pads them to the
    MXU tile: a TFLOP/s drop at near-identical nominal FLOPs.
    """
    if shapes is None:
        shapes = [
            (128, 128, 128), (256, 256, 256), (512, 512, 512),
            (1024, 1024, 1024),
            # misaligned: +/-1 off the 128 tile and odd fractions
            (127, 127, 127), (129, 129, 129), (96, 96, 96),
            (384, 384, 100), (1000, 1000, 1000),
        ]
    return [measure_matmul(m, n, k, dtype, device=device, iters=iters)
            for (m, n, k) in shapes]


def warp_ilp_sweep(
    dtype: str = "bfloat16",
    batches: Sequence[int] = (1, 2, 4, 8, 16, 32),
    ilps: Sequence[int] = (1, 2, 4, 6, 8),
    m: int = 128, n: int = 128, k: int = 128,
    device: DeviceModel | None = None,
    iters: int = 8,
) -> List[MatmulPoint]:
    """Fig 4/5 analogue: throughput/latency vs (parallel tiles x ILP).

    The paper finds GB203 saturates at ILP=6 with 25 warps and GH100 at
    ILP=5 with 29 warps; here the saturation point is where TFLOP/s stops
    growing with ``batch`` or ``ilp``.
    """
    device = device or detect_backend_model()
    out = []
    for b in batches:
        for i in ilps:
            out.append(measure_matmul(m, n, k, dtype, batch=b, ilp=i,
                                      device=device, iters=iters))
    return out


def saturation_point(points: Sequence[MatmulPoint],
                     tol: float = 0.05) -> MatmulPoint:
    """First point achieving within ``tol`` of the sweep's peak TFLOP/s —
    the paper's "maximum ILP level at which sustained throughput is
    achieved"."""
    peak = max(p.tflops for p in points)
    for p in sorted(points, key=lambda p: (p.batch, p.ilp)):
        if p.tflops >= (1 - tol) * peak:
            return p
    return points[-1]


def gemm_case_study(
    dtype: str = "bfloat16",
    sizes: Sequence[tuple] = (
        (512, 512, 512),
        (1024, 1024, 1024),
        (2048, 2048, 2048),
        (2048, 2048, 4096),
        (2048, 4096, 8192),
        (4096, 4096, 4096),
    ),
    device: DeviceModel | None = None,
    iters: int = 5,
) -> List[MatmulPoint]:
    """§VII.A (Fig 11, Tab VII): D-GEMM runtime/TFLOPs across sizes."""
    return [measure_matmul(m, n, k, dtype, device=device, iters=iters)
            for (m, n, k) in sizes]
