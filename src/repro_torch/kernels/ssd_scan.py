"""Mamba-2 SSD chunked scan (counterpart of
``repro.kernels.ssd_scan.ssd_scan_bhsp`` and its model-layout wrapper
``repro.kernels.ops.ssd_scan``).

The kernel is CUDA C++ (``repro_torch/csrc/ssd_scan.cu``), built for
sm_90a at first use and bound with ctypes (see ``_build``).  It reads
the model layout as the reference's wrapper takes it: x (bt, s, h, p),
dt_a (bt, s, h), b and c (bt, s, n), contiguous.  :func:`plan` reads
shapes, dtypes and addresses only and says how the kernel runs a call:
one block per (row, head, slice of ``pw`` columns of p), its shared
memory, and TMA copies where every row and pointer lies on 16 bytes
(element copies elsewhere).  The C entry point refuses a plan that
disagrees with its own layout.

:func:`ssd_scan` pads s to the chunk with an identity tail (dt_a = 0,
x = 0: decay 1, no input) and dispatches on the device of its tensors:
on the CPU it runs :func:`ssd_scan_plain` (``models.ssm.ssd_chunked``);
on a CUDA device it launches the kernel, or raises.  There is no
fallback from one to the other.  ``ssd_scan.launches`` counts kernel
launches and nothing else; ``ssd_scan_plain.calls`` counts calls of the
plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
             + [ctypes.c_void_p])
MAX_P, MAX_N, MAX_CHUNK = 64, 128, 1024   # csrc/ssd_scan.cu's limits
# csrc/ssd_scan.cu's block: 8 warps, __launch_bounds__(256, 2) (at most
# two an SM), sub-chunks of ROWS rows in STAGES stages, SCALARS floats of
# a sub-chunk's scalars
MAX_BLOCKS_PER_SM, ROWS, STAGES, SCALARS = 2, 64, 2, 3 * 64 + 4
SLICES = (64, 32, 16)                     # the widths of p a block takes
SMS = 132                                 # an H100 SXM
SMEM_LIMIT = 232448                       # bytes a block may use
SM_SMEM = 233472                          # bytes of shared memory an SM has
BLOCK_RESERVED = 1024                     # bytes the runtime keeps a block


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernel runs a call: ``splits`` slices of ``pw`` columns of
    p, one block per (row, head, slice), ``blocks`` in all; ``vec``:
    tiles by TMA (else element copies); ``smem_bytes`` a block,
    ``blocks_per_sm`` resident at once."""
    pw: int
    splits: int
    vec: bool
    smem_bytes: int
    blocks: int
    blocks_per_sm: int


def smem_bytes(pw: int, bc_elt: int, x_elt: int) -> int:
    """``csrc/ssd_scan.cu``'s ``layout``, n padded to MAX_N: STAGES stages
    of TMA boxes of ROWS rows x 128 bytes (B and C across MAX_N columns, x
    across the slice, at least one box), the scalars of each stage, the
    fp32 state slice (rows of MAX_N + 8), the warp pairs' partial sums (8
    warps x pw / 16 tiles of 128 floats), an 8-byte mbarrier a stage, and
    1024 bytes to put the boxes on a 1024-byte boundary."""
    box = ROWS * 128
    stage = 2 * ROWS * MAX_N * bc_elt + -(-pw * x_elt // 128) * box
    return (STAGES * (stage + SCALARS * 4) + pw * (MAX_N + 8) * 4
            + 8 * (pw // 16) * 128 * 4 + STAGES * 8 + 1024)


def slice_shape(pw: int, p: int, bc_elt: int, x_elt: int):
    """(splits, smem bytes, blocks an SM) of slices ``pw`` wide."""
    smem = smem_bytes(pw, bc_elt, x_elt)
    per_sm = min(MAX_BLOCKS_PER_SM, SM_SMEM // (smem + BLOCK_RESERVED))
    return -(-p // pw), smem, per_sm


def ssd_scan_plain(x: torch.Tensor, dt_a: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, chunk: int,
                   initial_state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: ``models.ssm.ssd_chunked``
    on inputs already padded to a multiple of ``chunk``; y at x's
    dtype, the state fp32."""
    # models.ssm imports this module for ssd_scan, so the plain version
    # is looked up at call time
    from repro_torch.models.ssm import ssd_chunked
    ssd_scan_plain.calls += 1
    y, state = ssd_chunked(x, dt_a, b, c, chunk, initial_state)
    return y.to(x.dtype), state


ssd_scan_plain.calls = 0


def check_kernel_inputs(x, dt_a, b, c, chunk, initial_state) -> None:
    """Raise on what the kernel does not take: shapes, its limits,
    dtypes, a non-contiguous tensor, tensors on two devices.  s must
    already be padded to a multiple of ``chunk``."""
    bt, s, h, p = x.shape
    n = b.shape[-1]
    if tuple(dt_a.shape) != (bt, s, h) or tuple(b.shape) != (bt, s, n) \
            or c.shape != b.shape:
        raise ValueError(f"shapes: x {tuple(x.shape)} dt_a "
                         f"{tuple(dt_a.shape)} b {tuple(b.shape)} c "
                         f"{tuple(c.shape)}")
    if initial_state is not None and \
            tuple(initial_state.shape) != (bt, h, p, n):
        raise ValueError(f"initial_state {tuple(initial_state.shape)} is "
                         f"not {(bt, h, p, n)}")
    if p > MAX_P or n > MAX_N or chunk > MAX_CHUNK or s % chunk:
        raise ValueError(f"kernel takes p <= {MAX_P}, n <= {MAX_N}, "
                         f"chunk <= {MAX_CHUNK} dividing s (p={p}, n={n}, "
                         f"chunk={chunk}, s={s})")
    if x.dtype not in _DTYPE_CODE or b.dtype not in _DTYPE_CODE \
            or c.dtype != b.dtype or dt_a.dtype != torch.float32 \
            or (initial_state is not None
                and initial_state.dtype != torch.float32):
        raise TypeError(f"kernel takes x and b / c in float32 or bfloat16 "
                        f"(b and c alike), dt_a and initial_state float32; "
                        f"got x {x.dtype}, dt_a {dt_a.dtype}, b {b.dtype}, "
                        f"c {c.dtype}")
    tensors = [("x", x), ("dt_a", dt_a), ("b", b), ("c", c)]
    if initial_state is not None:
        tensors.append(("initial_state", initial_state))
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous "
                             f"(strides {t.stride()})")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def plan(x: torch.Tensor, dt_a: torch.Tensor, b: torch.Tensor,
         c: torch.Tensor, chunk: int,
         initial_state: Optional[torch.Tensor] = None) -> Plan:
    """Checks a call's inputs (:func:`check_kernel_inputs`) and chooses
    the slice width: of the widths in ``SLICES`` up to the first that
    holds all of p, the widest whose grid has at least ``SMS`` blocks
    with ``MAX_BLOCKS_PER_SM`` resident an SM; else the one with the most
    blocks resident at once (ties to the wider, which repeats C·Bᵀ
    less)."""
    check_kernel_inputs(x, dt_a, b, c, chunk, initial_state)
    bt, _, h, p = x.shape
    n = b.shape[-1]
    bc_elt, x_elt = b.element_size(), x.element_size()
    options = []
    for pw in SLICES:
        if pw > SLICES[-1] and pw // 2 >= p:
            continue              # a narrower slice already holds all of p
        splits, smem, per_sm = slice_shape(pw, p, bc_elt, x_elt)
        if smem <= SMEM_LIMIT:
            options.append((pw, splits, smem, per_sm, bt * h * splits))
    full = [o for o in options
            if o[3] >= MAX_BLOCKS_PER_SM and o[4] >= SMS]
    pw, splits, smem, per_sm, blocks = (
        full[0] if full else max(options,
                                 key=lambda o: min(o[4], o[3] * SMS)))
    if blocks > 2 ** 31 - 1:
        raise ValueError(f"kernel takes at most 2^31 - 1 blocks (bt={bt}, "
                         f"h={h}, {splits} slices of p)")
    vec = (all(t.data_ptr() % 16 == 0 for t in (x, b, c))
           and p * x_elt % 16 == 0 and n * bc_elt % 16 == 0)
    return Plan(pw, splits, vec, smem, blocks, per_sm)


def _kernel(x, dt_a, b, c, chunk, initial_state):
    pl = plan(x, dt_a, b, c, chunk, initial_state)
    bt, s, h, p = x.shape
    n = b.shape[-1]
    lib = _build.load("ssd_scan")
    fn = lib.repro_ssd_scan
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    y = torch.empty_like(x)
    state = torch.empty((bt, h, p, n), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPE_CODE[x.dtype], _DTYPE_CODE[b.dtype],
                 x.data_ptr(), dt_a.data_ptr(), b.data_ptr(), c.data_ptr(),
                 0 if initial_state is None else initial_state.data_ptr(),
                 y.data_ptr(), state.data_ptr(), bt, s, h, p, n, chunk,
                 pl.pw, pl.splits, int(pl.vec), pl.smem_bytes,
                 stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error "
                           f"{err}")
    ssd_scan.launches += 1
    return y, state


def ssd_scan(x: torch.Tensor, dt_a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, chunk: int = 256,
             initial_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model-layout SSD: x (bt, s, h, p) pre-discretized (x * dt), dt_a
    (bt, s, h), b / c (bt, s, n); ``initial_state`` (bt, h, p, n) fp32
    seeds the scan (zeros when omitted).  s is padded to the chunk with
    an identity tail.  Returns (y (bt, s, h, p) at x's dtype,
    final_state (bt, h, p, n) fp32).  CPU tensors take the plain
    version (differentiable: plain torch ops); CUDA tensors launch the
    kernel, which has no backward: with grad enabled and a CUDA input
    that requires it, this raises."""
    s = x.shape[1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt_a = F.pad(dt_a, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    if x.device.type != "cpu" and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt_a, b, c, initial_state)):
        raise NotImplementedError(
            "ssd_scan has no backward kernel yet (ROADMAP: the next "
            "training slice): its CUDA kernel's output carries no "
            "gradient, so a card input that requires grad is refused")
    if x.device.type == "cpu":
        y, state = ssd_scan_plain(x, dt_a, b, c, chunk, initial_state)
    elif x.device.type == "cuda":
        y, state = _kernel(x, dt_a, b, c, chunk, initial_state)
    else:
        raise ValueError(f"ssd_scan runs on 'cuda' (kernel) or 'cpu' "
                         f"(plain version), not {x.device}")
    return (y[:, :s] if pad else y), state


ssd_scan.launches = 0
