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

Training: with grad enabled and an input that requires it,
:func:`ssd_scan` runs through :class:`SsdScanFn` (the padding stays
outside it), whose forward also returns the state entering each chunk
(the kernel stores it when given a ``states`` buffer; the plain version
returns ``ssd_chunked``'s ``prev_states``) and whose backward is
:func:`ssd_scan_bwd` from the saved x, dt_a, b, c and states: on the
CPU :func:`ssd_scan_bwd_plain` (the explicit formulas, chunk by chunk,
in fp32), on a CUDA device the hand-written kernel
``csrc/ssd_scan_bwd.cu`` (the reference differentiates its XLA
``ssd_chunked``; its Pallas kernel has no backward), which raises
without the states.  :func:`bwd_plan` is its launch plan.
``ssd_scan_bwd.launches`` counts backward calls that launched the
kernel's passes; ``ssd_scan_bwd_plain.calls`` calls of the plain
version.  With grad disabled nothing changes: the forward stores no
states and builds no autograd node.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import compat
from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
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
                   initial_state: Optional[torch.Tensor] = None,
                   states: bool = False):
    """The kernel's function in plain PyTorch: ``models.ssm.ssd_chunked``
    on inputs already padded to a multiple of ``chunk``; y at x's
    dtype, the state fp32; with ``states`` also the state entering each
    chunk, (bt, s / chunk, h, p, n) fp32."""
    # models.ssm imports this module for ssd_scan, so the plain version
    # is looked up at call time
    from repro_torch.models.ssm import ssd_chunked
    ssd_scan_plain.calls += 1
    out = ssd_chunked(x, dt_a, b, c, chunk, initial_state,
                      return_states=states)
    return (out[0].to(x.dtype),) + tuple(out[1:])


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


def _kernel(x, dt_a, b, c, chunk, initial_state, states=False):
    pl = plan(x, dt_a, b, c, chunk, initial_state)
    bt, s, h, p = x.shape
    n = b.shape[-1]
    lib = _build.load("ssd_scan")
    fn = lib.repro_ssd_scan
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    y = torch.empty_like(x)
    state = torch.empty((bt, h, p, n), dtype=torch.float32, device=x.device)
    entering = (torch.empty((bt, s // chunk, h, p, n), dtype=torch.float32,
                            device=x.device) if states else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPE_CODE[x.dtype], _DTYPE_CODE[b.dtype],
                 x.data_ptr(), dt_a.data_ptr(), b.data_ptr(), c.data_ptr(),
                 0 if initial_state is None else initial_state.data_ptr(),
                 y.data_ptr(), state.data_ptr(),
                 0 if entering is None else entering.data_ptr(),
                 bt, s, h, p, n, chunk, pl.pw, pl.splits, int(pl.vec),
                 pl.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error "
                           f"{err}")
    ssd_scan.launches += 1
    return (y, state, entering) if states else (y, state)


def _forward(x, dt_a, b, c, chunk, initial_state, states=False):
    """(y, final state), with ``states`` also the entering states: on the
    CPU the plain version, on a CUDA device one kernel launch."""
    extra = {"states": True} if states else {}
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt_a, b, c, chunk, initial_state, **extra)
    if x.device.type == "cuda":
        return _kernel(x, dt_a, b, c, chunk, initial_state, **extra)
    raise ValueError(f"ssd_scan runs on 'cuda' (kernel) or 'cpu' (plain "
                     f"version), not {x.device}")


def ssd_scan_states(x: torch.Tensor, dt_a: torch.Tensor, b: torch.Tensor,
                    c: torch.Tensor, chunk: int,
                    initial_state: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y, final state, entering states) of inputs already padded to a
    multiple of ``chunk``: training's forward, the call whose states
    :func:`ssd_scan_bwd` reads.  CUDA tensors: one kernel launch that
    also stores each chunk's entering state (bt, s / chunk, h, p, n)
    fp32; CPU tensors: the plain version.  Not differentiable (training
    goes through :class:`SsdScanFn`, whose forward this is)."""
    return _forward(x, dt_a, b, c, chunk, initial_state, states=True)


# ---- the backward ------------------------------------------------------ #

def ssd_scan_bwd_plain(x: torch.Tensor, dt_a: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, states: torch.Tensor,
                       dy: torch.Tensor,
                       dfinal: Optional[torch.Tensor] = None,
                       chunk: int = 256):
    """The backward kernel's function in plain PyTorch: the gradients of
    :func:`ssd_scan_plain` (inputs padded to a multiple of ``chunk``)
    from its inputs, the state entering each chunk ``states`` (bt, s /
    chunk, h, p, n), the output's gradient ``dy`` and the final state's
    ``dfinal`` (zeros when omitted), by the explicit formulas of
    ``csrc/ssd_scan_bwd.cu``'s header, chunk by chunk in reverse, in
    fp32 (no autograd).  Returns (dx at x's dtype, d dt_a fp32, db and
    dc at b's dtype, the initial state's gradient fp32)."""
    ssd_scan_bwd_plain.calls += 1
    bt, s, h, p = x.shape
    n = b.shape[-1]
    nc = s // chunk
    f32 = torch.float32
    xs = x.to(f32).reshape(bt, nc, chunk, h, p)
    dys = dy.to(f32).reshape(bt, nc, chunk, h, p)
    bm = b.to(f32).reshape(bt, nc, chunk, n)
    cm = c.to(f32).reshape(bt, nc, chunk, n)
    acs = torch.cumsum(dt_a.to(f32).reshape(bt, nc, chunk, h)
                       .permute(0, 3, 1, 2), -1,
                       dtype=torch.float64).to(f32)      # (bt, h, nc, q)
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()
    ds = (torch.zeros((bt, h, p, n), dtype=f32, device=x.device)
          if dfinal is None else dfinal.to(f32))
    dx, da = torch.empty_like(xs), torch.empty_like(acs)
    db, dc = torch.empty_like(bm), torch.empty_like(cm)
    for ci in reversed(range(nc)):
        xc, dyc, bc, cc = xs[:, ci], dys[:, ci], bm[:, ci], cm[:, ci]
        a = acs[:, :, ci]                                # (bt, h, q)
        st = states[:, ci].to(f32)                       # (bt, h, p, n)
        a_last = a[..., -1]
        # selected, never multiplied by the mask: above the diagonal the
        # exponent is positive and can overflow
        el = torch.where(mask, torch.exp(a[..., :, None] - a[..., None, :]),
                         torch.zeros((), dtype=f32, device=x.device))
        g = torch.einsum("bln,bsn->bls", cc, bc)[:, None] * el
        m = torch.einsum("blhp,bshp->bhls", dyc, xc)
        ml = m * el
        w = torch.exp(a_last[..., None] - a)             # (bt, h, q)
        e = torch.exp(a)
        u = (torch.einsum("bhpn,bsn->bshp", ds, bc)
             * w.permute(0, 2, 1)[..., None])            # w_s dS' b_s
        dx[:, ci] = torch.einsum("bhls,blhp->bshp", g, dyc) + u
        sty = (torch.einsum("bhpn,blhp->bhln", st, dyc)
               * e[..., None])                           # e_l Sᵀ dy_l
        dc[:, ci] = torch.einsum("bhls,bsn->bln", ml, bc) + sty.sum(1)
        db[:, ci] = (torch.einsum("bhls,bln->bsn", ml, cc)
                     + torch.einsum("bhs,bhpn,bshp->bsn", w, ds, xc))
        wm = m * g
        v = (xc * u).sum(-1).permute(0, 2, 1)            # (bt, h, q)
        d = (wm.sum(-1) - wm.sum(-2)
             + (sty * cc[:, None]).sum(-1) - v)
        d[..., -1] += v.sum(-1) + torch.exp(a_last) * (ds * st).sum((-2, -1))
        da[:, :, ci] = d
        ds = (torch.exp(a_last)[..., None, None] * ds
              + torch.einsum("bhl,blhp,bln->bhpn", e, dyc, cc))
    ddt = torch.flip(torch.cumsum(torch.flip(da, (-1,)), -1,
                                  dtype=torch.float64), (-1,)).to(f32)
    return (dx.reshape(bt, s, h, p).to(x.dtype),
            ddt.permute(0, 2, 3, 1).reshape(bt, s, h),
            db.reshape(bt, s, n).to(b.dtype),
            dc.reshape(bt, s, n).to(c.dtype), ds)


ssd_scan_bwd_plain.calls = 0

BWD_TILE = 64                 # csrc/ssd_scan_bwd.cu's kT
_BWD_PLAN_MISMATCH = 1000     # its kPlanMismatch
_BWD_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 13
                 + [ctypes.c_int] * 6
                 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                    ctypes.c_void_p])


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How ``csrc/ssd_scan_bwd.cu`` runs a call: ``tiles`` tiles of
    ``tile`` positions a chunk; the quadratic passes (rows, cols) run one
    block per (row, chunk, tile, group of ``heads_per_group`` heads),
    ``quad_blocks`` in all, ``groups`` partial sums of db / dc; ``nj``
    16-column groups of n a thread takes; each pass's shared memory; the
    fp32 scratch; the cb pass's blocks (row, chunk, tile, tile) and the
    sweep's (row, head).  The kernel refuses a plan that is not its own
    layout."""
    tile: int
    tiles: int
    heads_per_group: int
    groups: int
    nj: int
    quad_blocks: int
    cb_smem: int
    sweep_smem: int
    rows_smem: int
    cols_smem: int
    scratch_floats: int
    cb_blocks: int
    sweep_blocks: int

    def launch_args(self) -> Tuple[int, ...]:
        """The fields in the order of the ``.cu``'s ``own`` plan."""
        return tuple(getattr(self, f.name)
                     for f in dataclasses.fields(self))


def bwd_smem(nj: int) -> dict:
    """``csrc/ssd_scan_bwd.cu``'s ``smem_of``: bytes of each pass's shared
    memory with n in ``nj`` groups of 16 columns (fp32 tiles of 64 rows
    with odd row strides: 65 for 64 columns, 16 nj + 1 for n)."""
    t64, tn = BWD_TILE * (BWD_TILE + 1), BWD_TILE * (16 * nj + 1)
    return {"cb": 2 * BWD_TILE * (16 * 8 + 1) * 4,
            "sweep": (t64 + tn + 8) * 4,
            "rows": (3 * t64 + tn + 2 * BWD_TILE) * 4,
            "cols": (4 * t64 + tn + 2 * BWD_TILE) * 4}


def check_bwd_inputs(x, dt_a, b, c, states, dy, dfinal, chunk) -> None:
    """Raise on what the backward kernel does not take: the forward's
    checks (:func:`check_kernel_inputs`), then ``states`` (bt, s / chunk,
    h, p, n) fp32, ``dy`` like x, ``dfinal`` (bt, h, p, n) fp32 or None,
    each contiguous and on x's device."""
    check_kernel_inputs(x, dt_a, b, c, chunk, None)
    bt, s, h, p = x.shape
    n = b.shape[-1]
    if states is None:
        raise ValueError("ssd_scan_bwd needs the states the forward stored "
                         "(ssd_scan_states); it runs no forward itself")
    want = {"states": (states, (bt, s // chunk, h, p, n), torch.float32),
            "dy": (dy, tuple(x.shape), x.dtype)}
    if dfinal is not None:
        want["dfinal"] = (dfinal, (bt, h, p, n), torch.float32)
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, expected "
                             f"{shape} {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (strides "
                             f"{t.stride()})")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def bwd_plan(x: torch.Tensor, dt_a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, states: torch.Tensor, dy: torch.Tensor,
             dfinal: Optional[torch.Tensor], chunk: int,
             sm_count: int = SMS) -> BwdPlan:
    """Checks a backward call's inputs (:func:`check_bwd_inputs`) and
    returns how the kernel runs it on a card of ``sm_count`` SMs: the
    heads of a (row, chunk, tile) block go in the fewest groups that give
    the quadratic passes two blocks an SM, at most so many that the
    groups' partial db / dc (2 groups bt s n floats) stay within the
    states' size.  Reads shapes, dtypes and addresses only, on any
    device."""
    check_bwd_inputs(x, dt_a, b, c, states, dy, dfinal, chunk)
    bt, s, h, p = x.shape
    n = b.shape[-1]
    nc, tiles = s // chunk, -(-chunk // BWD_TILE)
    nj = next(j for j in (1, 2, 4, 8) if n <= 16 * j)
    base = bt * nc * tiles
    want = -(-2 * sm_count // base) if base else 1
    cap = max(1, h * p // (2 * chunk))
    hpg = -(-h // max(1, min(h, want, cap)))
    groups = -(-h // hpg)
    quad = base * groups
    if quad > 2 ** 31 - 1 or bt * nc > 2 ** 31 - 1:
        raise ValueError(f"backward kernel takes at most 2^31 - 1 blocks a "
                         f"launch (bt={bt}, s={s}, chunk={chunk}, "
                         f"{groups} groups of heads)")
    sm = bwd_smem(nj)
    scratch = (4 * bt * s * h + 2 * bt * s * chunk + nc * bt * h * p * n
               + bt * h * nc + 2 * groups * bt * s * n)
    return BwdPlan(tile=BWD_TILE, tiles=tiles, heads_per_group=hpg,
                   groups=groups, nj=nj, quad_blocks=quad,
                   cb_smem=sm["cb"], sweep_smem=sm["sweep"],
                   rows_smem=sm["rows"], cols_smem=sm["cols"],
                   scratch_floats=scratch, cb_blocks=bt * nc * tiles * tiles,
                   sweep_blocks=bt * h)


def _bwd_kernel(x, dt_a, b, c, states, dy, dfinal, chunk):
    lib = _build.load("ssd_scan_bwd")
    pl = bwd_plan(x, dt_a, b, c, states, dy, dfinal, chunk,
                  compat.sm_count(x.device.index))
    bt, s, h, p = x.shape
    n = b.shape[-1]
    fn = lib.repro_ssd_scan_bwd
    fn.argtypes, fn.restype = _BWD_ARGTYPES, ctypes.c_int
    dx = torch.empty_like(x)
    ddt = torch.empty_like(dt_a)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    dh0 = torch.empty((bt, h, p, n), dtype=torch.float32, device=x.device)
    scratch = torch.empty(pl.scratch_floats, dtype=torch.float32,
                          device=x.device)
    launch = pl.launch_args()
    launch = (ctypes.c_longlong * len(launch))(*launch)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPE_CODE[x.dtype], _DTYPE_CODE[b.dtype], x.data_ptr(),
                 dt_a.data_ptr(), b.data_ptr(), c.data_ptr(),
                 states.data_ptr(), dy.data_ptr(),
                 0 if dfinal is None else dfinal.data_ptr(), dx.data_ptr(),
                 ddt.data_ptr(), db.data_ptr(), dc.data_ptr(),
                 dh0.data_ptr(), scratch.data_ptr(), bt, s, h, p, n, chunk,
                 launch, len(pl.launch_args()), stream)
    if err == _BWD_PLAN_MISMATCH:
        raise RuntimeError(f"ssd_scan_bwd: the kernel refused the plan {pl} "
                           f"as not its own layout (csrc/ssd_scan_bwd.cu)")
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd kernel launch failed: CUDA error "
                           f"{err}")
    ssd_scan_bwd.launches += 1
    return dx, ddt, db, dc, dh0


def ssd_scan_bwd(x: torch.Tensor, dt_a: torch.Tensor, b: torch.Tensor,
                 c: torch.Tensor, states: Optional[torch.Tensor],
                 dy: torch.Tensor, dfinal: Optional[torch.Tensor] = None,
                 chunk: int = 256):
    """(dx, d dt_a, db, dc, d initial_state) of :func:`ssd_scan_states`
    (inputs padded to a multiple of ``chunk``) from its inputs, the
    states it returned, the output's gradient ``dy`` (x's dtype) and the
    final state's ``dfinal`` (fp32; zeros when None); each gradient at
    its input's dtype, the initial state's fp32.  CPU tensors take
    :func:`ssd_scan_bwd_plain`; CUDA tensors launch the kernel.  Both
    need ``states`` and raise without it."""
    if states is None:
        raise ValueError("ssd_scan_bwd needs the states the forward stored "
                         "(ssd_scan_states); it runs no forward itself")
    if x.device.type == "cpu":
        return ssd_scan_bwd_plain(x, dt_a, b, c, states, dy, dfinal, chunk)
    if x.device.type == "cuda":
        return _bwd_kernel(x, dt_a, b, c, states, dy, dfinal, chunk)
    raise ValueError(f"ssd_scan_bwd runs on 'cuda' (kernel) or 'cpu' "
                     f"(plain version), not {x.device}")


ssd_scan_bwd.launches = 0


class SsdScanFn(torch.autograd.Function):
    """:func:`ssd_scan` on inputs padded to the chunk, differentiable in
    x, dt_a, b, c and the initial state: the forward is
    :func:`ssd_scan_states`, and :func:`ssd_scan_bwd` runs from the
    saved inputs and states."""

    @staticmethod
    def forward(ctx, x, dt_a, b, c, initial_state, chunk):
        y, state, states = ssd_scan_states(x, dt_a, b, c, chunk,
                                           initial_state)
        ctx.save_for_backward(x, dt_a, b, c, states)
        ctx.chunk, ctx.has_initial = chunk, initial_state is not None
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt_a, b, c, states = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        dx, ddt, db, dc, dh0 = ssd_scan_bwd(
            x, dt_a, b, c, states, dy,
            None if dfinal is None else dfinal.contiguous(), ctx.chunk)
        return dx, ddt, db, dc, (dh0 if ctx.has_initial else None), None


def ssd_scan(x: torch.Tensor, dt_a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, chunk: int = 256,
             initial_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model-layout SSD: x (bt, s, h, p) pre-discretized (x * dt), dt_a
    (bt, s, h), b / c (bt, s, n); ``initial_state`` (bt, h, p, n) fp32
    seeds the scan (zeros when omitted).  s is padded to the chunk with
    an identity tail.  Returns (y (bt, s, h, p) at x's dtype,
    final_state (bt, h, p, n) fp32).  CPU tensors take the plain
    version; CUDA tensors launch the kernel.  With grad enabled and an
    input that requires it, the result is differentiable
    (:class:`SsdScanFn`, the padding outside it)."""
    s = x.shape[1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt_a = F.pad(dt_a, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt_a, b, c, initial_state)):
        y, state = SsdScanFn.apply(x, dt_a, b, c, initial_state, chunk)
    else:
        y, state = _forward(x, dt_a, b, c, chunk, initial_state)
    return (y[:, :s] if pad else y), state


ssd_scan.launches = 0
