"""Flash attention over a whole sequence (counterpart of
``repro.kernels.flash_attention.flash_attention_bhsd`` and its
model-layout wrapper ``repro.kernels.ops.flash_attention``).

The kernel is CUDA C++ (``repro_torch/csrc/flash_attention.cu``), built
for sm_90a at first use and bound with ctypes (see ``_build``).  It reads
the model layout q (b, sq, hq, d), k / v (b, skv, hkv, d) through their
strides and masks ragged sq and skv itself: no transposed or padded
copies.  bf16 runs on the tensor cores (``wgmma``, fp32 accumulation,
K/V tiles brought by TMA over the model layout: 128 query rows a
block), fp32 on the CUDA cores in fp32 (64 rows a block).  :func:`plan`
checks a call's inputs and returns its launch (tiles, stages, grid,
shared memory, the order of the q tiles); it reads shapes, dtypes,
strides and addresses only, so the CPU tests reach it.

:func:`flash_attention` dispatches on the device of its tensors: on the
CPU it runs :func:`flash_attention_plain` (``models.attention.attention``,
the reference's XLA dispatch: full attention up to ``chunk`` keys,
online softmax over KV chunks beyond; full attention at the query
positions when ``q_offset`` is set); on a CUDA device it launches the
kernel, or raises.  There is no fallback from one to the other.
``flash_attention.launches`` counts kernel launches and nothing else;
``flash_attention_plain.calls`` counts calls of the plain version.

A row with no visible key (possible only with ``q_offset`` or a window)
comes out as zeros from the kernel and as the mean of V from the plain
version, as in the reference's Pallas kernel and XLA path; the model
never produces such a row (causal rows always see themselves).

Training: with grad enabled and an input that requires it,
:func:`flash_attention` runs through :class:`FlashAttentionFn`, whose
forward is :func:`flash_attention_lse` (the same dispatch; the kernel
also stores each row's log-sum-exp, the plain version computes it with
:func:`attention_lse_plain`) and whose backward is
:func:`flash_attention_bwd` from the saved q, k, v, output and LSE: on
the CPU :func:`flash_attention_bwd_plain` (the explicit formulas in
fp32), on a CUDA device the hand-written kernel
``csrc/flash_attention_bwd.cu`` (the reference differentiates its XLA
``attention()``; there is no Pallas backward), which reads the forward's
LSE and raises without it.  :func:`bwd_plan` is its launch plan (tiles,
stages, shared memory, the q-head split, the grids).  A ``q_offset``
with a gradient raises.  ``flash_attention_bwd.launches`` counts
backward calls that launched the kernel's passes.  With grad disabled
nothing changes: the forward runs as before, storing no LSE, with no
autograd node.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch import compat
from repro_torch.kernels import _build
from repro_torch.models.attention import NEG_INF, attention, full_attention

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VEC = {torch.float32: 4, torch.bfloat16: 8}    # elements per 16 bytes
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 12
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])
MAX_D = 256                                     # csrc/flash_attention.cu
SMEM_LIMIT = 232448                     # bytes a block may use on an H100
# K and V bytes of the (b, head) pairs whose q tiles the bf16 grid runs
# together: a third of the H100's 50 MB L2, so a head's K/V tiles stay
# there while its q tiles read them
GROUP_KV_BYTES = 16 << 20


@dataclasses.dataclass(frozen=True)
class Plan:
    """How the kernel runs a call (``csrc/flash_attention.cu``): ``rows``
    query rows a block, K/V tiles of ``bk`` keys in a ring of ``stages``,
    head_dim padded to ``d_pad``; ``blocks`` blocks over ``pairs`` (batch
    row, q head) pairs x ``q_tiles`` tiles of queries, issued as
    :meth:`block` says."""
    d_pad: int
    rows: int
    bk: int
    stages: int
    threads: int
    smem_bytes: int
    pairs: int = 0
    q_tiles: int = 0
    head_group: int = 1

    @property
    def blocks(self) -> int:
        return self.pairs * self.q_tiles

    def block(self, i: int) -> Tuple[int, int]:
        """(b * hq + head, q tile) of the i-th block: pairs in groups of
        ``head_group``, every q tile of a group (heaviest, the last,
        first) before the next group."""
        group, rank = divmod(i, self.head_group * self.q_tiles)
        in_group = min(self.head_group, self.pairs - group * self.head_group)
        return (group * self.head_group + rank % in_group,
                self.q_tiles - 1 - rank // in_group)


def tile_shape(dtype: torch.dtype, d: int) -> Plan:
    """The kernel's tile for ``dtype`` at head_dim ``d`` (no grid yet).
    bf16: 128 rows, two consumer warpgroups and a producer; K/V tiles of
    128 keys (64 at d 256), 2 stages; shared memory 1024-aligned q, K and
    V tiles, 9 mbarriers, 1024 bytes of alignment slack.  fp32: 64 rows,
    256 threads, 64-key tiles of transposed rows of 68 floats."""
    d_pad = 64 if d <= 64 else 128 if d <= 128 else 256
    if dtype == torch.bfloat16:
        bk, stages = (64 if d_pad == 256 else 128), 2
        smem = 128 * d_pad * 2 + 2 * stages * bk * d_pad * 2 \
            + (1 + 4 * stages) * 8 + 1024
        return Plan(d_pad, 128, bk, stages, 384, smem)
    return Plan(d_pad, 64, 64, 1, 256, 4 * 68 * (2 * d_pad + 64))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          softcap: Optional[float] = None,
                          scale: Optional[float] = None, q_offset: int = 0,
                          chunk: int = 1024) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the reference's
    ``attention()`` dispatch (fp32 scores masked to -1e30, ``p`` cast to
    v's dtype before PV), chunked over ``chunk`` keys when skv is
    longer; with a ``q_offset``, ``full_attention`` at those query
    positions (the reference's dispatch places queries at 0)."""
    flash_attention_plain.calls += 1
    if q_offset:
        return full_attention(
            q, k, v, causal=causal, window=window, softcap=softcap,
            scale=scale,
            q_positions=q_offset + torch.arange(q.shape[1], device=q.device))
    return attention(q, k, v, causal=causal, window=window, softcap=softcap,
                     scale=scale, chunk=chunk)


flash_attention_plain.calls = 0


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: Optional[int], q_offset: int) -> None:
    """Raise on what the kernel does not take: shapes, head_dim above
    ``MAX_D`` or not a multiple of 16 bytes, dtypes, a head_dim that is
    not the unit-stride axis, strides or pointers off 16 bytes, tensors
    on two devices, a window below 1 or a negative ``q_offset``."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"shapes: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or hkv < 1 or hq % hkv:
        raise ValueError(f"shapes: q {tuple(q.shape)} k {tuple(k.shape)}: "
                         f"batch and head_dim must agree, hq % hkv == 0")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"kernel takes q, k, v all float32 or all "
                        f"bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    vec = _VEC[q.dtype]
    if d > MAX_D or d % vec:
        raise ValueError(f"kernel takes head_dim <= {MAX_D}, a multiple of "
                         f"{vec} for {q.dtype} (got {d})")
    if window is not None and window < 1 or q_offset < 0:
        raise ValueError(f"window must be >= 1 and q_offset >= 0 (window="
                         f"{window}, q_offset={q_offset})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: head_dim must be the unit-stride "
                             f"axis (strides {t.stride()})")
        if any(s % vec for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: strides {t.stride()} and the data "
                             f"pointer must be multiples of 16 bytes")
        if q.dtype == torch.bfloat16 and any(
                s <= 0 for s, n in zip(t.stride()[:3], t.shape[:3])
                if n > 1):
            raise ValueError(f"{name}: TMA reads bf16 tiles through "
                             f"positive strides; got strides {t.stride()} "
                             f"for shape {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         window: Optional[int], q_offset: int) -> Plan:
    """Checks a call's inputs (:func:`check_kernel_inputs`) and returns how
    the kernel runs it: one block per (batch row, q head, tile of
    ``rows`` queries), the tiles of a (batch row, head) issued from the
    last (the causal tail, with the most K/V tiles) to the first.  bf16
    takes the pairs in groups whose K and V come to about
    ``GROUP_KV_BYTES`` (a whole number of GQA groups); fp32 in one group
    (its grid is (b * hq, q tiles))."""
    check_kernel_inputs(q, k, v, window, q_offset)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    shape = tile_shape(q.dtype, d)
    n_qt = -(-sq // shape.rows)
    if -(-sq // 64) > 65535 or b * hq * n_qt > 2 ** 31 - 1:
        raise ValueError(f"kernel takes at most 65535 q tiles of 64 rows "
                         f"and 2^31 - 1 blocks (b={b}, sq={sq}, hq={hq})")
    if q.dtype == torch.bfloat16:
        per_kv_head = 2 * max(skv, 1) * d * q.element_size()
        group = max(1, GROUP_KV_BYTES // per_kv_head) * (hq // hkv)
    else:
        group = b * hq
    return dataclasses.replace(shape, pairs=b * hq, q_tiles=n_qt,
                               head_group=max(1, min(group, b * hq)))


def _kernel(q, k, v, causal, window, softcap, scale, q_offset,
            lse: Optional[torch.Tensor] = None):
    """One launch; with ``lse`` (fp32 (b, hq, sq), contiguous) the kernel
    also stores each row's log-sum-exp there."""
    pl = plan(q, k, v, window, q_offset)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(), b, sq, skv, hq,
                 hkv, d,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out.stride()[:3], scale, bool(causal), window is not None,
                 window or 0, softcap is not None, softcap or 0.0, q_offset,
                 pl.head_group, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


def wgmma_rs_unit_tile(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The check of ``csrc/wgmma.cuh``'s ``MmaRS`` (A from registers) and
    ``desc_sw128_mn`` (B MN-major): ``a (64, k) @ b (k, n)`` in fp32 for
    bf16 CUDA tensors, k in 16, 32, 48, 64 and n in 64, 128, by one
    warpgroup's k / 16 products over b stored MN-major and swizzled."""
    k, n = b.shape
    if (a.shape != (64, k) or k not in (16, 32, 48, 64) or n not in (64, 128)
            or a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16
            or a.device.type != "cuda" or b.device != a.device):
        raise ValueError(f"wgmma_rs_unit_tile: needs bf16 CUDA a (64, k), "
                         f"b (k, n), k in 16..64 by 16, n 64 or 128; got "
                         f"{tuple(a.shape)} {a.dtype}, {tuple(b.shape)} "
                         f"{b.dtype} on {a.device}")
    a, b = a.contiguous(), b.contiguous()
    d = torch.empty((64, n), dtype=torch.float32, device=a.device)
    fn = _build.load("flash_attention").repro_wgmma_rs_unit
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        err = fn(a.data_ptr(), b.data_ptr(), d.data_ptr(), k, n,
                 torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wgmma_rs_unit_tile launch failed: CUDA error "
                           f"{err}")
    return d


def _forward(q, k, v, causal, window, softcap, scale, q_offset, chunk,
             lse=False):
    """The output, or (output, LSE) with ``lse``: on the CPU the plain
    version (and :func:`attention_lse_plain`), on a CUDA device one
    kernel launch that stores both."""
    if q.device.type == "cpu":
        out = flash_attention_plain(q, k, v, causal=causal, window=window,
                                    softcap=softcap, scale=scale,
                                    q_offset=q_offset, chunk=chunk)
        if not lse:
            return out
        return out, attention_lse_plain(q, k, causal=causal, window=window,
                                        softcap=softcap, scale=scale)
    if q.device.type == "cuda":
        if not lse:
            return _kernel(q, k, v, causal, window, softcap, scale, q_offset)
        b, sq, hq, _ = q.shape
        rows = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
        return (_kernel(q, k, v, causal, window, softcap, scale, q_offset,
                        rows), rows)
    raise ValueError(f"flash_attention runs on 'cuda' (kernel) or 'cpu' "
                     f"(plain version), not {q.device}")


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None, chunk: int = 1024
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of whole-sequence attention with queries at 0..sq-1:
    ``out`` as :func:`flash_attention`, ``lse`` fp32 (b, hq, sq), each
    row's natural-log log-sum-exp over its visible keys (0 for a row
    with none), which :func:`flash_attention_bwd` reads.  CUDA tensors:
    one kernel launch that stores both; CPU tensors: the plain forward
    and :func:`attention_lse_plain`.  Not differentiable (training goes
    through :class:`FlashAttentionFn`, whose forward this is)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _forward(q, k, v, causal, window, softcap, scale, 0, chunk,
                    lse=True)


class FlashAttentionFn(torch.autograd.Function):
    """:func:`flash_attention` differentiable in q, k and v: the forward
    is :func:`flash_attention_lse`, and :func:`flash_attention_bwd` runs
    from the saved q, k, v, output and LSE.  Queries sit at 0..sq-1."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, chunk):
        o, lse = _forward(q, k, v, causal, window, softcap, scale, 0,
                          chunk, lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.flags = dict(causal=causal, window=window, softcap=softcap,
                         scale=scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(),
                                         lse=lse, **ctx.flags)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None, q_offset: int = 0,
                    chunk: int = 1024) -> torch.Tensor:
    """Whole-sequence attention in the model layout: q (b, sq, hq, d),
    k / v (b, skv, hkv, d) -> (b, sq, hq, d) at q's dtype.  Queries sit
    at positions ``q_offset + arange(sq)``, keys at ``arange(skv)``.
    ``chunk`` is the plain version's KV block (the kernel tiles by
    itself).  CPU tensors take the plain version; CUDA tensors launch
    the kernel.  With grad enabled and an input that requires it, the
    result is differentiable (:class:`FlashAttentionFn`); ``q_offset``
    then raises."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if q_offset:
            raise NotImplementedError(
                "flash_attention: no backward with q_offset != 0 (no "
                "training path uses one)")
        return FlashAttentionFn.apply(q, k, v, causal, window, softcap,
                                      scale, chunk)
    return _forward(q, k, v, causal, window, softcap, scale, q_offset, chunk)


flash_attention.launches = 0


# --------------------------------------------------------------------- #
# Backward
# --------------------------------------------------------------------- #

_BWD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 12
                 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
                 + [ctypes.c_longlong] * 15
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_float,
                    ctypes.c_void_p])
_BWD_PLAN_MISMATCH = -1         # csrc/flash_attention_bwd.cu kPlanMismatch


def _plain_scores(q, k, causal, window, softcap, scale):
    """fp32 capped scores (b, hkv, g, sq, skv) of q (b, sq, hq, d) against
    k, masked to ``NEG_INF``; the visible mask (sq, skv); ``tanh(scale
    q·k / c)`` under a softcap ``c`` (else None)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, hkv, hq // hkv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    t = None
    if softcap is not None:
        t = torch.tanh(s / softcap)
        s = softcap * t
    q_pos = torch.arange(sq, device=q.device)
    k_pos = torch.arange(skv, device=q.device)
    ok = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        ok &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        ok &= q_pos[:, None] - k_pos[None, :] < window
    return s.masked_fill(~ok, NEG_INF), ok, t


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """The LSE that the forward kernel stores, in plain PyTorch: fp32 (b,
    hq, sq), ``torch.logsumexp`` of each row's masked fp32 scores, 0 for a
    row with no visible key.  ``attention_lse_plain.calls`` counts calls
    (the CPU leg of :func:`flash_attention_lse`)."""
    attention_lse_plain.calls += 1
    b, sq, hq, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s, ok, _ = _plain_scores(q, k, causal, window, softcap, scale)
    lse = torch.logsumexp(s, dim=-1)                       # (b, hkv, g, sq)
    lse = torch.where(ok.any(-1), lse, torch.zeros((), device=q.device))
    return lse.reshape(b, hq, sq)


attention_lse_plain.calls = 0


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              do: torch.Tensor, *,
                              lse: Optional[torch.Tensor] = None,
                              causal: bool = True,
                              window: Optional[int] = None,
                              softcap: Optional[float] = None,
                              scale: Optional[float] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """The backward kernel's function in plain PyTorch, in fp32 whatever
    the inputs' dtype: with ``t = tanh(scale q·k / c)`` under a softcap
    ``c``, ``s`` the capped score, ``P = exp(s - lse)`` on the visible
    (query, key) pairs and 0 elsewhere, ``D = rowsum(dO * O)``:
    ``dV = P^T dO``, ``dS = P (dO V^T - D) (1 - t^2)``, ``dQ = scale dS
    K``, ``dK = scale dS^T Q``; dK and dV sum over the q heads of a GQA
    group.  ``lse`` (b, hq, sq) is the forward's (:func:`flash_attention_lse`);
    without it each row's LSE is computed here from the scores.  Returns
    (dq, dk, dv) at the inputs' dtypes."""
    flash_attention_bwd_plain.calls += 1
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    f32 = torch.float32
    s, ok, t = _plain_scores(q, k, causal, window, softcap, scale)
    if lse is None:
        lse = torch.logsumexp(s, dim=-1, keepdim=True)
    else:
        lse = lse.to(f32).reshape(b, hkv, hq // hkv, sq, 1)
    p = torch.where(ok, torch.exp(s - lse), torch.zeros((), dtype=f32,
                                                         device=q.device))
    qg = q.float().reshape(b, sq, hkv, hq // hkv, d)
    dog = do.float().reshape(b, sq, hkv, hq // hkv, d)
    delta = (do.float() * o.float()).sum(-1)               # (b, sq, hq)
    delta = delta.reshape(b, sq, hkv, hq // hkv).permute(0, 2, 3, 1)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = p * (dp - delta[..., None])
    if softcap is not None:
        ds = ds * (1.0 - t * t)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg) * scale
    return (dq.reshape(b, sq, hq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


flash_attention_bwd_plain.calls = 0


def check_bwd_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     o: torch.Tensor, do: torch.Tensor,
                     window: Optional[int],
                     lse: Optional[torch.Tensor] = None) -> None:
    """Raise on what the backward kernel does not take: shapes (o and dO
    as q, ``lse`` fp32 (b, hq, sq) where given), head_dim above
    ``MAX_D``, dtypes (all float32 or all bfloat16), a head_dim that is
    not the unit-stride axis, tensors on two devices, a window below 1."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape \
            or o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"shapes: q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} o {tuple(o.shape)} do "
                         f"{tuple(do.shape)}")
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv < 1 or hq % hkv:
        raise ValueError(f"shapes: q {tuple(q.shape)} k {tuple(k.shape)}: "
                         f"batch and head_dim must agree, hq % hkv == 0")
    if d > MAX_D or q.dtype not in _DTYPE_CODE or any(
            t.dtype != q.dtype for t in (k, v, o, do)):
        raise TypeError(f"backward kernel takes head_dim <= {MAX_D} and q, "
                        f"k, v, o, do all float32 or all bfloat16; got d "
                        f"{d}, {[t.dtype for t in (q, k, v, o, do)]}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 (window={window})")
    named = [("q", q), ("k", k), ("v", v), ("o", o), ("do", do)]
    for name, t in named:
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name}: head_dim must be the unit-stride "
                             f"axis (strides {t.stride()})")
    if lse is not None:
        if tuple(lse.shape) != (b, hq, sq) or lse.dtype != torch.float32:
            raise ValueError(f"lse: fp32 (b, hq, sq) = {(b, hq, sq)} from "
                             f"the forward; got {lse.dtype} "
                             f"{tuple(lse.shape)}")
        named.append(("lse", lse))
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """How the backward kernel runs a call (``csrc/flash_attention_bwd.cu``):
    head_dim padded to ``d_pad``; (A) ``dot_blocks`` blocks of 8 rows
    (D and the LSE into rows padded to ``sq_pad``); (B) ``kv_blocks``
    blocks of ``keys`` keys, each over ``head_split``-th of a GQA group's
    q heads, in steps of ``q_tile`` queries through ``kv_stages`` stages
    (``kv_smem`` bytes); (R) ``reduce_blocks`` blocks summing
    ``part_floats`` fp32 partials (0 and 0 without a split); (C)
    ``dq_blocks`` blocks of ``dq_rows`` queries, in steps of ``dq_bk``
    keys through ``dq_stages`` stages (``dq_smem`` bytes).  bf16 runs
    (B) and (C) on ``wgmma`` with ``threads`` = 384 (two consumer
    warpgroups and a TMA producer); fp32 on the CUDA cores with 256.
    The wrapper hands the kernel every field (:meth:`launch_args`); the
    kernel refuses a plan that is not its own layout and launches the
    grids and shared memory it was given."""
    d_pad: int
    keys: int
    q_tile: int
    kv_stages: int
    kv_smem: int
    dq_rows: int
    dq_bk: int
    dq_stages: int
    dq_smem: int
    threads: int
    sq_pad: int
    head_split: int
    dot_blocks: int
    kv_blocks: int
    reduce_blocks: int
    dq_blocks: int
    part_floats: int

    @property
    def launches(self) -> int:
        """Kernel launches of one call: (A), (B), (R) with a split, (C)."""
        return 3 + (self.reduce_blocks > 0)

    def launch_args(self) -> Tuple[int, ...]:
        """The plan in the order of ``repro_flash_attention_bwd``'s
        ``plan`` array."""
        return tuple(getattr(self, f.name) for f in dataclasses.fields(self))


def _bwd_tiles(dtype: torch.dtype, d: int) -> dict:
    """The backward's tile shapes and shared memory at head_dim ``d``
    (see :class:`BwdPlan`; the byte counts are the kernels')."""
    d_pad = 64 if d <= 64 else 128 if d <= 128 else 256
    if dtype == torch.bfloat16:
        keys = 64 if d_pad == 256 else 128
        kv_stages = dq_stages = 2 if d_pad == 256 else 3
        dq_bk = 32 if d_pad == 256 else 64
        kv_smem = (2 * keys * d_pad * 2 + kv_stages * 2 * 64 * d_pad * 2
                   + kv_stages * 2 * 64 * 4 + (1 + 2 * kv_stages) * 8 + 1024)
        dq_smem = (2 * 128 * d_pad * 2 + dq_stages * 2 * dq_bk * d_pad * 2
                   + (1 + 2 * dq_stages) * 8 + 1024)
        return dict(d_pad=d_pad, keys=keys, q_tile=64, kv_stages=kv_stages,
                    kv_smem=kv_smem, dq_rows=128, dq_bk=dq_bk,
                    dq_stages=dq_stages, dq_smem=dq_smem, threads=384)
    bk = 32 if d_pad == 256 else 64
    rows = (d_pad + 1) * 4
    return dict(d_pad=d_pad, keys=bk, q_tile=64, kv_stages=1,
                kv_smem=(2 * bk + 128) * rows + 128 * (bk + 16) * 4 + 512,
                dq_rows=64, dq_bk=bk, dq_stages=1,
                dq_smem=(2 * bk + 128) * rows + 64 * (bk + 16) * 4 + 512,
                threads=256)


def bwd_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
             window: Optional[int], sm_count: int) -> BwdPlan:
    """Checks a backward call's inputs (:func:`check_bwd_inputs`; bf16 also
    what TMA reads: q, k, v, dO and o with head_dim a multiple of 8,
    strides a multiple of 16 bytes and positive where the extent is above
    1, 16-byte aligned pointers) and returns how the kernel runs it on a
    card of ``sm_count`` SMs.  Where (B)'s b * hkv * key tiles blocks are
    fewer than ``sm_count`` (bf16), each GQA group's q heads are split
    over the smallest ``head_split`` dividing hq / hkv that reaches it
    (all of them where none does).  Reads shapes, dtypes, strides and
    addresses only, on any device."""
    check_bwd_inputs(q, k, v, o, do, window, lse)
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    tiles = _bwd_tiles(q.dtype, d)
    if q.dtype == torch.bfloat16:
        if d % 8:
            raise ValueError(f"backward kernel takes a bf16 head_dim that "
                             f"is a multiple of 8 (TMA rows of 16 bytes); "
                             f"got {d}")
        for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
            if any(st % 8 for st in t.stride()[:3]) or t.data_ptr() % 16 \
                    or any(st <= 0 for st, n in zip(t.stride()[:3],
                                                     t.shape[:3]) if n > 1):
                raise ValueError(f"{name}: TMA reads bf16 tiles through "
                                 f"positive strides that are multiples of "
                                 f"16 bytes from a 16-byte aligned pointer; "
                                 f"got strides {t.stride()}")
    if -(-sq // 64) > 65535 or -(-skv // 32) > 65535:
        raise ValueError(f"backward kernel takes at most 65535 tiles of 64 "
                         f"queries and of 32 keys (sq={sq}, skv={skv})")
    ratio = hq // hkv
    pairs = b * hkv
    n_kt = -(-skv // tiles["keys"])
    split = 1
    if q.dtype == torch.bfloat16 and 0 < pairs * n_kt < sm_count:
        split = next((s for s in range(1, ratio + 1)
                      if ratio % s == 0 and pairs * n_kt * s >= sm_count),
                     ratio)
    n_el = b * skv * hkv * d
    part = 2 * split * n_el if split > 1 else 0
    sq_pad = -(-sq // 128) * 128
    dq_blocks = b * hq * -(-sq // tiles["dq_rows"])
    if max(pairs * n_kt * split, dq_blocks, b * hq * sq_pad // 8) \
            > 2 ** 31 - 1:
        raise ValueError(f"backward kernel takes at most 2^31 - 1 blocks a "
                         f"launch (b={b}, sq={sq}, skv={skv}, hq={hq})")
    return BwdPlan(**tiles, sq_pad=sq_pad, head_split=split,
                   dot_blocks=-(-b * hq * sq_pad // 8),
                   kv_blocks=pairs * n_kt * split,
                   reduce_blocks=-(-n_el // 1024) if part else 0,
                   dq_blocks=dq_blocks, part_floats=part)


def _bwd_kernel(q, k, v, o, do, causal, window, softcap, scale, lse=None):
    lib = _build.load("flash_attention_bwd")
    if lse is None:
        raise ValueError("flash_attention_bwd on a CUDA device needs the "
                         "forward's lse (flash_attention_lse); it runs no "
                         "forward or statistics pass itself")
    pl = bwd_plan(q, k, v, o, do, lse, window,
                  compat.sm_count(q.device.index))
    lse = lse.contiguous()
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    fn = lib.repro_flash_attention_bwd
    fn.argtypes, fn.restype = _BWD_ARGTYPES, ctypes.c_int
    dq = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, skv, hkv, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    stats = torch.empty((2, b * hq * pl.sq_pad), dtype=torch.float32,
                        device=q.device)
    part = (torch.empty(pl.part_floats, dtype=torch.float32, device=q.device)
            if pl.part_floats else None)
    launch = pl.launch_args()
    launch = (ctypes.c_longlong * len(launch))(*launch)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 stats[0].data_ptr(), stats[1].data_ptr(),
                 None if part is None else part.data_ptr(), b, sq, skv, hq,
                 hkv, d, launch,
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *o.stride()[:3], *do.stride()[:3], scale, bool(causal),
                 window is not None, window or 0, softcap is not None,
                 softcap or 0.0, stream)
    if err == _BWD_PLAN_MISMATCH:
        raise RuntimeError(f"flash_attention_bwd: the kernel refused the "
                           f"plan {pl} as not its own layout "
                           f"(csrc/flash_attention_bwd.cu own_plan)")
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: "
                           f"CUDA error {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, *,
                        lse: Optional[torch.Tensor] = None,
                        causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention` (queries at 0..sq-1) from
    its inputs, its output ``o``, the output's gradient ``do`` and the
    forward's ``lse`` (:func:`flash_attention_lse`), at the inputs'
    dtype.  CPU tensors take :func:`flash_attention_bwd_plain` (which
    computes the LSE itself where none is given); CUDA tensors launch the
    kernel, which needs ``lse`` and raises without it."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, lse=lse,
                                         causal=causal, window=window,
                                         softcap=softcap, scale=scale)
    if q.device.type == "cuda":
        return _bwd_kernel(q, k, v, o, do, causal, window, softcap, scale,
                           lse=lse)
    raise ValueError(f"flash_attention_bwd runs on 'cuda' (kernel) or "
                     f"'cpu' (plain version), not {q.device}")


flash_attention_bwd.launches = 0
