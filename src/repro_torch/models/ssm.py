"""Mamba-2 SSD (state-space duality) block (counterpart of
``repro.models.ssm``): parameters, the chunked SSD core, the
whole-sequence block (scoring and whole-prompt prefill), chunked pooled
prefill with carried state, and the one-token decode recurrence.

Layout as in the reference: x (b, s, h, p) heads x head_dim; B, C
(b, s, n) with one group shared by all heads; A one scalar per head.
The projections are kept separate (wz / wx / wb / wc / wdt and three
depthwise convs), so the bridge carries the reference's tree as it is.

:func:`ssd_chunked` is the plain version of the SSD kernel, in the
reference's arithmetic order; :func:`ssm_forward` and
:func:`ssm_prefill_chunk` run their SSD core through
``kernels.ssd_scan``, which takes this plain version for CPU
tensors and launches the hand-written CUDA kernel for CUDA tensors.
Decode (:func:`ssm_decode`) is the O(1)-state recurrence in plain torch;
the reference has no kernel there either.  The speculative verify
(:func:`ssm_verify_chunk`) runs that recurrence over a block without
writing, and the commit (:func:`ssm_commit_chunk`) replays it over the
kept prefix.

The slot's cache row is updated in place: the prefill writes the
advanced conv carries and state into the row it is given (views into
the pool), and the decode step writes only the ``active`` rows.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import slotstate
from repro_torch.models.layers import causal_conv1d, dense_init, mm, rms_norm


# --------------------------------------------------------------------- #
# Parameters
# --------------------------------------------------------------------- #

def init_ssm(cfg: ArchConfig, dtype, generator: torch.Generator, device,
             lead=()) -> dict:
    """The reference's shapes and distributions; ``A_log``, ``dt_bias``
    and ``D`` are float32 whatever ``dtype`` is.  ``lead`` prepends
    stacking axes (the period axis)."""
    d, d_in, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    k = cfg.ssm_conv
    f32 = torch.float32

    def w(shape, fan_in):
        return dense_init((*lead, *shape), dtype, generator, device,
                          fan_in=fan_in)

    def fixed(values):
        return values.to(device).expand(*lead, h).clone()

    # dt_bias = softplus^-1(dt), dt log-uniform in [1e-3, 1e-1]
    dt = torch.exp(torch.linspace(math.log(1e-3), math.log(1e-1), h,
                                  dtype=f32))
    dt_bias = dt + torch.log(-torch.expm1(-dt))

    def zeros(c):
        return torch.zeros((*lead, c), dtype=dtype, device=device)

    return {
        "wz": w((d, d_in), d), "wx": w((d, d_in), d),
        "wb": w((d, n), d), "wc": w((d, n), d), "wdt": w((d, h), d),
        "conv_x_w": w((d_in, k), k), "conv_x_b": zeros(d_in),
        "conv_b_w": w((n, k), k), "conv_b_b": zeros(n),
        "conv_c_w": w((n, k), k), "conv_c_b": zeros(n),
        "A_log": fixed(torch.log(torch.linspace(1.0, 16.0, h, dtype=f32))),
        "dt_bias": fixed(dt_bias),
        "D": fixed(torch.ones(h, dtype=f32)),
        "gate_norm": torch.ones((*lead, d_in), dtype=dtype, device=device),
        "out_proj": w((d_in, d), d_in),
    }


# --------------------------------------------------------------------- #
# Chunked SSD core
# --------------------------------------------------------------------- #

def _cumsum(a: torch.Tensor) -> torch.Tensor:
    """Prefix sums over the last axis, accumulated in float64 and rounded
    to a's dtype: what torch's CPU cumsum does for float32 anyway, and
    what the kernel does, so the plain version is one function on the
    card and on the host (the card's float32 cumsum scans in float32, a
    few ulps off over a 256-step chunk)."""
    return torch.cumsum(a, dim=-1, dtype=torch.float64).to(a.dtype)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., q) -> (..., q, q): out[i, j] = sum(a[j+1..i]) for i >= j,
    -inf above the diagonal (as cumsum differences, the reference's
    order)."""
    q = a.shape[-1]
    cs = _cumsum(a)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return seg.masked_fill(~mask, -math.inf)


def ssd_chunked(x: torch.Tensor, dt_a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None,
                return_states: bool = False):
    """Chunk-parallel SSD, the plain version of the ``ssd_scan`` kernel.

    x (bt, s, h, p) already discretized (x * dt); dt_a (bt, s, h) the
    per-step log decay; b, c (bt, s, n); s a multiple of ``chunk``.
    Returns (y (bt, s, h, p), final_state (bt, h, p, n)), all fp32;
    with ``return_states`` also the state entering each chunk,
    (bt, s / chunk, h, p, n) fp32, which the backward reads."""
    bt, s, h, p = x.shape
    n = b.shape[-1]
    if s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk} != 0")
    nc = s // chunk
    f32 = torch.float32
    x = x.to(f32).reshape(bt, nc, chunk, h, p)
    a = dt_a.to(f32).reshape(bt, nc, chunk, h).permute(0, 3, 1, 2)
    bm = b.to(f32).reshape(bt, nc, chunk, n)
    cm = c.to(f32).reshape(bt, nc, chunk, n)

    a_cs = _cumsum(a)                                 # (bt, h, nc, q)
    # 1. intra-chunk (diagonal blocks): masked quadratic form
    el = torch.exp(_segsum(a))                        # (bt, h, nc, q, q)
    scores = torch.einsum("bcln,bcsn->bcls", cm, bm)  # (bt, nc, q, q)
    y_diag = torch.einsum("bcls,bhcls,bcshp->bclhp", scores, el, x)
    # 2. chunk-final states
    decay_states = torch.exp(a_cs[..., -1:] - a_cs)   # (bt, h, nc, q)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", bm, decay_states, x)
    # 3. inter-chunk recurrence, in order over the chunks
    chunk_decay = torch.exp(a_cs[..., -1])            # (bt, h, nc)
    state = (torch.zeros((bt, h, p, n), dtype=f32, device=x.device)
             if initial_state is None else initial_state.to(f32))
    prev = []
    for ci in range(nc):
        prev.append(state)                            # entering state
        state = state * chunk_decay[..., ci, None, None] + states[:, ci]
    prev_states = torch.stack(prev, dim=1)            # (bt, nc, h, p, n)
    # 4. contribution of the entering state within each chunk
    state_decay = torch.exp(a_cs)                     # (bt, h, nc, q)
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", cm, prev_states,
                         state_decay)
    y = (y_diag + y_off).reshape(bt, s, h, p)
    if return_states:
        return y, state, prev_states
    return y, state


def ssd_reference(x: torch.Tensor, dt_a: torch.Tensor, b: torch.Tensor,
                  c: torch.Tensor,
                  initial_state: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The O(s) sequential recurrence: the oracle for
    :func:`ssd_chunked` (tests)."""
    bt, s, h, p = x.shape
    n = b.shape[-1]
    f32 = torch.float32
    state = (torch.zeros((bt, h, p, n), dtype=f32, device=x.device)
             if initial_state is None else initial_state.to(f32))
    x, dt_a, b, c = (t.to(f32) for t in (x, dt_a, b, c))
    ys = []
    for t in range(s):
        state = (state * torch.exp(dt_a[:, t])[..., None, None]
                 + x[:, t, ..., None] * b[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", state, c[:, t]))
    return torch.stack(ys, dim=1), state


# --------------------------------------------------------------------- #
# Block: projections -> conv -> SSD -> gated norm -> out projection
# --------------------------------------------------------------------- #

def _discretize(p: dict, dt_raw: torch.Tensor):
    """dt = softplus(raw + bias); returns (dt, dt * A), fp32 (JAX's
    promotion: A_log may have been cast to the compute dtype)."""
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    a = -torch.exp(p["A_log"])                        # (h,) negative
    return dt, dt * a


def _project(p: dict, x: torch.Tensor):
    return (mm(x, p["wz"]), mm(x, p["wx"]), mm(x, p["wb"]), mm(x, p["wc"]),
            mm(x, p["wdt"]))


def _gated_out(p: dict, y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
               dtype: torch.dtype, cfg: ArchConfig) -> torch.Tensor:
    """Per-head skip D * x, the cast to the activations' ``dtype``, gated
    RMSNorm and the out projection."""
    bt, s = y.shape[:2]
    y = y + p["D"][:, None] * xh.float()
    y = y.reshape(bt, s, cfg.ssm_heads * cfg.ssm_head_dim).to(dtype)
    y = rms_norm(p["gate_norm"], y * F.silu(z), cfg.norm_eps)
    return mm(y, p["out_proj"])


def init_ssm_cache(cfg: ArchConfig, batch: int, dtype, device,
                   lead=()) -> dict:
    """Sectioned depthwise-conv carries (one leaf per conv input stream,
    the last k-1 raw inputs) at ``dtype`` and the fp32 SSD state.  Zero
    is the empty state."""
    k1 = cfg.ssm_conv - 1

    def z(*shape, dt=dtype):
        return torch.zeros((*lead, batch, *shape), dtype=dt, device=device)

    return {"conv_x": z(k1, cfg.d_inner), "conv_b": z(k1, cfg.ssm_state),
            "conv_c": z(k1, cfg.ssm_state),
            "state": z(cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                       dt=torch.float32)}


def ssm_forward(p: dict, x: torch.Tensor, cfg: ArchConfig,
                return_state: bool = False):
    """Whole-sequence SSD block.  x (bt, s, d_model) -> out of the same
    shape; the SSD core runs through ``kernels.ssd_scan`` with chunk
    ``min(cfg.ssm_chunk, s)`` (the kernel carries the state over the
    chunks; s is padded to the chunk with an identity tail).  With
    ``return_state`` also the cache entry the sequence leaves: the conv
    carries (the last k-1 raw inputs, zero-padded on the left when s <
    k-1) at x's dtype and the fp32 final state."""
    bt, s, _ = x.shape
    h, pd = cfg.ssm_heads, cfg.ssm_head_dim
    z, xr, br, cr, dt_raw = _project(p, x)
    xh = F.silu(causal_conv1d(xr, p["conv_x_w"], p["conv_x_b"]))
    b_ = F.silu(causal_conv1d(br, p["conv_b_w"], p["conv_b_b"]))
    c_ = F.silu(causal_conv1d(cr, p["conv_c_w"], p["conv_c_b"]))
    xh = xh.reshape(bt, s, h, pd)
    dt, dt_a = _discretize(p, dt_raw)
    y, state = ssd_scan(xh * dt[..., None], dt_a, b_, c_,
                        chunk=min(cfg.ssm_chunk, s))
    out = _gated_out(p, y, xh, z, x.dtype, cfg)
    if not return_state:
        return out
    k1 = cfg.ssm_conv - 1

    def tail(r):
        return F.pad(r[:, s - min(s, k1):], (0, 0, max(0, k1 - s), 0)
                     ).to(x.dtype)

    return out, {"conv_x": tail(xr), "conv_b": tail(br), "conv_c": tail(cr),
                 "state": state}


def ssm_prefill_chunk(p: dict, x: torch.Tensor, cache: dict,
                      cfg: ArchConfig, valid: torch.Tensor, valid_len: int
                      ) -> torch.Tensor:
    """One prompt chunk through the SSD block, with the conv carries and
    the state carried across chunk boundaries.

    x (bt, s, d_model), zero-padded past ``valid_len``; ``cache`` this
    slot's row ``{"conv_x", "conv_b", "conv_c", "state"}`` (views into
    the pool, bt rows), advanced in place to ``valid_len``; ``valid``
    (s,) bool prefix mask.  Returns out (bt, s, d_model); outputs at
    invalid positions are garbage.

    The convs run over ``[carry | raw]`` and drop the first k-1 outputs,
    so the zero left-pad never reaches a kept window.  Positions past
    ``valid_len`` are identity steps of the recurrence (decay 1, input
    0: x, dt_a and b are zeroed; c is not, as in the reference), so the
    state at the chunk's end is the state at ``valid_len``."""
    bt, s, _ = x.shape
    h, pd = cfg.ssm_heads, cfg.ssm_head_dim
    k1 = cfg.ssm_conv - 1
    z, xr, br, cr, dt_raw = _project(p, x)
    fx = torch.cat([cache["conv_x"].to(xr.dtype), xr], dim=1)
    fb = torch.cat([cache["conv_b"].to(br.dtype), br], dim=1)
    fc = torch.cat([cache["conv_c"].to(cr.dtype), cr], dim=1)
    xh = F.silu(causal_conv1d(fx, p["conv_x_w"], p["conv_x_b"])[:, k1:])
    b_ = F.silu(causal_conv1d(fb, p["conv_b_w"], p["conv_b_b"])[:, k1:])
    c_ = F.silu(causal_conv1d(fc, p["conv_c_w"], p["conv_c_b"])[:, k1:])
    xh = xh.reshape(bt, s, h, pd)
    dt, dt_a = _discretize(p, dt_raw)
    vm = valid[None, :]                                    # (1, s)
    x_disc = torch.where(vm[..., None, None], xh * dt[..., None], 0.0)
    dt_a = torch.where(vm[..., None], dt_a, 0.0)
    b_c = torch.where(vm[..., None], b_, 0.0)
    y, state = ssd_scan(x_disc, dt_a, b_c, c_, chunk=min(cfg.ssm_chunk, s),
                        initial_state=cache["state"])
    out = _gated_out(p, y, xh, z, x.dtype, cfg)
    # the carries: the k-1 raw rows ending at valid_len, i.e. rows
    # [valid_len, valid_len + k-1) of [carry | raw] (reaching into the
    # old carry when valid_len < k-1)
    for name, f in (("conv_x", fx), ("conv_b", fb), ("conv_c", fc)):
        cache[name].copy_(f[:, valid_len:valid_len + k1])
    cache["state"].copy_(state)
    return out


def _conv_step(p: dict, sec: str, window: torch.Tensor) -> torch.Tensor:
    """One position's depthwise conv of section ``sec`` over its window
    (bt, k, c) of raw inputs, then SiLU: (bt, c).  The window and the
    weight meet at their promoted dtype, as in the reference."""
    w = p[f"conv_{sec}_w"]
    dt = torch.promote_types(window.dtype, w.dtype)
    return F.silu(torch.einsum("bkc,ck->bc", window.to(dt), w.to(dt))
                  + p[f"conv_{sec}_b"])


def _state_step(state: torch.Tensor, dt_a: torch.Tensor, xd: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """One step of the recurrence, S <- S * exp(dt * A) + (dt * x) outer
    B, fp32: state (bt, h, p, n), dt_a (bt, h), xd (bt, h, p), b (bt, n).
    Decode, the speculative verify and its commit all step through it."""
    return (state * torch.exp(dt_a)[..., None, None]
            + xd[..., None] * b[:, None, None, :])


def ssm_decode(p: dict, x: torch.Tensor, cache: dict, cfg: ArchConfig,
               active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token recurrence.  x (bt, 1, d_model); ``cache`` the layer's
    pool (bt rows), advanced in place on the ``active`` rows only
    (``slotstate.decode_advance``).  Returns out (bt, 1, d_model)."""
    bt = x.shape[0]
    h, pd = cfg.ssm_heads, cfg.ssm_head_dim
    z, xr, br, cr, dt_raw = _project(p, x)
    # conv over the k-1 carried raw inputs and this one, per section
    windows = {sec: torch.cat([cache[f"conv_{sec}"].to(r.dtype), r], dim=1)
               for sec, r in (("x", xr), ("b", br), ("c", cr))}
    xh = _conv_step(p, "x", windows["x"])[:, None].reshape(bt, 1, h, pd)
    b_ = _conv_step(p, "b", windows["b"])[:, None]
    c_ = _conv_step(p, "c", windows["c"])[:, None]
    dt, dt_a = _discretize(p, dt_raw)
    xd = (xh * dt[..., None]).float()[:, 0]                 # (bt, h, p)
    state = _state_step(cache["state"], dt_a.float()[:, 0], xd,
                        b_.float()[:, 0])
    y = torch.einsum("bhpn,bn->bhp", state, c_.float()[:, 0])[:, None]
    out = _gated_out(p, y, xh, z, x.dtype, cfg)
    new = {f"conv_{sec}": wdw[:, 1:] for sec, wdw in windows.items()}
    new["state"] = state
    slotstate.decode_advance(active, cache, new)
    return out


# --------------------------------------------------------------------- #
# Speculative verify and commit (decode-exact)
# --------------------------------------------------------------------- #

def _conv_windows(f: torch.Tensor, s: int, k: int) -> list:
    """f (bt, k-1+s, c) -> the ``s`` per-position conv windows, each
    (bt, k, c) and contiguous as decode's: window j is rows [j, j+k) of
    ``[carry | raw]``, the window :func:`ssm_decode` sees at step j."""
    return [f[:, j:j + k].contiguous() for j in range(s)]


def ssm_verify_chunk(p: dict, x: torch.Tensor, cache: dict, cfg: ArchConfig
                     ) -> Tuple[torch.Tensor, dict]:
    """Verify ``s`` drafted tokens through the SSD block in one pass,
    reading the cache and writing nothing.

    x (bt, s, d_model); ``cache`` the layer's pool (bt rows).  Position
    j's output uses the state after j decode steps and the conv window
    ending at j, both with :func:`ssm_decode`'s own ops: a sequential
    fp32 scan (not :func:`ssd_chunked`, whose association differs) over
    per-position windows of ``[carry | raw]`` (not ``causal_conv1d``,
    whose zero left pad differs from the carried window).  Each position
    runs the transcendental ops (conv SiLU, softplus, exp) on tensors of
    decode's shapes: a CPU kernel splits a tensor into vector and scalar
    parts by its size, and the two parts can round differently.

    Returns (out (bt, s, d_model), info): what :func:`ssm_commit_chunk`
    needs, the discretized inputs ``xd`` (bt, s, h, p) / ``dt_a``
    (bt, s, h) / ``b`` (bt, s, n), fp32, and the ``[carry | raw]`` conv
    streams ``fx`` / ``fb`` / ``fc`` (bt, k-1+s, c)."""
    bt, s, _ = x.shape
    h, pd = cfg.ssm_heads, cfg.ssm_head_dim
    z, xr, br, cr, dt_raw = _project(p, x)
    streams = {sec: torch.cat([cache[f"conv_{sec}"].to(r.dtype), r], dim=1)
               for sec, r in (("x", xr), ("b", br), ("c", cr))}
    windows = {sec: _conv_windows(f, s, cfg.ssm_conv)
               for sec, f in streams.items()}
    state = cache["state"]
    xhs, xds, das, bs, ys = [], [], [], [], []
    for j in range(s):
        conv = {sec: _conv_step(p, sec, w[j]) for sec, w in windows.items()}
        xh = conv["x"].reshape(bt, 1, h, pd)
        dt, dt_a = _discretize(p, dt_raw[:, j:j + 1].contiguous())
        xd = (xh * dt[..., None]).float()[:, 0]             # (bt, h, p)
        a = dt_a.float()[:, 0]                              # (bt, h)
        b_ = conv["b"].float()
        state = _state_step(state, a, xd, b_)
        ys.append(torch.einsum("bhpn,bn->bhp", state, conv["c"].float()))
        xhs.append(xh[:, 0])
        xds.append(xd)
        das.append(a)
        bs.append(b_)
    out = _gated_out(p, torch.stack(ys, dim=1), torch.stack(xhs, dim=1), z,
                     x.dtype, cfg)
    info = {"xd": torch.stack(xds, dim=1), "dt_a": torch.stack(das, dim=1),
            "b": torch.stack(bs, dim=1), "fx": streams["x"],
            "fb": streams["b"], "fc": streams["c"]}
    return out, info


def ssm_commit_chunk(cache: dict, info: dict, e: torch.Tensor,
                     cfg: ArchConfig) -> dict:
    """Advance the layer's pool (bt rows) by the first ``e`` (bt,)
    verified positions of each row, in place; rows with ``e`` 0 keep
    their carries and state.

    Nothing was written during verify, so rolling back is committing
    only the accepted prefix: the state replays :func:`ssm_decode`'s
    update from the pre-block state over all ``s`` positions, with the
    rejected ones identity steps (log decay 0, so exp gives 1, and input
    0): bit for bit ``e`` decode steps.  The conv carry is rows
    [e, e + k-1) of ``[carry | raw]``, gathered per row."""
    bt, s = info["dt_a"].shape[:2]
    k1 = cfg.ssm_conv - 1
    dev = e.device
    ok = torch.arange(s, device=dev)[None, :] < e[:, None]   # (bt, s)
    state = cache["state"]
    for j in range(s):
        m = ok[:, j]
        state = _state_step(
            state, torch.where(m[:, None], info["dt_a"][:, j], 0.0),
            torch.where(m[:, None, None], info["xd"][:, j], 0.0),
            torch.where(m[:, None], info["b"][:, j], 0.0))
    rows = e.long()[:, None] + torch.arange(k1, device=dev)[None, :]
    new = {"state": state}
    for sec in ("x", "b", "c"):
        f = info[f"f{sec}"]
        new[f"conv_{sec}"] = f.gather(
            1, rows[..., None].expand(bt, k1, f.shape[-1]))
    slotstate.decode_advance(e > 0, cache, new)
    return cache
