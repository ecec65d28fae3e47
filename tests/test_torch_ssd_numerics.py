"""The precision design of the ``ssd_scan`` kernel (``csrc/ssd_scan.cu``),
pinned on the CPU.

The kernel forms its products on the tensor cores in TF32 (10 mantissa
bits).  Each product with an fp32 operand is split: v = hi + lo with
hi = rna(v), lo = rna(v - hi) (``cvt.rna.tf32.f32``: round to nearest,
ties away from zero), and a·b = a_hi·b_hi + a_hi·b_lo + a_lo·b_hi; an
operand exact in TF32 (a bf16 b / c) is its own hi.  The kernel scans a
chunk in sub-chunks of 64 rows with the state carried between them.

This file emulates that arithmetic with numpy on seeded inputs (operands
rounded as the kernel rounds them, products summed in float64) at h 4,
s 512, chunk 256, and holds it against ``ssd_chunked``'s function in
float64 (the chunk's prefix sums rounded to fp32 as the function rounds
them, all else in float64): split TF32 stays under 2e-5 (the kernel's
tolerance is 2e-4 against ``ssd_chunked``), one TF32 product per term
does not stay under 2e-4.  It also holds the port's ``ssd_chunked`` (fp32) to the oracle, so
the oracle is the function the kernel is compared with on the card.
"""

import numpy as np
import pytest
import torch

from repro_torch.models.ssm import ssd_chunked

BT, S, H, P, N, CHUNK, SUB = 1, 512, 4, 32, 64, 256, 64


def rna_tf32(v: np.ndarray) -> np.ndarray:
    """fp32 -> TF32 as ``cvt.rna.tf32.f32``: 10 mantissa bits, round to
    nearest with ties away from zero (add half of the dropped 13 bits to
    the magnitude, then clear them)."""
    u = np.asarray(v, np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _parts(v: np.ndarray, exact: bool, split: bool):
    """(hi, lo) of the kernel's operand: an exact operand is its own hi;
    without the split one TF32 rounding and no lo."""
    v = np.asarray(v, np.float32)
    if exact:
        return v.astype(np.float64), None
    hi = rna_tf32(v)
    lo = rna_tf32(v - hi) if split else None
    return hi.astype(np.float64), (None if lo is None
                                   else lo.astype(np.float64))


def product(a, b, exact_a=False, exact_b=False, split=True):
    """a @ b as the kernel forms it: hi·hi + hi·lo + lo·hi in TF32
    operands (the terms whose operand has no lo drop out), summed in
    float64 and rounded to fp32."""
    ah, al = _parts(a, exact_a, split)
    bh, bl = _parts(b, exact_b, split)
    out = ah @ bh
    if bl is not None:
        out = out + ah @ bl
    if al is not None:
        out = out + al @ bh
    return out.astype(np.float32)


def kernel_emulation(x, dt_a, b, c, state, bc_exact, split):
    """The kernel's sub-chunk scan of one (row, head): acs the chunk's
    float64 prefix sum rounded to fp32; per sub-chunk of 64 rows
    y = (C Bᵀ ⊙ L) x + exp(acs - acs_base) C stateᵀ and state = state
    exp(acs_end - acs_base) + (x ⊙ w)ᵀ B, acs_base the previous
    sub-chunk's last acs (0 at a chunk's start)."""
    s = x.shape[0]
    f32 = np.float32
    y = np.zeros_like(x)
    for c0 in range(0, s, CHUNK):
        run, base = 0.0, f32(0.0)
        for r0 in range(c0, c0 + CHUNK, SUB):
            rows = slice(r0, r0 + SUB)
            cs = run + np.cumsum(dt_a[rows].astype(np.float64))
            acs = cs.astype(f32)
            run = float(cs[-1])
            end = acs[-1]
            cm, bm, xm = c[rows], b[rows], x[rows]
            g = product(cm, bm.T, bc_exact, bc_exact, split)
            seg = (acs[:, None] - acs[None, :]).astype(f32)
            tril = np.tril(np.ones((SUB, SUB), bool))
            with np.errstate(over="ignore"):
                el = np.where(tril, np.exp(seg), f32(0.0)).astype(f32)
            sm = (g * el).astype(f32)
            y_off = product(cm, state.T, bc_exact, False, split)
            eoff = np.exp((acs - base).astype(f32)).astype(f32)
            y[rows] = product(sm, xm, False, False, split) \
                + y_off * eoff[:, None]
            w = np.exp((end - acs).astype(f32)).astype(f32)
            tile = product((xm * w[:, None]).astype(f32).T, bm, False,
                           bc_exact, split)
            dec = f32(np.exp(f32(end - base)))
            state = (state * dec + tile).astype(f32)
            base = end
    return y, state


def oracle(x, dt_a, b, c, state):
    """``ssd_chunked``'s function in float64, one (row, head): acs the
    chunk's float64 prefix sum rounded to fp32 (as ``ssd_chunked`` and
    the kernel round it), everything after it in float64."""
    f64 = np.float64
    st = state.astype(f64)
    y = np.zeros(x.shape)
    for c0 in range(0, x.shape[0], CHUNK):
        rows = slice(c0, c0 + CHUNK)
        acs = np.cumsum(dt_a[rows].astype(f64)).astype(np.float32) \
            .astype(f64)
        xm, bm, cm = (v[rows].astype(f64) for v in (x, b, c))
        tril = np.tril(np.ones((CHUNK, CHUNK), bool))
        seg = np.where(tril, acs[:, None] - acs[None, :], 0.0)
        el = np.where(tril, np.exp(seg), 0.0)
        y[rows] = ((cm @ bm.T) * el) @ xm \
            + (cm @ st.T) * np.exp(acs)[:, None]
        w = np.exp(acs[-1] - acs)
        st = st * np.exp(acs[-1]) + (xm * w[:, None]).T @ bm
    return y, st


def _inputs(seed: int, bc_bf16: bool):
    """Unit-scale inputs with model-like decays (those of
    ``chip_smoke.ssd_case``): x, b, c, state N(0, 0.25); dt_a = dt * a,
    a = -linspace(1, 16) per head, dt log-uniform in [1e-3, 1e-1]."""
    rng = np.random.default_rng(seed)

    def t(shape):
        return (rng.standard_normal(shape) * 0.5).astype(np.float32)

    a = -np.linspace(1.0, 16.0, H, dtype=np.float32)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (BT, S, H)))
    dt_a = (dt * a).astype(np.float32)
    x, b, c, state = t((BT, S, H, P)), t((BT, S, N)), t((BT, S, N)), \
        t((BT, H, P, N))
    if bc_bf16:
        b = torch.from_numpy(b).bfloat16().float().numpy()
        c = torch.from_numpy(c).bfloat16().float().numpy()
    return x, dt_a, b, c, state


def _errors(bc_bf16: bool, split: bool):
    x, dt_a, b, c, state = _inputs(7, bc_bf16)
    err_y = err_st = 0.0
    for hi in range(H):
        args = (x[0, :, hi], dt_a[0, :, hi], b[0], c[0], state[0, hi])
        y, st = kernel_emulation(*args, bc_exact=bc_bf16, split=split)
        y_want, st_want = oracle(*args)
        err_y = max(err_y, np.abs(y - y_want).max())
        err_st = max(err_st, np.abs(st - st_want).max())
    return err_y, err_st


@pytest.mark.parametrize("bc_bf16", [False, True], ids=["bc_fp32", "bc_bf16"])
def test_split_tf32_stays_within_2e_5(bc_bf16):
    err_y, err_st = _errors(bc_bf16, split=True)
    assert err_y < 2e-5 and err_st < 2e-5, (err_y, err_st)


@pytest.mark.parametrize("bc_bf16", [False, True], ids=["bc_fp32", "bc_bf16"])
def test_one_tf32_product_misses_2e_4(bc_bf16):
    """Without the split the kernel could not meet its tolerance."""
    err_y, _ = _errors(bc_bf16, split=False)
    assert err_y > 2e-4, err_y


def test_oracle_is_the_function_ssd_chunked_computes():
    """``ssd_chunked`` (the kernel's plain version, fp32) agrees with the
    float64 oracle within 2e-5 on the same inputs."""
    x, dt_a, b, c, state = _inputs(7, True)
    y, st = ssd_chunked(*(torch.from_numpy(v) for v in (x, dt_a, b, c)),
                        CHUNK, torch.from_numpy(state))
    for hi in range(H):
        y_want, st_want = oracle(x[0, :, hi], dt_a[0, :, hi], b[0], c[0],
                                 state[0, hi])
        assert np.abs(y[0, :, hi].numpy() - y_want).max() < 2e-5
        assert np.abs(st[0, hi].numpy() - st_want).max() < 2e-5


def test_rna_rounds_to_nearest_ties_away():
    """10 mantissa bits kept; a dropped half (bit 12 set, the rest 0)
    rounds away from zero, less rounds down."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    half = np.float32(2.0 ** -11)
    v = np.array([one + half, -(one + half), one + half * np.float32(0.99),
                  one + ulp], np.float32)
    got = rna_tf32(v)
    assert got[0] == one + ulp and got[1] == -(one + ulp)
    assert got[2] == one and got[3] == one + ulp
    r = rna_tf32(np.random.default_rng(0).standard_normal(1000)
                 .astype(np.float32))
    assert (r.view(np.uint32) & 0x1FFF == 0).all()
