"""The probe kernels' plain versions (``repro_torch.kernels.probe_*``)
against the JAX package: the Pallas kernels in interpret mode, their
oracles, and the compute probe's jnp chains.  Inputs are made with numpy.

Tolerances.  The compute chains' int32, fp32, mixed1 and mixed2 (up to
n = 40, before any float -> int32 convert overflows) values are exact:
the JAX chain and the plain version both compute ``x * a + b``.  fp64:
JAX runs with x64 off, so the reference's "fp64" chain is float32; the
port's is float64 with the same constants, within (n + 1) float32 ulps
plus the constants' float32 rounding ((n + 1) * 2^-22).  The card's
chains (fma, one rounding a step) are emulated here exactly to check
``assert_chain_close``, the comparison the card runs: it passes them and
fails chains with b or a dropped, or half the steps lost.
``mma_probe``: rtol 2e-2, atol 2e-4, as ``tests/test_kernels.py``.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as K
from repro.core.probes import compute as ref_compute
from repro.core.probes import memory as ref_memory
from repro.kernels import probe_chase as ref_chase
from repro.kernels import ref
from repro.kernels.probe_dep_chain import dep_chain_closed_form
from repro_torch import compat
from repro_torch.core.probes import memory
from repro_torch.kernels import _build
from repro_torch.kernels import probe_chase as pc
from repro_torch.kernels import probe_dep_chain as pdc
from repro_torch.kernels import probe_mma as pm


# ------------------------------------------------------------------ #
# chase
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("rows,steps", [(16, 50), (64, 200)])
def test_chase_matches_reference_kernel(rows, steps):
    buf = pc.make_chase_buffer(rows)
    want = int(K.chase(jnp.asarray(buf.numpy()), steps, interpret=True))
    got = pc.chase(buf, steps)
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == want == pc.chase_reference(buf.numpy(), steps)


@pytest.mark.parametrize("rows,seed", [(1, 0), (2, 0), (16, 0), (64, 3),
                                       (1000, 7), (4096, 1)])
def test_make_chase_buffer_bit_identical(rows, seed):
    want = np.asarray(ref_chase.make_chase_buffer(rows, seed))
    got = pc.make_chase_buffer(rows, seed)
    assert got.dtype == torch.int32 and got.shape == (rows, 128)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,seed", [(16, 0), (17, 1), (1000, 2), (4096, 0),
                                    (5000, 9)])
def test_permutation_chain_bit_identical(n, seed):
    want = ref_memory._permutation_chain(n, seed)
    got = memory._permutation_chain(n, seed)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", ["flat", "column"])
def test_chase_flat_chain(shape):
    nxt = memory._permutation_chain(1000, 4)
    buf = torch.from_numpy(nxt.copy())
    if shape == "column":
        buf = buf.view(-1, 1)
    got = pc.chase_timed(buf, 777)
    assert got.index == pc.chase_reference(nxt[:, None], 777)
    assert got.cycles is None and got.ns is None    # plain: not timed


# ------------------------------------------------------------------ #
# dep_chain
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("chain_len,ilp", [(10, 1), (100, 2), (57, 4)])
def test_dep_chain_matches_reference_kernel(chain_len, ilp):
    x = np.random.default_rng(chain_len).standard_normal(
        (ilp, 8, 128)).astype(np.float32)
    want = np.asarray(K.dep_chain(jnp.asarray(x), chain_len, ilp=ilp,
                                  interpret=True))
    got = pdc.dep_chain(torch.from_numpy(x), chain_len, ilp=ilp).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    closed = np.asarray(dep_chain_closed_form(jnp.asarray(x), chain_len))
    np.testing.assert_allclose(got, closed, rtol=1e-4)
    torch.testing.assert_close(
        pdc.dep_chain_closed_form(torch.from_numpy(x), chain_len),
        torch.from_numpy(closed), rtol=1e-6, atol=1e-6)


def _ref_chain(workload, n, lanes):
    """The reference compute probe's chain output, as numpy arrays keyed
    like the port's values."""
    if workload in ("int32", "fp32", "fp64"):
        dtype = {"int32": jnp.int32, "fp32": jnp.float32,
                 "fp64": jnp.float64}[workload]
        key = {"int32": "int", "fp32": "float", "fp64": "double"}[workload]
        return {key: np.asarray(ref_compute._make_chain(n, lanes, dtype)())}
    make = (ref_compute._make_mixed1 if workload == "mixed1"
            else ref_compute._make_mixed2)
    xi, xf = make(n, lanes)()
    return {"int": np.asarray(xi), "float": np.asarray(xf)}


@pytest.mark.parametrize("lanes", [1, 4096])
@pytest.mark.parametrize("workload,n", [
    (w, n) for w in ("int32", "mixed1", "fp32", "fp64")
    for n in (0, 1, 7, 256)] + [("mixed2", n) for n in (0, 1, 7, 40)])
def test_chain_values_match_reference(workload, n, lanes):
    want = _ref_chain(workload, n, lanes)
    run = pdc.run_chain(workload, n, lanes, device="cpu")
    assert run.cycles is None
    assert set(run.values) == set(want)
    for key, w in want.items():
        g = run.values[key]
        assert g.shape == (1, lanes)
        g = g.numpy().reshape(w.shape)
        if key in ("int", "float"):
            np.testing.assert_array_equal(g, w)
        else:
            assert w.dtype == np.float32 and g.dtype == np.float64
            np.testing.assert_allclose(g, w, rtol=(n + 1) * 2.0 ** -22,
                                       atol=0)


def _fma_chain(workload, n, lanes=4, a=None, b=None):
    """The card's timed chain, emulated exactly: ``fma.rn.f32`` as the
    float64 ``x * a + b`` rounded once to float32 (exact in float64
    here: x in [1, 2) times a is 48 bits, and b = 1e-7's last bit is
    2^-47), ``fma.rn.f64`` in rational arithmetic rounded once.  Keyed
    like ``ChainRun.values``; mixed1's int chain is the plain one."""
    a = pdc.FLOAT_INIT[1] if a is None else a
    b = pdc.FLOAT_INIT[2] if b is None else b
    if workload == "fp64":
        x = pdc.FLOAT_INIT[0]
        for _ in range(n):
            x = float(Fraction(x) * Fraction(a) + Fraction(b))
        return {"double": torch.full((1, lanes), x, dtype=torch.float64)}
    x = np.full((1, lanes), pdc.FLOAT_INIT[0], np.float32)
    a64, b64 = np.float64(np.float32(a)), np.float64(np.float32(b))
    for _ in range(n):
        x = (x.astype(np.float64) * a64 + b64).astype(np.float32)
    out = {"float": torch.from_numpy(x)}
    if workload == "mixed1":
        out["int"] = pdc.chain_plain("int32", n, lanes)["int"]
    return out


@pytest.mark.parametrize("n", [0, 1, 7, 40, 256, 1024])
@pytest.mark.parametrize("workload", ["fp32", "mixed1", "fp64"])
def test_chain_comparison_passes_the_fma_chain(workload, n):
    """The card's fma chain meets ``assert_chain_close`` against the
    plain multiply-and-add: exactly in fp32 and mixed1."""
    got = _fma_chain(workload, n)
    want = pdc.chain_plain(workload, n, 4)
    pdc.assert_chain_close(got, want, n)
    if workload != "fp64":
        assert torch.equal(got["float"], want["float"])


@pytest.mark.parametrize("n", [1, 7, 40, 256])
@pytest.mark.parametrize("fault", ["b=0", "a=1", "half the steps"])
@pytest.mark.parametrize("workload", ["fp32", "mixed1", "fp64"])
def test_chain_comparison_catches_a_wrong_chain(workload, fault, n):
    """A chain that drops b or a, or loses half its steps, fails the
    comparison at every length."""
    kw = {"b=0": {"b": 0.0}, "a=1": {"a": 1.0}}.get(fault, {})
    got = _fma_chain(workload, n // 2 if fault == "half the steps" else n,
                     **kw)
    with pytest.raises(AssertionError):
        pdc.assert_chain_close(got, pdc.chain_plain(workload, n, 4), n)


def _round_f32(q):
    """The float32 nearest the rational ``q``, ties to even."""
    r = np.float32(float(q))
    cands = (np.nextafter(r, np.float32(-np.inf)), r,
             np.nextafter(r, np.float32(np.inf)))
    return float(min(cands, key=lambda c: (
        abs(Fraction(float(c)) - q),
        int(np.array(c).view(np.int32)) & 1)))


@pytest.mark.parametrize("b,passes", [(0.5, True), (0.0, False)])
def test_chain_comparison_of_the_public_dep_chain(b, passes):
    """The public chain (a = 1.0001, b = 0.5 from random x) is held
    within (n + 1) ulps: an exact fma chain passes, one without b fails."""
    n = 10
    x = np.random.default_rng(0).standard_normal(8 * 128).astype(np.float32)
    a = Fraction(float(np.float32(1.0001)))
    got = []
    for v in x.tolist():
        for _ in range(n):
            v = _round_f32(Fraction(v) * a + Fraction(b))
        got.append(v)
    got = {"float": torch.tensor(got, dtype=torch.float32).view(1, 8, 128)}
    want = {"float": pdc.dep_chain_plain(torch.from_numpy(x).view(1, 8, 128),
                                         n)}
    if passes:
        pdc.assert_chain_close(got, want, n, reference_constants=False)
    else:
        with pytest.raises(AssertionError):
            pdc.assert_chain_close(got, want, n, reference_constants=False)


def test_mixed2_overflows_past_chain_40():
    """Up to n = 40 mixed2's values stay far inside int32; by n = 64 its
    float -> int32 convert has overflowed (the int chain went negative),
    and the values are implementation-defined: only the chain's data
    dependence is kept there, so they are not compared."""
    v40 = pdc.run_chain("mixed2", 40, 1, device="cpu").values
    assert 0 < int(v40["int"][0, 0]) < 2 ** 24
    assert 0 < float(v40["float"][0, 0]) < 2 ** 24
    v64 = pdc.run_chain("mixed2", 64, 1, device="cpu").values
    assert int(v64["int"][0, 0]) < 0


# ------------------------------------------------------------------ #
# mma_probe
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("ilp,bm,dtype", [
    (1, 128, np.float32), (2, 64, np.float32), (4, 128, np.float32),
    (2, 128, "bfloat16")])
def test_mma_probe_matches_reference_kernel(ilp, bm, dtype):
    rng = np.random.default_rng(ilp * 10 + bm)
    x = rng.standard_normal((ilp, 256, 256)).astype(np.float32)
    y = rng.standard_normal((256, 128)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    xj, yj = jnp.asarray(x).astype(jdt), jnp.asarray(y).astype(jdt)
    want = K.mma_probe(xj, yj, bm=bm, bn=128, bk=128, ilp=ilp,
                       interpret=True)
    xt = torch.from_numpy(x).to(tdt)
    yt = torch.from_numpy(y).to(tdt)
    got = pm.mma_probe(xt, yt, bm=bm, bn=128, bk=128, ilp=ilp)
    assert got.dtype == tdt and got.shape == (ilp, 256, 128)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-4)
    np.testing.assert_allclose(
        got.float().numpy(),
        np.asarray(ref.matmul_ref(xj, yj).astype(jnp.float32)),
        rtol=2e-2, atol=2e-4)


def test_mma_probe_checks_tiles_like_the_reference():
    x, y = torch.zeros(2, 256, 256), torch.zeros(256, 128)
    with pytest.raises(ValueError):
        pm.mma_probe(x, y, bm=96, ilp=2)
    with pytest.raises(ValueError):
        pm.mma_probe(x, y, ilp=1)


# ------------------------------------------------------------------ #
# the wrappers: CPU -> plain, CUDA -> kernel or raise
# ------------------------------------------------------------------ #

def test_probe_kernel_paths_without_library_raise(monkeypatch):
    """The CUDA path with no compiler raises; no fallback, no count."""
    monkeypatch.setattr(compat, "nvcc_path", lambda: None)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR / "absent")
    before = (pdc.dep_chain.launches, pc.chase.launches,
              pm.mma_probe.launches)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        pdc._launch("fp32", {"float": torch.ones(1, 1024)}, 10, True)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        pc._launch(pc.make_chase_buffer(16), 10)
    x = torch.zeros(1, 2, 32, 32, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        pm._launch(x, x, torch.float32)
    assert (pdc.dep_chain.launches, pc.chase.launches,
            pm.mma_probe.launches) == before


def test_chase_takes_the_reference_layouts_only():
    with pytest.raises(ValueError, match="128"):
        pc.chase(torch.zeros(16, 64, dtype=torch.int32), 3)


def test_probe_wrappers_refuse_other_devices():
    with pytest.raises(ValueError, match="cuda"):
        pdc.dep_chain(torch.zeros(1, 8, 128, device="meta"), 3)
    with pytest.raises(ValueError, match="cuda"):
        pdc.run_chain("fp32", 3, device="meta")
    with pytest.raises(ValueError, match="cuda"):
        pc.chase(torch.zeros(16, 128, dtype=torch.int32, device="meta"), 3)
    with pytest.raises(ValueError, match="cuda"):
        pm.mma_probe(torch.zeros(1, 128, 128, device="meta"),
                     torch.zeros(128, 128, device="meta"))


def test_plain_versions_count_calls_not_launches():
    launches = (pdc.dep_chain.launches, pc.chase.launches,
                pm.mma_probe.launches)
    calls = (pdc.dep_chain_plain.calls, pc.chase_plain.calls,
             pm.mma_probe_plain.calls)
    pdc.dep_chain(torch.ones(1, 8, 128), 3)
    pdc.run_chain("int32", 3, device="cpu")
    pc.chase(pc.make_chase_buffer(16), 5)
    pm.mma_products(torch.ones(1, 1, 16, 16), torch.ones(1, 1, 16, 8))
    assert (pdc.dep_chain.launches, pc.chase.launches,
            pm.mma_probe.launches) == launches
    assert (pdc.dep_chain_plain.calls, pc.chase_plain.calls,
            pm.mma_probe_plain.calls) == tuple(c + d for c, d in
                                               zip(calls, (2, 1, 1)))


def test_jax_runs_x64_off():
    """The fp64 comparison above rests on this."""
    assert not jax.config.jax_enable_x64
