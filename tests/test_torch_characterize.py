"""The port's characterization layer (``repro_torch.core``) and its entry
point (``repro_torch.launch.characterize``) against the JAX package's
``repro.core`` and ``examples/characterize.py``, on the CPU."""

import dataclasses
import math
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import device_model as ref_dm
from repro.core import report as ref_report
from repro.core import timing as ref_timing
from repro.core.probes import compute as ref_compute
from repro.core.probes import matmul as ref_matmul
from repro.core.probes import memory as ref_memory
from repro.core.probes import precision as ref_precision
from repro_torch.core import device_model as dm
from repro_torch.core import report, timing
from repro_torch.core.probes import compute, matmul, memory, precision
from repro_torch.launch import characterize

ROOT = pathlib.Path(__file__).resolve().parents[1]


# ------------------------------------------------------------------ #
# device models
# ------------------------------------------------------------------ #

def test_registry_equals_reference_field_for_field():
    assert list(dm.REGISTRY) == list(ref_dm.REGISTRY)
    for name, ref in ref_dm.REGISTRY.items():
        got = dm.REGISTRY[name]
        assert [f.name for f in dataclasses.fields(got)] == \
            [f.name for f in dataclasses.fields(ref)]
        assert dataclasses.asdict(got) == dataclasses.asdict(ref), name
        assert dm.get_device_model(name).hbm == got.hbm
        assert got.peak_flops_for("float4_e2m1fn") == \
            ref.peak_flops_for("float4_e2m1fn")


@pytest.mark.parametrize("name,sms,l2,want", [
    ("NVIDIA H100 80GB HBM3", 132, 50 << 20, "h100-sxm5"),
    ("NVIDIA H100 PCIe", 114, 50 << 20, "gh100-h100-pcie"),
    ("NVIDIA H100 NVL", 132, 50 << 20, "nvidia-h100-nvl"),
    ("NVIDIA H200", 132, 50 << 20, "nvidia-h200"),
])
def test_part_detection(name, sms, l2, want):
    """The H100 SXM and PCIe parts are known; any other card raises,
    naming its properties, rather than getting guessed peaks."""
    if want in dm.PARTS:
        assert dm.part_for(name, sms, l2).name == want
    else:
        with pytest.raises(ValueError, match=f"{name!r} \\({sms} SMs"):
            dm.part_for(name, sms, l2)


def test_part_models():
    sxm = dm.H100_SXM
    assert sxm.kind == "gpu" and sxm.clock_hz == 1.98e9
    assert sxm.hbm.bandwidth_Bps == 3.35e12
    assert sxm.peak_flops["bfloat16"] == 989e12
    assert sxm.peak_flops["float32"] == 494.5e12          # TF32
    assert math.isclose(sxm.vector_flops["float32"], 66.9e12, rel_tol=1e-3)
    with pytest.raises(ValueError, match="known parts"):
        dm.part_for("Some GPU", 66, 25 << 20)
    pcie = dm.part_for("NVIDIA H100 PCIe", 114, 50 << 20)
    assert (pcie.hbm.bandwidth_Bps, pcie.peak_flops["bfloat16"],
            pcie.vector_flops["float32"]) == (2000e9, 756e12, 51.2e12)
    assert dm.detect_backend_model("cpu") is dm.HOST_CPU
    assert dm.torch_device(dm.HOST_CPU) == torch.device("cpu")
    with pytest.raises(ValueError, match="tpu"):
        dm.torch_device(dm.TPU_V5E)


# ------------------------------------------------------------------ #
# timing and report helpers: identical output on identical input
# ------------------------------------------------------------------ #

def _results(mod, medians):
    return [mod.TimingResult(median_s=m, mean_s=m, min_s=m, std_s=0.0,
                             iters=3, warmup=1, overhead_s=0.0)
            for m in medians]


@pytest.mark.parametrize("total,base,n", [(2e-6, 1e-6, 256), (1e-6, 2e-6, 4),
                                          (3e-6, 1e-6, 0)])
def test_amortized_ns_and_friends(total, base, n):
    got = timing.amortized_ns(*_results(timing, (total, base)), n)
    want = ref_timing.amortized_ns(*_results(ref_timing, (total, base)), n)
    assert got == want
    xs = [total, base, 0.0, -1.0, n]
    assert timing.geomean(xs) == ref_timing.geomean(xs)
    assert timing.to_cycles(total, 1.98e9) == \
        ref_timing.to_cycles(total, 1.98e9)
    r = _results(timing, (total,))[0]
    assert (r.per(n), r.median_us, r.median_ns) == (
        total / max(n, 1), total * 1e6, total * 1e9)


def test_time_fn_on_the_host():
    r = timing.time_fn(lambda x: x * 2, torch.ones(8), iters=5, warmup=1,
                       keep_samples=True)
    assert [f.name for f in dataclasses.fields(r)] == \
        [f.name for f in dataclasses.fields(ref_timing.TimingResult)]
    assert r.iters == 5 and len(r.samples) == 5 and r.median_s >= 0
    assert r.overhead_s == timing.timer_overhead() > 0


def test_tables_identical():
    curve = [memory.ChasePoint(1 << p, 1.5 * p, 3.25 * p)
             for p in range(12, 16)]
    ref_curve = [ref_memory.ChasePoint(*dataclasses.astuple(c))
                 for c in curve]
    assert report.dataclass_table(curve) == \
        ref_report.dataclass_table(ref_curve)
    assert report.dataclass_table(curve, ["ns_per_load"]) == \
        ref_report.dataclass_table(ref_curve, ["ns_per_load"])
    assert report.dataclass_table([]) == ref_report.dataclass_table([])
    rows = [{"a": 1.0, "b": 123456.0, "c": 1e-4, "d": "x"}]
    assert report.csv_rows("n", rows) == ref_report.csv_rows("n", rows)
    rep, ref_rep = report.Report("T"), ref_report.Report("T")
    for r in (rep, ref_rep):
        r.add_table("h", curve if r is rep else ref_curve, note="n")
    assert rep.render() == ref_rep.render()


@pytest.mark.parametrize("ns", [
    (10, 10, 15, 16, 40, 41, 41, 90),
    (5, 5, 5, 5),
    (1, 2, 4, 8, 16),
    (3, 2, 1, 10, 9, 8),
])
def test_find_boundaries_identical(ns):
    curve = [memory.ChasePoint(1 << (12 + i), float(v), float(v) * 2)
             for i, v in enumerate(ns)]
    ref_curve = [ref_memory.ChasePoint(*dataclasses.astuple(c))
                 for c in curve]
    assert memory.find_boundaries(curve) == \
        ref_memory.find_boundaries(ref_curve)
    assert memory.find_boundaries(curve, jump=2.0) == \
        ref_memory.find_boundaries(ref_curve, jump=2.0)


@pytest.mark.parametrize("tflops", [
    (1.0, 2.0, 3.0, 2.9, 3.05, 1.0),
    (5.0, 5.0, 5.0),
    (0.1, 0.5, 0.2, 0.49),
])
def test_saturation_point_identical(tflops):
    grid = [(b, i) for b in (1, 4, 16) for i in (1, 2)][:len(tflops)]
    pts = [matmul.MatmulPoint(128, 128, 128, "bfloat16", b, i, 1.0, t, True)
           for (b, i), t in zip(grid[::-1], tflops)]
    ref_pts = [ref_matmul.MatmulPoint(*dataclasses.astuple(p)) for p in pts]
    got = matmul.saturation_point(pts)
    want = ref_matmul.saturation_point(ref_pts)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


# ------------------------------------------------------------------ #
# the probes' arithmetic against the reference
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("batch,ilp", [(1, 1), (2, 3), (3, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mm_ilp_matches_reference(batch, ilp, dtype):
    rng = np.random.default_rng(batch * 7 + ilp)
    a = rng.standard_normal((batch, ilp, 32, 48)).astype(np.float32)
    b = rng.standard_normal((batch, ilp, 48, 24)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = np.asarray(ref_matmul._mm_ilp(jnp.asarray(a).astype(jdt),
                                         jnp.asarray(b).astype(jdt), ilp))
    got = matmul._mm_ilp(torch.from_numpy(a).to(tdt),
                         torch.from_numpy(b).to(tdt), ilp)
    assert got.dtype == torch.float32 and got.shape == (batch,)
    # one fp32 sum of 32 * 24 products of length 48, in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)


def test_mm_ilp_pads_off_fragment_shapes():
    g = torch.Generator().manual_seed(0)
    a = torch.randn((2, 2, 17, 20), generator=g)
    b = torch.randn((2, 2, 20, 9), generator=g)
    want = torch.einsum("bimk,bikn->bimn", a, b).sum(dim=(1, 2, 3))
    torch.testing.assert_close(matmul._mm_ilp(a, b, 2), want)


def test_host_sweeps_keep_the_reference_fields():
    ramp = compute.ilp_ramp("mixed1", lengths=(1, 4), lanes=8,
                            device=dm.HOST_CPU, iters=1)
    assert [p.chain_len for p in ramp] == [1, 4]
    assert all(p.total_ns > 0 and p.ops_per_cycle > 0 for p in ramp)
    assert [f.name for f in dataclasses.fields(ramp[0])] == \
        [f.name for f in dataclasses.fields(ref_compute.RampPoint)]
    sweep = memory.stride_sweep(strides=(1, 4), concurrencies=(1, 2),
                                accesses=64, working_set_bytes=1 << 12,
                                iters=1, device=dm.HOST_CPU)
    assert [(p.stride, p.concurrency) for p in sweep] == [
        (1, 1), (1, 2), (4, 1), (4, 2)]
    conc = memory.concurrency_scaling(streams_list=(1, 3), total_bytes=1 << 12,
                                      iters=1, device=dm.HOST_CPU)
    assert [p.streams for p in conc] == [1, 3]
    assert all(p.aggregate_gbps > 0 for p in conc)
    pts = matmul.tile_sweep(shapes=[(16, 8, 16), (17, 9, 20)],
                            device=dm.HOST_CPU, iters=1)
    assert [p.aligned for p in pts] == [True, False]    # 8 x 8 tile


def test_strided_reduce_equals_reference():
    x = np.arange(1 << 10, dtype=np.float32)
    got = memory._strided_reduce(torch.from_numpy(x), 4, 3, 100)
    want = ref_memory._strided_reduce(jnp.asarray(x), 4, 3, 100)
    assert float(got) == float(want)


def test_measure_matmul_on_the_host():
    p = matmul.measure_matmul(32, 16, 32, "bfloat16", batch=2, ilp=2,
                              device=dm.HOST_CPU, iters=2)
    assert (p.m, p.n, p.k, p.batch, p.ilp, p.aligned) == (32, 16, 32, 2, 2,
                                                          True)
    assert p.runtime_ms > 0 and p.tflops > 0
    assert not matmul.measure_matmul(12, 16, 32, device=dm.HOST_CPU,
                                     iters=1).aligned     # 8 x 8 tile


def test_support_matrix_shared_fields_equal_reference():
    shared = ("fmt", "bits", "max_finite", "representable", "compat_name")
    for dev in (dm.HOST_CPU, dm.H100_SXM):
        got = precision.support_matrix(dev) if dev.kind == "cpu" else None
        if got is None:
            continue
        want = ref_precision.support_matrix()
        assert [tuple(getattr(r, f) for f in shared) for r in got] == \
            [tuple(getattr(r, f) for f in shared) for r in want]
        assert [f.name for f in dataclasses.fields(got[0])] == \
            [f.name for f in dataclasses.fields(want[0])]
    assert precision.FORMAT_INFO == ref_precision.FORMAT_INFO
    assert precision._COMPAT_NAME == ref_precision._COMPAT_NAME


def test_support_matrix_on_hopper(monkeypatch):
    """On sm_90 fp8 is native and fp6 / fp4 are expanded first."""
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda *a: (9, 0))
    rows = {r.fmt: r for r in precision.support_matrix(dm.H100_SXM)}
    assert rows["e4m3"].native_dot and rows["e5m2"].native_dot
    for f in ("e2m1", "e2m3", "e3m2"):
        assert rows[f].lowers_via_convert and not rows[f].native_dot
        assert "bf16" in rows[f].pipeline


@pytest.mark.parametrize("fmt", ["e2m1", "e2m3", "e3m2", "e4m3", "e5m2"])
def test_cast_error_equals_reference(fmt):
    got = precision.cast_error(fmt, seed=3, n=4096)
    want = ref_precision.cast_error(fmt, seed=3, n=4096)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)


def _np_block_quantize(x, fmt, block=32):
    """The reference's ``block_quantize`` in numpy: scale 2^ceil(log2(
    absmax / fmax)) (log2 in float64, exact powers of two), values cast
    with ``ml_dtypes`` (the reference's dtypes)."""
    import ml_dtypes
    dt = {"e2m1": ml_dtypes.float4_e2m1fn, "e2m3": ml_dtypes.float6_e2m3fn,
          "e3m2": ml_dtypes.float6_e3m2fn, "e4m3": ml_dtypes.float8_e4m3fn,
          "e5m2": ml_dtypes.float8_e5m2}[fmt]
    xb = x.reshape(*x.shape[:-1], x.shape[-1] // block, block)
    absmax = np.abs(xb).max(axis=-1, keepdims=True)
    q32 = np.maximum(absmax, 1e-30).astype(np.float32) / np.float32(
        ref_precision.FORMAT_INFO[fmt]["max"])
    exp = np.ceil(np.log2(q32.astype(np.float64)))
    scale = np.ldexp(np.float32(1), exp.astype(np.int32))
    q = (xb / scale).astype(dt).astype(np.float32)
    return q.reshape(x.shape), scale[..., 0]


@pytest.mark.parametrize("fmt", ["e2m1", "e2m3", "e3m2", "e4m3", "e5m2"])
def test_block_quantize_matches_reference(fmt):
    """Bit for bit with the numpy oracle of the reference's definition;
    against the reference itself where its JAX can cast to the format (not
    fp6) and where its float32 log2 / exp2 give the same power of two (a
    few ulps off beyond |e| ~ 12: e5m2's blocks; see ROADMAP Queue 3)."""
    x = (np.random.default_rng(1).standard_normal((8, 64)) * 4.0
         ).astype(np.float32)
    q, s = precision.block_quantize(torch.from_numpy(x), fmt)
    nq, ns = _np_block_quantize(x, fmt)
    np.testing.assert_array_equal(s.numpy(), ns)
    np.testing.assert_array_equal(q.float().numpy(), nq)
    y = precision.block_dequantize(q, s)
    np.testing.assert_array_equal(
        y.numpy(), (nq.reshape(8, 2, 32) * ns[..., None]).reshape(8, 64))
    if fmt not in ("e2m3", "e3m2"):
        rq, rs = ref_precision.block_quantize(jnp.asarray(x), fmt)
        rs = np.asarray(rs)
        np.testing.assert_allclose(s.numpy(), rs, rtol=1e-6)
        same = np.repeat(s.numpy() == rs, 32, axis=-1)
        assert same.mean() > 0.5
        np.testing.assert_array_equal(
            q.float().numpy()[same],
            np.asarray(rq).astype(np.float32)[same])
        ry = np.asarray(ref_precision.block_dequantize(rq, jnp.asarray(rs)))
        np.testing.assert_allclose(y.numpy(), ry, rtol=1e-5, atol=1e-30)
    err = precision.block_roundtrip_error(fmt)
    assert 0 < err < 0.5       # fp4: ~0.24 on N(0, 16)


# ------------------------------------------------------------------ #
# the entry point
# ------------------------------------------------------------------ #

def _reference_headings():
    src = (ROOT / "examples" / "characterize.py").read_text()
    heads = re.findall(r'print\("(== .* ==)"\)', src)
    cols = re.findall(r'\["(fmt|workload)"[^\]]*\]', src)
    assert len(heads) == 6 and cols
    return heads


def test_characterize_cpu_prints_the_reference_sections():
    lines = []
    out = characterize.run(
        "cpu", latency_iters=1,
        sweep=dict(batches=(1, 2), ilps=(1, 2), iters=1, m=32, n=16, k=32),
        chase_sizes=(1 << 12, 1 << 14), chase_steps=64, chase_iters=1,
        bw_bytes=1 << 16, bw_iters=1, log=lines.append)
    text = "\n".join(lines)
    for head in _reference_headings():
        assert head in text
    for columns in ("| workload | support | true_cycles | completion_cycles |",
                    "| fmt | bits | representable | pipeline |",
                    "| working_set_bytes | ns_per_load | cycles_per_load |",
                    "| mode | nbytes | gbps |"):
        assert columns in text
    assert "backend device model: host-cpu" in text
    assert "saturates at tiles=" in text and "fp64/fp32 = " in text
    assert len(out["latency"]) == 5 and len(out["chase"]) == 2
    assert len(out["matmul"]) == 4 and len(out["bandwidth"]) == 3
    assert "paper GH100" not in text          # card-only section


def test_paper_rows_name_every_figure():
    lat = [compute.LatencyResult(w, "native", 1.0, 2.0, 4.0, 8.0)
           for w in ("int32", "fp32", "fp64", "mixed1", "mixed2")]
    curve = [memory.ChasePoint(1 << p, 10.0 * p, 20.0 * p)
             for p in range(14, 27, 2)]
    out = {"clock_hz": 1.98e9, "timer_overhead_cycles": 2.0,
           "latency": lat, "fp64_factor": 1.5, "chase": curve,
           "boundaries": [1 << 16],
           "saturation": matmul.MatmulPoint(128, 128, 128, "bfloat16", 16,
                                            4, 0.03, 8.5, True),
           "bandwidth": [memory.BandwidthResult(m, 1 << 28, g)
                         for m, g in (("read", 2.0), ("write", 1.0),
                                      ("copy", 1.5))]}
    rows = characterize.paper_rows(out)
    names = [r[0] for r in rows]
    assert len(names) == len(set(names)) == 2 + 10 + 1 + 4 + 1 + 3 + 1
    table = dict((r[0], r[1:]) for r in rows)
    assert table["fp32 completion (cycles)"][:2] == [8.0, 7.86]
    assert table["chase L2 (cycles/load)"][0] == 20.0 * 22   # 1..16 MiB
    assert table["read/write ratio"][0] == 2.0


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_probe_entry_points_default_to_the_card(no_card):
    for call in (lambda: compute.latency_table(),
                 lambda: compute.ilp_ramp(),
                 lambda: memory.pointer_chase(1 << 12),
                 lambda: memory.stream_bandwidth(1 << 12),
                 lambda: matmul.measure_matmul(16, 8, 16),
                 lambda: precision.support_matrix(),
                 lambda: dm.detect_backend_model(),
                 lambda: characterize.main([])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
