"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips on a host without a CUDA device.  The
GPU machine has no JAX, and ``tests/conftest.py`` imports it, so run
this file there without the conftest:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        -m cuda tests/test_torch_cuda.py

Tolerances.  ``flash_decode`` / ``flash_decode_quant``, by the q (and
dequantized cache) dtype: fp32 atol=rtol=1e-5 (summation order); bf16
atol 2e-2 (the plain version rounds p to bf16 before PV, as the
reference does; the kernel keeps p in fp32).  Their split schedule is
held to the same tolerances on its edges (rows whose visible slots lie
in one split, S not a multiple of splits x tile, the most splits, a
wrapped window across splits, every split of a row empty, copies
narrower than 16 bytes), and two calls must give the same bits.  ``qmatmul`` /
``qmatmul_packed``: fp32 output rtol 1e-5, atol 1e-4 * sqrt(k / 1024)
(only the summation order differs); bf16 output within 2 bf16 ulps of
the plain version plus that fp32 tolerance; packed bit-identical to the
container kernel, on the narrow (m <= 64) and the wide path; two calls
bit-identical.  The ``wgmma.cuh`` unit tiles (both operands in shared
memory; A in registers with B MN-major): rtol 1e-5, atol 1e-5 against
an fp32 product of the same bf16 operands (exact products, only the
summation order differs).  Probe kernels: ``chase`` exact; ``dep_chain``
(``probe_dep_chain.assert_chain_close``): the compute workloads' int32,
fp32, mixed1 and mixed2 (up to chain 40) values exact, fp64 and the
public chain (a = 1.0001, b = 0.5) within (n + 1) ulps (fma against the
plain version's multiply and add);
``mma_probe`` bf16 / fp16 out within 1 ulp of the type + 1e-5 sqrt(k),
TF32 atol 2^-8 sqrt(k), fp32 out from bf16 / fp16 inputs atol 1e-5
sqrt(k).  ``ssd_scan``
(the kernel in split TF32, the plain version in fp32, unit-scale
inputs): y and the final state atol 2e-4, the tolerance of the reference's own kernel test against its
sequential oracle (``tests/test_kernels.py``); a bf16 y may also
differ by one bf16 ulp (rtol 2^-7: both sides round their fp32 y to
bf16); its backward ``ssd_scan_bwd`` (fp32 on the CUDA cores) against
``ssd_scan_bwd_plain`` within atol 1e-4 x the largest magnitude of each
gradient (fp32 sums in another order), a bf16 gradient also within one
bf16 ulp.  ``flash_attention``, the tolerances of the reference's own
kernel test (``tests/test_kernels.py``): fp32 atol 2e-5; bf16 atol 2e-2
(the plain version rounds the normalized p to bf16 before PV, as the
reference does, the kernel the running-max p; both accumulate in fp32),
over the rows that see a key; a row that sees none must be 0.  The
sampler (``serve.prng``, ``serve.sampler``): threefry draws and
uniforms bit-identical on card and CPU, gumbel values within atol 2e-6
(``log`` may differ by an ulp between the two), sampled tokens equal;
the gemma2 / gemma-2b reduced engines (fp32, TF32 off) give the CPU's
streams, greedy and sampled; so do the seamless and internvl2 reduced
engines, whose cross-attention decode (query position 2^30 over a ring
with a tail of empty slots) and non-causal head_dim-64 attention are
held to the plain versions at seamless's full-width shapes.  NVML
(``core.nvml``): the card's NVML device found by torch's UUID with
torch's name; the energy counter rises under a matmul loop, and the
mean and instant power lie within 1.05 x the enforced limit.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch import compat
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import (
    flash_attention, flash_attention_plain)
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
from repro_torch.kernels.flash_decode import plan as fd_plan
from repro_torch.kernels import probe_chase as pc
from repro_torch.kernels import probe_dep_chain as pdc
from repro_torch.kernels import probe_mma as pm
from repro_torch.kernels.flash_decode_quant import (
    flash_decode_quant, flash_decode_quant_plain)
from repro_torch.kernels.flash_decode_quant import plan as fdq_plan
from repro_torch.kernels.qmatmul import (
    pack_for_qmatmul, plan, qmatmul, qmatmul_packed, qmatmul_packed_plain,
    qmatmul_plain, quantize_for_qmatmul, wgmma_unit_tile)
from repro_torch.kernels.flash_attention import wgmma_rs_unit_tile
from repro_torch.kernels.ssd_scan import plan as ssd_plan
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
from repro_torch.models import attention as attn
from repro_torch.models.model import build_model
from repro_torch.serve import ServeEngine, prng, sampler

pytestmark = pytest.mark.cuda

F32, BF16 = torch.float32, torch.bfloat16
TOL = {F32: dict(atol=1e-5, rtol=1e-5), BF16: dict(atol=2e-2, rtol=0.0)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(seed, b, S, hq, hkv, d, q_dtype, kv_dtype, pos, ring=False):
    rng = np.random.default_rng(seed)

    def t(shape, dtype):
        return torch.from_numpy(
            rng.standard_normal(shape, np.float32)).to("cuda", dtype)

    q = t((b, 1, hq, d), q_dtype)
    k, v = t((b, S, hkv, d), kv_dtype), t((b, S, hkv, d), kv_dtype)
    sp = np.full((b, S), -1, np.int32)
    for r, p in enumerate(pos):
        written = np.arange(max(0, p - S + 1) if ring else 0,
                            min(p + 1, S) if not ring else p + 1)
        sp[r, written % S] = written
    pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    return q, k, v, torch.from_numpy(sp).cuda(), pos


def _check(q, k, v, sp, pos, **flags):
    got = flash_decode(q, k, v, sp, pos, **flags)
    torch.cuda.synchronize()
    want = flash_decode_plain(q, k, v, sp, pos, **flags)
    ok = (sp >= 0) & (sp <= pos[:, None])
    if flags.get("window") is not None:
        ok &= sp > pos[:, None] - flags["window"]
    rows = ok.any(dim=1)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[rows].float(), want[rows].float(),
                               **TOL[k.dtype])
    assert (got[~rows] == 0).all()


@pytest.mark.parametrize("d", [16, 32, 64, 96, 128, 256])
@pytest.mark.parametrize("dtypes", [(F32, F32), (BF16, BF16), (F32, BF16)],
                         ids=["f32", "bf16", "f32q_bf16kv"])
def test_head_dims_and_dtypes(cuda, d, dtypes):
    _check(*_inputs(d, 3, 200, 4, 2, d, *dtypes, pos=[199, 57, 130]))


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1), (16, 1),
                                    (24, 2), (12, 4)])
def test_gqa_ratios(cuda, hq, hkv):
    """Ratios 1..16, including groups wider than one block (16, 12)."""
    _check(*_inputs(hq * 10 + hkv, 2, 130, hq, hkv, 64, F32, F32,
                    pos=[129, 64]))


@pytest.mark.parametrize("S", [1, 63, 64, 65, 1000])
def test_capacity_edges(cuda, S):
    _check(*_inputs(S, 2, S, 4, 2, 32, F32, F32, pos=[S - 1, S // 2]))


@pytest.mark.parametrize("window,softcap", [(64, None), (None, 20.0),
                                            (32, 10.0)])
def test_window_softcap_on_wrapped_ring(cuda, window, softcap):
    _check(*_inputs(7, 2, 96, 4, 2, 32, F32, F32, pos=[245, 300],
                    ring=True), window=window, softcap=softcap)


def test_rows_without_visible_slot(cuda):
    q, k, v, sp, pos = _inputs(9, 4, 128, 4, 4, 64, BF16, BF16,
                               pos=[127, 5, 60, 90])
    sp[1] = -1
    pos[3] = -1                      # every slot lies ahead of this row
    _check(q, k, v, sp, pos)


def test_strided_cache_and_launch_count(cuda):
    """A cache stored (b, hkv, S, d) and passed as a (b, S, hkv, d) view;
    one launch counted per call."""
    q, k, v, sp, pos = _inputs(11, 2, 80, 8, 2, 64, F32, F32, pos=[79, 40])
    before = flash_decode.launches
    _check(q, k.transpose(1, 2).contiguous().transpose(1, 2),
           v.transpose(1, 2).contiguous().transpose(1, 2), sp, pos)
    assert flash_decode.launches == before + 1


# the split schedule: splits_for from the shapes alone, the S axis split
# round-robin by 32-slot tile, the splits combined in the launch
SPLIT_CASES = {
    # name: (b, S, hq, hkv, d, pos, ring, window)
    # every visible slot in tile 0: one split works, the others are empty
    "one_split_rows": (4, 512, 8, 8, 64, [0, 5, 20, 31], False, None),
    # S not a multiple of splits x tile (32 splits of a 1000-slot row)
    "S_1000": (2, 1000, 4, 2, 64, [999, 420], False, None),
    "S_333": (3, 333, 4, 2, 32, [332, 100, 250], False, None),
    # one row, one kv-head: the most splits (128 of 4096 slots)
    "long_row_S4096": (1, 4096, 8, 1, 128, [4095], False, None),
    # a 300-slot window of a wrapped 512-slot ring, across the splits
    "window_wrapped": (4, 512, 8, 4, 64, [3000, 2000, 1500, 700], True,
                       300),
}


def _split_case(name, seed, q_dtype, kv_dtype):
    b, S, hq, hkv, d, pos, ring, window = SPLIT_CASES[name]
    x = _inputs(seed, b, S, hq, hkv, d, q_dtype, kv_dtype, pos, ring=ring)
    return x, dict(window=window)


@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
@pytest.mark.parametrize("dtypes", [(F32, F32), (BF16, BF16)],
                         ids=["f32", "bf16"])
def test_split_edges(cuda, name, dtypes):
    (q, k, v, sp, pos), flags = _split_case(name, len(name), *dtypes)
    assert fd_plan(q, k, v, sp, pos, compat.sm_count(0)).splits > 1
    _check(q, k, v, sp, pos, **flags)


def test_split_row_with_every_split_empty(cuda):
    """A row with no visible slot in any split comes out 0, the others
    as the plain version says."""
    q, k, v, sp, pos = _inputs(12, 4, 1024, 8, 8, 64, BF16, BF16,
                               pos=[1023, 300, 40, 700])
    sp[2] = -1
    assert fd_plan(q, k, v, sp, pos, compat.sm_count(0)).splits > 1
    _check(q, k, v, sp, pos)


@pytest.mark.parametrize("dtype,pad,width", [
    (BF16, 1, 2), (BF16, 2, 4), (BF16, 4, 8), (F32, 1, 4), (F32, 2, 8)])
def test_narrow_copies(cuda, dtype, pad, width):
    """A cache view into rows of d + pad elements: copies as wide as the
    row stride allows, the same results."""
    q, k, v, sp, pos = _inputs(13, 3, 300, 8, 4, 128, dtype, dtype,
                               pos=[299, 150, 31])
    kp = torch.zeros((3, 300, 4, 128 + pad), dtype=dtype, device="cuda")
    vp = torch.zeros_like(kp)
    kp[..., :128], vp[..., :128] = k, v
    k, v = kp[..., :128], vp[..., :128]
    assert fd_plan(q, k, v, sp, pos, compat.sm_count(0)).widths == (width,)
    _check(q, k, v, sp, pos)


def test_two_calls_bit_identical_and_counters_reset(cuda):
    """The splits are combined in split order, whatever the order of
    arrival: two calls give the same bits, and so does a third after a
    call of another grid (its counters are back at 0)."""
    a = _inputs(14, 8, 1024, 16, 16, 128, BF16, BF16,
                pos=list(range(100, 1001, 128)))
    other = _inputs(15, 1, 4096, 8, 1, 128, BF16, BF16, pos=[4095])
    first = flash_decode(*a)
    second = flash_decode(*a)
    flash_decode(*other)
    third = flash_decode(*a)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))
    assert torch.equal(first.view(torch.int16), third.view(torch.int16))


def test_engine_card_matches_cpu(cuda):
    """gptneox-1b reduced, fp32: the engine on the card gives the CPU's
    greedy streams, and launches the kernel once per layer per step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("gptneox-1b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    streams = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(model, params, batch=2, max_seq=64,
                          decode_block=7, prefill_chunk=4, device=dev)
        eng.submit([1, 2, 3, 4, 5, 6, 7], max_new_tokens=12)
        eng.submit([9, 8, 7], max_new_tokens=4)
        before = flash_decode.launches
        streams[dev] = [(r.status, r.tokens) for r in eng.run()]
        launched = flash_decode.launches - before
        assert launched == (cfg.n_layers * eng.decode_steps
                            if dev == "cuda" else 0)
    assert streams["cuda"] == streams["cpu"]


def test_sampler_card_matches_cpu(cuda):
    """The threefry draws on the card are the CPU's bit for bit (uniforms
    too), gumbel values within 2e-6 (``log`` may differ by an ulp), and
    the sampled tokens equal, at the full vocabulary of gemma2-2b."""
    key = prng.fold_in(prng.prng_key(3), torch.tensor(7))
    keys = sampler.fold_slot_keys(prng.prng_key(3),
                                  torch.arange(8, dtype=torch.int32),
                                  torch.arange(100, 108, dtype=torch.int32))
    shape = (8, 256000)
    for k in (key, keys):
        assert torch.equal(prng.random_bits(k.cuda(), shape[1:]).cpu(),
                           prng.random_bits(k, shape[1:]))
        u = prng.uniform(k.cuda(), shape[1:], prng.TINY, 1.0).cpu()
        assert torch.equal(u.view(torch.int32),
                           prng.uniform(k, shape[1:], prng.TINY,
                                        1.0).view(torch.int32))
        torch.testing.assert_close(prng.gumbel(k.cuda(), shape[1:]).cpu(),
                                   prng.gumbel(k, shape[1:]), atol=2e-6,
                                   rtol=0)
    logits = torch.from_numpy(np.random.default_rng(4).standard_normal(
        shape, np.float32) * 4)
    seed = torch.arange(8, dtype=torch.int32) * 1000
    pos = torch.arange(8, dtype=torch.int32) + 300
    for temperature, top_k in ((0.8, 8), (1.0, 0), (0.0, 0)):
        args = (prng.prng_key(3), temperature, top_k)
        got = sampler.sample_tokens(logits.cuda(), *args,
                                    slot_seed=seed.cuda(), pos=pos.cuda())
        want = sampler.sample_tokens(logits, *args, slot_seed=seed, pos=pos)
        assert torch.equal(got.cpu(), want)


def _card_vs_cpu_streams(arch, window=None, **kw):
    """An fp32 reduced model's engine on the card and on the CPU (TF32
    off): streams by device, and the decode kernel launches per layer per
    step on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    if window:
        cfg = dataclasses.replace(cfg, sliding_window=window)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    streams = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(model, params, batch=2, max_seq=96,
                          decode_block=7, prefill_chunk=8, device=dev, **kw)
        eng.submit(list(range(1, 41)), max_new_tokens=30)
        eng.submit([9, 8, 7], max_new_tokens=12)
        before = flash_decode.launches
        streams[dev] = [(r.status, r.tokens) for r in eng.run()]
        launched = flash_decode.launches - before
        assert launched == (cfg.n_layers * eng.decode_steps
                            if dev == "cuda" else 0)
    return streams


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_gemma2_engine_card_matches_cpu(cuda, temperature):
    """gemma2-2b reduced, window 16: a 40-token prompt and 30 new tokens
    wrap the local rings in prefill and in decode; greedy and sampled
    (top_k 8, seed 3) streams equal on card and CPU."""
    streams = _card_vs_cpu_streams("gemma2-2b", window=16,
                                   temperature=temperature, top_k=8, seed=3)
    assert streams["cuda"] == streams["cpu"]


def test_sampled_decode_block_makes_no_sync(cuda):
    """The fused loop, sampling included, makes no implicit device-to-host
    synchronization (a host value copied to the card synchronizes too):
    the block's one host read is ``_harvest``'s, after it."""
    cfg = get_config("gemma2-2b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    eng = ServeEngine(model, params, batch=2, max_seq=64, temperature=0.8,
                      top_k=8, seed=3, decode_block=4, prefill_chunk=8,
                      device="cuda")
    eng.submit(list(range(1, 11)), max_new_tokens=20)
    eng.submit([3, 4], max_new_tokens=20)
    eng.decode_loop(4)            # admission and a first block
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks, _ = eng._decode_block(4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert toks.shape == (4, 2)


def test_gemma_2b_engine_card_matches_cpu(cuda):
    """gemma-2b reduced (one KV head for 4 q-heads): greedy streams equal
    on card and CPU."""
    streams = _card_vs_cpu_streams("gemma-2b")
    assert streams["cuda"] == streams["cpu"]


# --------------------------------------------------------------------- #
# flash_decode_quant
# --------------------------------------------------------------------- #

FORMATS = ("float8_e4m3fn", "float8_e5m2", "float6_e2m3fn",
           "float6_e3m2fn", "float4_e2m1fn")
PACKED = FORMATS[2:]


def _quant_inputs(seed, fmt, b, S, hq, hkv, d, q_dtype, pos, ring=False):
    """q and a quantized cache written through the port's own
    ``cache_write_chunk`` on the card."""
    q, k, v, sp, pos = _inputs(seed, b, S, hq, hkv, d, q_dtype, F32, pos,
                               ring=ring)
    kv = attn.init_kv_cache(b, S, hkv, d, F32, "cuda", kv_format=fmt)
    attn.cache_write_chunk(kv, k, v,
                           torch.arange(S, device="cuda"),
                           torch.ones(S, dtype=torch.bool, device="cuda"),
                           kv_format=fmt)
    kv["slot_pos"].copy_(sp)
    return q, kv, pos


def _check_quant(q, kv, pos, fmt, **flags):
    got = flash_decode_quant(q, kv, pos, fmt=fmt, **flags)
    torch.cuda.synchronize()
    want = flash_decode_quant_plain(q, kv, pos, fmt=fmt, **flags)
    sp = kv["slot_pos"]
    ok = (sp >= 0) & (sp <= pos[:, None])
    if flags.get("window") is not None:
        ok &= sp > pos[:, None] - flags["window"]
    rows = ok.any(dim=1)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got[rows].float(), want[rows].float(),
                               **TOL[q.dtype])
    assert (got[~rows] == 0).all()


@pytest.mark.parametrize("S", [63, 64, 1000])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)], ids=["mha", "gqa4"])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_formats_shapes(cuda, fmt, d, hq, hkv, S):
    _check_quant(*_quant_inputs(S + d, fmt, 2, S, hq, hkv, d, F32,
                                pos=[S - 1, S // 3]), fmt)


@pytest.mark.parametrize("window,softcap", [(64, None), (None, 20.0),
                                            (32, 10.0)])
@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_window_softcap_on_wrapped_ring(cuda, fmt, window, softcap):
    _check_quant(*_quant_inputs(7, fmt, 2, 96, 4, 2, 64, F32,
                                pos=[245, 300], ring=True), fmt,
                 window=window, softcap=softcap)


@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_bf16_and_rows_without_visible_slot(cuda, fmt):
    q, kv, pos = _quant_inputs(9, fmt, 4, 128, 16, 16, 128, BF16,
                               pos=[127, 5, 60, 90])
    kv["slot_pos"][1] = -1
    pos[3] = -1
    _check_quant(q, kv, pos, fmt)


def test_quant_strided_pool_view_and_launch_count(cuda):
    """The engine's layer view of a period-stacked pool (a strided
    slice); one launch counted per call, none by the plain version."""
    fmt = "float4_e2m1fn"
    q, kv, pos = _quant_inputs(11, fmt, 2, 80, 8, 2, 64, F32, pos=[79, 40])
    stacked = {n: torch.stack([t, t]).transpose(0, 1).contiguous()
               .transpose(0, 1) for n, t in kv.items()}
    layer = {n: t[1] for n, t in stacked.items()}
    before = flash_decode_quant.launches
    _check_quant(q, layer, pos, fmt)
    assert flash_decode_quant.launches == before + 1


@pytest.mark.parametrize("name", sorted(SPLIT_CASES))
@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_split_edges(cuda, fmt, name):
    b, S, hq, hkv, d, pos, ring, window = SPLIT_CASES[name]
    q, kv, pos = _quant_inputs(len(name), fmt, b, S, hq, hkv, d, BF16, pos,
                               ring=ring)
    assert fdq_plan(q, kv, pos, fmt, compat.sm_count(0)).splits > 1
    _check_quant(q, kv, pos, fmt, window=window)


@pytest.mark.parametrize("fmt", FORMATS)
def test_quant_split_row_with_every_split_empty(cuda, fmt):
    q, kv, pos = _quant_inputs(12, fmt, 4, 1024, 8, 8, 64, F32,
                               pos=[1023, 300, 40, 700])
    kv["slot_pos"][2] = -1
    _check_quant(q, kv, pos, fmt)


@pytest.mark.parametrize("fmt,pad,widths", [
    ("float8_e4m3fn", 1, (1, 1)), ("float8_e5m2", 4, (4, 4)),
    ("float6_e2m3fn", 8, (8, 4)), ("float4_e2m1fn", 2, (2, 2))])
def test_quant_narrow_copies(cuda, fmt, pad, widths):
    """Code and scale rows as views into rows ``pad`` bytes longer."""
    q, kv, pos = _quant_inputs(13, fmt, 3, 300, 8, 4, 128, BF16,
                               pos=[299, 150, 31])
    for name in ("k_q", "k_s", "v_q", "v_s"):
        t = kv[name]
        buf = torch.zeros((*t.shape[:3], t.shape[3] + pad),
                          dtype=torch.uint8, device="cuda")
        buf[..., :t.shape[3]] = t.view(torch.uint8)
        kv[name] = buf[..., :t.shape[3]].view(t.dtype)
    assert fdq_plan(q, kv, pos, fmt, compat.sm_count(0)).widths == widths
    _check_quant(q, kv, pos, fmt)


@pytest.mark.parametrize("fmt", ["float8_e4m3fn", "float4_e2m1fn"])
def test_quant_two_calls_bit_identical_and_counters_reset(cuda, fmt):
    a = _quant_inputs(14, fmt, 8, 1024, 16, 16, 128, BF16,
                      pos=list(range(100, 1001, 128)))
    other = _quant_inputs(15, fmt, 1, 4096, 8, 1, 128, BF16, pos=[4095])
    first = flash_decode_quant(*a, fmt=fmt)
    second = flash_decode_quant(*a, fmt=fmt)
    flash_decode_quant(*other, fmt=fmt)
    third = flash_decode_quant(*a, fmt=fmt)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))
    assert torch.equal(first.view(torch.int16), third.view(torch.int16))


# --------------------------------------------------------------------- #
# qmatmul / qmatmul_packed
# --------------------------------------------------------------------- #

def _qmm_inputs(seed, m, n, k, x_dtype=BF16):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k), np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n), np.float32) * 0.05)
    return x.to("cuda", x_dtype), w.cuda()


def _assert_qmm_close(got, want, k):
    atol = 1e-4 * (k / 1024) ** 0.5
    if got.dtype == F32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)
        return
    g, w = got.float(), want.float()
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w)[1] - 8)
    bad = (g - w).abs() > 2 * ulp + atol
    assert not bad.any(), (g[bad][:5], w[bad][:5])


@pytest.mark.parametrize("out_dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m", [1, 37, 128])
@pytest.mark.parametrize("fmt", FORMATS)
def test_qmatmul_formats_ragged_m(cuda, fmt, m, out_dtype):
    k, n = 512, 192
    x, w = _qmm_inputs(m, m, n, k)
    qw, sc = quantize_for_qmatmul(w, fmt)
    before = qmatmul.launches
    got = qmatmul(x, qw, sc, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert qmatmul.launches == before + 1
    assert got.shape == (m, n) and got.dtype == out_dtype
    _assert_qmm_close(got, qmatmul_plain(x, qw, sc, out_dtype), k)
    if fmt in PACKED:
        pw, sc2 = pack_for_qmatmul(w, fmt)
        assert torch.equal(sc, sc2)
        got_p = qmatmul_packed(x, pw, sc2, fmt, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert torch.equal(got_p.view(torch.uint8) if out_dtype == BF16
                           else got_p.view(torch.int32),
                           got.view(torch.uint8) if out_dtype == BF16
                           else got.view(torch.int32))
        _assert_qmm_close(got_p, qmatmul_packed_plain(x, pw, sc2, fmt,
                                                      out_dtype), k)


def test_qmatmul_fp32_x_and_ragged_n(cuda):
    x, w = _qmm_inputs(3, 70, 100, 256, x_dtype=F32)
    qw, sc = quantize_for_qmatmul(w, "float8_e4m3fn")
    _assert_qmm_close(qmatmul(x, qw, sc, out_dtype=F32),
                      qmatmul_plain(x, qw, sc, F32), 256)


@pytest.mark.parametrize("k", [16, 32, 48, 64])
def test_wgmma_unit_tile(cuda, k):
    """One warpgroup's m64n128k16 products through the swizzled tiles
    and descriptors of ``wgmma.cuh``, k / 16 slices."""
    rng = np.random.default_rng(k)
    a = torch.from_numpy(rng.standard_normal((64, k), np.float32))
    b = torch.from_numpy(rng.standard_normal((128, k), np.float32))
    a, b = a.to("cuda", BF16), b.to("cuda", BF16)
    got = wgmma_unit_tile(a, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, a.float() @ b.float().T, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("k", [16, 32, 48, 64])
@pytest.mark.parametrize("n", [64, 128])
def test_wgmma_rs_unit_tile(cuda, n, k):
    """One warpgroup's m64nNk16 products with A from registers (the
    mma.sync fragment layout) and B MN-major, swizzled, two column
    blocks apart at n 128 (``MmaRS``, ``desc_sw128_mn``): the form of
    flash_attention's P V."""
    rng = np.random.default_rng(n + k)
    a = torch.from_numpy(rng.standard_normal((64, k), np.float32))
    b = torch.from_numpy(rng.standard_normal((k, n), np.float32))
    a, b = a.to("cuda", BF16), b.to("cuda", BF16)
    got = wgmma_rs_unit_tile(a, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, a.float() @ b.float(), rtol=1e-5,
                               atol=1e-5)


def _qmm_check_both(x, w, fmt, out_dtype, k):
    """qmatmul (and qmatmul_packed, bit for bit) against the plain
    version; returns the container kernel's output."""
    qw, sc = quantize_for_qmatmul(w, fmt)
    got = qmatmul(x, qw, sc, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.shape == (x.shape[0], w.shape[1]) and got.dtype == out_dtype
    _assert_qmm_close(got, qmatmul_plain(x, qw, sc, out_dtype), k)
    if fmt in PACKED:
        pw, sc2 = pack_for_qmatmul(w, fmt)
        got_p = qmatmul_packed(x, pw, sc2, fmt, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert torch.equal(got_p.view(torch.uint8), got.view(torch.uint8))
    return got


@pytest.mark.parametrize("k", [32, 96, 2048])
@pytest.mark.parametrize("n", [100, 192, 8200])
@pytest.mark.parametrize("m", [1, 8, 64, 65, 200, 256])
@pytest.mark.parametrize("fmt", FORMATS)
def test_qmatmul_tensor_core_paths(cuda, fmt, m, n, k):
    """bf16 x: the narrow path (m <= 64, split k at n = 8200 and at
    k = 2048) and the wide one, ragged n, a last half step of k (k =
    32, 96: fp6 packed rows of 24 and 72 bytes)."""
    x, w = _qmm_inputs(m + n + k, m, n, k)
    _qmm_check_both(x, w, fmt, BF16, k)


@pytest.mark.parametrize("m", [8, 64, 200])
@pytest.mark.parametrize("fmt", FORMATS)
def test_qmatmul_tensor_core_fp32_out(cuda, fmt, m):
    x, w = _qmm_inputs(m, m, 192, 2048)
    _qmm_check_both(x, w, fmt, F32, 2048)


@pytest.mark.parametrize("pad", [8, 4, 1, "offset"])
@pytest.mark.parametrize("m", [8, 200])
def test_qmatmul_strided_x(cuda, m, pad):
    """x a view with ldx > k: rows 16-, 8- or 2-byte aligned (the copy
    granule follows), or starting one element in."""
    k, n = 512, 192
    x, w = _qmm_inputs(m + 1, m, n, k)
    if pad == "offset":
        big = torch.zeros((m, k + 8), dtype=BF16, device="cuda")
        big[:, 1:k + 1] = x
        xs = big[:, 1:k + 1]
    else:
        big = torch.zeros((m, k + pad), dtype=BF16, device="cuda")
        big[:, :k] = x
        xs = big[:, :k]
    assert xs.stride(0) > k
    for fmt in ("float8_e4m3fn", "float6_e2m3fn", "float4_e2m1fn"):
        got = _qmm_check_both(xs, w, fmt, BF16, k)
        qw, sc = quantize_for_qmatmul(w, fmt)
        assert torch.equal(got, qmatmul(x, qw, sc))


@pytest.mark.parametrize("m", [8, 200])
def test_qmatmul_packed_weight_rows_at_odd_offsets(cuda, m):
    """fp6 codes read from a view one byte in, row stride 3k/4 + 1: too
    ragged for TMA and cp.async, the rows are copied byte by byte."""
    k, n = 512, 192
    x, w = _qmm_inputs(m + 11, m, n, k)
    pw, sc = pack_for_qmatmul(w, "float6_e2m3fn")
    big = torch.zeros((n, pw.shape[1] + 1), dtype=torch.uint8,
                      device="cuda")
    big[:, 1:] = pw
    got = qmatmul_packed(x, big[:, 1:], sc, "float6_e2m3fn")
    torch.cuda.synchronize()
    assert torch.equal(got, qmatmul_packed(x, pw, sc, "float6_e2m3fn"))
    _assert_qmm_close(got, qmatmul_packed_plain(x, pw, sc, "float6_e2m3fn"),
                      k)


@pytest.mark.parametrize("m, n, k", [(8, 8192, 2048), (64, 1024, 1024),
                                     (200, 1024, 1024)])
def test_qmatmul_two_calls_bit_identical(cuda, m, n, k):
    """No atomics: the split-k path (8 x 8192 x 2048 splits k on an
    H100) and the others give the same bits twice."""
    x, w = _qmm_inputs(5, m, n, k)
    pw, sc = pack_for_qmatmul(w, "float4_e2m1fn")
    a = qmatmul_packed(x, pw, sc, "float4_e2m1fn")
    b = qmatmul_packed(x, pw, sc, "float4_e2m1fn")
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert plan(m, n, k, sms).path == ("narrow" if m <= 64 else "wide")


# ------------------------------------------------------------------ #
# probe kernels
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("rows", [16, 4096, 1 << 17])
def test_chase_rows(cuda, rows):
    buf = pc.make_chase_buffer(rows, seed=rows)
    want = pc.chase_reference(buf.numpy(), 8192)
    buf = buf.cuda()
    before = pc.chase.launches
    assert int(pc.chase(buf, 8192)) == want == int(pc.chase_plain(buf, 8192))
    run = pc.chase_timed(buf, 50)
    assert pc.chase.launches == before + 2
    assert run.index == pc.chase_reference(buf.cpu().numpy(), 50)
    assert run.cycles > 0 and run.ns > 0


@pytest.mark.parametrize("n", [1 << 12, 1 << 20, 1 << 24])
def test_chase_flat(cuda, n):
    nxt = pc.chase_cycle(n, 1)
    buf = torch.from_numpy(nxt).view(n, 1).cuda()
    assert int(pc.chase(buf, 8192)) == pc.chase_reference(nxt[:, None], 8192)


@pytest.mark.parametrize("chain_len,ilp", [(10, 1), (100, 2), (57, 4),
                                           (256, 8)])
def test_dep_chain(cuda, chain_len, ilp):
    x = torch.from_numpy(np.random.default_rng(chain_len).standard_normal(
        (ilp, 8, 128)).astype(np.float32)).cuda()
    before = pdc.dep_chain.launches
    got = pdc.dep_chain(x, chain_len, ilp)
    torch.cuda.synchronize()
    assert pdc.dep_chain.launches == before + 1
    pdc.assert_chain_close({"float": got},
                           {"float": pdc.dep_chain_plain(x, chain_len)},
                           chain_len, reference_constants=False)


@pytest.mark.parametrize("lanes", [1, 4096])
@pytest.mark.parametrize("workload,n", [
    (w, n) for w in ("int32", "fp32", "fp64", "mixed1")
    for n in (0, 1, 7, 40, 256, 100)] + [("mixed2", n) for n in (0, 1, 7, 40)])
def test_chain_workloads(cuda, workload, n, lanes):
    run = pdc.run_chain(workload, n, lanes, device="cuda")
    torch.cuda.synchronize()
    steps = n // 2 if workload == "mixed2" else n
    assert run.unrolled == (steps in pdc.timed_steps())
    assert run.cycles.shape == (lanes,) and (run.cycles >= 0).all()
    pdc.assert_chain_close(run.values,
                           pdc.chain_plain(workload, n, lanes, device="cuda"),
                           n)


def test_chain_timer_overhead_and_latency(cuda):
    """Two back-to-back clock64 reads take a few cycles, and a dependent
    fp32 chain of 256 takes 256 latencies of at least 2 cycles."""
    c0 = pdc.run_chain("fp32", 0, 1, device="cuda").cycles.item()
    c256 = pdc.run_chain("fp32", 256, 1, device="cuda").cycles.item()
    assert 0 < c0 < 64
    assert c256 - c0 >= 2 * 256


def _mma_close(got, want, k, kind):
    g, w = got.float(), want.float()
    if kind in ("bf16", "fp16"):
        bits = 8 if kind == "bf16" else 11
        ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w)[1] - bits)
        tol = ulp + 1e-5 * k ** 0.5
    else:
        tol = (2.0 ** -8 if kind == "tf32" else 1e-5) * k ** 0.5
    assert torch.isfinite(g).all()
    assert ((g - w).abs() <= tol).all()


@pytest.mark.parametrize("mkn", [(256, 256, 128), (128, 128, 128)])
@pytest.mark.parametrize("ilp", [1, 2, 4])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "tf32"])
def test_mma_probe(cuda, dtype, ilp, mkn):
    m, k, n = mkn
    g = torch.Generator(device="cuda").manual_seed(m + ilp)
    x = torch.randn((ilp, m, k), generator=g, device="cuda").to(dtype)
    y = torch.randn((k, n), generator=g, device="cuda").to(dtype)
    before = pm.mma_probe.launches
    got = pm.mma_probe(x, y, ilp=ilp)
    torch.cuda.synchronize()
    assert pm.mma_probe.launches == before + 1
    assert got.dtype == dtype and got.shape == (ilp, m, n)
    _mma_close(got, pm.mma_probe_plain(x, y, dtype), k,
               "bf16" if dtype == BF16 else "tf32")


@pytest.mark.parametrize("ilp", range(1, 9))
@pytest.mark.parametrize("dtype", [BF16, torch.float16, F32],
                         ids=["bf16", "fp16", "tf32"])
def test_mma_probe_every_ilp_off_the_block_tile(cuda, dtype, ilp):
    """Every ilp of the kernel, m, n and k off its 32 x 32 block tile and
    its 64-byte k slices (48 x 48 @ 48 x 72, and 272 of k), out in the
    input's dtype with y broadcast over the products (``mma_probe``) and
    in fp32 with a y per product (``mma_products``)."""
    kind = {BF16: "bf16", torch.float16: "fp16", F32: "tf32"}[dtype]
    g = torch.Generator(device="cuda").manual_seed(ilp)
    for m, k, n in ((48, 48, 72), (16, 272, 8)):
        x = torch.randn((ilp, m, k), generator=g, device="cuda").to(dtype)
        y = torch.randn((k, n), generator=g, device="cuda").to(dtype)
        before = pm.mma_probe.launches
        got = pm.mma_probe(x, y, bm=16, bn=8, bk=16, ilp=ilp)
        torch.cuda.synchronize()
        assert pm.mma_probe.launches == before + 1
        assert got.dtype == dtype and got.shape == (ilp, m, n)
        _mma_close(got, pm.mma_probe_plain(x, y, dtype), k, kind)
        a = torch.randn((3, ilp, m, k), generator=g, device="cuda").to(dtype)
        b = torch.randn((3, ilp, k, n), generator=g, device="cuda").to(dtype)
        got = pm.mma_products(a, b)
        torch.cuda.synchronize()
        assert got.dtype == F32 and got.shape == (3, ilp, m, n)
        _mma_close(got, pm.mma_probe_plain(a, b, F32), k,
                   "tf32" if dtype == F32 else "fp32")


@pytest.mark.parametrize("batch,ilp", [(1, 1), (4, 2), (16, 4)])
def test_mma_products(cuda, batch, ilp):
    g = torch.Generator(device="cuda").manual_seed(batch)
    a = torch.randn((batch, ilp, 128, 128), generator=g, device="cuda")
    b = torch.randn((batch, ilp, 128, 128), generator=g, device="cuda")
    a, b = a.to(BF16), b.to(BF16)
    got = pm.mma_products(a, b)
    torch.cuda.synchronize()
    assert got.dtype == F32
    _mma_close(got, pm.mma_probe_plain(a, b, F32), 128, "fp32")


# --------------------------------------------------------------------- #
# ssd_scan
# --------------------------------------------------------------------- #

def _ssd_inputs(seed, bt, s, h, p, n, x_dtype=F32, bc_dtype=F32,
                with_state=True):
    """Unit-scale inputs (those of tests/test_kernels.py) with model-like
    decays: dt_a = dt * -exp(A_log), A_log per head as ``init_ssm`` sets
    it and dt log-uniform in [1e-3, 1e-1]: dt_a in [-1.6, -0.001]."""
    rng = np.random.default_rng(seed)

    def t(shape, scale=0.5, dtype=F32):
        return torch.from_numpy(
            rng.standard_normal(shape, np.float32) * scale).to("cuda", dtype)

    a = -np.linspace(1.0, 16.0, h, dtype=np.float32)
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (bt, s, h)))
    dt_a = torch.from_numpy((dt * a).astype(np.float32)).to("cuda")
    state = t((bt, h, p, n)) if with_state else None
    return (t((bt, s, h, p), dtype=x_dtype), dt_a,
            t((bt, s, n), dtype=bc_dtype), t((bt, s, n), dtype=bc_dtype),
            state)


def _check_ssd(x, dt_a, b, c, state, chunk):
    before = ssd_scan.launches
    y, st = ssd_scan(x, dt_a, b, c, chunk=chunk, initial_state=state)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    s = x.shape[1]
    pad = (-s) % chunk
    padded = [torch.nn.functional.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
              for t in (x, dt_a, b, c)]
    y_want, st_want = ssd_scan_plain(*padded, chunk, state)
    y_want = y_want[:, :s]
    assert y.dtype == x.dtype and y.shape == x.shape
    assert st.dtype == F32 and torch.isfinite(y).all()
    rtol = 2.0 ** -7 if x.dtype == BF16 else 0.0
    torch.testing.assert_close(y.float(), y_want.float(), atol=2e-4,
                               rtol=rtol)
    torch.testing.assert_close(st, st_want, atol=2e-4, rtol=0.0)


@pytest.mark.parametrize("chunk", [32, 64, 100, 256, 1024])
@pytest.mark.parametrize("s,h,p,n", [(128, 2, 32, 16), (192, 4, 64, 32),
                                     (256, 3, 64, 128), (100, 2, 16, 8),
                                     (96, 4, 48, 64), (256, 80, 64, 128),
                                     (130, 1, 64, 128), (64, 80, 48, 64)])
def test_ssd_scan_shapes(cuda, chunk, s, h, p, n):
    """Chunks of one sub-chunk and less (32, 64), across sub-chunks (100,
    256) and 16 of them (1024); ``ssd_scan.plan``'s edges: h 1 to 80, p 48
    (a slice of 32 and one of 16) and 64, n 64 and 128."""
    _check_ssd(*_ssd_inputs(s + chunk, 2, s, h, p, n), chunk)


@pytest.mark.parametrize("bt,s,h,p,n,chunk", [
    (1, 256, 80, 64, 128, 256),     # the serving call: 160 blocks of 32
    (8, 512, 80, 64, 128, 256),     # 640 (row, head) pairs
    (8, 1024, 80, 48, 64, 1024),
    (1, 64, 2, 64, 128, 32),        # 2 pairs, a slice of 16 each
    (3, 200, 5, 18, 20, 64),        # rows off 16 bytes: element copies
])
def test_ssd_scan_grid_edges(cuda, bt, s, h, p, n, chunk):
    """bt x h from 2 to 640 pairs, the slice widths ``ssd_scan.plan``
    takes there, and the element-copy path."""
    x, dt_a, b, c, state = _ssd_inputs(bt * s + chunk, bt, s, h, p, n,
                                       bc_dtype=BF16)
    if (p, n) == (18, 20):
        assert not ssd_plan(*[torch.nn.functional.pad(
            t, (0, 0) * (t.ndim - 2) + (0, (-s) % chunk))
            for t in (x, dt_a, b, c)], chunk, state).vec
    _check_ssd(x, dt_a, b, c, state, chunk)


@pytest.mark.parametrize("x_dtype,bc_dtype", [(F32, BF16), (BF16, BF16),
                                              (BF16, F32)])
def test_ssd_scan_dtypes(cuda, x_dtype, bc_dtype):
    _check_ssd(*_ssd_inputs(3, 2, 300, 4, 64, 128, x_dtype, bc_dtype),
               chunk=128)


def test_ssd_scan_zero_initial_state_and_long_carry(cuda):
    """No initial state; the carry inside the kernel crosses 8 chunks."""
    _check_ssd(*_ssd_inputs(4, 2, 2048, 4, 64, 128, with_state=False),
               chunk=256)


def test_ssd_scan_refuses_what_it_does_not_take(cuda):
    x, dt_a, b, c, state = _ssd_inputs(5, 1, 64, 2, 80, 16)
    with pytest.raises(ValueError, match="p <= 64"):
        ssd_scan(x, dt_a, b, c, chunk=32)
    x, dt_a, b, c, state = _ssd_inputs(5, 1, 64, 2, 32, 16)
    with pytest.raises(TypeError):
        ssd_scan(x, dt_a.double(), b, c, chunk=32)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt_a, b, c,
                 chunk=32)


def test_mamba2_engine_card_matches_cpu(cuda):
    """mamba2-2.7b reduced, fp32, TF32 off (matmul and the cuDNN conv):
    the engine on the card gives the CPU's greedy streams and launches
    ssd_scan once per prefill chunk per layer; the CPU never does."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("mamba2-2.7b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    streams = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(model, params, batch=2, max_seq=64,
                          decode_block=4, prefill_chunk=8, device=dev)
        eng.submit([int(2 + (i * 11) % 300) for i in range(20)],
                   max_new_tokens=9)
        eng.submit([3, 4, 5], max_new_tokens=2)
        eng.submit([7, 1, 7, 1, 7], max_new_tokens=5)
        before = ssd_scan.launches
        streams[dev] = [(r.status, r.tokens) for r in eng.run()]
        launched = ssd_scan.launches - before
        assert launched == ((3 + 1 + 1) * cfg.n_layers
                            if dev == "cuda" else 0)
    assert streams["cuda"] == streams["cpu"]


# --------------------------------------------------------------------- #
# flash_attention
# --------------------------------------------------------------------- #

def _fa_inputs(seed, b, sq, skv, hq, hkv, d, dtype):
    rng = np.random.default_rng(seed)

    def t(shape):
        return torch.from_numpy(
            rng.standard_normal(shape, np.float32)).to("cuda", dtype)

    return t((b, sq, hq, d)), t((b, skv, hkv, d)), t((b, skv, hkv, d))


def _fa_visible_rows(sq, skv, causal, window, q_offset):
    """(sq,) bool: the query rows that see at least one key."""
    qp = q_offset + torch.arange(sq)[:, None]
    kp = torch.arange(skv)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        ok &= qp >= kp
    if window is not None:
        ok &= qp - kp < window
    return ok.any(dim=1).cuda()


def _check_fa(q, k, v, **flags):
    before = (flash_attention.launches, flash_attention_plain.calls)
    got = flash_attention(q, k, v, **flags)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention_plain.calls) == (
        before[0] + 1, before[1])
    want = flash_attention_plain(q, k, v, **flags)
    rows = _fa_visible_rows(q.shape[1], k.shape[1], flags.get("causal", True),
                            flags.get("window"), flags.get("q_offset", 0))
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.isfinite(got).all()
    atol = 2e-5 if q.dtype == F32 else 2e-2
    torch.testing.assert_close(got[:, rows].float(), want[:, rows].float(),
                               atol=atol, rtol=0.0)
    assert (got[:, ~rows] == 0).all()


FA_CASES = {
    # chip_smoke.py phase 1f's cases
    "a_gptneox_bf16": (dict(b=8, sq=2048, skv=2048, hq=16, hkv=16, d=128,
                            dtype=BF16), {}),
    "b_gptneox_fp32": (dict(b=8, sq=2048, skv=2048, hq=16, hkv=16, d=128,
                            dtype=F32), {}),
    "c_gqa_32_8_d64": (dict(b=2, sq=384, skv=1000, hq=32, hkv=8, d=64,
                            dtype=BF16), {}),
    "d_window_softcap": (dict(b=2, sq=1024, skv=1024, hq=8, hkv=8, d=128,
                              dtype=BF16), dict(window=256, softcap=50.0)),
    "e_non_causal": (dict(b=2, sq=500, skv=700, hq=8, hkv=4, d=128,
                          dtype=BF16), dict(causal=False)),
    "f_ragged": (dict(b=3, sq=96, skv=130, hq=4, hkv=2, d=128, dtype=BF16),
                 {}),
    "g_q_offset": (dict(b=2, sq=128, skv=640, hq=8, hkv=8, d=128,
                        dtype=BF16), dict(q_offset=512)),
    "h_d256": (dict(b=2, sq=300, skv=300, hq=4, hkv=2, d=256, dtype=BF16),
               {}),
}


@pytest.mark.parametrize("case", sorted(FA_CASES))
def test_flash_attention_cases(cuda, case):
    spec, flags = FA_CASES[case]
    _check_fa(*_fa_inputs(len(case), **spec), **flags)


@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [16, 64, 96, 128, 256])
@pytest.mark.parametrize("flags", [
    {}, dict(causal=False), dict(window=64), dict(window=40, softcap=20.0),
    dict(q_offset=70, window=50), dict(q_offset=300, causal=False,
                                       window=30)],
    ids=["causal", "full", "window", "window_softcap", "offset_window",
         "offset_noncausal_window_empty_rows"])
def test_flash_attention_sweep(cuda, dtype, d, flags):
    """Head dims padded inside the kernel (16, 96), every mask flag, and
    rows that see no key (zeros from the kernel)."""
    _check_fa(*_fa_inputs(d, 2, 150, 200, 4, 2, d, dtype), **flags)


def test_flash_attention_strided_head_major(cuda):
    """K/V stored (b, hkv, s, d) and handed over as (b, s, hkv, d)
    views: the kernel reads the strides, no copy."""
    q, k, v = _fa_inputs(9, 2, 200, 200, 8, 4, 64, BF16)
    kh, vh = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (k, v))
    assert kh.stride(1) == 64 and not kh.is_contiguous()
    _check_fa(q, kh, vh)


FA_WGMMA_CASES = {
    # sq and skv off the 128-row q tile and the K/V tile
    "ragged": (dict(b=2, sq=200, skv=333, hq=4, hkv=2), {}),
    "non_causal": (dict(b=2, sq=131, skv=259, hq=4, hkv=4),
                   dict(causal=False)),
    "q_offset": (dict(b=2, sq=150, skv=610, hq=4, hkv=2),
                 dict(q_offset=460)),
    "window_softcap": (dict(b=2, sq=390, skv=390, hq=4, hkv=2),
                       dict(window=100, softcap=30.0)),
    "gqa_32_8": (dict(b=1, sq=260, skv=260, hq=32, hkv=8), {}),
}


@pytest.mark.parametrize("case", sorted(FA_WGMMA_CASES))
@pytest.mark.parametrize("d", [64, 72, 128, 256])
def test_flash_attention_wgmma_head_dims(cuda, d, case):
    """The bf16 kernel at each padded head_dim (72 pads to 128 by the TMA
    maps' zero fill), ragged sq / skv, q_offset, window + softcap, GQA."""
    spec, flags = FA_WGMMA_CASES[case]
    _check_fa(*_fa_inputs(d + len(case), d=d, dtype=BF16, **spec), **flags)


@pytest.mark.parametrize("d", [64, 72, 128, 256])
def test_flash_attention_fused_qkv_views(cuda, d):
    """q, k, v as the model's head split of one fused projection, (b, s,
    3 * h * d) viewed (b, s, 3, h, d): strided views, no copy."""
    rng = np.random.default_rng(d)
    qkv = torch.from_numpy(rng.standard_normal((2, 300, 3 * 4 * d),
                                               np.float32)).to("cuda", BF16)
    q, k, v = qkv.view(2, 300, 3, 4, d).unbind(2)
    assert q.stride() == (300 * 12 * d, 12 * d, d, 1)
    _check_fa(q, k, v)
    _check_fa(q, k, v, window=64, q_offset=0)


def test_flash_attention_gptneox_prefill_card_matches_cpu(cuda):
    """gptneox-1b reduced, fp32, TF32 off: Model.prefill on the card
    launches the kernel once per layer and gives the CPU's logits and
    cache within 1e-4, then the same greedy stream."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("gptneox-1b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 70)))
    runs = {}
    for dev in ("cpu", "cuda"):
        p = _tree_to(params, dev)
        before = flash_attention.launches
        logits, cache = model.prefill(p, {"tokens": tokens.to(dev)}, 96)
        assert flash_attention.launches - before == (
            cfg.n_layers if dev == "cuda" else 0)
        stream, tok = [], logits.argmax(-1)
        for i in range(8):
            stream.append(tok.tolist())
            pos = torch.full((2,), 70 + i, dtype=torch.int32, device=dev)
            tok = model.decode_step(p, cache, tok, pos).argmax(-1)
        runs[dev] = (logits.cpu(), cache["pos0"]["kv"]["k"].cpu(), stream)
    torch.testing.assert_close(runs["cuda"][0], runs["cpu"][0], atol=1e-4,
                               rtol=1e-4)
    torch.testing.assert_close(runs["cuda"][1], runs["cpu"][1], atol=1e-4,
                               rtol=1e-4)
    assert runs["cuda"][2] == runs["cpu"][2]


def _tree_to(tree, dev):
    return {k: _tree_to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


# --------------------------------------------------------------------- #
# the MoE FFN, jamba's ssd_scan shapes, robustness in the fused block
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("arch,s,over", [
    ("kimi-k2-1t-a32b", 16, dict(moe_num_experts=16, moe_top_k=8)),
    ("kimi-k2-1t-a32b", 1, dict(moe_num_experts=16, moe_top_k=8)),
    ("jamba-v0.1-52b", 64, dict(moe_capacity_factor=0.5)),
    ("llama4-maverick-400b-a17b", 48, {})])
def test_apply_moe_card_matches_cpu(cuda, arch, s, over):
    """``models.moe.apply_moe`` on the card against its CPU run, fp32
    with TF32 off: y within atol 1e-5 (summation order), the aux losses
    within 1e-6 relative above 1, as many pairs dropped; top-8 over 16 experts, jamba's top-2 with drops, llama4's
    top-1 with a shared expert, and decode rows (s 1)."""
    from repro_torch.models import moe
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch).reduced(), **over)
    p = moe.init_moe(cfg, F32, torch.Generator().manual_seed(1), "cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, s, cfg.d_model), np.float32))
    want, want_aux = moe.apply_moe(p, x, cfg, subgroup=16)
    got, aux = moe.apply_moe({k: v.cuda() if torch.is_tensor(v) else
                              {n: w.cuda() for n, w in v.items()}
                              for k, v in p.items()}, x.cuda(), cfg,
                             subgroup=16)
    pairs = 3 * s * cfg.moe_top_k          # (token, choice) pairs
    assert round(float(aux["moe_dropped"]) * pairs) == round(
        float(want_aux["moe_dropped"]) * pairs)
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)
    for k in want_aux:
        tol = 1e-6 * max(1.0, abs(float(want_aux[k])))
        assert abs(float(aux[k]) - float(want_aux[k])) <= tol, (
            k, float(aux[k]), float(want_aux[k]))


@pytest.mark.parametrize("bt,s", [(1, 256), (2, 2048)])
def test_ssd_scan_at_jamba_shapes(cuda, bt, s):
    """jamba-v0.1-52b's SSD at full width: 128 heads of p 64 over a
    state of n 16, chunk 256; the serving call (one 256-token prefill
    chunk, fp32 x, bf16 b / c, an initial state) and the whole-sequence
    call (2 x 2048 tokens, the carry across 8 chunks)."""
    _check_ssd(*_ssd_inputs(21 + bt, bt, s, 128, 64, 16, bc_dtype=BF16,
                            with_state=bt == 1), chunk=256)


def test_arming_and_cancel_make_no_sync(cuda):
    """Arming a logits fault, poisoning a slot's SSM state, cancelling a
    request and the fused block that follows make no implicit
    device-to-host synchronization on a hybrid MoE model (jamba
    reduced): both faults fire in the block (the slots end ``faulted``
    at the harvest), the cancelled slot is out, the fourth slot's
    stream goes on."""
    cfg = get_config("jamba-v0.1-52b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    eng = ServeEngine(model, params, batch=4, max_seq=64, decode_block=4,
                      prefill_chunk=8, device="cuda")
    ids = [eng.submit(list(range(1, 11)), max_new_tokens=20),
           eng.submit([3, 4], max_new_tokens=20),
           eng.submit([5, 6, 7], max_new_tokens=20),
           eng.submit([8, 9], max_new_tokens=20)]
    eng.decode_loop(4)            # admission and a first block
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.inject_fault(ids[0], "logits_nan", delay=1)
        eng.inject_fault(ids[3], "state_inf")
        eng.cancel(ids[1])
        toks, emits = eng._decode_block(4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    eng._harvest(toks, emits)
    res = {r.request_id: r.status for r in eng.results}
    assert res == {ids[0]: "faulted", ids[1]: "shed", ids[3]: "faulted"}
    assert eng.slot_req[2] is not None and eng.accounting()["balanced"]


# --------------------------------------------------------------------- #
# the encoder-decoder and VLM paths: cross-attention decode at query
# position 2^30, non-causal flash_attention at head_dim 64, engines
# --------------------------------------------------------------------- #

def _cross_ring(seed, b, S, h, d, src_lens):
    """q (b, 1, h, d) bf16 and a cross ring (b, S, h, d) in fp32 whose
    row r holds source positions 0..src_lens[r]-1, then slot_pos -1."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32)).cuda()
               for shape in ((b, 1, h, d), (b, S, h, d), (b, S, h, d)))
    sp = torch.full((b, S), -1, dtype=torch.int32, device="cuda")
    for r, n in enumerate(src_lens):
        sp[r, :n] = torch.arange(n, dtype=torch.int32, device="cuda")
    return q.to(BF16), k, v, sp


@pytest.mark.parametrize("fmt", [None, "float8_e4m3fn", "float4_e2m1fn"])
def test_cross_attention_decode_at_far_position(cuda, fmt):
    """seamless-m4t-medium's cross-attention decode: b 8, a ring of 1024
    source slots, hq = hkv = 16, d 64, query position 2^30 (every
    written slot visible), sources of 600..1000 frames (a tail of
    slot_pos -1), bf16, dense and quantized."""
    q, k, v, sp = _cross_ring(64, 8, 1024, 16, 64,
                              np.linspace(600, 1000, 8).astype(int))
    pos = torch.full((8,), 2 ** 30, dtype=torch.int32, device="cuda")
    if fmt is None:
        _check(q, k.to(BF16), v.to(BF16), sp, pos)
        return
    kv = {"slot_pos": sp}
    for name, x in (("k", k), ("v", v)):
        kv[f"{name}_q"], kv[f"{name}_s"] = attn.quantize_kv(x, fmt)
    got = flash_decode_quant(q, kv, pos, fmt=fmt)
    torch.cuda.synchronize()
    want = flash_decode_quant_plain(q, kv, pos, fmt=fmt)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), **TOL[BF16])


@pytest.mark.parametrize("sq,skv", [(1000, 1000), (16, 1000), (600, 1024)],
                         ids=["encoder", "cross_prompt", "cross_padded"])
def test_flash_attention_non_causal_d64(cuda, sq, skv):
    """seamless's whole-sequence attention, bf16, 16 heads of 64,
    non-causal: the encoder (sq = skv = 1000, off the 128-row tile) and
    the decoder's cross-attention (a 16-token prompt, or 600 queries,
    over a source of 1000 / 1024 keys)."""
    _check_fa(*_fa_inputs(sq + skv, 2, sq, skv, 16, 16, 64, BF16),
              causal=False)


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "internvl2-2b"])
def test_encdec_and_vlm_engines_card_match_cpu(cuda, arch):
    """seamless / internvl2 reduced (2 decoder layers; seamless 2 encoder
    layers), fp32, TF32 off: two requests with their 9 frames or 5
    patches, greedy, on the card and the CPU: the same streams, and the
    card's decode kernel launched once a layer a step (twice for
    seamless: self and cross).  The card's second fused block runs under
    ``set_sync_debug_mode("error")``: the cross-attention adds no host
    synchronisation."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    rng = np.random.RandomState(7)
    modal = ({"frames": rng.randn(9, cfg.d_model).astype(np.float32) * 0.02}
             if cfg.is_encoder_decoder else
             {"patches": rng.randn(5, cfg.d_model).astype(np.float32) * 0.02})
    streams = {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(model, params, batch=2, max_seq=64, decode_block=4,
                          prefill_chunk=8, device=dev)
        for prompt in ([1, 2, 3, 4, 5, 6, 7], [9, 8, 7]):
            eng.submit(prompt, max_new_tokens=13, **modal)
        before = flash_decode.launches
        eng.decode_loop()
        if dev == "cuda":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                toks, emits = eng._decode_block(4)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            eng.decode_steps += 4
            eng._harvest(toks, emits)
        res = eng.run()
        per_step = cfg.n_layers * (2 if cfg.is_encoder_decoder else 1)
        assert flash_decode.launches - before == (
            per_step * eng.decode_steps if dev == "cuda" else 0)
        streams[dev] = [(r.status, r.tokens) for r in res]
    assert streams["cuda"] == streams["cpu"]
    assert all(s == "ok" and len(t) == 13 for s, t in streams["cuda"])


# --------------------------------------------------------------------- #
# speculative serving: engines card vs CPU, a block with no sync, the
# commit's cache writes
# --------------------------------------------------------------------- #

SPEC_ARCHS = {"attn": ("gptneox-1b", {}),
              "ssm": ("mamba2-2.7b", {}),
              "hybrid": ("jamba-v0.1-52b", {"moe_capacity_factor": 8.0})}


def _spec_pair(family, draft):
    """(model, params, SpecConfig) of a reduced family; ``draft`` "model"
    drafts with the target itself."""
    from repro_torch.serve import SpecConfig
    name, over = SPEC_ARCHS[family]
    model = build_model(dataclasses.replace(get_config(name).reduced(),
                                            **over))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    spec = (SpecConfig(draft_tokens=3, ngram_table=64) if draft == "ngram"
            else SpecConfig(draft_tokens=3, ngram_table=64,
                            draft_model=model, draft_params=params))
    return model, params, spec


@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy",
                                                        "sampled"])
@pytest.mark.parametrize("family,draft", [("attn", "ngram"),
                                          ("ssm", "ngram"),
                                          ("hybrid", "ngram"),
                                          ("attn", "model")])
def test_spec_engines_card_match_cpu(cuda, family, draft, temperature):
    """Reduced engines, fp32, TF32 off, speculating: the card's streams
    are the CPU's speculative and non-speculative streams, and the
    ``spec_report`` is the CPU's.  The target's verify runs no decode
    kernel; a draft model's steps launch ``flash_decode`` once a layer
    a draft."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, params, spec = _spec_pair(family, draft)
    sampling = dict(temperature=temperature, top_k=8, seed=3)
    requests = [([1, 2, 3, 4] * 5, 19), ([9, 8, 7], 7)]
    got = {}
    for dev, sp in (("cpu", None), ("cpu", spec), ("cuda", spec)):
        eng = ServeEngine(model, params, batch=2, max_seq=64,
                          decode_block=8, prefill_chunk=8, device=dev,
                          spec=sp, **sampling)
        for prompt, n in requests:
            eng.submit(prompt, max_new_tokens=n)
        before = flash_decode.launches
        streams = [(r.status, r.tokens) for r in eng.run()]
        launched = flash_decode.launches - before
        if dev == "cuda":
            blocks = eng.decode_steps // (spec.draft_tokens + 1)
            assert launched == (0 if draft == "ngram" else
                                model.cfg.n_layers * spec.draft_tokens
                                * blocks)
        got[(dev, sp is not None)] = (streams, eng.spec_report())
    assert got[("cuda", True)] == got[("cpu", True)]
    assert got[("cuda", True)][0] == got[("cpu", False)][0]
    assert all(s == "ok" for s, _ in got[("cuda", True)][0])


@pytest.mark.parametrize("draft", ["ngram", "model"])
def test_spec_block_makes_no_sync(cuda, draft):
    """gptneox reduced with fp8 KV: arming a logits fault, a cancel and
    the speculative block that follows make no implicit device-to-host
    synchronization; the fault (armed on the block's first row, which
    every active slot keeps) fires in the block, the other slots go
    on."""
    model, params, spec = _spec_pair("attn", draft)
    eng = ServeEngine(model, params, batch=3, max_seq=64, decode_block=8,
                      prefill_chunk=8, device="cuda",
                      kv_format="float8_e4m3fn", spec=spec)
    ids = [eng.submit([1, 2, 3, 4] * 3, max_new_tokens=30),
           eng.submit([3, 4], max_new_tokens=30),
           eng.submit([5, 6, 7], max_new_tokens=30)]
    eng.decode_loop(4)            # admission and a first block
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng.inject_fault(ids[0], "logits_nan", delay=0)
        eng.cancel(ids[1])
        toks, emits = eng._spec_block()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    eng._harvest(toks.T, emits.T)
    res = {r.request_id: r.status for r in eng.results}
    assert res == {ids[0]: "faulted", ids[1]: "shed"}
    assert eng.slot_req[2] is not None and eng.accounting()["balanced"]


@pytest.mark.parametrize("fmt", [None, *FORMATS])
def test_cache_write_rows_card_matches_cpu(cuda, fmt):
    """The speculative commit's scatter (per-row positions through a ring
    wrap, a masked tail, an inactive row) and the rollback that follows
    leave the card's cache byte for byte the CPU's, dense bf16 and every
    KV format."""
    rng = np.random.default_rng(4)
    b, cap, h, d = 3, 16, 2, 32
    k = torch.from_numpy(rng.standard_normal((b, 5, h, d), np.float32))
    v = torch.from_numpy(rng.standard_normal((b, 5, h, d), np.float32))
    positions = torch.tensor([[14, 15, 16, 17, 18], [3, 4, 5, 6, 7],
                              [0, 1, 2, 3, 4]], dtype=torch.int32)
    valid = torch.tensor([[1, 1, 1, 1, 0], [1, 1, 0, 0, 0],
                          [0, 0, 0, 0, 0]], dtype=torch.bool)
    out = {}
    for dev in ("cpu", "cuda"):
        cache = attn.init_kv_cache(b, cap, h, d, BF16, dev, kv_format=fmt)
        attn.cache_write_rows(cache, k.to(dev), v.to(dev),
                              positions.to(dev), valid.to(dev),
                              kv_format=fmt)
        attn.cache_rollback(cache, positions.to(dev), ~valid.to(dev) |
                            (positions.to(dev) == 16))
        out[dev] = {n: t.cpu().view(torch.uint8) if t.element_size() == 1
                    else t.cpu() for n, t in cache.items()}
    for name, want in out["cpu"].items():
        assert torch.equal(out["cuda"][name], want), name


# (b, s, hq, hkv, d, dtype, flags, q scale): the training path's own
# shape, row 5's prefill shape, gemma2's head_dim with its window and
# softcap, the seamless encoder's non-causal d 64, fp32, and fp32 with a
# softcap the scores reach (q scaled by 4: scores of sd 4 against a cap
# of 5, so the chain factor 1 - t^2 spans ~1 to ~0; at softcap 50 it
# stays near 1 and a backward without it would pass)
FA_BWD_CASES = {
    "a_qwen_train": (8, 256, 16, 2, 128, torch.bfloat16, {}, 1.0),
    "b_row5": (8, 2048, 16, 16, 128, torch.bfloat16, {}, 1.0),
    "c_d256_window_softcap": (2, 1024, 8, 4, 256, torch.bfloat16,
                              dict(window=512, softcap=50.0), 1.0),
    "d_non_causal_d64": (4, 1000, 16, 16, 64, torch.bfloat16,
                         dict(causal=False), 1.0),
    "e_fp32": (4, 512, 16, 2, 128, torch.float32, {}, 1.0),
    "f_fp32_softcap5_q4": (2, 512, 8, 2, 128, torch.float32,
                           dict(softcap=5.0), 4.0),
}


def _bwd_inputs(device, seed, b, sq, skv, hq, hkv, d, dtype, q_scale=1.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = (q_scale * torch.randn((b, sq, hq, d), generator=g,
                               device=device)).to(dtype)
    k, v = (torch.randn((b, skv, hkv, d), generator=g,
                        device=device).to(dtype) for _ in range(2))
    do = torch.randn(q.shape, generator=g, device=device).to(dtype)
    return q, k, v, do


def _check_bwd(q, k, v, do, flags):
    """The forward's (out, LSE), then the backward given that LSE against
    ``flash_attention_bwd_plain`` (fp32 formulas on the same inputs, its
    own LSE): bf16 atol 1e-2 x the largest |grad| (the outputs' bf16
    rounding, ~2^-9 relative, and bf16 inputs read alike on both sides),
    fp32 atol 1e-5 x the largest |grad| (summation order); two calls
    bit-identical (no atomics)."""
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_lse)
    o, lse = flash_attention_lse(q, k, v, **flags)
    got = flash_attention_bwd(q, k, v, o, do, lse=lse, **flags)
    again = flash_attention_bwd(q, k, v, o, do, lse=lse, **flags)
    want = flash_attention_bwd_plain(q, k, v, o, do, **flags)
    torch.cuda.synchronize()
    frac = 1e-2 if q.dtype == torch.bfloat16 else 1e-5
    for name, x, y, z in zip("qkv", got, again, want):
        assert torch.equal(x, y), f"d{name}: two calls differ"
        scale = z.float().abs().max().item()
        torch.testing.assert_close(x.float(), z.float(), rtol=0,
                                   atol=frac * scale, msg=f"d{name}")


@pytest.mark.parametrize("case", list(FA_BWD_CASES))
def test_flash_attention_bwd_matches_plain(cuda, case):
    """``flash_attention_bwd``, given the forward kernel's LSE, against
    ``flash_attention_bwd_plain`` (``_check_bwd``'s tolerances); two
    calls bit-identical."""
    b, s, hq, hkv, d, dtype, flags, q_scale = FA_BWD_CASES[case]
    q, k, v, do = _bwd_inputs(cuda, len(case), b, s, s, hq, hkv, d, dtype,
                              q_scale)
    _check_bwd(q, k, v, do, flags)


# (b, sq, skv, hq, hkv, d, dtype, flags): ragged q and key tiles, sq
# against skv both ways, MQA split over the most blocks, a window with a
# softcap at d 256 and at d 64, and a head_dim below the 64-wide tile
FA_BWD_EDGES = {
    "mqa_split_sq100": (1, 100, 100, 8, 1, 128, BF16, {}),
    "sq70_skv200_non_causal_d64": (2, 70, 200, 4, 2, 64, BF16,
                                   dict(causal=False)),
    "sq200_skv70_causal": (2, 200, 70, 4, 4, 128, BF16, {}),
    "d256_ragged_window_softcap": (1, 333, 333, 4, 2, 256, BF16,
                                   dict(window=100, softcap=20.0)),
    "d64_window7_softcap5": (2, 150, 150, 4, 2, 64, BF16,
                             dict(window=7, softcap=5.0)),
    "d40": (2, 90, 90, 2, 1, 40, BF16, {}),
    "fp32_ragged_window": (1, 77, 77, 4, 2, 72, F32, dict(window=30)),
}


@pytest.mark.parametrize("case", list(FA_BWD_EDGES))
def test_flash_attention_bwd_edges(cuda, case):
    """The backward's tile edges and the q-head split (``bwd_plan``
    splits a kv head's 8 q heads over 8 blocks at ``mqa_split_sq100``),
    held as ``test_flash_attention_bwd_matches_plain``."""
    from repro_torch.kernels.flash_attention import bwd_plan
    b, sq, skv, hq, hkv, d, dtype, flags = FA_BWD_EDGES[case]
    q, k, v, do = _bwd_inputs(cuda, 7, b, sq, skv, hq, hkv, d, dtype)
    if case == "mqa_split_sq100":
        lse = torch.zeros((b, hq, sq), device=cuda)
        assert bwd_plan(q, k, v, q, do, lse, None,
                        compat.sm_count(0)).head_split == 8
    _check_bwd(q, k, v, do, flags)


@pytest.mark.parametrize("d,dtype", [(64, BF16), (128, BF16), (256, BF16),
                                     (128, F32)])
def test_flash_attention_lse_matches_plain(cuda, d, dtype):
    """The forward kernel's LSE against ``attention_lse_plain`` (fp32, atol
    1e-4), causal and with a window and a softcap; its output is the
    same bits as the call that stores no LSE."""
    from repro_torch.kernels.flash_attention import (
        attention_lse_plain, flash_attention_lse)
    for flags in ({}, dict(window=50, softcap=30.0), dict(causal=False)):
        q, k, v, _ = _bwd_inputs(cuda, d, 2, 300, 300, 4, 2, d, dtype)
        o, lse = flash_attention_lse(q, k, v, **flags)
        want = attention_lse_plain(q, k, **flags)
        torch.cuda.synchronize()
        torch.testing.assert_close(lse, want, rtol=0.0, atol=1e-4)
        assert torch.equal(o, flash_attention(q, k, v, **flags))


def test_flash_attention_bwd_needs_the_forward_lse(cuda):
    """On the card the backward takes the forward's LSE or raises,
    launching nothing: there is no hidden forward or statistics pass."""
    from repro_torch.kernels import flash_attention as kfa
    q, k, v, do = _bwd_inputs(cuda, 3, 1, 64, 64, 2, 2, 64, BF16)
    o = flash_attention(q, k, v)
    before = kfa.flash_attention_bwd.launches
    with pytest.raises(ValueError, match="lse"):
        kfa.flash_attention_bwd(q, k, v, o, do)
    assert kfa.flash_attention_bwd.launches == before


@pytest.mark.parametrize("field", ["kv_smem", "keys", "dq_blocks",
                                   "head_split"])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_flash_attention_bwd_refuses_a_plan_not_its_own(cuda, monkeypatch,
                                                        field, dtype):
    """The kernel holds ``bwd_plan``'s plan to its own tiles: a plan off
    in one field raises, launching nothing; the true plan runs."""
    import dataclasses
    from repro_torch.kernels import flash_attention as kfa
    q, k, v, do = _bwd_inputs(cuda, 5, 2, 100, 100, 8, 1, 128, dtype)
    o, lse = kfa.flash_attention_lse(q, k, v)
    true_plan = kfa.bwd_plan
    off = {"head_split": 2} if dtype == BF16 else {}

    def wrong(*args):
        pl = true_plan(*args)
        return dataclasses.replace(
            pl, **{field: off.get(field, getattr(pl, field) + 16)})

    monkeypatch.setattr(kfa, "bwd_plan", wrong)
    before = kfa.flash_attention_bwd.launches
    with pytest.raises(RuntimeError, match="not its own layout"):
        kfa.flash_attention_bwd(q, k, v, o, do, lse=lse)
    assert kfa.flash_attention_bwd.launches == before
    monkeypatch.setattr(kfa, "bwd_plan", true_plan)
    kfa.flash_attention_bwd(q, k, v, o, do, lse=lse)
    assert kfa.flash_attention_bwd.launches == before + 1


def test_train_step_card_matches_cpu(cuda):
    """One fp32 train step of qwen2.5-3b reduced (TF32 off), card
    against CPU from the same state and batch: loss and grad_norm rtol
    1e-5, every param rtol 1e-4 / atol 1e-6 but for at most 1 element
    in 1000 of a leaf within 2 lr (a gradient at rounding level steps by
    its sign), the K bias (a tiny gradient everywhere) within 2 lr, m and
    v rtol 1e-4 / atol 1e-5 x the leaf's largest magnitude."""
    from repro_torch import bridge
    from repro_torch.optim import AdamWConfig, Schedule
    from repro_torch.train import make_train_step, train_state_init
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("qwen2.5-3b").reduced()
    model = build_model(cfg)
    opt = AdamWConfig(schedule=Schedule(peak_lr=3e-3, warmup_steps=0,
                                        decay_steps=10))
    lr = float(opt.schedule(1))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32))
                              .astype(np.int32))
    out = {}
    for dev in ("cpu", "cuda"):
        state = train_state_init(model, opt, torch.Generator().manual_seed(0),
                                 "cpu")
        state = bridge.train_state_from_numpy(
            bridge.train_state_to_numpy(state), cfg, dev)
        state, m = make_train_step(model, opt, accum_steps=2)(
            state, {"tokens": tokens.to(dev)})
        out[dev] = ({k: float(v) for k, v in m.items()},
                    bridge.train_state_to_numpy(state))
    (mc, sc), (mg, sg) = out["cpu"], out["cuda"]
    for name in ("loss", "grad_norm"):
        assert mg[name] == pytest.approx(mc[name], rel=1e-5)
    for key, want in sc.items():
        got = sg[key]
        if key.startswith("params") and key.endswith("/attn/bk"):
            np.testing.assert_allclose(got, want, atol=2 * lr, rtol=0,
                                       err_msg=key)
        elif key.startswith("params"):
            bad = np.abs(got - want) > 1e-6 + 1e-4 * np.abs(want)
            assert bad.sum() <= want.size // 1000, key
            np.testing.assert_allclose(got[bad], want[bad], atol=2 * lr,
                                       rtol=0, err_msg=key)
        else:
            np.testing.assert_allclose(
                got, want, rtol=1e-4,
                atol=1e-5 * float(np.abs(want).max(initial=0.0)),
                err_msg=key)


# --------------------------------------------------------------------- #
# ssd_scan's backward (training through the SSD scan)
# --------------------------------------------------------------------- #

def _ssd_bwd_inputs(seed, bt, s, h, p, n, chunk, x_dtype=F32, bc_dtype=BF16,
                    with_state=True, with_dfinal=True):
    """``_ssd_inputs`` padded to the chunk, with dy (x's dtype, 0 on the
    padded tail), a final-state cotangent and the plain forward's
    entering states."""
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    x, dt_a, b, c, h0 = _ssd_inputs(seed, bt, s, h, p, n, x_dtype, bc_dtype,
                                    with_state)
    g = torch.Generator(device="cuda").manual_seed(seed)
    dy = torch.randn(x.shape, generator=g, device="cuda").to(x_dtype)
    pad = (-s) % chunk
    x, dt_a, b, c, dy = (torch.nn.functional.pad(
        t, (0, 0) * (t.ndim - 2) + (0, pad)) for t in (x, dt_a, b, c, dy))
    dfinal = (torch.randn((bt, h, p, n), generator=g, device="cuda")
              if with_dfinal else None)
    _, _, states = ssd_scan_plain(x, dt_a, b, c, chunk, h0, states=True)
    return x, dt_a, b, c, h0, states, dy, dfinal


@pytest.mark.parametrize("bt,s,h,p,n,chunk,x_dtype,bc_dtype", [
    (4, 512, 80, 64, 128, 256, F32, BF16),     # mamba2's training call
    (2, 1024, 128, 64, 16, 256, F32, BF16),    # jamba's SSM
    (2, 100, 4, 64, 128, 32, F32, BF16),       # padded, 4 chunks
    (2, 300, 8, 64, 128, 100, BF16, BF16),     # bf16 x, ragged tiles
    (2, 256, 8, 48, 64, 64, F32, F32),         # fp32 b / c, p 48, n 64
    (1, 1024, 2, 64, 128, 1024, F32, BF16),    # 16 tiles a chunk
    (3, 200, 5, 18, 20, 64, F32, BF16),        # odd p and n
    (1, 64, 1, 16, 8, 16, F32, F32),           # one head, tiny tiles
])
def test_ssd_scan_bwd_matches_plain(cuda, bt, s, h, p, n, chunk, x_dtype,
                                    bc_dtype):
    """The backward kernel against ``ssd_scan_bwd_plain`` on the same
    inputs and states: every gradient within atol 1e-4 x the plain one's
    largest magnitude (fp32 sums in another order; a bf16 gradient also
    within one bf16 ulp, rtol 2^-7); two calls bit-identical; one launch
    counted a call."""
    from repro_torch.kernels import ssd_scan as kss
    x, dt_a, b, c, _, states, dy, dfinal = _ssd_bwd_inputs(
        s + chunk, bt, s, h, p, n, chunk, x_dtype, bc_dtype)
    before = kss.ssd_scan_bwd.launches
    got = kss.ssd_scan_bwd(x, dt_a, b, c, states, dy, dfinal, chunk)
    again = kss.ssd_scan_bwd(x, dt_a, b, c, states, dy, dfinal, chunk)
    want = kss.ssd_scan_bwd_plain(x, dt_a, b, c, states, dy, dfinal, chunk)
    torch.cuda.synchronize()
    assert kss.ssd_scan_bwd.launches == before + 2
    for name, g, a, w, like in zip(("dx", "ddt", "db", "dc", "dh0"), got,
                                   again, want, (x, dt_a, b, c, dfinal)):
        assert g.dtype == like.dtype and g.shape == like.shape, name
        assert torch.isfinite(g).all(), name
        assert torch.equal(g, a), name
        torch.testing.assert_close(
            g.float(), w.float(), rtol=2.0 ** -7 if g.dtype == BF16 else 0.0,
            atol=1e-4 * w.float().abs().max().item(), msg=name)


def test_ssd_scan_states_match_plain(cuda):
    """The forward kernel's entering states against the plain version's
    (atol 2e-4, as y); y and the final state are the bits of the call
    that stores nothing."""
    from repro_torch.kernels.ssd_scan import ssd_scan_states
    for args, chunk in ((_ssd_inputs(21, 2, 768, 80, 64, 128, F32, BF16),
                         256),
                        (_ssd_inputs(22, 2, 200, 4, 48, 64), 64),
                        (_ssd_inputs(23, 3, 200, 5, 18, 20, F32, BF16), 64)):
        x, dt_a, b, c, h0 = args
        pad = (-x.shape[1]) % chunk
        x, dt_a, b, c = (torch.nn.functional.pad(
            t, (0, 0) * (t.ndim - 2) + (0, pad)) for t in (x, dt_a, b, c))
        y, st, states = ssd_scan_states(x, dt_a, b, c, chunk, h0)
        y0, st0 = ssd_scan(x, dt_a, b, c, chunk=chunk, initial_state=h0)
        _, _, want = ssd_scan_plain(x, dt_a, b, c, chunk, h0, states=True)
        torch.cuda.synchronize()
        assert states.shape == want.shape
        torch.testing.assert_close(states, want, atol=2e-4, rtol=0.0)
        assert torch.equal(states[:, 0], h0)
        assert torch.equal(y, y0) and torch.equal(st, st0)


def test_ssd_scan_trains_through_the_kernels(cuda):
    """``ssd_scan`` with inputs that require grad on the card: one
    forward launch (storing the states) and one backward launch, no
    plain version; the gradients of x, dt_a, b, c and the initial state
    (through the padded tail) match the CPU's (the plain forward and
    backward) within atol 1e-4 x the largest magnitude."""
    from repro_torch.kernels import ssd_scan as kss
    x, dt_a, b, c, h0 = _ssd_inputs(31, 2, 300, 8, 64, 128, F32, F32)
    g = torch.Generator(device="cuda").manual_seed(31)
    dy = torch.randn(x.shape, generator=g, device="cuda")
    dfinal = torch.randn(h0.shape, generator=g, device="cuda")
    grads = {}
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).requires_grad_(True)
                  for t in (x, dt_a, b, c, h0)]
        counts = (kss.ssd_scan.launches, kss.ssd_scan_bwd.launches,
                  kss.ssd_scan_plain.calls, kss.ssd_scan_bwd_plain.calls)
        y, final = kss.ssd_scan(*leaves[:4], chunk=128,
                                initial_state=leaves[4])
        loss = (y * dy.to(dev)).sum() + (final * dfinal.to(dev)).sum()
        grads[dev] = torch.autograd.grad(loss, leaves)
        delta = tuple(a - b_ for a, b_ in zip(
            (kss.ssd_scan.launches, kss.ssd_scan_bwd.launches,
             kss.ssd_scan_plain.calls, kss.ssd_scan_bwd_plain.calls),
            counts))
        assert delta == ((1, 1, 0, 0) if dev == "cuda" else (0, 0, 1, 1))
    for name, got, want in zip(("x", "dt_a", "b", "c", "h0"), grads["cuda"],
                               grads["cpu"]):
        torch.testing.assert_close(got.cpu(), want, rtol=0.0,
                                   atol=1e-4 * want.abs().max().item(),
                                   msg=name)


def test_ssd_scan_bwd_needs_the_forward_states(cuda):
    """On the card the backward takes the forward's states or raises,
    launching nothing."""
    from repro_torch.kernels import ssd_scan as kss
    x, dt_a, b, c, _, _, dy, _ = _ssd_bwd_inputs(41, 1, 64, 2, 16, 16, 32)
    before = kss.ssd_scan_bwd.launches
    with pytest.raises(ValueError, match="states"):
        kss.ssd_scan_bwd(x, dt_a, b, c, None, dy, None, 32)
    assert kss.ssd_scan_bwd.launches == before


@pytest.mark.parametrize("field", ["heads_per_group", "nj", "rows_smem",
                                   "scratch_floats", "tiles"])
def test_ssd_scan_bwd_refuses_a_plan_not_its_own(cuda, monkeypatch, field):
    """The kernel holds ``bwd_plan``'s plan to its own layout: a plan off
    in one field raises, launching nothing; the true plan runs."""
    from repro_torch.kernels import ssd_scan as kss
    x, dt_a, b, c, _, states, dy, dfinal = _ssd_bwd_inputs(
        43, 2, 256, 8, 64, 128, 128)
    true_plan = kss.bwd_plan

    def wrong(*args):
        pl = true_plan(*args)
        return dataclasses.replace(pl, **{field: getattr(pl, field) + 1})

    monkeypatch.setattr(kss, "bwd_plan", wrong)
    before = kss.ssd_scan_bwd.launches
    with pytest.raises(RuntimeError, match="not its own layout"):
        kss.ssd_scan_bwd(x, dt_a, b, c, states, dy, dfinal, 128)
    assert kss.ssd_scan_bwd.launches == before
    monkeypatch.setattr(kss, "bwd_plan", true_plan)
    kss.ssd_scan_bwd(x, dt_a, b, c, states, dy, dfinal, 128)
    assert kss.ssd_scan_bwd.launches == before + 1


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-v0.1-52b"])
def test_ssm_train_step_card_matches_cpu(cuda, arch):
    """One fp32 train step of mamba2 / jamba reduced (TF32 off), card
    against CPU from the same state and batch, with chip_smoke's phase
    3i / 3j tolerances: loss and grad_norm rtol 1e-5, every param rtol
    1e-4 / atol 1e-6 but for at most 1 element in 100 of a leaf within 2
    lr (AdamW steps a gradient at rounding level by its sign: jamba's
    512-element ``wdt`` leaves hold such elements), m and v rtol 1e-4 /
    atol 1e-5 x the leaf's largest magnitude; the card's step launches
    the SSD kernels (twice the forward, once the backward, a layer) and
    no plain version."""
    from repro_torch import bridge
    from repro_torch.kernels import ssd_scan as kss
    from repro_torch.optim import AdamWConfig, Schedule
    from repro_torch.train import make_train_step, train_state_init
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    opt = AdamWConfig(schedule=Schedule(peak_lr=3e-3, warmup_steps=0,
                                        decay_steps=10))
    lr = float(opt.schedule(1))
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 80))
                              .astype(np.int32))
    pattern = cfg.block_pattern()
    n_ssm = sum(pattern[i % len(pattern)].mixer == "ssm"
                for i in range(cfg.n_layers))
    out = {}
    for dev in ("cpu", "cuda"):
        state = train_state_init(model, opt, torch.Generator().manual_seed(0),
                                 "cpu")
        state = bridge.train_state_from_numpy(
            bridge.train_state_to_numpy(state), cfg, dev)
        counts = (kss.ssd_scan.launches, kss.ssd_scan_bwd.launches,
                  kss.ssd_scan_plain.calls, kss.ssd_scan_bwd_plain.calls)
        state, m = make_train_step(model, opt, accum_steps=1)(
            state, {"tokens": tokens.to(dev)})
        delta = tuple(a - b_ for a, b_ in zip(
            (kss.ssd_scan.launches, kss.ssd_scan_bwd.launches,
             kss.ssd_scan_plain.calls, kss.ssd_scan_bwd_plain.calls),
            counts))
        if dev == "cuda":
            assert delta == (2 * n_ssm, n_ssm, 0, 0)
        out[dev] = ({k: float(v) for k, v in m.items()},
                    bridge.train_state_to_numpy(state))
    (mc, sc), (mg, sg) = out["cpu"], out["cuda"]
    for name in ("loss", "grad_norm"):
        assert mg[name] == pytest.approx(mc[name], rel=1e-5)
    for key, want in sc.items():
        got = sg[key]
        if key.startswith("params"):
            bad = np.abs(got - want) > 1e-6 + 1e-4 * np.abs(want)
            assert bad.sum() <= want.size // 100, key
            np.testing.assert_allclose(got[bad], want[bad], atol=2 * lr,
                                       rtol=0, err_msg=key)
        else:
            np.testing.assert_allclose(
                got, want, rtol=1e-4,
                atol=1e-5 * float(np.abs(want).max(initial=0.0)),
                err_msg=key)


# --------------------------------------------------------------------- #
# data-parallel training: the compressed mean and the DP step
# --------------------------------------------------------------------- #

@pytest.fixture
def dp_group(cuda, monkeypatch):
    """One rank of a default group that reduces CPU tensors through gloo
    and the card's through NCCL (a HashStore: no TCP store; bootstrap
    over the loopback device)."""
    import torch.distributed as dist
    monkeypatch.setenv("NCCL_SOCKET_IFNAME", "lo")
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group("cpu:gloo,cuda:nccl", store=dist.HashStore(),
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_compressed_psum_tree_card_matches_cpu(dp_group):
    """The leaf set of the CPU tests (1-D, 2-D, 3-D, all zero, an
    outlier row, leaves at +-qmax) through NCCL on the card and gloo on
    the CPU from the same bits and key: bit-identical, also in blocks
    smaller than a row."""
    import torch_dp_cases as cases
    from repro_torch import bridge
    from repro_torch.distributed import compression
    from repro_torch.serve import prng
    leaves = bridge.unflatten({k: torch.from_numpy(v) for k, v in
                               cases._flat(cases.leaf_set(1)).items()})
    for chunk in (compression.CHUNK, 64):
        old, compression.CHUNK = compression.CHUNK, chunk
        try:
            out = {}
            for dev in ("cpu", "cuda"):
                key = prng.fold_in(prng.prng_key(3, dev),
                                   torch.tensor(2, device=dev))
                tree = bridge.unflatten({k: t.to(dev) for k, t in
                                         bridge.flatten(leaves).items()})
                out[dev] = bridge.flatten(compression.compressed_psum_tree(
                    tree, key, None, 1))
        finally:
            compression.CHUNK = old
        for k, want in out["cpu"].items():
            got = out["cuda"][k]
            assert got.device.type == "cuda"
            assert torch.equal(got.cpu().view(torch.int32),
                               want.view(torch.int32)), (chunk, k)


@pytest.mark.parametrize("compress", [False, True])
def test_local_dp_step_card_matches_cpu(dp_group, compress):
    """One DP step at accum 2 of qwen2.5-3b reduced (fp32, TF32 off), the
    card's through NCCL against the CPU's through gloo, from the same
    state and batch: loss and grad_norm rtol 1e-5, every param within
    rtol 1e-4 / atol 1e-6 but for at most 1 element in 100 of a leaf,
    within 2 lr (a gradient at a rounding boundary steps by its sign, or
    by a quantum of the compressed mean), the launches those of the
    attention kernels and no plain version."""
    from repro_torch import bridge
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.optim import AdamWConfig, Schedule
    from repro_torch.train import make_local_dp_train_step, train_state_init
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("qwen2.5-3b").reduced()
    model = build_model(cfg)
    opt = AdamWConfig(schedule=Schedule(peak_lr=3e-3, warmup_steps=0,
                                        decay_steps=10))
    lr = float(opt.schedule(1))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, 32)).astype(np.int32))
    state0 = bridge.train_state_to_numpy(train_state_init(
        model, opt, torch.Generator().manual_seed(0), "cpu"))
    out = {}
    for dev in ("cpu", "cuda"):
        state = bridge.train_state_from_numpy(state0, cfg, dev)
        before = (kfa.flash_attention.launches,
                  kfa.flash_attention_bwd.launches,
                  kfa.flash_attention_plain.calls)
        state, m = make_local_dp_train_step(
            model, opt, accum_steps=2, compress=compress)(
                state, {"tokens": tokens.to(dev)})
        if dev == "cuda":
            assert (kfa.flash_attention.launches - before[0],
                    kfa.flash_attention_bwd.launches - before[1],
                    kfa.flash_attention_plain.calls - before[2]) == (
                        2 * 2 * cfg.n_layers, 2 * cfg.n_layers, 0)
        out[dev] = ({k: float(v) for k, v in m.items()},
                    bridge.train_state_to_numpy(state))
    (mc, sc), (mg, sg) = out["cpu"], out["cuda"]
    for name in ("loss", "grad_norm"):
        assert mg[name] == pytest.approx(mc[name], rel=1e-5)
    assert int(sg["opt/step"]) == int(sc["opt/step"]) == 1
    for key, want in sc.items():
        if key.startswith("params"):
            got = sg[key]
            bad = np.abs(got - want) > 1e-6 + 1e-4 * np.abs(want)
            if not key.endswith("/attn/bk"):
                assert bad.sum() <= want.size // 100, key
            np.testing.assert_allclose(got[bad], want[bad], atol=2 * lr,
                                       rtol=0, err_msg=key)


def test_nvml_device_is_torchs_by_uuid(cuda):
    """NVML's device for cuda:0 is found by torch's UUID, and its name
    and UUID are torch's (``nvml.Device`` raises otherwise)."""
    from repro_torch.core import nvml
    ok, why = nvml.available()
    assert ok, why
    dev = nvml.Device(0)
    props = torch.cuda.get_device_properties(0)
    assert dev.name == torch.cuda.get_device_name(0) == props.name
    assert dev.uuid == dev.nvml_uuid == nvml.nvml_uuid(props.uuid)
    assert dev.uuid.startswith("GPU-")


def test_nvml_counter_rises_under_a_loop_within_the_limit(cuda):
    """A bf16 matmul loop over ~30 counter periods: the counter rises by
    at least 10 updates, and the mean and the instant power lie in (0,
    1.05 x the enforced limit]."""
    from repro_torch.core import nvml
    dev = nvml.Device(0)
    a = torch.randn((4096, 4096), device="cuda").bfloat16()
    with nvml.EnergyWindow(dev, poll_s=1e-3) as w:
        t_end = time.perf_counter() + 30.0
        while len(w.points) <= 30 and time.perf_counter() < t_end:
            for _ in range(8):
                b = a @ a
            b.sum().item()
    assert w.updates >= 10 and w.joules > 0 and w.counter_joules >= w.joules
    assert w.seconds == pytest.approx(w.updates * w.period_s, rel=0.5)
    limit = dev.power_limit_w()
    assert w.end.limit_w == limit > 0
    assert 0 < w.watts <= 1.05 * limit
    assert 0 < dev.power_w() <= 1.05 * limit
    sm, mem = dev.clocks_mhz()
    assert sm > 0 and mem > 0 and dev.temperature_c() > 0
