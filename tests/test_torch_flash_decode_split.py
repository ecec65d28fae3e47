"""The decode kernels' launch plans, on the CPU: ``splits_for`` (how many
blocks share the S axis), the copy widths and the workspace of
``flash_decode.plan`` and ``flash_decode_quant.plan``, and every input
check those plans make.  The CUDA path calls ``plan`` before each launch;
it reads shapes, dtypes, strides and addresses only, so CPU tensors reach
it here.  The kernels themselves are held to their plain versions on the
card (``tests/test_torch_cuda.py``).
"""

import pytest
import torch

from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import flash_decode_quant as fdq
from repro_torch.models import attention as attn

SMS = 132                               # an H100 SXM
BF16, F32 = torch.bfloat16, torch.float32


def _dense(b=8, S=1024, hq=16, hkv=16, d=128, dtype=BF16, q_dtype=None):
    q = torch.zeros((b, 1, hq, d), dtype=q_dtype or dtype)
    k = torch.zeros((b, S, hkv, d), dtype=dtype)
    v = torch.zeros((b, S, hkv, d), dtype=dtype)
    sp = torch.full((b, S), -1, dtype=torch.int32)
    pos = torch.zeros((b,), dtype=torch.int32)
    return q, k, v, sp, pos


def _quant(fmt, b=2, S=64, hq=4, hkv=2, d=128, q_dtype=BF16):
    q = torch.zeros((b, 1, hq, d), dtype=q_dtype)
    kv = attn.init_kv_cache(b, S, hkv, d, F32, "cpu", kv_format=fmt)
    return q, kv, torch.zeros((b,), dtype=torch.int32)


# ---- splits_for ------------------------------------------------------- #

@pytest.mark.parametrize("S", [1, 63, 64, 65, 1024, 4096])
@pytest.mark.parametrize("b,per_row", [(1, 1), (1, 16), (8, 16), (2, 4),
                                       (8, 64), (64, 32)])
def test_splits_never_exceed_the_tiles(S, b, per_row):
    splits = fd.splits_for(b, per_row, S, SMS)
    assert 1 <= splits <= max(1, -(-S // fd.TILE))


@pytest.mark.parametrize("S", [1, 63, 64, 65, 1024, 4096])
@pytest.mark.parametrize("b,per_row", [(33, 16), (64, 32), (528, 1),
                                       (8, 128)])
def test_splits_are_one_where_the_blocks_fill_the_card(S, b, per_row):
    """b x blocks a row >= BLOCKS_PER_SM x SMs: no split."""
    assert b * per_row >= fd.BLOCKS_PER_SM * SMS
    assert fd.splits_for(b, per_row, S, SMS) == 1


def test_splits_follow_shapes_and_sm_count():
    # the serving shape: 128 (b, kv-head) blocks on 132 SMs, one wave
    assert fd.splits_for(8, 16, 1024, SMS) == 4
    assert fd.splits_for(8, 16, 1024, SMS) * 128 <= fd.BLOCKS_PER_SM * SMS
    # one long row of one kv-head takes every tile of S
    assert fd.splits_for(1, 1, 4096, SMS) == 128
    assert fd.splits_for(1, 1, 65, SMS) == 3
    assert fd.splits_for(1, 1, 1, SMS) == 1
    # fewer SMs, fewer splits
    assert fd.splits_for(8, 16, 1024, 16) == 1
    assert fd.splits_for(8, 16, 1024, 264) == 8


def test_plan_reads_no_pos():
    """The plan is a function of shapes: pos and slot_pos (which live on
    the card) never change it."""
    q, k, v, sp, pos = _dense()
    plans = set()
    for p in (0, 300, 1023, 5000, -1):
        pos.fill_(p)
        sp.copy_(torch.arange(1024, dtype=torch.int32) - p % 7)
        plans.add(fd.plan(q, k, v, sp, pos, SMS))
    assert len(plans) == 1


# ---- workspace and copy widths ---------------------------------------- #

def test_plan_serving_shape_workspace_and_width():
    pl = fd.plan(*_dense(), SMS)
    assert (pl.g_per_block, pl.blocks_per_row, pl.splits) == (1, 16, 4)
    assert pl.widths == (16,)
    assert pl.workspace == (8, 16, 4, 130)


def test_plan_one_split_has_no_workspace():
    pl = fd.plan(*_dense(b=64, hq=32, hkv=16), SMS)
    assert pl.splits == 1 and pl.workspace is None


@pytest.mark.parametrize("hq,hkv,g,per_row", [(32, 8, 4, 8), (16, 1, 8, 2),
                                              (24, 2, 8, 4), (12, 4, 3, 4)])
def test_plan_gqa_chunks(hq, hkv, g, per_row):
    pl = fd.plan(*_dense(b=2, S=256, hq=hq, hkv=hkv, d=64), SMS)
    assert (pl.g_per_block, pl.blocks_per_row) == (g, per_row)
    assert pl.workspace == (2, hq, pl.splits, 66)


@pytest.mark.parametrize("dtype,pad,width", [
    (BF16, 0, 16), (BF16, 8, 16), (BF16, 4, 8), (BF16, 2, 4), (BF16, 1, 2),
    (F32, 0, 16), (F32, 2, 8), (F32, 1, 4)])
def test_copy_width_of_strided_cache_views(dtype, pad, width):
    """A cache view inside rows of d + pad elements: the copy is as wide
    as the row stride (and the address) allow."""
    b, S, hkv, d = 2, 96, 2, 128
    q, _, _, sp, pos = _dense(b=b, S=S, hq=4, hkv=hkv, d=d, dtype=dtype)
    buf = torch.zeros((b, S, hkv, d + pad), dtype=dtype)
    k = v = buf[..., :d]
    assert fd.plan(q, k, v, sp, pos, SMS).widths == (width,)


def test_copy_width_of_head_major_view_and_offset():
    """A (b, hkv, S, d) cache handed over as a (b, S, hkv, d) view keeps
    16-byte copies; the same view one element into its buffer takes 2."""
    b, S, hkv, d = 2, 80, 2, 64
    q, _, _, sp, pos = _dense(b=b, S=S, hq=4, hkv=hkv, d=d)
    k = torch.zeros((b, hkv, S, d), dtype=BF16).transpose(1, 2)
    assert fd.plan(q, k, k, sp, pos, SMS).widths == (16,)
    flat = torch.zeros(b * hkv * S * d + 1, dtype=BF16)
    k1 = flat[1:].view(b, hkv, S, d).transpose(1, 2)
    assert fd.plan(q, k1, k1, sp, pos, SMS).widths == (2,)


@pytest.mark.parametrize("fmt,d,widths", [
    ("float8_e4m3fn", 128, (16, 4)),     # 128-byte code rows, 4 scales
    ("float4_e2m1fn", 128, (16, 4)),     # 64-byte rows
    ("float6_e2m3fn", 128, (16, 4)),     # 96-byte rows
    ("float6_e3m2fn", 32, (8, 1)),       # 24-byte rows, one scale
    ("float8_e5m2", 64, (16, 2)),
    ("float4_e2m1fn", 16, (8, 1))])
def test_quant_copy_widths(fmt, d, widths):
    q, kv, pos = _quant(fmt, d=d)
    pl = fdq.plan(q, kv, pos, fmt, SMS)
    assert pl.widths == widths
    assert pl.workspace == (2, 4, pl.splits, d + 2)


def test_quant_strided_pool_view_widths():
    """The engine's layer view of a period-stacked pool (a strided slice)
    keeps the widths of a contiguous cache; a code view one byte into its
    buffer takes 1-byte copies."""
    fmt = "float8_e4m3fn"
    q, kv, pos = _quant(fmt, S=80, hkv=2, hq=8, d=64)
    stacked = {n: torch.stack([t, t]).transpose(0, 1).contiguous()
               .transpose(0, 1) for n, t in kv.items()}
    layer = {n: t[1] for n, t in stacked.items()}
    assert fdq.plan(q, layer, pos, fmt, SMS).widths == (16, 2)
    codes = kv["k_q"]
    flat = torch.zeros(codes.numel() + 1, dtype=codes.dtype)
    off = dict(kv, k_q=flat[1:].view(codes.shape))
    assert fdq.plan(q, off, pos, fmt, SMS).widths == (1, 2)


def test_quant_plan_matches_dense_schedule():
    q, kv, pos = _quant("float4_e2m1fn", b=8, S=1024, hq=16, hkv=16)
    pl = fdq.plan(q, kv, pos, "float4_e2m1fn", SMS)
    dense = fd.plan(*_dense(), SMS)
    assert (pl.g_per_block, pl.blocks_per_row, pl.splits, pl.workspace) == (
        dense.g_per_block, dense.blocks_per_row, dense.splits,
        dense.workspace)


# ---- input checks ------------------------------------------------------ #

META = torch.device("meta")


def _bad_dense(case):
    q, k, v, sp, pos = _dense(b=2, S=64, hq=4, hkv=2, d=64)
    if case == "q_two_tokens":
        q = torch.zeros((2, 2, 4, 64), dtype=BF16)
    elif case == "v_shape":
        v = torch.zeros((2, 65, 2, 64), dtype=BF16)
    elif case == "slot_pos_shape":
        sp = torch.zeros((2, 63), dtype=torch.int32)
    elif case == "pos_shape":
        pos = torch.zeros((3,), dtype=torch.int32)
    elif case == "gqa_ratio":
        q = torch.zeros((2, 1, 3, 64), dtype=BF16)
    elif case == "d_over_256":
        q, k, v, sp, pos = _dense(b=2, S=64, hq=4, hkv=2, d=264)
    elif case == "kv_dtypes_differ":
        v = v.float()
    elif case == "bf16_q_f32_cache":
        k, v = k.float(), v.float()
    elif case == "f16_q":
        q = q.half()
    elif case == "slot_pos_int64":
        sp = sp.long()
    elif case == "slot_pos_strided":
        sp = torch.zeros((2, 128), dtype=torch.int32)[:, ::2]
    elif case == "pos_strided":
        pos = torch.zeros((4,), dtype=torch.int32)[::2]
    elif case == "head_dim_strided":
        k = torch.zeros((2, 64, 2, 128), dtype=BF16)[..., ::2]
    elif case == "q_head_dim_strided":
        q = torch.zeros((2, 1, 4, 128), dtype=BF16)[..., ::2]
    elif case == "k_other_device":
        k = k.to(META)
    elif case == "slot_pos_other_device":
        sp = sp.to(META)
    elif case == "pos_other_device":
        pos = pos.to(META)
    return q, k, v, sp, pos


DENSE_CHECKS = {
    "q_two_tokens": ValueError, "v_shape": ValueError,
    "slot_pos_shape": ValueError, "pos_shape": ValueError,
    "gqa_ratio": ValueError, "d_over_256": ValueError,
    "kv_dtypes_differ": TypeError, "bf16_q_f32_cache": TypeError,
    "f16_q": TypeError, "slot_pos_int64": TypeError,
    "slot_pos_strided": ValueError, "pos_strided": ValueError,
    "head_dim_strided": ValueError, "q_head_dim_strided": ValueError,
    "k_other_device": ValueError, "slot_pos_other_device": ValueError,
    "pos_other_device": ValueError}


@pytest.mark.parametrize("case", sorted(DENSE_CHECKS))
def test_dense_plan_refuses(case):
    with pytest.raises(DENSE_CHECKS[case]):
        fd.plan(*_bad_dense(case), SMS)


def _bad_quant(case):
    fmt = "float4_e2m1fn" if case.startswith("fp4") else "float8_e4m3fn"
    q, kv, pos = _quant(fmt, d=64)
    kv = dict(kv)
    if case == "fp8_stored_d":
        kv["k_q"] = kv["v_q"] = torch.zeros((2, 64, 2, 32),
                                            dtype=torch.float8_e4m3fn)
    elif case == "fp8_scale_shape":
        kv["v_s"] = torch.zeros((2, 64, 2, 4), dtype=torch.uint8)
    elif case == "fp8_scale_block_not_4":
        q, kv, pos = _quant(fmt, d=6)
    elif case == "fp8_d_over_256":
        q, kv, pos = _quant(fmt, d=288)
    elif case == "fp8_gqa_ratio":
        q = torch.zeros((2, 1, 3, 64), dtype=BF16)
    elif case == "fp8_q_dtype":
        q = q.half()
    elif case == "fp4_codes_dtype":
        kv["k_q"] = kv["k_q"].view(torch.int8)
        kv["v_q"] = kv["v_q"].view(torch.int8)
    elif case == "fp8_codes_as_bytes":
        kv["k_q"] = kv["k_q"].view(torch.uint8)
        kv["v_q"] = kv["v_q"].view(torch.uint8)
    elif case == "fp8_scales_dtype":
        kv["k_s"] = kv["k_s"].to(torch.int32)
    elif case == "fp8_slot_pos_dtype":
        kv["slot_pos"] = kv["slot_pos"].long()
    elif case == "fp8_pos_shape":
        pos = torch.zeros((1,), dtype=torch.int32)
    elif case == "fp8_codes_strided":
        big = torch.zeros((2, 64, 2, 128), dtype=torch.float8_e4m3fn)
        kv["k_q"] = big[..., ::2]
    elif case == "fp8_scales_other_device":
        kv["v_s"] = kv["v_s"].to(META)
    elif case == "fp8_pos_other_device":
        pos = pos.to(META)
    return q, kv, pos, fmt


QUANT_CHECKS = {
    "fp8_stored_d": ValueError, "fp8_scale_shape": ValueError,
    "fp8_scale_block_not_4": ValueError, "fp8_d_over_256": ValueError,
    "fp8_gqa_ratio": ValueError, "fp8_q_dtype": TypeError,
    "fp4_codes_dtype": TypeError, "fp8_codes_as_bytes": TypeError,
    "fp8_scales_dtype": TypeError, "fp8_slot_pos_dtype": TypeError,
    "fp8_pos_shape": ValueError, "fp8_codes_strided": ValueError,
    "fp8_scales_other_device": ValueError,
    "fp8_pos_other_device": ValueError}


@pytest.mark.parametrize("case", sorted(QUANT_CHECKS))
def test_quant_plan_refuses(case):
    q, kv, pos, fmt = _bad_quant(case)
    with pytest.raises(QUANT_CHECKS[case]):
        fdq.plan(q, kv, pos, fmt, SMS)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrappers run the plain versions and count no
    launch."""
    q, k, v, sp, pos = _dense(b=2, S=64, hq=4, hkv=2, d=32, dtype=F32)
    sp.copy_(torch.arange(64, dtype=torch.int32))
    pos.fill_(40)
    before = fd.flash_decode.launches
    out = fd.flash_decode(q, k, v, sp, pos)
    assert torch.equal(out, fd.flash_decode_plain(q, k, v, sp, pos,
                                                  scale=32 ** -0.5))
    assert fd.flash_decode.launches == before
    q, kv, pos = _quant("float4_e2m1fn", d=32, q_dtype=F32)
    before = fdq.flash_decode_quant.launches
    fdq.flash_decode_quant(q, kv, pos, fmt="float4_e2m1fn")
    assert fdq.flash_decode_quant.launches == before
