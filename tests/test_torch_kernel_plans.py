"""The launch plans of ``mma_probe``, ``flash_attention`` (forward and
backward) and ``ssd_scan``, on the CPU: the block tile, grid and shared
memory of ``probe_mma.plan``; the tile, stages, shared memory, head
groups and block order of ``flash_attention.plan``; the tiles, shared
memory, q-head split and grids of ``flash_attention.bwd_plan``; the
slices of p, padding of n,
copy width, shared memory and blocks an SM of ``ssd_scan.plan``; and
every input check those plans make.  The
CUDA paths call ``plan`` before each launch; it reads shapes, dtypes,
strides and addresses only, so CPU tensors reach it here.  The kernels
themselves are held to their plain versions on the card
(``tests/test_torch_cuda.py``).
"""

import dataclasses
import itertools
import pathlib
import re

import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import probe_mma as pm
from repro_torch.kernels import ssd_scan as ss

SMS = 132                                # an H100 SXM
BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32


# ---- probe_mma.plan ---------------------------------------------------- #

def _ab(batch=16, ilp=4, m=128, k=128, n=128, dtype=BF16):
    return (torch.zeros((batch, ilp, m, k), dtype=dtype),
            torch.zeros((batch, ilp, k, n), dtype=dtype))


def test_probe_plan_fills_the_card_at_the_timed_shape():
    """batch 16 x ilp 4 products of 128^3: a block per (entry, 32 x 32
    tile) gives 256 blocks, more than the 132 SMs (a 128 x 128 tile would
    give 16)."""
    pl = pm.plan(*_ab(), torch.float32)
    assert (pl.bm, pl.bn) == pm.BLOCK_TILE == (32, 32)
    assert pl.grid == (16, 16)
    assert pl.grid[0] * pl.grid[1] >= SMS


@pytest.mark.parametrize("m,n,k", [(128, 128, 128), (48, 72, 48),
                                   (16, 8, 16), (256, 40, 96)])
@pytest.mark.parametrize("dtype", [BF16, F16, F32], ids=["bf16", "fp16",
                                                         "tf32"])
def test_probe_plan_tiles_ragged_shapes(dtype, m, n, k):
    """m, n off the block tile take one more tile each; a stage holds 64
    bytes of k (32 values, 16 for fp32)."""
    pl = pm.plan(*_ab(3, 2, m, k, n, dtype), dtype)
    assert pl.grid == (-(-m // 32) * -(-n // 32), 3)
    assert pl.bk == (16 if dtype == F32 else 32)
    assert pl.bk * torch.empty((), dtype=dtype).element_size() == 64


@pytest.mark.parametrize("ilp", range(1, 9))
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "tf32"])
def test_probe_plan_shared_memory_per_ilp(dtype, ilp):
    pl = pm.plan(*_ab(1, ilp, dtype=dtype), F32)
    assert pl.smem_bytes == pl.stages * ilp * pm.PRODUCT_STAGE_BYTES
    assert pl.stages >= 2 and pl.smem_bytes <= fa.SMEM_LIMIT
    assert pl.threads == 128


def test_probe_plan_takes_a_broadcast_y():
    """``mma_probe`` passes y.expand(1, ilp, k, n): batch and ilp strides 0."""
    x = torch.zeros((1, 4, 128, 64), dtype=BF16)
    y = torch.zeros((64, 32), dtype=BF16).expand(1, 4, 64, 32)
    assert y.stride()[:2] == (0, 0)
    assert pm.plan(x, y, BF16).grid == (4, 1)


def _bad_probe_calls():
    a, b = _ab(2, 2, 32, 32, 32)
    yield "ndim", (a[0], b[0], F32), ValueError
    yield "k mismatch", (a, _ab(2, 2, 32, 48, 32)[1], F32), ValueError
    yield "dtypes differ", (a, b.float(), F32), ValueError
    yield "int8 in", (a.to(torch.int8), b.to(torch.int8), F32), TypeError
    yield "fp16 out of bf16", (a, b, F16), TypeError
    yield "m % 16", (*_ab(1, 1, 24, 32, 32), F32), ValueError
    yield "n % 8", (*_ab(1, 1, 32, 32, 20), F32), ValueError
    yield "k % 16", (*_ab(1, 1, 32, 24, 32), F32), ValueError
    yield "tf32 k % 8", (*_ab(1, 1, 32, 12, 32, F32), F32), ValueError
    yield "ilp 9", (*_ab(1, 9, 32, 32, 32), F32), ValueError
    big = torch.zeros((1, 1, 16, 16), dtype=BF16).expand(65536, 1, 16, 16)
    yield "batch", (big, big, F32), ValueError
    yield "k not unit-stride", (a.transpose(2, 3), b, F32), ValueError
    wide = torch.zeros((2, 2, 32, 40), dtype=BF16)[..., 4:36]
    yield "a off 16 bytes", (wide, b, F32), ValueError
    ragged = torch.zeros((2, 2, 32, 36), dtype=BF16)[..., :32]
    yield "b row stride off 16 bytes", (a, ragged, F32), ValueError


@pytest.mark.parametrize("case,args,exc", list(_bad_probe_calls()),
                         ids=[c for c, _, _ in _bad_probe_calls()])
def test_probe_plan_refuses(case, args, exc):
    with pytest.raises(exc):
        pm.plan(*args)


def test_probe_plan_accepts_what_mma_products_makes():
    """``_mm_ilp`` pads to the fragment and hands contiguous tensors."""
    for dtype, kstep in ((BF16, 16), (F16, 16), (F32, 8)):
        pm.plan(*_ab(2, 3, 16, kstep, 8, dtype), F32)


# ---- flash_attention.plan ---------------------------------------------- #

def _qkv(b=2, sq=300, skv=300, hq=4, hkv=2, d=128, dtype=BF16):
    return (torch.zeros((b, sq, hq, d), dtype=dtype),
            torch.zeros((b, skv, hkv, d), dtype=dtype),
            torch.zeros((b, skv, hkv, d), dtype=dtype))


@pytest.mark.parametrize("d", [16, 64, 72, 96, 128, 200, 256])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_attention_tiles_fit_shared_memory(dtype, d):
    pl = fa.plan(*_qkv(d=d, dtype=dtype), None, 0)
    assert pl.d_pad == (64 if d <= 64 else 128 if d <= 128 else 256)
    assert pl.smem_bytes <= fa.SMEM_LIMIT
    if dtype == BF16:
        assert (pl.rows, pl.threads) == (128, 384)
        assert pl.bk == (64 if pl.d_pad == 256 else 128)
        assert pl.stages >= 2
        # q tile + K and V rings + 9 mbarriers + 1024 bytes of alignment
        assert pl.smem_bytes == (128 + 2 * pl.stages * pl.bk) * pl.d_pad * 2 \
            + 9 * 8 + 1024
    else:
        assert (pl.rows, pl.threads, pl.bk) == (64, 256, 64)


@pytest.mark.parametrize("b,sq,hq,hkv,skv,dtype", [
    (8, 2048, 16, 16, 2048, BF16),       # gptneox-1b prefill, (a)
    (2, 300, 32, 8, 1000, BF16),         # GQA 32/8
    (3, 1, 4, 1, 5000, BF16),
    (1, 129, 8, 4, 129, BF16),
    (2, 300, 4, 2, 300, F32),
])
def test_attention_blocks_heaviest_first_within_head_groups(b, sq, hq, hkv,
                                                            skv, dtype):
    """Every (pair, q tile) once; a group is a run of whole GQA groups of
    pairs, all its q tiles before the next group's, the last q tile (the
    causal tail) first; bf16 groups hold at most GROUP_KV_BYTES of K and
    V unless one kv head alone is more."""
    pl = fa.plan(*_qkv(b, sq, skv, hq, hkv, 64, dtype), None, 0)
    assert pl.pairs == b * hq and pl.q_tiles == -(-sq // pl.rows)
    order = [pl.block(i) for i in range(pl.blocks)]
    assert sorted(order) == sorted(itertools.product(range(b * hq),
                                                     range(pl.q_tiles)))
    ratio = hq // hkv
    assert pl.head_group % ratio == 0 or pl.head_group == b * hq
    per_kv_head = 2 * skv * 64 * 2
    if dtype == BF16 and per_kv_head <= fa.GROUP_KV_BYTES:
        assert pl.head_group // ratio * per_kv_head <= fa.GROUP_KV_BYTES
    if dtype == F32:
        assert pl.head_group == b * hq      # the fp32 grid: one group
    span = pl.head_group * pl.q_tiles
    for g0 in range(0, pl.blocks, span):
        chunk = order[g0:g0 + span]
        pairs = {p for p, _ in chunk}
        assert pairs == set(range(min(pairs), max(pairs) + 1))
        assert min(pairs) % pl.head_group == 0
        tiles = [t for _, t in chunk]
        assert tiles == sorted(tiles, reverse=True)
        assert tiles[0] == pl.q_tiles - 1


def test_attention_head_group_at_the_prefill_shape():
    """gptneox-1b, b 8 x 16 heads, s 2048: 1 MiB of K and V a head, 16
    heads a group (256 blocks of 128 rows, about two waves of 132)."""
    pl = fa.plan(*_qkv(8, 2048, 2048, 16, 16, 128), None, 0)
    assert (pl.head_group, pl.q_tiles, pl.blocks) == (16, 16, 2048)


def test_attention_plan_refuses_what_tma_cannot_read():
    """bf16 K/V reach the kernel through TMA maps: a broadcast (stride 0)
    axis of extent > 1 is refused; fp32 (plain loads) takes it."""
    q, k, v = _qkv(hq=4, hkv=1)
    kb = torch.zeros((2, 300, 1, 128), dtype=BF16).expand(2, 300, 4, 128)
    with pytest.raises(ValueError, match="TMA"):
        fa.plan(q, kb, kb, None, 0)
    qf, kf, _ = _qkv(hq=4, hkv=1, dtype=F32)
    kbf = kf.expand(2, 300, 4, 128)
    assert fa.plan(qf, kbf, kbf, None, 0).head_group == 8
    # a stride-0 axis of extent 1 is never followed: taken
    k1 = torch.zeros((1, 300, 1, 128), dtype=BF16).expand(1, 300, 1, 128)
    q1 = torch.zeros((1, 300, 4, 128), dtype=BF16)
    assert fa.plan(q1, k1, k1, None, 0).pairs == 4


def test_attention_plan_refuses_too_many_q_tiles():
    q = torch.zeros((1, 1, 1, 64)).expand(1, 64 * 65535 + 1, 1, 64)
    k = torch.zeros((1, 8, 1, 64))
    with pytest.raises(ValueError, match="65535"):
        fa.plan(q, k, k, None, 0)


@pytest.mark.parametrize("case", ["shapes", "dtype", "d", "stride",
                                  "window", "offset"])
def test_attention_plan_keeps_the_old_checks(case):
    q, k, v = _qkv()
    args = {
        "shapes": (q, k[:, :, :1], v, None, 0),
        "dtype": (q, k.float(), v, None, 0),
        "d": (*_qkv(d=260), None, 0),
        "stride": (q.transpose(1, 3).contiguous().transpose(1, 3), k, v,
                   None, 0),
        "window": (q, k, v, 0, 0),
        "offset": (q, k, v, None, -1),
    }[case]
    with pytest.raises((ValueError, TypeError)):
        fa.plan(*args)


# ---- flash_attention.bwd_plan ------------------------------------------ #

def _bwd(b=2, sq=300, skv=300, hq=4, hkv=2, d=128, dtype=BF16):
    q, k, v = _qkv(b, sq, skv, hq, hkv, d, dtype)
    return q, k, v, q.clone(), q.clone(), torch.zeros((b, hq, sq))


@pytest.mark.parametrize("d", [16, 40, 64, 72, 128, 200, 256])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_bwd_plan_fits_shared_memory(dtype, d):
    """Both passes' tiles fit a block's shared memory at every head_dim;
    bf16 runs two consumer warpgroups and a producer (64 keys each, or
    both on 64 keys at d 256), fp32 256 threads."""
    pl = fa.bwd_plan(*_bwd(d=d, dtype=dtype), None, SMS)
    assert pl.d_pad == (64 if d <= 64 else 128 if d <= 128 else 256)
    assert max(pl.kv_smem, pl.dq_smem) <= fa.SMEM_LIMIT
    if dtype == BF16:
        assert pl.threads == 384 and pl.q_tile == 64 and pl.dq_rows == 128
        assert pl.keys == (64 if pl.d_pad == 256 else 128)
        assert min(pl.kv_stages, pl.dq_stages) >= 2
    else:
        assert pl.threads == 256 and pl.head_split == 1
    assert pl.sq_pad % 128 == 0 and 0 <= pl.sq_pad - 300 < 128


def test_bwd_plan_splits_the_group_at_the_training_shape():
    """qwen2.5-3b's training call (b 8, s 256, 16 q heads over 2 kv heads,
    d 128): 8 x 2 x 2 key blocks are under 132 SMs, so each GQA group of
    8 q heads is split, to at least 132 blocks: 8 blocks of one head
    each, 256 blocks, fp32 partials of dK and dV for each split, and a
    reduce; row 5's shape (b 8, s 2048, 16 heads) needs no split."""
    pl = fa.bwd_plan(*_bwd(8, 256, 256, 16, 2, 128), None, SMS)
    assert pl.kv_blocks >= SMS and 8 % pl.head_split == 0
    assert (pl.head_split, pl.kv_blocks, pl.dq_blocks) == (8, 256, 256)
    assert pl.part_floats == 2 * 8 * (8 * 256 * 2 * 128)
    assert pl.launches == 4 and pl.reduce_blocks > 0
    big = fa.bwd_plan(*_bwd(8, 2048, 2048, 16, 16, 128), None, SMS)
    assert (big.head_split, big.part_floats, big.launches) == (1, 0, 3)
    assert big.kv_blocks == 8 * 16 * 16


@pytest.mark.parametrize("b,s,hq,hkv,d", [
    (8, 256, 16, 2, 128), (2, 1024, 8, 4, 256), (1, 100, 8, 1, 128),
    (4, 1000, 16, 16, 64), (1, 64, 12, 4, 128), (2, 512, 8, 2, 128)])
def test_bwd_plan_split_is_the_smallest_divisor_that_fills(b, s, hq, hkv, d):
    """head_split divides hq / hkv; it is the smallest one that brings (B)
    to ``SMS`` blocks, or all of the group where none does; (B) has a
    block per (pair, key tile, split), (C) one per (batch row, q head, q
    tile), and the split's partials are dK and dV once per split."""
    pl = fa.bwd_plan(*_bwd(b, s, s, hq, hkv, d), None, SMS)
    ratio, n_kt = hq // hkv, -(-s // pl.keys)
    assert ratio % pl.head_split == 0
    base = b * hkv * n_kt
    fits = [x for x in range(1, ratio + 1)
            if ratio % x == 0 and (base >= SMS or base * x >= SMS)]
    assert pl.head_split == (fits[0] if fits else ratio)
    assert pl.kv_blocks == base * pl.head_split
    assert pl.dq_blocks == b * hq * -(-s // pl.dq_rows)
    n_el = b * s * hkv * d
    assert pl.part_floats == (2 * pl.head_split * n_el
                              if pl.head_split > 1 else 0)
    assert pl.reduce_blocks == (-(-n_el // 1024) if pl.part_floats else 0)


def test_bwd_plan_fields_are_the_kernels_order():
    """``BwdPlan.launch_args`` hands the kernel every field in the order
    of ``csrc/flash_attention_bwd.cu``'s ``pf::Field``, by which the
    kernel reads them (``kDPad`` is ``d_pad``)."""
    src = (pathlib.Path(fa.__file__).parents[1] / "csrc"
           / "flash_attention_bwd.cu").read_text()
    body = re.search(r"namespace pf \{\s*enum Field \{([^}]*)\}", src)
    names = [n.strip() for n in body.group(1).split(",")]
    assert names[-1] == "kFields"
    snake = [re.sub(r"(?<!^)(?=[A-Z])", "_", n[1:]).lower()
             for n in names[:-1]]
    assert snake == [f.name for f in dataclasses.fields(fa.BwdPlan)]
    pl = fa.bwd_plan(*_bwd(8, 256, 256, 16, 2, 128), None, SMS)
    assert pl.launch_args() == tuple(getattr(pl, n) for n in snake)


def test_bwd_plan_refuses_what_tma_cannot_read():
    """bf16 q, k, v, o and dO reach the kernel through TMA maps or 16-byte
    rows: a broadcast (stride 0) axis of extent > 1, a stride off 16
    bytes or a head_dim off 8 values is refused; fp32 takes them."""
    q, k, v, o, do, lse = _bwd(hq=4, hkv=1)
    kb = torch.zeros((2, 300, 1, 128), dtype=BF16).expand(2, 300, 4, 128)
    with pytest.raises(ValueError, match="TMA"):
        fa.bwd_plan(q, kb, kb, o, do, torch.zeros((2, 4, 300)), None, SMS)
    odd = torch.zeros((2, 300, 4, 132), dtype=BF16)[..., :128]
    with pytest.raises(ValueError, match="TMA"):
        fa.bwd_plan(q, k, v, odd, do, lse, None, SMS)
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.bwd_plan(*_bwd(d=36), None, SMS)
    qf, kf, vf, of, dof, lsef = _bwd(hq=4, hkv=1, dtype=F32)
    kbf = kf.expand(2, 300, 4, 128)
    assert fa.bwd_plan(qf, kbf, kbf, of, dof, torch.zeros((2, 4, 300)),
                       None, SMS).head_split == 1
    assert fa.bwd_plan(*_bwd(d=36, dtype=F32), None, SMS).d_pad == 64


@pytest.mark.parametrize("case", ["shapes", "dtype", "window", "lse_shape",
                                  "lse_dtype", "stride"])
def test_bwd_plan_keeps_the_checks(case):
    q, k, v, o, do, lse = _bwd()
    args = {
        "shapes": (q, k, v, o, do[:, :4], lse),
        "dtype": (q, k, v, o.float(), do, lse),
        "window": (q, k, v, o, do, lse),
        "lse_shape": (q, k, v, o, do, lse[:, :1]),
        "lse_dtype": (q, k, v, o, do, lse.double()),
        "stride": (q, k, v, o, do.transpose(2, 3).contiguous()
                   .transpose(2, 3), lse),
    }[case]
    with pytest.raises((ValueError, TypeError)):
        fa.bwd_plan(*args, 0 if case == "window" else None, SMS)


# ---- ssd_scan.plan ----------------------------------------------------- #

def _ssd(bt=1, s=256, h=80, p=64, n=128, x_dtype=F32, bc_dtype=BF16,
         state=True):
    return (torch.zeros((bt, s, h, p), dtype=x_dtype),
            torch.zeros((bt, s, h), dtype=F32),
            torch.zeros((bt, s, n), dtype=bc_dtype),
            torch.zeros((bt, s, n), dtype=bc_dtype),
            torch.zeros((bt, h, p, n)) if state else None)


def _ssd_plan(bt=1, s=256, h=80, p=64, n=128, chunk=256, **kw):
    x, dt_a, b, c, state = _ssd(bt, s, h, p, n, **kw)
    return ss.plan(x, dt_a, b, c, chunk, state)


def test_ssd_plan_fills_the_card_at_the_serving_shape():
    """(a), the serving call: 80 (row, head) pairs, p 64 in two slices of
    32: 160 blocks of 110,128 bytes (two stages of TMA boxes, B and C 64 x
    128 bf16 and x 64 x 32 fp32, with 196 scalars each; the fp32 state
    slice 32 x 136; the warp pairs' partial sums, 8 x 2 x 128 fp32; an
    8-byte mbarrier a stage; 1024 bytes of alignment), two resident an
    SM."""
    pl = _ssd_plan()
    assert (pl.pw, pl.splits, pl.vec) == (32, 2, True)
    assert pl.smem_bytes == 2 * (2 * 64 * 128 * 2 + 64 * 32 * 4 + 196 * 4
                                 + 8) + 32 * 136 * 4 + 8 * 2 * 128 * 4 \
        + 1024 == 110128
    assert pl.blocks == 160 >= SMS
    assert pl.blocks_per_sm == 2
    assert 2 * (pl.smem_bytes + ss.BLOCK_RESERVED) <= ss.SM_SMEM
    assert pl.smem_bytes <= fa.SMEM_LIMIT == ss.SMEM_LIMIT


def test_ssd_plan_at_the_whole_sequence_shape():
    """(b), bt 8 x s 2048 x 80 heads: 1280 blocks of the same slices."""
    pl = _ssd_plan(bt=8, s=2048)
    assert (pl.pw, pl.splits, pl.blocks, pl.blocks_per_sm) == (32, 2, 1280,
                                                               2)


@pytest.mark.parametrize("chunk", [32, 256, 1024])
@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("p", [48, 64])
@pytest.mark.parametrize("bt,h", [(1, 2), (2, 4), (8, 4), (1, 80), (2, 80),
                                  (8, 80)])
@pytest.mark.parametrize("dtypes", [(F32, BF16), (BF16, BF16), (F32, F32)],
                         ids=["x32_bc16", "x16_bc16", "x32_bc32"])
def test_ssd_plan_split_at_the_edges(dtypes, bt, h, p, n, chunk):
    """The slices cover p exactly once; the shared memory is the layout's
    (n padded to 128) and fits; the blocks an SM are what the
    memory allows; the widest slice that fills the card with two blocks an
    SM is taken, else the grid with the most blocks resident at once."""
    x_dtype, bc_dtype = dtypes
    pl = _ssd_plan(bt, chunk, h, p, n, chunk, x_dtype=x_dtype,
                   bc_dtype=bc_dtype)
    assert pl.pw in ss.SLICES
    assert pl.splits == -(-p // pl.pw) and (pl.splits - 1) * pl.pw < p
    x_elt, bc_elt = x_dtype.itemsize, bc_dtype.itemsize
    assert pl.smem_bytes == ss.smem_bytes(pl.pw, bc_elt, x_elt)
    assert pl.smem_bytes <= ss.SMEM_LIMIT
    assert pl.blocks == bt * h * pl.splits
    assert 1 <= pl.blocks_per_sm <= ss.MAX_BLOCKS_PER_SM
    assert pl.blocks_per_sm * (pl.smem_bytes + ss.BLOCK_RESERVED) \
        <= ss.SM_SMEM
    if pl.blocks_per_sm < ss.MAX_BLOCKS_PER_SM:
        assert (pl.blocks_per_sm + 1) * (pl.smem_bytes
                                         + ss.BLOCK_RESERVED) > ss.SM_SMEM
    options = {}
    for pw in ss.SLICES:
        if pw > ss.SLICES[-1] and pw // 2 >= p:
            continue
        splits, smem, per_sm = ss.slice_shape(pw, p, bc_elt, x_elt)
        options[pw] = (bt * h * splits, per_sm)
    fills = [pw for pw, (blocks, per_sm) in options.items()
             if blocks >= SMS and per_sm >= 2]
    if fills:
        assert pl.pw == max(fills)
    else:
        resident = {pw: min(blocks, per_sm * SMS)
                    for pw, (blocks, per_sm) in options.items()}
        assert resident[pl.pw] == max(resident.values())
        assert pl.pw == max(pw for pw, r in resident.items()
                            if r == max(resident.values()))


@pytest.mark.parametrize("p,pw", [(8, 16), (16, 16), (17, 32), (32, 32),
                                  (33, 64), (64, 64)])
def test_ssd_plan_takes_no_slice_wider_than_p_needs(p, pw):
    """A narrow p never takes a slice whose half already holds it, even
    where a wider slice would fill more of the card."""
    pl = _ssd_plan(bt=8, s=64, h=80, p=p, n=128, chunk=64, bc_dtype=F32)
    assert pl.pw <= pw


@pytest.mark.parametrize("n", [8, 16, 20, 100, 128])
def test_ssd_plan_shared_memory_does_not_depend_on_n(n):
    """Shared memory holds B, C and the state at n = 128 whatever n is
    (the columns past n are zero), so every n takes the same slices."""
    assert _ssd_plan(n=n).smem_bytes == _ssd_plan().smem_bytes
    assert _ssd_plan(n=n).pw == _ssd_plan().pw


def test_ssd_plan_copies_by_tma_only_where_aligned():
    """TMA needs every row of x, b and c and their first element on 16
    bytes; otherwise the plan says element copies."""
    assert _ssd_plan(p=20).vec                   # 80-byte x rows
    assert not _ssd_plan(p=18).vec               # 72-byte x rows
    assert not _ssd_plan(n=20).vec               # 40-byte bf16 b / c rows
    assert _ssd_plan(n=24, bc_dtype=F32).vec     # 96-byte fp32 rows
    x, dt_a, b, c, state = _ssd(s=64)
    off = torch.zeros(x.numel() + 1)[1:].view(x.shape)
    assert off.is_contiguous() and off.data_ptr() % 16 == 4
    assert not ss.plan(off, dt_a, b, c, 64, state).vec
    assert ss.plan(x, dt_a, b, c, 64, state).vec


def _bad_ssd_calls():
    x, dt_a, b, c, state = _ssd(s=64, h=2)
    yield "dt_a shape", (x, dt_a[:, :32], b, c, 64, state), ValueError
    yield "b shape", (x, dt_a, b[..., :64], c, 64, state), ValueError
    yield "state shape", (x, dt_a, b, c, 64, state[:, :1]), ValueError
    yield "p 80", (*_ssd(s=64, h=2, p=80)[:4], 64, None), ValueError
    yield "n 136", (*_ssd(s=64, h=2, n=136)[:4], 64, None), ValueError
    yield "chunk 2048", (*_ssd(s=2048, h=2)[:4], 2048, None), ValueError
    yield "s % chunk", (x, dt_a, b, c, 48, state), ValueError
    yield "x fp16", (x.half(), dt_a, b, c, 64, state), TypeError
    yield "dt_a fp64", (x, dt_a.double(), b, c, 64, state), TypeError
    yield "b, c differ", (x, dt_a, b, c.float(), 64, state), TypeError
    yield "state bf16", (x, dt_a, b, c, 64, state.bfloat16()), TypeError
    yield "x strided", (x.transpose(2, 3).contiguous().transpose(2, 3),
                        dt_a, b, c, 64, state), ValueError
    yield "c strided", (x, dt_a, b, torch.zeros(1, 64, 256,
                                               dtype=BF16)[..., ::2],
                        64, state), ValueError
    yield "b on meta", (x, dt_a, b.to("meta"), c, 64, state), ValueError


@pytest.mark.parametrize("case,args,exc", list(_bad_ssd_calls()),
                         ids=[c for c, _, _ in _bad_ssd_calls()])
def test_ssd_plan_refuses(case, args, exc):
    with pytest.raises(exc):
        ss.plan(*args)
