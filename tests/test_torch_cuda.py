"""The port's CUDA kernel against its plain version, on the card.

Marked ``cuda``; each test skips on a host without a CUDA device.  The
GPU machine has no JAX, and ``tests/conftest.py`` imports it, so run
this file there without the conftest:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider \
        -m cuda tests/test_torch_cuda.py

Tolerances, by the cache dtype: fp32 atol=rtol=1e-5 (summation order);
bf16 atol 2e-2 (the plain version rounds p to the cache's bf16 before
PV, as the reference does; the kernel keeps p in fp32).
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
from repro_torch.models.model import build_model
from repro_torch.serve import ServeEngine

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
