"""The port's block-scaled GEMM entry points against the reference's, on
the CPU: ``quantize_for_qmatmul`` / ``pack_for_qmatmul`` bytes, the plain
versions of ``qmatmul`` / ``qmatmul_packed`` against the reference's
Pallas kernels (interpret mode, m=16, n=128, k=256, small blocks) and
``qmatmul_ref``, and packed equal to container bit for bit; and the
wrapper's host-side choice of the kernel's path (``plan``: by x's dtype
and m, and the narrow path's split of k with its workspace shape).

Tolerance against the reference: bf16 outputs within 2 bf16 ulps plus
1e-4 * sqrt(k / 1024), because the reference accumulates its k blocks
in another order than one fp32 matmul does.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.kernels as K  # noqa: E402
from repro.kernels.ref import qmatmul_ref  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.qmatmul import (  # noqa: E402
    NARROW_M, Plan, plan, qmatmul_packed_plain, qmatmul_plain,
    wgmma_unit_tile)

FORMATS = ("float8_e4m3fn", "float8_e5m2", "float6_e2m3fn",
           "float6_e3m2fn", "float4_e2m1fn")
PACKED = FORMATS[2:]


def _inputs(seed, m=16, k=256, n=128):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    x_bf16 = torch.from_numpy(x).to(torch.bfloat16)
    return x_bf16, torch.from_numpy(w), jnp.asarray(
        x_bf16.float().numpy(), jnp.bfloat16), jnp.asarray(w)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _assert_bf16_close(got, want, k):
    g, w = _f32(got), _f32(want)
    ulp = np.exp2(np.frexp(w)[1].astype(np.float64) - 8)
    assert (np.abs(g - w) <= 2 * ulp + 1e-4 * np.sqrt(k / 1024)).all()


@pytest.mark.parametrize("fmt", FORMATS)
def test_quantize_and_pack_for_qmatmul(fmt):
    _, w, _, w_ref = _inputs(1)
    qw, sc = ops.quantize_for_qmatmul(w, fmt)
    qw_ref, sc_ref = K.quantize_for_qmatmul(w_ref, fmt)
    assert qw.shape == (128, 256) and qw.is_contiguous()
    # by value: the reference's JAX holds fp4 natively, the port in e4m3
    np.testing.assert_array_equal(_f32(qw), _f32(qw_ref))
    # scales within 8 ulps: the reference's traced exp2 misses 2^e by a
    # few ulps for |e| beyond about 12 (the e5m2 scales); the port's
    # powers of two are exact, and the codes above are the same
    np.testing.assert_allclose(sc.numpy(), np.asarray(sc_ref), rtol=1e-6,
                               atol=0)
    if fmt in PACKED:
        pw, sc2 = ops.pack_for_qmatmul(w, fmt)
        pw_ref, _ = K.pack_for_qmatmul(w_ref, fmt)
        assert pw.dtype == torch.uint8 and pw.is_contiguous()
        np.testing.assert_array_equal(pw.numpy(), np.asarray(pw_ref))
        np.testing.assert_array_equal(sc2.numpy(), sc.numpy())


@pytest.mark.parametrize("fmt", ("float8_e4m3fn", "float4_e2m1fn",
                                 "float6_e3m2fn"))
def test_plain_matches_reference_kernels(fmt):
    x, w, x_ref, w_ref = _inputs(2)
    qw, sc = ops.quantize_for_qmatmul(w, fmt)
    qw_ref, sc_ref = K.quantize_for_qmatmul(w_ref, fmt)
    got = ops.qmatmul(x, qw, sc)
    assert got.dtype == torch.bfloat16 and got.shape == (16, 128)
    want = K.qmatmul(x_ref, qw_ref, sc_ref, bm=16, bn=128, bk=128)
    _assert_bf16_close(got, want, 256)
    np.testing.assert_array_equal(
        _f32(got), _f32(qmatmul_ref(x_ref, qw_ref, sc_ref)))
    if fmt in PACKED:
        pw, _ = ops.pack_for_qmatmul(w, fmt)
        got_p = ops.qmatmul_packed(x, pw, sc, fmt)
        want_p = K.qmatmul_packed(x_ref, jnp.asarray(pw.numpy()), sc_ref,
                                  fmt, bm=16, bn=128, bk=128)
        _assert_bf16_close(got_p, want_p, 256)
        np.testing.assert_array_equal(_f32(got_p), _f32(got))


@pytest.mark.parametrize("fmt", PACKED)
def test_packed_equals_container_bit_for_bit(fmt):
    """Ragged m and fp32 output too; the plain versions unpack to the
    same fp32 values, so the products are identical."""
    x, w, _, _ = _inputs(3, m=37, k=96, n=40)
    qw, sc = ops.quantize_for_qmatmul(w, fmt)
    pw, _ = ops.pack_for_qmatmul(w, fmt)
    for out_dtype in (torch.bfloat16, torch.float32):
        a = ops.qmatmul(x, qw, sc, out_dtype=out_dtype)
        b = ops.qmatmul_packed(x, pw, sc, fmt, out_dtype=out_dtype)
        assert a.dtype == out_dtype and torch.equal(a, b)
    np.testing.assert_allclose(
        qmatmul_plain(x, qw, sc, torch.float32).numpy(),
        x.double().numpy() @ (qw.double().numpy().reshape(40, 3, 32)
                              * sc.double().numpy()[..., None]
                              ).reshape(40, 96).T, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        qmatmul_packed_plain(x, pw, sc, fmt).float().numpy(),
        qmatmul_plain(x, qw, sc).float().numpy())


@pytest.mark.parametrize("m, path", [(1, "narrow"), (8, "narrow"),
                                     (64, "narrow"), (65, "wide"),
                                     (2048, "wide")])
def test_plan_path_by_m(m, path):
    """bf16 x: A and B swap (the narrow entry) at m <= 64, the only
    place the choice is made; the wide path never splits k."""
    pl = plan(m, 8192, 2048, 132)
    assert pl.path == path
    if path == "wide":
        assert pl == Plan("wide", 1, None)


@pytest.mark.parametrize("m, n, k, splits", [
    (8, 8192, 2048, 4),      # 64 blocks on 132 SMs: 4 x 64 <= 2 an SM
    (64, 8192, 2048, 4),
    (8, 8200, 2048, 4),      # 65 blocks, the last ragged
    (8, 1024, 1024, 4),      # capped: at least 4 steps of 64 a split
    (1, 100, 32, 1),         # one step of k: nothing to split
    (37, 192, 96, 1),
    (8, 16896, 2048, 1),     # 132 blocks fill the card
    (200, 1024, 1024, 1),    # the wide path never splits
])
def test_plan_split_k_workspace(m, n, k, splits):
    pl = plan(m, n, k, 132)
    assert pl.splits == splits
    assert pl.workspace == ((splits, m, n) if splits > 1 else None)
    assert splits == 1 or -(-k // 64) // splits >= 4
    assert splits * -(-n // 128) <= 2 * 132 or splits == 1


def test_plan_fits_the_kernel_entries():
    """What ``repro_qmatmul_narrow`` accepts: m <= 64, and a split k
    needs a workspace and at most one split per step of 64 values of k;
    the wide path (``repro_qmatmul``) takes no workspace."""
    for m in (1, 7, 8, 9, 33, 64, 65, 129):
        for n in (1, 100, 128, 8200, 20000):
            for k in (32, 64, 96, 256, 2048, 8192):
                for sms in (1, 78, 132):
                    pl = plan(m, n, k, sms)
                    assert pl.path == ("narrow" if m <= NARROW_M else "wide")
                    if pl.path == "wide":
                        assert pl == Plan("wide", 1, None)
                    elif pl.splits > 1:
                        assert pl.splits <= -(-k // 64)
                        assert pl.workspace == (pl.splits, m, n)
                    else:
                        assert pl.workspace is None


def test_plan_split_k_follows_the_sm_count():
    assert plan(8, 8192, 2048, 264).splits == 8
    assert plan(8, 8192, 2048, 64).splits == 1


def test_wgmma_unit_tile_needs_the_card():
    a = torch.zeros((64, 16), dtype=torch.bfloat16)
    b = torch.zeros((128, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="wgmma_unit_tile"):
        wgmma_unit_tile(a, b)
