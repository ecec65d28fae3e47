"""The port's Mamba-2 SSD block against the reference's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages;
parameters are the reference's init, carried across by
``repro_torch.bridge``.  Tolerances (all float32):

* the port's ``ssd_chunked`` / ``ssd_reference`` against the
  reference's: atol 2e-5 at |y| up to ~12 (the same algorithm; only the
  summation order differs, measured <= 6e-6);
* against the Pallas ``ssd_scan`` run in interpret mode
  (``repro.kernels.ops.ssd_scan``, as ``tests/test_kernels.py`` runs
  it): atol 2e-4, that test's tolerance against its sequential oracle;
* ``causal_conv1d``: atol 1e-6 (four products per output);
* ``ssm_prefill_chunk`` and ``ssm_decode``: outputs, conv carries (raw
  projections, so matmul rounding) and carried state atol 1e-5.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint.checkpointer import _flatten  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.serve import quant as ref_quant  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ssd_scan as kss  # noqa: E402
from repro_torch.models import layers, ssm  # noqa: E402
from repro_torch.serve.quant import quantize_params  # noqa: E402

SSD_ATOL = 2e-5
PALLAS_ATOL = 2e-4
BLOCK_ATOL = 1e-5


def _ssd_inputs(seed, bt, s, h, p, n):
    """The input distribution of tests/test_kernels.py's SSD cases."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((bt, s, h, p)) * 0.5).astype(np.float32)
    dt_a = (-np.abs(rng.standard_normal((bt, s, h))) * 0.2).astype(
        np.float32)
    b = (rng.standard_normal((bt, s, n)) * 0.5).astype(np.float32)
    c = (rng.standard_normal((bt, s, n)) * 0.5).astype(np.float32)
    return x, dt_a, b, c


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


# --------------------------------------------------------------------- #
# the SSD core
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("s,h,p,n", [(128, 2, 32, 16), (192, 4, 64, 32)])
def test_ssd_chunked_matches_reference_and_pallas(chunk, s, h, p, n):
    """tests/test_kernels.py::test_ssd_scan_sweep's shapes: the port's
    plain version against the reference's, its wrapper (CPU: the plain
    version) against the interpret-mode Pallas kernel, and both against
    the sequential oracles."""
    arrays = _ssd_inputs(s + h + chunk, 2, s, h, p, n)
    y, st = ssm.ssd_chunked(*_t(*arrays), chunk)
    y_ref, st_ref = ref_ssm.ssd_chunked(*_j(*arrays), chunk)
    _close(y, y_ref, SSD_ATOL)
    _close(st, st_ref, SSD_ATOL)
    yw, stw = kss.ssd_scan(*_t(*arrays), chunk=chunk)
    yk, stk = ref_ops.ssd_scan(*_j(*arrays), chunk=chunk)
    _close(yw, yk, PALLAS_ATOL)
    _close(stw, stk, PALLAS_ATOL)
    y_seq, st_seq = ssm.ssd_reference(*_t(*arrays))
    y_seq_ref, st_seq_ref = ref_ssm.ssd_reference(*_j(*arrays))
    _close(y_seq, y_seq_ref, SSD_ATOL)
    _close(st_seq, st_seq_ref, SSD_ATOL)
    _close(y, y_seq, PALLAS_ATOL)
    _close(st, st_seq, PALLAS_ATOL)


def test_ssd_scan_initial_state_chains():
    """tests/test_kernels.py::test_ssd_scan_initial_state: scanning
    [s0 | s1] in one call equals scanning s0, then s1 seeded with s0's
    final state; the second half also against the Pallas kernel with
    the same carry."""
    s0, s1, h, p, n = 64, 64, 2, 32, 16
    x, dt_a, b, c = _t(*_ssd_inputs(74, 2, s0 + s1, h, p, n))
    y_all, st_all = kss.ssd_scan(x, dt_a, b, c, chunk=32)
    _, st0 = kss.ssd_scan(x[:, :s0], dt_a[:, :s0], b[:, :s0], c[:, :s0],
                          chunk=32)
    y1, st1 = kss.ssd_scan(x[:, s0:], dt_a[:, s0:], b[:, s0:], c[:, s0:],
                           chunk=32, initial_state=st0)
    _close(y1, y_all[:, s0:], PALLAS_ATOL)
    _close(st1, st_all, PALLAS_ATOL)
    yk, stk = ref_ops.ssd_scan(
        *_j(*(t[:, s0:].numpy() for t in (x, dt_a, b, c))), chunk=32,
        initial_state=jnp.asarray(st0.numpy()))
    _close(y1, yk, PALLAS_ATOL)
    _close(st1, stk, PALLAS_ATOL)


def test_ssd_scan_pads_to_the_chunk():
    """tests/test_kernels.py::test_ssd_scan_padding: s = 100 is not a
    multiple of chunk 32; the wrapper pads with an identity tail."""
    arrays = _ssd_inputs(102, 1, 100, 2, 16, 8)
    calls = kss.ssd_scan_plain.calls
    y, st = kss.ssd_scan(*_t(*arrays), chunk=32)
    assert kss.ssd_scan_plain.calls == calls + 1
    assert y.shape == (1, 100, 2, 16) and st.shape == (1, 2, 16, 8)
    yk, stk = ref_ops.ssd_scan(*_j(*arrays), chunk=32)
    _close(y, yk, PALLAS_ATOL)
    _close(st, stk, PALLAS_ATOL)
    y_seq, st_seq = ssm.ssd_reference(*_t(*arrays))
    _close(y, y_seq, PALLAS_ATOL)
    _close(st, st_seq, PALLAS_ATOL)


def test_segsum_masks_above_the_diagonal():
    a = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 6)).astype(np.float32))
    got = ssm._segsum(a)
    want = ref_ssm._segsum(jnp.asarray(a.numpy()))
    assert torch.isinf(got.triu(1)[..., 0, 1:]).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_causal_conv1d_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 11, 24)).astype(np.float32)
    w = rng.standard_normal((24, 4)).astype(np.float32)
    b = rng.standard_normal((24,)).astype(np.float32)
    got = layers.causal_conv1d(*_t(x, w, b))
    want = ref_layers.causal_conv1d(*_j(x, w, b))
    assert got.shape == (2, 11, 24)
    _close(got, want, 1e-6)


# --------------------------------------------------------------------- #
# the block on bridged parameters
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def block():
    """(reduced config, the reference's layer-0 SSM params, the port's)."""
    ref_cfg = ref_get_config("mamba2-2.7b").reduced()
    ref_params = ref_build_model(ref_cfg).init(jax.random.PRNGKey(0))
    flat = {k: np.asarray(v) for k, v in _flatten(ref_params).items()}
    cfg = get_config("mamba2-2.7b").reduced()
    params = bridge.params_from_numpy(flat, cfg, "cpu")
    ref_p = jax.tree.map(lambda a: a[0], ref_params["layers"]["pos0"]["ssm"])
    p = {k: v[0] for k, v in params["layers"]["pos0"]["ssm"].items()}
    return ref_cfg, cfg, ref_p, p


def _random_row(cfg, seed, bt=1):
    """A cache row with non-zero conv carries and state (numpy)."""
    rng = np.random.default_rng(seed)
    k1 = cfg.ssm_conv - 1
    f = lambda *shape: (rng.standard_normal(shape) * 0.5).astype(np.float32)
    return {"conv_x": f(bt, k1, cfg.d_inner),
            "conv_b": f(bt, k1, cfg.ssm_state),
            "conv_c": f(bt, k1, cfg.ssm_state),
            "state": f(bt, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)}


@pytest.mark.parametrize("valid_len", [8, 5, 2, 1])
def test_prefill_chunk_matches_reference(block, valid_len):
    """A chunk of 8 with a carried row: full, ragged, and valid_len
    below k-1 = 3, where the new carry reaches back into the old one."""
    ref_cfg, cfg, ref_p, p = block
    rng = np.random.default_rng(valid_len)
    x = rng.standard_normal((1, 8, cfg.d_model)).astype(np.float32)
    x[:, valid_len:] = 0.0
    row = _random_row(cfg, 11 + valid_len)
    valid = np.arange(8) < valid_len
    out_ref, row_ref = ref_ssm.ssm_prefill_chunk(
        ref_p, jnp.asarray(x), {k: jnp.asarray(v) for k, v in row.items()},
        ref_cfg, jnp.asarray(valid), jnp.int32(valid_len))
    port_row = {k: torch.from_numpy(v.copy()) for k, v in row.items()}
    calls = kss.ssd_scan_plain.calls
    out = ssm.ssm_prefill_chunk(p, torch.from_numpy(x), port_row, cfg,
                                torch.from_numpy(valid), valid_len)
    assert kss.ssd_scan_plain.calls == calls + 1
    _close(out[:, :valid_len], np.asarray(out_ref)[:, :valid_len],
           BLOCK_ATOL)
    for name, leaf in port_row.items():
        _close(leaf, row_ref[name], BLOCK_ATOL)


def test_decode_matches_reference_on_active_rows(block):
    """Three rows, the middle one inactive: active rows take the
    reference's new carries and state, the inactive row keeps its own
    (``slotstate.decode_advance``)."""
    ref_cfg, cfg, ref_p, p = block
    rng = np.random.default_rng(21)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    row = _random_row(cfg, 22, bt=3)
    out_ref, new_ref = ref_ssm.ssm_decode(
        ref_p, jnp.asarray(x), {k: jnp.asarray(v) for k, v in row.items()},
        ref_cfg)
    cache = {k: torch.from_numpy(v.copy()) for k, v in row.items()}
    active = torch.tensor([True, False, True])
    out = ssm.ssm_decode(p, torch.from_numpy(x), cache, cfg, active=active)
    _close(out, out_ref, BLOCK_ATOL)
    for name, leaf in cache.items():
        _close(leaf.numpy()[[0, 2]], np.asarray(new_ref[name])[[0, 2]],
               BLOCK_ATOL)
        np.testing.assert_array_equal(leaf.numpy()[1], row[name][1])


def test_init_ssm_tree_and_fp32_leaves():
    """The reference's keys, shapes and dtypes at full width (meta
    device), ``A_log`` / ``dt_bias`` / ``D`` fp32 under bf16 params, and
    the reference's deterministic values for them."""
    cfg = get_config("mamba2-2.7b")
    ref_cfg = ref_get_config("mamba2-2.7b")
    want = jax.eval_shape(lambda: ref_ssm.init_ssm(jax.random.PRNGKey(0),
                                                   ref_cfg, jnp.bfloat16))
    got = ssm.init_ssm(cfg, torch.bfloat16, None, "meta")
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
            for k, v in got.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    small = get_config("mamba2-2.7b").reduced()
    mine = ssm.init_ssm(small, torch.float32, torch.Generator().manual_seed(0),
                        "cpu", lead=(2,))
    ref = ref_ssm.init_ssm(jax.random.PRNGKey(0),
                           ref_get_config("mamba2-2.7b").reduced(),
                           jnp.float32)
    for k in ("A_log", "dt_bias", "D"):
        assert mine[k].shape == (2, small.ssm_heads)
        np.testing.assert_allclose(mine[k][1].numpy(), np.asarray(ref[k]),
                                   rtol=1e-6)


def test_float_cast_follows_the_reference(block):
    """``quantize_params(params, "bfloat16")`` casts every leaf with
    ndim >= 2, as the reference's does: with the period axis that
    includes ``A_log``, ``dt_bias`` and ``D`` (n_periods, h)."""
    ref_cfg = ref_get_config("mamba2-2.7b").reduced()
    ref_params = ref_build_model(ref_cfg).init(jax.random.PRNGKey(0))
    ref_cast, ref_stats = ref_quant.quantize_params(ref_params, "bfloat16")
    flat = {k: np.asarray(v) for k, v in _flatten(ref_params).items()}
    params = bridge.params_from_numpy(flat, get_config(
        "mamba2-2.7b").reduced(), "cpu")
    cast, stats = quantize_params(params, "bfloat16")
    want = {k: str(v.dtype) for k, v in _flatten(ref_cast).items()}
    got = {k: str(v.dtype).removeprefix("torch.")
           for k, v in bridge.flatten(cast).items()}
    assert got == want
    assert got["layers/pos0/ssm/A_log"] == "bfloat16"
    assert stats["quantized_bytes"] == ref_stats["quantized_bytes"]
