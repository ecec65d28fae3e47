"""The gradient of the port's ``ssd_scan`` on the CPU.

``ssd_scan_bwd_plain`` (the formulas of ``csrc/ssd_scan_bwd.cu``'s
header, chunk by chunk, no autograd) against ``jax.grad`` of the
reference's XLA ``ssd_chunked`` and against ``torch.autograd`` of the
port's ``ssd_chunked``; the plain forward's entering states against the
reference's; ``SsdScanFn`` through ``ssd_scan`` with its counters and
the padded tail; ``bwd_plan`` at mamba2's and jamba's shapes and what it
refuses.  Inputs are made with numpy from a seed.  Tolerances (fp32, the
order of the sums only): every fp32 gradient within rtol 1e-4 and atol
1e-5 x the leaf's largest magnitude; a bf16 gradient (db, dc of bf16 b /
c: both sides round one fp32 sum to bf16) also within one bf16 ulp.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro.models.ssm import ssd_chunked as ref_ssd_chunked  # noqa: E402

from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.models.ssm import ssd_chunked  # noqa: E402

F32, BF16 = torch.float32, torch.bfloat16
NAMES = ("x", "dt_a", "b", "c", "initial_state")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread keeps parallel test workers from spinning
    against each other; the previous count is restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, bt, s, h, p, n):
    """numpy (x, dt_a, b, c, initial state, dy, dfinal): unit-scale
    values, decays dt_a in [-1.6, -0.001] as the model's."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    dt_a = -rng.uniform(1e-3, 1.6, (bt, s, h)).astype(np.float32)
    return (t(bt, s, h, p), dt_a, t(bt, s, n), t(bt, s, n), t(bt, h, p, n),
            t(bt, s, h, p), t(bt, h, p, n))


def _close(name, got, want, bf16=False):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got, want, rtol=2.0 ** -8 if bf16 else 1e-4,
        atol=1e-5 * max(float(np.abs(want).max()), 1e-30), err_msg=name)


def _jax_grads(x, dt_a, b, c, h0, dy, dfinal, chunk, bc_dtype):
    """jax.grad of sum(y dy) + sum(final dfinal) through the reference's
    ssd_chunked, s padded to the chunk inside (as its ops.ssd_scan)."""
    s = x.shape[1]
    pad = (-s) % chunk
    jdt = jnp.bfloat16 if bc_dtype == BF16 else jnp.float32

    def loss(x, dt_a, b, c, h0):
        def p(t):
            return jnp.pad(t, [(0, 0), (0, pad)] + [(0, 0)] * (t.ndim - 2))
        y, final = ref_ssd_chunked(p(x), p(dt_a), p(b), p(c), chunk, h0)
        return (jnp.sum(y[:, :s] * dy) + jnp.sum(final * dfinal))

    return jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(x), jnp.asarray(dt_a), jnp.asarray(b).astype(jdt),
        jnp.asarray(c).astype(jdt), jnp.asarray(h0))


@pytest.mark.parametrize("bc_dtype", [F32, BF16])
@pytest.mark.parametrize("bt,s,h,p,n,chunk", [
    (2, 96, 3, 5, 4, 32),       # three whole chunks
    (2, 100, 2, 8, 16, 32),     # four chunks, the last padded by 28
    (1, 40, 4, 16, 8, 64),      # one chunk, padded
])
def test_bwd_plain_matches_jax_grad(bt, s, h, p, n, chunk, bc_dtype):
    """Every gradient of ``ssd_scan`` on the CPU (SsdScanFn, whose
    backward is ``ssd_scan_bwd_plain``) against ``jax.grad`` of the
    reference's ``ssd_chunked``, with an initial state and a final-state
    cotangent."""
    x, dt_a, b, c, h0, dy, dfinal = _inputs(s + chunk, bt, s, h, p, n)
    want = _jax_grads(x, dt_a, b, c, h0, dy, dfinal, chunk, bc_dtype)
    leaves = [torch.from_numpy(x), torch.from_numpy(dt_a),
              torch.from_numpy(b).to(bc_dtype),
              torch.from_numpy(c).to(bc_dtype), torch.from_numpy(h0)]
    for t in leaves:
        t.requires_grad_(True)
    calls = ss.ssd_scan_bwd_plain.calls
    y, final = ss.ssd_scan(*leaves[:4], chunk=chunk, initial_state=leaves[4])
    loss = (y * torch.from_numpy(dy)).sum() + (
        final * torch.from_numpy(dfinal)).sum()
    got = torch.autograd.grad(loss, leaves)
    assert ss.ssd_scan_bwd_plain.calls == calls + 1
    for name, g, w, leaf in zip(NAMES, got, want, leaves):
        assert g.dtype == leaf.dtype and g.shape == leaf.shape, name
        _close(name, g.float().numpy(), np.asarray(w, np.float32),
               bf16=g.dtype == BF16)


@pytest.mark.parametrize("with_dfinal", [True, False])
@pytest.mark.parametrize("bt,s,h,p,n,chunk", [(2, 96, 3, 5, 4, 32),
                                              (1, 128, 2, 16, 32, 16)])
def test_bwd_plain_matches_torch_autograd(bt, s, h, p, n, chunk,
                                          with_dfinal):
    """``ssd_scan_bwd_plain`` called directly (given the plain forward's
    states) against ``torch.autograd`` of the port's ``ssd_chunked``; no
    final-state cotangent is the same as zeros."""
    arrays = _inputs(7 * s + chunk, bt, s, h, p, n)
    x, dt_a, b, c, h0, dy, dfinal = (torch.from_numpy(a) for a in arrays)
    leaves = [t.clone().requires_grad_(True) for t in (x, dt_a, b, c, h0)]
    y, final = ssd_chunked(*leaves[:4], chunk, leaves[4])
    loss = (y * dy).sum() + ((final * dfinal).sum() if with_dfinal else 0)
    want = torch.autograd.grad(loss, leaves)
    _, _, states = ss.ssd_scan_plain(x, dt_a, b, c, chunk, h0, states=True)
    got = ss.ssd_scan_bwd_plain(x, dt_a, b, c, states, dy,
                                dfinal if with_dfinal else None, chunk)
    for name, g, w in zip(NAMES, got, want):
        _close(name, g.numpy(), w.numpy())


def test_plain_states_match_the_references_prefix_states():
    """The state entering chunk i is the reference's final state over the
    first i chunks (the ``prev_states`` its scan emits): chunk 0 holds
    the initial state itself."""
    bt, s, h, p, n, chunk = 2, 128, 3, 8, 16, 32
    x, dt_a, b, c, h0, _, _ = _inputs(11, bt, s, h, p, n)
    _, final, states = ss.ssd_scan_plain(
        *(torch.from_numpy(a) for a in (x, dt_a, b, c)), chunk,
        torch.from_numpy(h0), states=True)
    assert states.shape == (bt, s // chunk, h, p, n) and states.dtype == F32
    np.testing.assert_array_equal(states[:, 0].numpy(), h0)
    for i in range(1, s // chunk):
        end = i * chunk
        _, want = ref_ssd_chunked(x[:, :end], dt_a[:, :end], b[:, :end],
                                  c[:, :end], chunk, h0)
        _close(f"state entering chunk {i}", states[:, i].numpy(),
               np.asarray(want))
    _, want = ref_ssd_chunked(x, dt_a, b, c, chunk, h0)
    _close("final state", final.numpy(), np.asarray(want))


def test_ssd_scan_fn_counts_and_drops_the_padded_tail():
    """With grad: one plain forward (storing states) and one plain
    backward a call; the gradients have the unpadded inputs' shapes and
    equal autograd of ``ssd_chunked`` over the padded inputs.  Without
    grad (or with no input requiring it): the plain forward alone, no
    autograd node."""
    bt, s, h, p, n, chunk = 2, 50, 2, 8, 4, 16
    arrays = _inputs(13, bt, s, h, p, n)
    x, dt_a, b, c, _, dy, _ = (torch.from_numpy(a) for a in arrays)
    fwd, bwd = ss.ssd_scan_plain.calls, ss.ssd_scan_bwd_plain.calls
    leaves = [t.clone().requires_grad_(True) for t in (x, dt_a, b, c)]
    y, final = ss.ssd_scan(*leaves, chunk=chunk)
    assert y.shape == x.shape and y.grad_fn is not None
    got = torch.autograd.grad((y * dy).sum(), leaves)
    assert (ss.ssd_scan_plain.calls, ss.ssd_scan_bwd_plain.calls) == (
        fwd + 1, bwd + 1)
    ref = [t.clone().requires_grad_(True) for t in (x, dt_a, b, c)]
    pad = (-s) % chunk
    y2, _ = ssd_chunked(*(F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
                          for t in ref), chunk)
    want = torch.autograd.grad((y2[:, :s] * dy).sum(), ref)
    for name, g, w, t in zip(NAMES, got, want, (x, dt_a, b, c)):
        assert g.shape == t.shape, name
        _close(name, g.numpy(), w.numpy())
    with torch.no_grad():
        y3, _ = ss.ssd_scan(*leaves, chunk=chunk)
    y4, _ = ss.ssd_scan(x, dt_a, b, c, chunk=chunk)
    assert y3.grad_fn is None and y4.grad_fn is None
    assert ss.ssd_scan_bwd_plain.calls == bwd + 1
    assert torch.equal(y3, y4) and torch.equal(y3, y.detach())


def test_bwd_needs_states_and_a_known_device():
    bt, s, h, p, n, chunk = 1, 32, 2, 4, 4, 16
    x, dt_a, b, c, _, dy, _ = (torch.from_numpy(a)
                               for a in _inputs(17, bt, s, h, p, n))
    with pytest.raises(ValueError, match="states"):
        ss.ssd_scan_bwd(x, dt_a, b, c, None, dy, None, chunk)
    meta = [t.to("meta") for t in (x, dt_a, b, c)]
    states = torch.empty((bt, s // chunk, h, p, n), device="meta")
    with pytest.raises(ValueError, match="'cuda'"):
        ss.ssd_scan_bwd(*meta, states, dy.to("meta"), None, chunk)


# ---- bwd_plan ------------------------------------------------------------ #

def _bwd_args(bt=4, s=512, h=80, p=64, n=128, chunk=256, x_dtype=F32,
              bc_dtype=BF16, dfinal=False):
    x = torch.zeros((bt, s, h, p), dtype=x_dtype)
    b = torch.zeros((bt, s, n), dtype=bc_dtype)
    return (x, torch.zeros((bt, s, h)), b, b.clone(),
            torch.zeros((bt, s // chunk, h, p, n)), torch.zeros_like(x),
            torch.zeros((bt, h, p, n)) if dfinal else None, chunk)


@pytest.mark.parametrize("shape,want_groups", [
    # mamba2-2.7b training (2o): 4 x 512 at chunk 256, 80 heads of 64
    (dict(bt=4, s=512, h=80, p=64, n=128), 9),
    # 1i (b): 8 x 2048
    (dict(bt=8, s=2048, h=80, p=64, n=128), 2),
    # jamba's SSM: 128 heads, n 16
    (dict(bt=2, s=1024, h=128, p=64, n=16), 9),
    # a few heads: one group
    (dict(bt=1, s=96, h=3, p=5, n=4, chunk=32), 1),
])
def test_bwd_plan_fits_and_fills(shape, want_groups):
    """At mamba2's and jamba's shapes every pass fits a block's shared
    memory (the rows and cols passes two blocks an SM), the quadratic
    passes reach two blocks an SM where the heads allow, and the groups'
    partial db / dc stay within the states' size."""
    args = _bwd_args(**shape)
    pl = ss.bwd_plan(*args, sm_count=132)
    bt, s, h, p = args[0].shape
    n, chunk = args[2].shape[-1], args[-1]
    assert pl.groups == want_groups
    assert pl.heads_per_group * (pl.groups - 1) < h <= \
        pl.heads_per_group * pl.groups
    assert pl.heads_per_group == -(-h // pl.groups)   # the kernel's check
    assert pl.tiles == -(-chunk // 64)
    assert pl.quad_blocks == bt * (s // chunk) * pl.tiles * pl.groups
    for smem in (pl.cb_smem, pl.sweep_smem, pl.rows_smem, pl.cols_smem):
        assert smem <= 232448
    assert 2 * (max(pl.rows_smem, pl.cols_smem) + 1024) <= 233472
    if pl.groups > 1:
        assert 2 * pl.groups * bt * s * n <= args[4].numel()
    assert pl.launch_args() == tuple(
        getattr(pl, f) for f in ("tile", "tiles", "heads_per_group",
                                 "groups", "nj", "quad_blocks", "cb_smem",
                                 "sweep_smem", "rows_smem", "cols_smem",
                                 "scratch_floats", "cb_blocks",
                                 "sweep_blocks"))


def test_bwd_plan_n_columns_follow_n():
    for n, nj in ((4, 1), (16, 1), (20, 2), (64, 4), (128, 8)):
        assert ss.bwd_plan(*_bwd_args(bt=1, s=64, h=2, p=8, n=n,
                                      chunk=64)).nj == nj


def test_bwd_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="p <= 64"):
        ss.bwd_plan(*_bwd_args(bt=1, s=64, h=2, p=80, n=16, chunk=32))
    with pytest.raises(ValueError, match="n <= 128"):
        ss.bwd_plan(*_bwd_args(bt=1, s=64, h=2, p=16, n=160, chunk=32))
    with pytest.raises(ValueError, match="chunk <= 1024"):
        ss.bwd_plan(*_bwd_args(bt=1, s=2048, h=1, p=16, n=16, chunk=2048))
    x, dt_a, b, c, states, dy, _, chunk = _bwd_args(bt=1, s=64, h=2, p=16,
                                                    n=16, chunk=32)
    with pytest.raises(ValueError, match="states"):
        ss.bwd_plan(x, dt_a, b, c, None, dy, None, chunk)
    with pytest.raises(ValueError, match="states"):
        ss.bwd_plan(x, dt_a, b, c, states[:, :1].contiguous(), dy, None,
                    chunk)
    with pytest.raises(ValueError, match="dy"):
        ss.bwd_plan(x, dt_a, b, c, states, dy.to(BF16), None, chunk)
    with pytest.raises(ValueError, match="dfinal"):
        ss.bwd_plan(x, dt_a, b, c, states, dy, torch.zeros((1, 2, 16, 8)),
                    chunk)
    with pytest.raises(ValueError, match="contiguous"):
        ss.bwd_plan(x, dt_a, b, c, states, dy.transpose(2, 3).contiguous()
                    .transpose(2, 3), None, chunk)
    with pytest.raises(TypeError):
        ss.bwd_plan(x, dt_a.double(), b, c, states, dy, None, chunk)
