"""Weight bridge: the reference's gptneox-1b reduced params -> numpy ->
port -> numpy is bit-for-bit, with the reference's key paths and shapes;
the port's own init builds the same tree."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint.checkpointer import _flatten  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.transformer import init_lm  # noqa: E402


@pytest.fixture(scope="module")
def ref_flat():
    model = ref_build_model(ref_get_config("gptneox-1b").reduced())
    params = model.init(jax.random.PRNGKey(0))
    return {k: np.asarray(v) for k, v in _flatten(params).items()}


def test_roundtrip_is_bit_exact(ref_flat):
    cfg = get_config("gptneox-1b").reduced()
    params = bridge.params_from_numpy(ref_flat, cfg, "cpu")
    back = bridge.params_to_numpy(params)
    assert list(back) == list(ref_flat)       # same keys, same order
    for k, want in ref_flat.items():
        assert back[k].dtype == want.dtype and back[k].shape == want.shape
        np.testing.assert_array_equal(back[k].view(np.uint32),
                                      want.view(np.uint32))


def test_bf16_leaves_cross_exactly(ref_flat):
    """ml_dtypes bf16 arrays reach torch as bfloat16 with the same values."""
    cfg = get_config("gptneox-1b").reduced()
    flat16 = {k: np.asarray(jnp.asarray(v, jnp.bfloat16))
              for k, v in ref_flat.items()}
    params = bridge.params_from_numpy(flat16, cfg, "cpu")
    for k, t in bridge.flatten(params).items():
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(),
                                      flat16[k].astype(np.float32))


@pytest.mark.parametrize("name", ["gptneox-1b", "reduced"])
def test_port_init_builds_the_reference_tree(name):
    """Same key set and shapes as the reference's init_lm (the full
    config is checked through shapes only, on the meta device)."""
    ref_cfg = ref_get_config("gptneox-1b")
    cfg = get_config("gptneox-1b")
    if name == "reduced":
        ref_cfg, cfg = ref_cfg.reduced(), cfg.reduced()
    want = jax.eval_shape(lambda: ref_build_model(ref_cfg).init(
        jax.random.PRNGKey(0)))
    want = {k: tuple(v.shape) for k, v in _flatten(want).items()}
    got = {k: tuple(v.shape)
           for k, v in bridge.flatten(init_lm(cfg, None, "meta")).items()}
    assert got == want


def test_port_init_distribution():
    """Truncated normal at ±2σ with σ = 1/sqrt(fan_in); norms are ones;
    the same generator seed gives the same weights."""
    cfg = get_config("gptneox-1b").reduced()
    a = init_lm(cfg, torch.Generator().manual_seed(3), "cpu")
    b = init_lm(cfg, torch.Generator().manual_seed(3), "cpu")
    for k, t in bridge.flatten(a).items():
        torch.testing.assert_close(t, bridge.flatten(b)[k], atol=0, rtol=0)
    wo = a["layers"]["pos0"]["attn"]["wo"]            # fan_in = h * hd
    sigma = 1 / np.sqrt(cfg.n_heads * cfg.head_dim)
    assert wo.abs().max() <= 2 * sigma + 1e-6
    assert 0.7 * sigma < wo.std() < 0.95 * sigma      # trunc. at 2σ: 0.88σ
    assert (a["layers"]["pos0"]["ln_mix"] == 1).all()


def test_mismatched_tree_raises(ref_flat):
    cfg = get_config("gptneox-1b").reduced()
    bad = dict(ref_flat)
    bad["embed"] = bad["embed"][:, :8]
    with pytest.raises(ValueError, match="shapes"):
        bridge.params_from_numpy(bad, cfg, "cpu")
    bad = dict(ref_flat)
    del bad["unembed"]
    with pytest.raises(ValueError, match="keys"):
        bridge.params_from_numpy(bad, cfg, "cpu")
