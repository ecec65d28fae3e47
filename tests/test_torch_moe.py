"""The port's MoE FFN (``repro_torch.models.moe``) against the reference's
(``repro.models.moe``) on the CPU, in fp32.

Both run the same weights and inputs, made with numpy from a seed.  The
output y must agree within atol 1e-5 and every aux loss within 1e-6,
relative above 1 (the z-loss of 16 experts is near 10, where 1e-6 is one
fp32 ulp): only the summation order differs, the reference contracting
one-hot tensors and the port moving rows by index.  Over:

* capacity factors 8.0 (no drops), 1.25 and 0.25 (drops);
* subgroups of the whole sequence (16 tokens) and of 8 tokens, and a
  one-token decode row per group;
* top-1 with a shared expert (llama4's routing), top-2 (jamba's), and
  top-8 over 16 experts with a shared expert (kimi's routing, which
  ``ArchConfig.reduced()`` caps at top-2);
* the ``swiglu``, ``geglu`` and ``gelu`` MLP variants;
* constructed gate ties, broken the reference's way (lower expert
  first), and a zero input, whose expert outputs are all zero rows.

Also: the seeded init keeps the router in fp32 at a bf16
``param_dtype``, and the expert leaves go through the weight quantizer
as the reference's do.
"""

import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.serve import quant as ref_quant  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.serve import quant  # noqa: E402

D, F = 16, 32
ROUTINGS = {   # name: (experts, top-k, shared expert)
    "top1_shared": (4, 1, True),
    "top2": (4, 2, False),
    "top8_of_16": (16, 8, True),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's plain versions at these widths are a few microseconds
    an op: one intra-op thread runs them as fast as many, and keeps
    parallel test workers from spinning against each other.  The
    previous count is restored for the worker's next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(routing, variant, cf):
    """(reference cfg, port cfg) of the same MoE FFN."""
    e, k, shared = ROUTINGS[routing]
    over = dict(d_model=D, moe_d_ff=F, moe_num_experts=e, moe_top_k=k,
                moe_shared_expert=shared, mlp_variant=variant,
                moe_capacity_factor=cf)
    return (dataclasses.replace(
                ref_get_config("kimi-k2-1t-a32b").reduced(), **over),
            dataclasses.replace(
                get_config("kimi-k2-1t-a32b").reduced(), **over))


def _params(cfg, seed):
    """MoE weights as numpy, with the reference's shapes."""
    rng = np.random.default_rng(seed)
    e, f = cfg.moe_num_experts, cfg.expert_d_ff

    def w(*shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)
                ).astype(np.float32)

    p = {"router": w(D, e, fan_in=D), "w1": w(e, D, f, fan_in=D),
         "w2": w(e, f, D, fan_in=f)}
    if cfg.mlp_variant in ("swiglu", "geglu"):
        p["w3"] = w(e, D, f, fan_in=D)
    if cfg.moe_shared_expert:
        p["shared"] = {"w1": w(D, f, fan_in=D), "w2": w(f, D, fan_in=f)}
        if cfg.mlp_variant in ("swiglu", "geglu"):
            p["shared"]["w3"] = w(D, f, fan_in=D)
    return p


def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in p.items()}


_ref_apply = jax.jit(ref_moe.apply_moe, static_argnums=(2, 3))


def _both(p, x, ref_cfg, cfg, subgroup=moe.MOE_SUBGROUP):
    """(reference (y, aux), port (y, aux)) as numpy."""
    ry, raux = _ref_apply(_tree(p, jnp.asarray), jnp.asarray(x), ref_cfg,
                          subgroup)
    y, aux = moe.apply_moe(_tree(p, torch.from_numpy), torch.from_numpy(x),
                           cfg, subgroup=subgroup)
    return ((np.asarray(ry), {k: float(v) for k, v in raux.items()}),
            (y.numpy(), {k: float(v) for k, v in aux.items()}))


def _check(ref, got):
    (ry, raux), (y, aux) = ref, got
    assert y.dtype == ry.dtype and y.shape == ry.shape
    np.testing.assert_allclose(y, ry, atol=1e-5, rtol=0)
    assert set(aux) == set(raux)
    for k in raux:
        tol = 1e-6 * max(1.0, abs(raux[k]))
        assert abs(aux[k] - raux[k]) <= tol, (k, aux[k], raux[k])


def _x(seed, shape=(2, 16, D)):
    return np.random.default_rng(seed).standard_normal(shape
                                                       ).astype(np.float32)


@pytest.mark.parametrize("cf", [8.0, 1.25, 0.25])
@pytest.mark.parametrize("routing", list(ROUTINGS))
def test_apply_moe_matches_reference(routing, cf):
    """Each routing at each capacity factor, over subgroups of 16 and of
    8 tokens (swiglu)."""
    ref_cfg, cfg = _cfgs(routing, "swiglu", cf)
    p = _params(cfg, seed=len(routing))
    for subgroup in (16, 8):
        ref, got = _both(p, _x(3), ref_cfg, cfg, subgroup)
        _check(ref, got)
        dropped = got[1]["moe_dropped"]
        if cf == 8.0:
            assert dropped == 0.0
        elif cf == 0.25:
            assert dropped >= 0.5


@pytest.mark.parametrize("subgroup", [16, 8])
@pytest.mark.parametrize("variant", ["geglu", "gelu"])
def test_mlp_variants_match_reference(variant, subgroup):
    """The other MLP variants, top-8 over 16 experts at cf 1.25 (drops)."""
    ref_cfg, cfg = _cfgs("top8_of_16", variant, 1.25)
    ref, got = _both(_params(cfg, seed=7 * len(variant)), _x(4), ref_cfg,
                     cfg, subgroup)
    _check(ref, got)
    assert got[1]["moe_dropped"] > 0


@pytest.mark.parametrize("routing", list(ROUTINGS))
def test_decode_rows_route_alone(routing):
    """s = 1 (a decode step): every row is its own group with capacity
    ceil(k cf / e); a row's output does not depend on the values of the
    other rows, to the bit (what keeps a survivor's stream intact when
    another slot faults)."""
    ref_cfg, cfg = _cfgs(routing, "swiglu", 1.25)
    p = _params(cfg, seed=11)
    x = _x(4, (5, 1, D))
    ref, got = _both(p, x, ref_cfg, cfg)
    _check(ref, got)
    other = _x(5, (5, 1, D))
    other[2] = x[2]
    other[4] = np.nan
    y, _ = moe.apply_moe(_tree(p, torch.from_numpy), torch.from_numpy(other),
                         cfg)
    np.testing.assert_array_equal(y.numpy()[2], got[0][2])
    assert np.isfinite(y.numpy()[:4]).all()


def test_gate_ties_break_to_the_lower_expert():
    """Experts 1 and 2 (and 0 and 3) share a router column, so their
    gates tie exactly: the reference's ``top_k`` takes the lower expert
    first, and so must the port, or the expert outputs (which differ)
    would be weighted the other way round."""
    ref_cfg, cfg = _cfgs("top2", "swiglu", 8.0)
    p = _params(cfg, seed=5)
    p["router"][:, 2] = p["router"][:, 1]
    p["router"][:, 3] = p["router"][:, 0]
    x = _x(6)
    _, _, gate, idx = moe.route(_tree(p, torch.from_numpy),
                                torch.from_numpy(x), 2)
    assert torch.equal(gate[..., 0], gate[..., 1])     # every pick tied
    assert (idx[..., 0] < idx[..., 1]).all()
    _check(*_both(p, x, ref_cfg, cfg))
    top1_ref, top1_cfg = _cfgs("top1_shared", "swiglu", 1.25)
    p1 = _params(top1_cfg, seed=8)
    p1["router"][:, 3] = p1["router"][:, 1]
    _check(*_both(p1, x, top1_ref, top1_cfg))


def test_zero_input_gives_zero_expert_rows():
    """A zero input routes uniformly (every gate ties); the expert rows
    it fills and the places nobody took stay zero in every variant."""
    for variant in ("swiglu", "geglu", "gelu"):
        ref_cfg, cfg = _cfgs("top2", variant, 1.25)
        ref_cfg = dataclasses.replace(ref_cfg, moe_shared_expert=False)
        cfg = dataclasses.replace(cfg, moe_shared_expert=False)
        p = _params(cfg, seed=9)
        x = np.zeros((1, 8, D), np.float32)
        ref, got = _both(p, x, ref_cfg, cfg)
        _check(ref, got)
        assert not got[0].any()


def test_subgroup_must_divide_the_sequence():
    _, cfg = _cfgs("top2", "swiglu", 1.25)
    p = _tree(_params(cfg, seed=1), torch.from_numpy)
    with pytest.raises(ValueError, match="not divisible"):
        moe.apply_moe(p, torch.zeros(1, 12, D), cfg, subgroup=8)


def test_init_keeps_the_router_in_fp32():
    cfg = dataclasses.replace(get_config("kimi-k2-1t-a32b").reduced(),
                              param_dtype="bfloat16")
    p = moe.init_moe(cfg, torch.bfloat16, torch.Generator().manual_seed(0),
                     "cpu", lead=(2,))
    e, d, f = cfg.moe_num_experts, cfg.d_model, cfg.expert_d_ff
    assert p["router"].dtype == torch.float32
    assert p["router"].shape == (2, d, e)
    assert p["w1"].dtype == torch.bfloat16 and p["w1"].shape == (2, e, d, f)
    assert p["w2"].shape == (2, e, f, d) and p["w3"].shape == (2, e, d, f)
    assert set(p["shared"]) == {"w1", "w2", "w3"}
    # each expert matrix is drawn on its own: truncated at 2 sigma
    lim = 2.0 / np.sqrt(d) * (1 + 2 ** -7)
    assert float(p["w1"].float().abs().max()) <= lim
    assert p["w1"][0, 0].float().std() > 0.5 / np.sqrt(d)


def test_expert_leaves_quantize_as_the_reference():
    """``quantize_params`` over a MoE block: the expert stacks
    (n_periods, e, d, f) and the shared expert are blocked along their
    last axis as in the reference, the router is left as it is even
    where its width is a multiple of the block (here 64 experts, as
    kimi-k2's 384 are: its name is not among the quantized leaves), and
    the bf16 cast casts the fp32 router too."""
    cfg = dataclasses.replace(get_config("kimi-k2-1t-a32b").reduced(),
                              moe_num_experts=64)
    leaves = {k: np.random.default_rng(2).standard_normal(
                  (2, *v.shape[1:])).astype(np.float32)
              for k, v in bridge.flatten(moe.init_moe(
                  cfg, torch.float32, None, "meta", lead=(2,))).items()}
    tree = bridge.unflatten(leaves)
    got, stats = quant.quantize_params(_tree(tree, torch.from_numpy),
                                       "float8_e4m3fn", torch.float32)
    want, ref_stats = ref_quant.quantize_params(
        _tree(tree, jnp.asarray), "float8_e4m3fn", jnp.float32)
    assert stats["n_quantized"] == ref_stats["n_quantized"] == len(
        leaves) - 1
    assert stats["quantized_bytes"] == ref_stats["quantized_bytes"]
    flat_got, flat_want = bridge.flatten(got), bridge.flatten(want)
    for k in leaves:
        np.testing.assert_array_equal(flat_got[k].numpy(),
                                      np.asarray(flat_want[k]))
    np.testing.assert_array_equal(flat_got["router"].numpy(),
                                  leaves["router"])
    cast, _ = quant.quantize_params(_tree(tree, torch.from_numpy),
                                    "bfloat16")
    assert all(t.dtype == torch.bfloat16
               for t in bridge.flatten(cast).values())
