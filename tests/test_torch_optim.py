"""The port's AdamW against the reference's, on the CPU: five steps of
``adamw_update`` from the same params on the same gradients (numpy from
a seed), under the default config, an active global-norm clip, a
factored second moment (matrices at and above ``factored_min_dim``,
period-stacked leaves included) and a bf16 first moment; params, ``m``,
``v`` (a factored leaf's row and column means) within rtol 1e-5, atol
1e-7 (fp32, the same formulas: summation order of the norm and the
means only), the step count equal.  A bf16 ``m`` may round one bf16 ulp
apart (rtol 2^-7, atol 2^-8 x the leaf's largest magnitude: the ulp
carries into the next step's sum), and the params by what that ulp
moves an update (atol 2^-6 x the summed lr).  Also: the update is in
place, decay reads the stacked shapes (``p.ndim >= 2``), and the
schedule matches the reference's.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint.checkpointer import _flatten  # noqa: E402
from repro.optim import AdamWConfig as RefConfig  # noqa: E402
from repro.optim import Schedule as RefSchedule  # noqa: E402
from repro.optim import adamw_init as ref_init  # noqa: E402
from repro.optim import adamw_update as ref_update  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.optim import (AdamWConfig, Schedule, adamw_init,  # noqa: E402
                               adamw_update, global_norm)

SHAPES = {"w": (130, 140), "stack": (2, 128, 129), "bias": (3, 16),
          "final_norm": (16,), "small": (2, 8, 8)}
CONFIGS = {
    "default": {},
    "clip": dict(clip_norm=0.05),
    "factored": dict(factored_v=True),
    "bf16_m": dict(m_dtype="bfloat16", weight_decay=0.3),
}
SCHED = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=6)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These small fp32 models run as fast on one intra-op thread, and
    one keeps parallel test workers from spinning against each other.
    The previous count is restored for the worker's next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_adamw_matches_reference(name):
    kw = CONFIGS[name]
    ref_cfg = RefConfig(schedule=RefSchedule(**SCHED), **kw)
    cfg = AdamWConfig(schedule=Schedule(**SCHED), **kw)
    rng = np.random.default_rng(len(name))
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in SHAPES.items()}
    ref_p = {k: jnp.asarray(v) for k, v in p0.items()}
    ref_s = ref_init(ref_cfg, ref_p)
    params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    state = adamw_init(cfg, params)
    ptrs = {k: t.data_ptr() for k, t in params.items()}
    lr_sum = 0.0
    for step in range(5):
        lr_sum += float(cfg.schedule(step + 1))
        g = {k: (rng.standard_normal(s) * 10 ** -step).astype(np.float32)
             for k, s in SHAPES.items()}
        ref_p, ref_s = ref_update(ref_cfg, ref_p,
                                  {k: jnp.asarray(v) for k, v in g.items()},
                                  ref_s)
        out_p, out_s = adamw_update(
            cfg, params, {k: torch.from_numpy(v) for k, v in g.items()},
            state)
        assert out_p is params and out_s is state
        got = bridge.flatten({"p": params, "m": state["m"], "v": state["v"]})
        want = _flatten({"p": ref_p, "m": ref_s["m"], "v": ref_s["v"]})
        assert set(got) == set(want)
        for k, w in want.items():
            w = np.asarray(w, np.float32)
            rtol, atol = 1e-5, 1e-7
            if kw.get("m_dtype") == "bfloat16" and k.startswith("m/"):
                rtol, atol = 2.0 ** -7, 2.0 ** -8 * float(np.abs(w).max())
            elif kw.get("m_dtype") == "bfloat16" and k.startswith("p/"):
                atol = 2.0 ** -6 * lr_sum
            np.testing.assert_allclose(got[k].float().numpy(), w, rtol=rtol,
                                       atol=atol,
                                       err_msg=f"{name} step {step}: {k}")
        assert int(state["step"]) == int(ref_s["step"]) == step + 1
    assert {k: t.data_ptr() for k, t in params.items()} == ptrs
    if kw.get("factored_v"):
        assert set(state["v"]["w"]) == {"row", "col"}
        assert state["v"]["stack"]["row"].shape == (2, 128)
        assert state["v"]["stack"]["col"].shape == (2, 129)
        assert isinstance(state["v"]["small"], torch.Tensor)
    if kw.get("m_dtype"):
        assert state["m"]["w"].dtype == torch.bfloat16


def test_decay_reads_the_stacked_shapes():
    """With zero gradients only the decay moves a param: a stacked norm
    scale (2-D) decays, ``final_norm`` (1-D) does not."""
    cfg = AdamWConfig(schedule=Schedule(peak_lr=0.1, warmup_steps=0,
                                        decay_steps=10), weight_decay=0.5)
    params = {"ln": torch.ones(3, 16), "final_norm": torch.ones(16)}
    state = adamw_init(cfg, params)
    adamw_update(cfg, params, {k: torch.zeros_like(v)
                               for k, v in params.items()}, state)
    assert bool((params["ln"] < 1.0).all())
    assert torch.equal(params["final_norm"], torch.ones(16))
    assert float(global_norm({"a": torch.full((4,), 3.0)})) == 6.0


@pytest.mark.parametrize("step", [0, 1, 5, 10, 60, 110, 200])
def test_schedule_matches_reference(step):
    kw = dict(peak_lr=1.0, warmup_steps=10, decay_steps=110, min_ratio=0.1)
    got = float(Schedule(**kw)(torch.tensor(step, dtype=torch.int32)))
    want = float(RefSchedule(**kw)(jnp.asarray(step, jnp.int32)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)
