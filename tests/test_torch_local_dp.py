"""The port's explicit data-parallel step against the reference's and
against the port's single-process step, on the CPU.

* World 1 (a one-rank gloo group in this process) against the
  reference's ``make_local_dp_train_step`` on its one-device mesh:
  qwen2.5-3b reduced to 2 layers, accum 2, two steps, each from the
  reference's state (carried across by ``repro_torch.bridge``).
  Uncompressed: the loss within 1e-6 of itself, the reference's own
  tolerance (``tests/test_local_dp.py``) read relative (the two packages
  sum in other orders: at a loss of ~6.5, 2-3 fp32 ulps, up to 1.43e-6;
  ``python tests/test_torch_local_dp.py`` prints these readings and
  the params' below); ce, acc and
  grad_norm rtol 1e-5; ``m`` / ``v`` rtol 1e-4, atol 1e-4 x the leaf's
  largest magnitude; every param within atol 1e-6, the reference's own
  tolerance, or else within what the two sides' moments explain (lr x
  the difference of their AdamW directions, :func:`_params_close`), and
  in every leaf but the K bias at most 1 element in 1000 beyond atol
  1e-6 / rtol 1e-4 (each within 2 x the lr).  Compressed: the same but
  for phase 3i's share, 1 element in 100, and up to 1 in 100 of ``m`` /
  ``v`` within one quantum's move: where ``g / scale`` sits at the
  stochastic rounding's boundary, the packages' ulp-level gradients
  round to neighbouring integers.
* World 1 against ``make_train_step`` at accum 1 and 2: bit-identical
  params, ``m``, ``v``, step and loss over two steps.
* Two gloo ranks (separate processes, a ``FileStore``) at accum 1
  against one process's ``make_train_step`` at accum 2 on the whole
  batch: bit-identical state and loss (the same two sums, the same
  division), grad_norm rtol 1e-6 (its sum of the leaves is in leaf
  order, ``make_train_step``'s in ``global_norm``'s).
* The uncompressed mean's buckets at world 1: their grouping, and each
  leaf's own elements back in place.
* Three gloo ranks: ``reduce_gradients`` (uncompressed) and
  ``reduce_metrics`` against the reference's jitted ``pmean`` over 3
  forced host devices.  Where the three ranks' sums are exact in fp32
  in any order, only the final scaling rounds: bit-identical, and the
  data are such that a plain ``/ 3`` differs.  On general data the
  summation order may differ: within 2^-22 x the sum of the ranks'
  magnitudes, twice the first-order bound (2 roundings of a 3-term sum
  each way, 4u, times ~1/3, plus 2 roundings of the products, 2u / 3:
  2u = 2^-23 of that sum, u = 2^-24).
* Accumulation over 3 microbatches (``accumulate_grads``) against the
  reference's jitted ``g / 3`` on one fixed, exact sum, in fp32 and in
  the bf16 accum dtype: bit-identical (in bf16 a ``/ 3`` rounds alike:
  the two fp32 results never straddle a bf16 rounding point).
* Convergence over 30 steps, compressed and not: the final loss below
  0.2 x the first, as ``tests/test_local_dp.py``.
"""

import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import torch_dp_cases as cases  # noqa: E402
from repro.checkpoint.checkpointer import _flatten  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.optim import Schedule as RefSchedule  # noqa: E402
from repro.train import train_state_init as ref_train_state_init  # noqa: E402
from repro.train.local_dp import (  # noqa: E402
    make_local_dp_train_step as ref_make_local_dp_train_step)

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import make_stream  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import AdamWConfig, Schedule  # noqa: E402
from repro_torch.train import (make_local_dp_train_step,  # noqa: E402
                               make_train_step, train_state_init)

ARCH = "qwen2.5-3b"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A one-rank gloo group as the default group (a FileStore: no
    socket to rendezvous), destroyed after the module."""
    store = dist.FileStore(str(tmp_path_factory.mktemp("gloo") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _port(sched=cases.DP_SCHED):
    cfg = dataclasses.replace(get_config(ARCH).reduced(), n_layers=2)
    return cfg, build_model(cfg), AdamWConfig(schedule=Schedule(**sched))


def _direction(state, opt, name):
    """AdamW's direction ``m_hat / (sqrt(v_hat) + eps)`` for the param
    ``name`` in the flat numpy train state after a step (float64)."""
    t = float(state["opt/step"])
    m = state["opt/m/" + name].astype(np.float64) / (1 - opt.b1 ** t)
    v = state["opt/v/" + name].astype(np.float64) / (1 - opt.b2 ** t)
    return m / (np.sqrt(v) + opt.eps)


def _params_close(label, got, want, opt, lr, share):
    """Both states, flat, after one step from one state.  Every param
    within atol 1e-6 of the reference's (``tests/test_local_dp.py``'s
    ``assert_allclose``), or else within 1e-6 + lr x (1 + 1e-3) x the
    difference of the two sides' AdamW directions (:func:`_direction`,
    each from its own ``m`` and ``v``, which :func:`_opt_close` holds to
    the reference's): a param may differ only as far as its moments
    do.  Besides, every leaf but the K bias has at most ``share`` of its
    elements beyond atol 1e-6 / rtol 1e-4, each within 2 x the lr.  The
    K bias is exempt from that share alone: its gradient sits at the
    rounding level (a bias on every key shifts a query's scores by
    nearly one constant), where the two packages' sums differ by ulps
    and AdamW's direction ``g / (|g| + eps)`` moves with them."""
    for k, w in want.items():
        if not k.startswith("params/"):
            continue
        name = k.split("/", 1)[1]
        g = got[k].astype(np.float32)
        w = w.astype(np.float32)
        diff = np.abs(g - w)
        moved = lr * (1 + 1e-3) * np.abs(_direction(got, opt, name)
                                         - _direction(want, opt, name))
        assert (diff <= 1e-6 + np.maximum(1e-7 * np.abs(w), moved)).all(), (
            label, k, float((diff - moved).max()))
        out = diff > 1e-6 + 1e-4 * np.abs(w)
        if not k.endswith("/attn/bk"):
            assert out.sum() <= share * w.size, (label, k, int(out.sum()),
                                                 float(diff.max()))
        assert (diff[out] <= 2 * lr).all(), (label, k, float(diff[out].max()))


def _opt_close(label, got, want, before, opt, quantum_share):
    """``m`` and ``v`` within rtol 1e-4 / atol 1e-4 x the leaf's largest
    magnitude.  With ``quantum_share``, up to that share of a leaf's
    elements may lie outside, each within what one quantum of the
    compressed gradient moves it: the quantum is at most ``max |c g| /
    127`` (``c g``, the clipped gradient, recovered from the reference's
    ``m`` and the ``m`` before the step), which moves ``m`` by ``(1 -
    b1)`` of it and ``v`` by ``(1 - b2) (2 max |c g| + q) q``."""
    for k, w in want.items():
        g = got[k]
        tol = 1e-4 * float(np.abs(w).max(initial=0.0))
        out = np.abs(g - w) > tol + 1e-4 * np.abs(w)
        if quantum_share and out.any():
            m = "opt/m/" + k.split("/", 2)[2]
            cg = (want[m] - opt.b1 * before[m]) / (1 - opt.b1)
            gmax = float(np.abs(cg).max())
            q = gmax / 127 * (1 + 1e-3)
            bound = ((1 - opt.b1) * q if k.startswith("opt/m/")
                     else (1 - opt.b2) * (2 * gmax + q) * q)
            assert out.sum() <= quantum_share * w.size, (label, k,
                                                         int(out.sum()))
            assert (np.abs(g - w)[out] <= bound).all(), (
                label, k, float(np.abs(g - w)[out].max()), bound)
            g = np.where(out, w, g)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=tol,
                                   err_msg=f"{label}: {k}")


def _world1_steps(compress):
    """The port's one-rank DP step and the reference's, two steps at
    accum 2, each from the reference's state: for each step (label, the
    port's metrics, the reference's, the port's flat numpy state after
    it, the reference's, the reference's before it, the port's AdamW
    config, the step's lr).  Needs a one-rank default group."""
    ref_cfg = dataclasses.replace(ref_get_config(ARCH).reduced(), n_layers=2)
    cfg, model, opt = _port()
    ref_model = ref_build_model(ref_cfg)
    ref_opt = RefAdamWConfig(schedule=RefSchedule(**cases.DP_SCHED))
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    ref_state = ref_train_state_init(ref_model, ref_opt,
                                     jax.random.PRNGKey(0))
    step = make_local_dp_train_step(model, opt, accum_steps=2,
                                    compress=compress)
    rng = np.random.default_rng(12)
    with mesh:
        ref_step = ref_make_local_dp_train_step(
            ref_model, ref_opt, mesh, accum_steps=2, compress=compress)
        for i in range(2):
            flat = {k: np.asarray(v) for k, v in _flatten(ref_state).items()}
            state = bridge.train_state_from_numpy(flat, cfg)
            tokens = rng.integers(0, cfg.vocab_size, (4, 16)).astype(
                np.int32)
            ref_state, ref_m = ref_step(ref_state,
                                        {"tokens": jnp.asarray(tokens)})
            state, m = step(state, {"tokens": torch.from_numpy(tokens)})
            got = bridge.train_state_to_numpy(state)
            want = {k: np.asarray(v) for k, v in _flatten(ref_state).items()}
            yield (f"compress {compress} step {i}", m, ref_m, got, want,
                   flat, opt, float(opt.schedule(i + 1)))


@pytest.mark.parametrize("compress", [False, True])
def test_world1_matches_reference(one_rank, compress):
    for i, (label, m, ref_m, got, want, flat, opt, lr) in enumerate(
            _world1_steps(compress)):
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                                   rtol=1e-6, err_msg=label)
        for name in ("ce", "acc", "grad_norm"):
            np.testing.assert_allclose(float(m[name]), float(ref_m[name]),
                                       rtol=1e-5, err_msg=label)
        assert int(got["opt/step"]) == int(want["opt/step"]) == i + 1
        _params_close(label, got, want, opt, lr,
                      0.01 if compress else 0.001)
        _opt_close(label,
                   {k: v for k, v in got.items()
                    if k.startswith("opt/") and k != "opt/step"},
                   {k: v for k, v in want.items()
                    if k.startswith("opt/") and k != "opt/step"},
                   flat, opt, 0.01 if compress else 0.0)


def _state_bits(state):
    return {k: v.tobytes() for k, v in
            bridge.train_state_to_numpy(state).items()}


@pytest.mark.parametrize("accum", [1, 2])
def test_world1_is_make_train_step(one_rank, accum):
    cfg, model, opt = _port()
    states = [train_state_init(model, opt, torch.Generator().manual_seed(3),
                               "cpu") for _ in range(2)]
    steps = (make_local_dp_train_step(model, opt, accum_steps=accum),
             make_train_step(model, opt, accum_steps=accum))
    rng = np.random.default_rng(13)
    for _ in range(2):
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (4, 16)).astype(np.int32))}
        (s0, m0), (s1, m1) = (f(s, batch) for f, s in zip(steps, states))
        assert torch.equal(m0["loss"], m1["loss"])
    a, b = (_state_bits(s) for s in states)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k] == b[k], k


def test_uncompressed_mean_buckets(one_rank, monkeypatch):
    """The uncompressed mean sums runs of leaves of up to ``BUCKET``
    elements in one all-reduce, a larger leaf alone, and hands each leaf
    its own elements back in place (world 1: the mean is the leaf)."""
    from repro_torch.train import local_dp
    monkeypatch.setattr(local_dp, "BUCKET", 100)
    rng = np.random.default_rng(5)
    shapes = [(30,), (5, 10), (40,), (250,), (10,), (3, 20)]
    grads = {f"g{i}": torch.from_numpy(
        rng.standard_normal(sh).astype(np.float32))
        for i, sh in enumerate(shapes)}
    buckets = local_dp._buckets(list(grads.values()))
    assert [[g.numel() for g in b] for b in buckets] == [
        [30, 50], [40], [250], [10, 60]]
    want = {k: g.clone() for k, g in grads.items()}
    ptrs = {k: g.data_ptr() for k, g in grads.items()}
    out = local_dp.reduce_gradients(grads, None, 1)
    assert list(out) == list(want)
    for k, g in out.items():
        assert g.data_ptr() == ptrs[k] and torch.equal(g, want[k]), k


def test_two_gloo_ranks_match_train_step(tmp_path):
    outs = cases.run_ranks("port_dp", 2, str(tmp_path))
    ranks = [dict(np.load(o)) for o in outs]
    _, model, opt, state, batches = cases.dp_setup()
    step = make_train_step(model, opt, accum_steps=2)
    for i, batch in enumerate(batches):
        state, m = step(state, batch)
        for r, got in enumerate(ranks):
            for k, v in m.items():
                want = np.float32(float(v))
                have = got[f"metrics/{i}/{k}"]
                if k == "grad_norm":
                    np.testing.assert_allclose(have, want, rtol=1e-6)
                else:
                    assert have == want, (r, i, k, have, want)
    want = bridge.train_state_to_numpy(state)
    for r, got in enumerate(ranks):
        for k, w in want.items():
            assert got[k].tobytes() == w.tobytes(), (r, k)


def test_world3_mean_is_the_jitted_pmean(tmp_path):
    store = str(tmp_path / "pmean.store")
    outs = [str(tmp_path / f"port_{r}.npz") for r in range(3)]
    cases.run([("ref_pmean", str(tmp_path / "ref.npz"), 3)]
              + [("port_pmean", 3, r, store, outs[r]) for r in range(3)])
    want = dict(np.load(tmp_path / "ref.npz"))
    sets = [cases._flat(cases.pmean_set(r)) for r in range(3)]
    exact = [k for k in want if k.startswith("exact/")]
    for group in ([k for k in exact if want[k].ndim],     # gradients
                  [k for k in exact if not want[k].ndim]):  # metrics
        total = np.concatenate([(sets[0][k] + sets[1][k] + sets[2][k])
                                .reshape(-1) for k in group])  # exact
        w = np.concatenate([want[k].reshape(-1) for k in group])
        assert (total / np.float32(3) != w).any(), group
    for r, out in enumerate(outs):
        got = dict(np.load(out))
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            if k in exact:
                assert got[k].tobytes() == w.tobytes(), (r, k)
            else:
                mag = sum(np.abs(x[k]).astype(np.float64) for x in sets)
                diff = np.abs(got[k].astype(np.float64) - w)
                assert (diff <= 2.0 ** -22 * mag).all(), (r, k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_accum3_mean_is_the_jitted_division(dtype):
    """``accumulate_grads`` over 3 microbatches: one fixed gradient sum
    (each microbatch's values small integers times 2^-8, so that the sum
    is exact in ``dtype``) and its metrics' sum against the jitted
    ``g / 3`` of the reference's accumulation."""
    from repro_torch.train.step import accumulate_grads
    rng = np.random.default_rng(21)
    top = 2 ** 20 if dtype == "float32" else 80     # |sum| < 2^24 / 2^8
    parts = [{"g": (rng.integers(-top, top, (17, 40)) * 2.0 ** -8).astype(
        np.float32)} for _ in range(3)]
    metrics = [{"loss": np.float32(rng.integers(-2 ** 20, 2 ** 20)
                                   * 2.0 ** -8)} for _ in range(3)]

    def grad_fn(params, batch):
        i = int(batch["i"][0])
        return ({k: torch.tensor(v) for k, v in metrics[i].items()},
                {k: torch.from_numpy(v) for k, v in parts[i].items()})

    m, g = accumulate_grads(grad_fn, {}, {"i": torch.arange(3)}, 3,
                            getattr(torch, dtype))
    jdt = getattr(jnp, dtype)
    g_sum = sum(jnp.asarray(p["g"]).astype(jdt) for p in parts)
    m_sum = sum(jnp.asarray(x["loss"]) for x in metrics)
    divide = jax.jit(lambda t: t / 3)
    want_g = np.asarray(divide(g_sum).astype(jnp.float32))
    assert g["g"].dtype == getattr(torch, dtype)
    assert g["g"].float().numpy().tobytes() == want_g.tobytes()
    assert m["loss"].numpy().tobytes() == np.asarray(
        divide(m_sum)).tobytes()
    if dtype == "float32":           # the data tell the two apart
        assert (np.asarray(g_sum) / np.float32(3) != want_g).any()


@pytest.mark.parametrize("compress", [False, True])
def test_converges(one_rank, compress):
    cfg, model, opt = _port(dict(peak_lr=1e-2, warmup_steps=5,
                                 decay_steps=100))
    stream = make_stream(cfg, 2, 64)
    step = make_local_dp_train_step(model, opt, compress=compress)
    state = train_state_init(model, opt, torch.Generator().manual_seed(0),
                             "cpu")
    losses = []
    for i in range(30):
        state, m = step(state, stream.batch(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < 0.2 * losses[0], (compress, losses[0], losses[-1])


def _readings(got, want, opt, lr):
    """Each param leaf with elements beyond atol 1e-6 of the
    reference's: (those elements, the leaf's size, their largest
    difference, the largest ratio of a difference to lr x the difference
    of the two sides' AdamW directions there)."""
    out = {}
    for k, w in want.items():
        if not k.startswith("params/"):
            continue
        name = k.split("/", 1)[1]
        diff = np.abs(got[k].astype(np.float32) - w.astype(np.float32))
        beyond = diff > 1e-6 + 1e-7 * np.abs(w)
        if beyond.any():
            moved = lr * np.abs(_direction(got, opt, name)
                                - _direction(want, opt, name))
            out[k] = (int(beyond.sum()), w.size, float(diff.max()),
                      float((diff[beyond]
                             / np.maximum(moved[beyond], 1e-30)).max()))
    return out


if __name__ == "__main__":
    # The readings the world-1 tolerance was set from, and the loss's
    # difference in fp32 ulps:
    #   PYTHONPATH=src python tests/test_torch_local_dp.py
    import tempfile
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tempfile.mkdtemp(),
                                                  "store"), 1),
        rank=0, world_size=1)
    for compress in (False, True):
        for label, m, ref_m, got, want, _, opt, lr in _world1_steps(
                compress):
            loss, ref_loss = float(m["loss"]), float(ref_m["loss"])
            ulps = abs(loss - ref_loss) / np.spacing(np.float32(ref_loss))
            print(f"{label}: loss {loss:.9g} reference {ref_loss:.9g} "
                  f"({ulps:.0f} ulps), lr {lr:.3g}")
            for k, (n, size, dmax, ratio) in _readings(got, want, opt,
                                                       lr).items():
                print(f"  {k}: {n} of {size} beyond 1e-6, largest "
                      f"{dmax:.4g}, at most {ratio:.4f} x its moments' "
                      f"move")
    dist.destroy_process_group()
