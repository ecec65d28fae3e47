"""The port's checkpointer and training loop on the CPU: a tree
round-trips bit for bit (bf16, fp32, int32, a factored ``v`` leaf, a 0-d
step); the newest ``keep`` snapshots are kept; an async save restores;
no ``.tmp`` directory survives a save and a stale one is never LATEST;
checkpoints written by the reference restore bit for bit in the port
and the other way round (bf16 included: the port reads it through a
uint8 view, the reference through ``ml_dtypes``); a restore refuses a
shape that differs; ``run_train_loop`` resumed from a checkpoint equals
the uninterrupted run bit for bit (losses and final state), and so
does the launcher's; the straggler watchdog and the heartbeat.
"""

import dataclasses
import os
import time
import types

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import checkpointer as ref_ckpt  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import (Checkpointer, load_tree,  # noqa: E402
                                    save_tree)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import make_stream  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import AdamWConfig, Schedule  # noqa: E402
from repro_torch.train import (TrainLoopConfig, make_train_step,  # noqa: E402
                               run_train_loop, train_state_init)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These small fp32 models run as fast on one intra-op thread, and
    one keeps parallel test workers from spinning against each other.
    The previous count is restored for the worker's next module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(4, 6, generator=g).bfloat16(),
                       "b": torch.randn(6, generator=g)},
            "opt": {"v": {"w": {"row": torch.rand(4, generator=g),
                                "col": torch.rand(6, generator=g)}},
                    "step": torch.tensor(7, dtype=torch.int32)}}


def _bits(t):
    t = torch.as_tensor(t).contiguous()
    return t.reshape(-1).view(torch.uint8)


def _equal_bits(a, b):
    fa, fb = bridge.flatten(a), bridge.flatten(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        assert torch.equal(_bits(fa[k]), _bits(fb[k])), k


def test_roundtrip_bit_for_bit(tmp_path):
    tree = _tree()
    save_tree(str(tmp_path / "s"), tree, 7)
    got, step, specs = load_tree(str(tmp_path / "s"), tree)
    assert step == 7 and specs is None
    _equal_bits(got, tree)
    save_tree(str(tmp_path / "t"), tree, 8, specs={"params/w": ["data", None]})
    assert load_tree(str(tmp_path / "t"), tree)[2] == {
        "params/w": ["data", None]}


def test_latest_gc_and_atomicity(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, async_save=False)
    assert ck.restore_latest(_tree()) is None
    os.makedirs(tmp_path / "step_00000009.tmp")     # a crashed save
    for s in (1, 2, 3, 4):
        ck.save(_tree(s), s)
    assert ck.latest_step() == 4
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_00000003", "step_00000004", "step_00000009.tmp"]
    like = _tree(0)
    got, step = ck.restore_latest(like)
    assert step == 4 and got is like
    _equal_bits(got, _tree(4))


def test_async_save_snapshots_at_call(tmp_path):
    """An async save copies the tensors at once: an in-place update
    right after it does not reach the snapshot."""
    ck = Checkpointer(str(tmp_path), async_save=True)
    tree = _tree(1)
    want = _tree(1)
    ck.save(tree, 5, block=False)
    tree["params"]["b"].add_(1.0)
    ck.wait()
    got, step = ck.restore_latest(_tree(0))
    assert step == 5
    _equal_bits(got, want)
    ck.close()


def test_restore_refuses_a_shape_mismatch(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    ck.save(_tree(), 1)
    bad = _tree()
    bad["params"]["b"] = torch.zeros(5)
    with pytest.raises(ValueError, match="params/b"):
        ck.restore(1, bad)


def test_reference_written_restores_in_the_port(tmp_path):
    tree = _tree(2)
    ref_tree = {"params": {"w": jnp.asarray(tree["params"]["w"].float()
                                            .numpy()).astype(jnp.bfloat16),
                           "b": jnp.asarray(tree["params"]["b"].numpy())},
                "opt": {"v": {"w": {k: jnp.asarray(v.numpy()) for k, v in
                                    tree["opt"]["v"]["w"].items()}},
                        "step": jnp.asarray(7, jnp.int32)}}
    ref_ckpt.save_tree(str(tmp_path / "ref"), ref_tree, 3)
    got, step, _ = load_tree(str(tmp_path / "ref"), tree)
    assert step == 3
    _equal_bits(got, tree)


def test_port_written_restores_in_the_reference(tmp_path):
    tree = _tree(3)
    save_tree(str(tmp_path / "port"), tree, 4)
    like = bridge.unflatten({k: 0 for k in bridge.flatten(tree)})
    got, step, _ = ref_ckpt.load_tree(str(tmp_path / "port"), like)
    assert step == 4
    flat = ref_ckpt._flatten(got)
    for k, t in bridge.flatten(tree).items():
        arr = np.asarray(flat[k])
        assert arr.dtype.name == str(t.dtype).removeprefix("torch."), k
        assert arr.shape == tuple(t.shape), k
        assert arr.tobytes() == _bits(t).numpy().tobytes(), k


def _run(ckpt_dir, total, model, opt, cfg):
    state = train_state_init(model, opt, torch.Generator().manual_seed(0),
                             "cpu")
    losses = []
    loop = TrainLoopConfig(total_steps=total, checkpoint_every=100,
                           log_every=1, checkpoint_dir=ckpt_dir)
    state, hist = run_train_loop(
        make_train_step(model, opt, accum_steps=2), state,
        make_stream(cfg, 4, 16), loop,
        on_metrics=lambda s, m: losses.append((s, m["loss"])))
    return state, losses


def test_train_loop_resume_equals_uninterrupted(tmp_path):
    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(), n_layers=2)
    model = build_model(cfg)
    opt = AdamWConfig(schedule=Schedule(peak_lr=1e-2, warmup_steps=2,
                                        decay_steps=10))
    straight, losses = _run(None, 4, model, opt, cfg)
    _, first = _run(str(tmp_path), 2, model, opt, cfg)
    assert os.path.exists(tmp_path / "heartbeat.0")
    resumed, rest = _run(str(tmp_path), 4, model, opt, cfg)
    assert [s for s, _ in first + rest] == [0, 1, 2, 3]
    assert first + rest == losses
    _equal_bits(resumed, straight)


@pytest.mark.parametrize("total,every,want", [
    (4, 2, [2, 4, 4]), (5, 2, [2, 4, 5]), (3, 100, [3])])
def test_train_loop_snapshot_steps(tmp_path, monkeypatch, total, every,
                                   want):
    """The loop's snapshots, as the reference's loop takes them: every
    ``checkpoint_every`` steps, then the final step (again when the last
    periodic snapshot was already it); LATEST names the final step."""
    from repro_torch.checkpoint import Checkpointer
    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(), n_layers=1)
    model = build_model(cfg)
    opt = AdamWConfig()
    saves = []
    save = Checkpointer.save
    monkeypatch.setattr(Checkpointer, "save", lambda self, tree, step, *a,
                        **k: (saves.append(step), save(self, tree, step, *a,
                                                       **k))[1])
    state = train_state_init(model, opt, torch.Generator().manual_seed(0),
                             "cpu")
    run_train_loop(make_train_step(model, opt), state, make_stream(cfg, 2, 8),
                   TrainLoopConfig(total_steps=total, checkpoint_every=every,
                                   checkpoint_dir=str(tmp_path),
                                   straggler_deadline_factor=1e9))
    assert saves == want
    assert (tmp_path / "LATEST").read_text() == str(total)


def test_watchdog_and_heartbeat(tmp_path, monkeypatch):
    """A step over 3x the rolling median is a straggler event (on a
    patched clock, so no sleep decides it); the heartbeat file holds
    the last step and goes stale."""
    from repro_torch.distributed import elastic
    clock = iter([0.0, 1.0, 1.0, 2.0, 2.0, 3.0, 3.0, 4.0, 4.0, 5.0,
                  5.0, 9.0])
    monkeypatch.setattr(elastic, "time", types.SimpleNamespace(
        perf_counter=lambda: next(clock), time=time.time))
    seen = []
    dog = elastic.StepWatchdog(3.0, on_straggler=seen.append)
    events = []
    for step in range(6):
        dog.start_step(step)
        events.append(dog.end_step())
    assert events[:5] == [None] * 5
    assert events[5] == elastic.StragglerEvent(5, 4.0, 1.0) == seen[0]
    assert dog.median_s == 1.0
    with pytest.raises(RuntimeError):
        dog.end_step()
    hb = elastic.Heartbeat(str(tmp_path), process_index=3)
    assert hb.last() is None and hb.stale(10.0)
    hb.beat(7)
    assert hb.last()[0] == 7 and not hb.stale(60.0)
    assert os.path.exists(tmp_path / "heartbeat.3")


def test_train_launcher_on_the_cpu_resumes(tmp_path):
    """The launcher, reduced on the CPU with a checkpoint directory: a
    second call with more steps resumes where the first stopped."""
    from repro_torch.launch import train as launch_train
    argv = ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "16",
            "--ckpt", str(tmp_path)]
    first = launch_train.main(argv + ["--steps", "2"])
    assert [h["step"] for h in first] == [0, 1]
    again = launch_train.main(argv + ["--steps", "3"])
    assert [h["step"] for h in again] == [2]
    assert all(np.isfinite(h["loss"]) for h in first + again)
