"""Multi-process cases of the port's data-parallel training, run in
subprocesses by ``tests/test_torch_compression.py`` and
``tests/test_torch_local_dp.py`` (not collected: no ``test_`` prefix).

Each case writes an ``.npz`` and prints ``CASE_OK``:

    # the reference's compressed_psum_tree under shard_map over the
    # first WORLD of 4 forced host devices (XLA_FLAGS set here, before
    # JAX starts), rank r's leaves stacked on a leading axis
    PYTHONPATH=src python tests/torch_dp_cases.py ref_compress OUT WORLD...
    # one gloo rank of the port (a FileStore at STORE: no TCP store)
    PYTHONPATH=src python tests/torch_dp_cases.py port_compress \\
        WORLD RANK STORE OUT
    PYTHONPATH=src python tests/torch_dp_cases.py port_dp \\
        WORLD RANK STORE OUT
    # the uncompressed mean: the reference's jitted pmean over WORLD
    # forced host devices, then one gloo rank of the port's
    # reduce_gradients and reduce_metrics
    PYTHONPATH=src python tests/torch_dp_cases.py ref_pmean OUT WORLD
    PYTHONPATH=src python tests/torch_dp_cases.py port_pmean \\
        WORLD RANK STORE OUT

The gloo ranks pair over the loopback device (``GLOO_SOCKET_IFNAME=lo``,
set by the caller) and run one torch thread each.
"""

import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

KEY_SEED, KEY_STEP = 3, 2
EXTREME = 127 / 8        # |g| / scale is exactly qmax = 127 (world <= 258)
DP_SCHED = dict(peak_lr=1e-2, warmup_steps=5, decay_steps=100)
DP_STEPS, DP_BATCH, DP_SEQ = 2, 4, 16


def leaf_set(rank: int) -> dict:
    """Rank ``rank``'s gradient leaves: 1-D, 2-D, 3-D (per-row scales),
    all zero, one outlier row, and three leaves that put every rank at
    +qmax, at -qmax, and at alternating signs over an odd count."""
    rng = np.random.default_rng(rank)
    outlier = rng.standard_normal((6, 8)).astype(np.float32)
    outlier[0] *= 1e3
    alt = np.full(21, EXTREME, np.float32)
    alt[1::2] *= -1
    return {"vec": rng.standard_normal(37).astype(np.float32),
            "mat": rng.standard_normal((9, 13)).astype(np.float32),
            "blocks": {"cube": rng.standard_normal((3, 5, 70)).astype(
                           np.float32),
                       "zero": np.zeros((4, 6), np.float32)},
            "outlier": outlier,
            "extreme": {"pos": np.full((5, 6), EXTREME, np.float32),
                        "neg": np.full((5, 6), -EXTREME, np.float32),
                        "alt": alt.reshape(3, 7)}}


def pmean_set(rank: int) -> dict:
    """Rank ``rank``'s leaves for the uncompressed mean: under
    ``exact/``, small integers times 2^-8, whose sums over up to 4 ranks
    are exact in fp32 in any order (|k| < 2^20), so that only the final
    scaling rounds; under ``general/``, normal values over six decades.
    The 0-d leaves are metrics, the others gradients."""
    rng = np.random.default_rng(100 + rank)

    def exact(shape):
        return (rng.integers(-2 ** 20, 2 ** 20, shape)
                * 2.0 ** -8).astype(np.float32)

    def general(shape):
        return (rng.standard_normal(shape)
                * 10.0 ** rng.uniform(-3, 3, shape)).astype(np.float32)

    return {kind: {"vec": fn(1000), "mat": fn((33, 70)),
                   **{f"metric{i}": fn(()) for i in range(8)}}
            for kind, fn in (("exact", exact), ("general", general))}


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def ref_compress(out: str, *worlds: int) -> None:
    """The reference's result at each world of ``worlds``, saved as
    ``{out}_{world}.npz``."""
    devices = _xla_devices(4)
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.compat import shard_map
    from repro.distributed.compression import compressed_psum_tree

    key = jax.random.fold_in(jax.random.PRNGKey(KEY_SEED), KEY_STEP)
    for world in worlds:
        mesh = Mesh(np.array(devices[:world]), ("data",))
        stacked = jax.tree.map(lambda *xs: np.stack(xs),
                               *[leaf_set(r) for r in range(world)])

        def local(g, key, world=world):
            g = jax.tree.map(lambda x: x[0], g)
            return compressed_psum_tree(g, key, "data", world)

        fn = jax.jit(shard_map(local, mesh=mesh,
                               in_specs=(P("data"), P()), out_specs=P()))
        np.savez(f"{out}_{world}.npz",
                 **_flat(jax.tree.map(np.asarray, fn(stacked, key))))


def _xla_devices(n: int):
    """JAX on the CPU with ``n`` forced host devices (set before JAX
    starts)."""
    os.environ["XLA_FLAGS"] = (f"--xla_force_host_platform_device_count={n} "
                               + os.environ.get("XLA_FLAGS", ""))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    return jax.devices()


def ref_pmean(out: str, world: int) -> None:
    """The reference's uncompressed mean, ``jax.lax.pmean`` of every
    leaf of :func:`pmean_set` under ``jit`` and ``shard_map`` over
    ``world`` host devices (as its local DP step reduces gradients and
    metrics), saved to ``out``."""
    devices = _xla_devices(world)
    import jax
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.compat import shard_map
    mesh = Mesh(np.array(devices[:world]), ("data",))
    stacked = jax.tree.map(lambda *xs: np.stack(xs),
                           *[pmean_set(r) for r in range(world)])

    def local(g):
        return jax.tree.map(lambda x: jax.lax.pmean(x[0], "data"), g)

    fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(P("data"),),
                           out_specs=P()))
    np.savez(out, **_flat(jax.tree.map(np.asarray, fn(stacked))))


def port_pmean(world: int, rank: int, store: str, out: str) -> None:
    """One gloo rank of the port's uncompressed mean of
    :func:`pmean_set`: ``local_dp.reduce_gradients`` of the gradients
    and ``local_dp.reduce_metrics`` of the 0-d leaves."""
    import torch
    import torch.distributed as dist
    from repro_torch.train.local_dp import reduce_gradients, reduce_metrics
    _init_gloo(world, rank, store)
    try:
        leaves = {k: torch.from_numpy(v)
                  for k, v in _flat(pmean_set(rank)).items()}
        got = reduce_gradients({k: v for k, v in leaves.items() if v.ndim},
                               None, world)
        got.update(reduce_metrics({k: v for k, v in leaves.items()
                                   if not v.ndim}, None, world))
        np.savez(out, **{k: v.numpy() for k, v in got.items()})
    finally:
        dist.destroy_process_group()


def _init_gloo(world: int, rank: int, store: str) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)


def port_compress(world: int, rank: int, store: str, out: str) -> None:
    import torch
    import torch.distributed as dist
    from repro_torch.bridge import flatten, unflatten
    from repro_torch.distributed import compressed_psum_tree
    from repro_torch.serve import prng
    _init_gloo(world, rank, store)
    try:
        leaves = {k: torch.from_numpy(v)
                  for k, v in _flat(leaf_set(rank)).items()}
        key = prng.fold_in(prng.prng_key(KEY_SEED), torch.tensor(KEY_STEP))
        got = compressed_psum_tree(unflatten(leaves), key, None, world)
        np.savez(out, **{k: v.numpy() for k, v in flatten(got).items()})
    finally:
        dist.destroy_process_group()


def dp_setup():
    """(cfg, model, opt, initial state, [global batches]) of the
    multi-rank DP case: qwen2.5-3b reduced to 2 layers, seeded."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.optim import AdamWConfig, Schedule
    from repro_torch.train import train_state_init
    cfg = dataclasses.replace(get_config("qwen2.5-3b").reduced(), n_layers=2)
    model = build_model(cfg)
    opt = AdamWConfig(schedule=Schedule(**DP_SCHED))
    state = train_state_init(model, opt, torch.Generator().manual_seed(0),
                             "cpu")
    rng = np.random.default_rng(11)
    batches = [{"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (DP_BATCH, DP_SEQ)).astype(np.int32))}
        for _ in range(DP_STEPS)]
    return cfg, model, opt, state, batches


def port_dp(world: int, rank: int, store: str, out: str) -> None:
    """``DP_STEPS`` uncompressed DP steps at accum 1 over ``world`` gloo
    ranks; the final train state and each step's metrics."""
    import torch.distributed as dist
    from repro_torch import bridge
    from repro_torch.train import make_local_dp_train_step
    _init_gloo(world, rank, store)
    try:
        _, model, opt, state, batches = dp_setup()
        step = make_local_dp_train_step(model, opt)
        metrics = {}
        for i, batch in enumerate(batches):
            state, m = step(state, batch)
            metrics.update({f"metrics/{i}/{k}": np.asarray(float(v),
                                                           np.float32)
                            for k, v in m.items()})
        np.savez(out, **bridge.train_state_to_numpy(state), **metrics)
    finally:
        dist.destroy_process_group()


def run(args, timeout: float = 120.0) -> list:
    """Run each argument list in ``args`` as a case of this file, all at
    once, each in its own interpreter (``PYTHONPATH=src``, the CPU, the
    loopback device for gloo); raise with a case's output if it failed.
    Returns the outputs."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(REPO, "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, __file__, *map(str, a)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for a in args]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for a, p, out in zip(args, procs, outs):
        if p.returncode != 0 or "CASE_OK" not in out:
            raise AssertionError(f"case {a} exited {p.returncode}:\n{out}")
    return outs


def run_ranks(case: str, world: int, tmp, timeout: float = 120.0) -> list:
    """``case`` on ``world`` gloo ranks sharing a FileStore in ``tmp``:
    the paths of the ranks' ``.npz`` outputs."""
    store = os.path.join(tmp, f"{case}_{world}.store")
    outs = [os.path.join(tmp, f"{case}_{world}_{r}.npz")
            for r in range(world)]
    run([(case, world, r, store, outs[r]) for r in range(world)], timeout)
    return outs


if __name__ == "__main__":
    case, *args = sys.argv[1:]
    if case == "ref_compress":
        ref_compress(args[0], *map(int, args[1:]))
    elif case == "port_compress":
        port_compress(int(args[0]), int(args[1]), args[2], args[3])
    elif case == "port_dp":
        port_dp(int(args[0]), int(args[1]), args[2], args[3])
    elif case == "ref_pmean":
        ref_pmean(args[0], int(args[1]))
    elif case == "port_pmean":
        port_pmean(int(args[0]), int(args[1]), args[2], args[3])
    else:
        raise SystemExit(f"unknown case {case!r}")
    print("CASE_OK", case)
