"""Explicit data-parallel train step (counterpart of
``repro.train.local_dp``): deferred gradient reduction over a
``torch.distributed`` process group, optionally int8-compressed.

Each rank holds the whole (replicated) train state and receives the
same global batch; it takes its contiguous rows ``[r * b / w, (r + 1) *
b / w)`` (what the reference's ``P(axis)`` gives shard ``r``),
accumulates its LOCAL gradients in fp32 over ``accum_steps``
microbatches, and reduces them exactly once a step: an averaging
all-reduce of every leaf, or :func:`compressed_psum_tree` under the key
``fold_in(prng_key(seed), step)`` with the step read before the update.
The metrics are averaged over the ranks (one all-reduce of their
stack), AdamW updates the state in place, and ``grad_norm`` is the
reduced gradients' norm, their fp32 sums of squares added in leaf order
as the reference's ``jax.tree.reduce`` adds them (the same sums, added
as ``global_norm`` adds them, give the update's clip).  The
uncompressed mean sums the leaves in buckets of up to ``BUCKET``
elements, one all-reduce a bucket rather than one a leaf; a larger leaf
is summed alone, in place.

Every rank ends a step with the same state.  A rank's tensors and the
group's backend must match: gloo for CPU tensors, NCCL for the card's
(one group can hold both, ``backend="cpu:gloo,cuda:nccl"``).  On one
rank the uncompressed step is :func:`~repro_torch.train.step.
make_train_step` bit for bit: its sums, its clip norm and its update.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.bridge import flatten, unflatten
from repro_torch.compat import divide_
from repro_torch.distributed.compression import compressed_psum_tree
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.optim.adamw import global_norm, leaf_sums
from repro_torch.serve import prng
from repro_torch.train.step import accumulate_grads, make_grad_fn

BUCKET = 1 << 26       # elements of the uncompressed mean's largest bucket


def _local_rows(batch: Dict[str, torch.Tensor], rank: int, world: int
                ) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s contiguous rows of each field of the global
    batch."""
    out = {}
    for name, x in batch.items():
        b = x.shape[0]
        if b % world:
            raise ValueError(f"batch {b} % world {world} != 0")
        n = b // world
        out[name] = x[rank * n:(rank + 1) * n]
    return out


def reduce_gradients(grads: Dict[str, torch.Tensor],
                     group: Optional[dist.ProcessGroup], world: int,
                     key: Optional[torch.Tensor] = None
                     ) -> Dict[str, torch.Tensor]:
    """The step's one reduction of the flat fp32 gradients ``grads``
    (``bridge.flatten``'s keys and order) over ``group``: with ``key``
    None, each leaf's mean in place (a sum over the ranks, then ``/
    world`` as ``jax.lax.pmean`` divides under ``jit``,
    :func:`~repro_torch.compat.divide_`; the leaves under ``BUCKET``
    elements summed together, one all-reduce a bucket); with a key,
    :func:`compressed_psum_tree` under it.  Returns the flat reduced
    gradients in the same order."""
    with torch.no_grad():
        if key is not None:
            return flatten(compressed_psum_tree(unflatten(grads), key,
                                                group, world))
        for bucket in _buckets(list(grads.values())):
            flat = (bucket[0] if len(bucket) == 1 else
                    torch.cat([g.reshape(-1) for g in bucket]))
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
            divide_(flat, world)
            if len(bucket) > 1:
                for g, part in zip(bucket, flat.split(
                        [g.numel() for g in bucket])):
                    g.copy_(part.view_as(g))
        return grads


def reduce_metrics(metrics: Dict[str, torch.Tensor],
                   group: Optional[dist.ProcessGroup], world: int
                   ) -> Dict[str, torch.Tensor]:
    """The 0-d fp32 ``metrics`` averaged over ``group``: one all-reduce
    of their stack, then ``/ world`` as ``jax.lax.pmean`` divides under
    ``jit``."""
    names = sorted(metrics)
    stacked = torch.stack([metrics[k] for k in names])
    dist.all_reduce(stacked, op=dist.ReduceOp.SUM, group=group)
    divide_(stacked, world)
    return {k: stacked[i] for i, k in enumerate(names)}


def _buckets(leaves):
    """``leaves`` in order, grouped into runs of at most ``BUCKET``
    elements; a leaf of ``BUCKET`` or more alone."""
    out, size = [], 0
    for g in leaves:
        if not out or size + g.numel() > BUCKET:
            out.append([])
            size = 0
        out[-1].append(g)
        size += g.numel()
    return out


def make_local_dp_train_step(model: Model, opt_cfg: AdamWConfig,
                             group: Optional[dist.ProcessGroup] = None,
                             accum_steps: int = 1, compress: bool = False,
                             seed: int = 0) -> Callable:
    """``train_step(state, batch) -> (state, metrics)`` over ``group``
    (``None``: the default process group), the state updated in place;
    ``batch`` is the global batch, the same on every rank.  metrics
    (0-d fp32 tensors): those of the loss averaged over microbatches and
    ranks, and ``grad_norm``."""
    grad_fn = make_grad_fn(model)

    def train_step(state: dict, batch: Dict[str, torch.Tensor]):
        world = dist.get_world_size(group)
        rank = dist.get_rank(group)
        params = state["params"]
        metrics, grads = accumulate_grads(
            grad_fn, params, _local_rows(batch, rank, world), accum_steps,
            torch.float32)
        with torch.no_grad():
            grads = {k: g.to(torch.float32) for k, g in grads.items()}
            key = None
            if compress:
                step = state["opt"]["step"]
                key = prng.fold_in(prng.prng_key(seed, step.device), step)
            # THE deferred reduction: exactly once a step
            grads = reduce_gradients(grads, group, world, key)
            metrics = reduce_metrics(metrics, group, world)
            sums = leaf_sums(grads)
            gnorm = global_norm(grads, sums)
            metrics["grad_norm"] = torch.sqrt(functools.reduce(
                torch.add, [sums[k] for k in grads]))
        adamw_update(opt_cfg, params, unflatten(grads), state["opt"],
                     gnorm=gnorm)
        return state, metrics

    return train_step
