"""AdamW with the reference's memory knobs (counterpart of
``repro.optim.adamw``): the global-norm clip, bias correction in fp32,
the first moment stored at ``m_dtype`` (update maths in fp32) and, with
``factored_v``, an Adafactor-style rank-1 second moment (row / column
means) for matrices of at least ``factored_min_dim`` on both of their
last two axes.

Unlike the reference, whose update is a pure function, :func:`adamw_update`
updates the parameter, ``m`` and ``v`` tensors **in place** and returns
the same objects: at qwen2.5-3b's full width a functional update builds
a second copy of the parameters and the optimizer state (about 31 GB)
on a card that holds 80.  The arithmetic is the reference's, leaf by
leaf; a leaf with a leading (period-stacked) axis is updated one slice
of that axis at a time, which changes no value (every step is
elementwise, or a mean over the last two axes) and bounds the fp32
temporaries to one slice.

Decay applies where ``p.ndim >= 2``, read on the period-stacked leaves
as the reference reads them: a stacked norm scale (n_periods, d) and a
stacked QKV bias are decayed, ``final_norm`` is not.  ``opt_state_specs``
waits for the mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.bridge import flatten


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine
    decay to ``min_ratio * peak_lr`` at ``decay_steps``; fp32."""
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_ratio: float = 0.1

    def __call__(self, step: Union[int, torch.Tensor]) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = self.peak_lr * step / max(self.warmup_steps, 1)
        progress = torch.clamp(
            (step - self.warmup_steps)
            / max(self.decay_steps - self.warmup_steps, 1), 0.0, 1.0)
        cos = self.peak_lr * (self.min_ratio + (1 - self.min_ratio) * 0.5
                              * (1 + torch.cos(math.pi * progress)))
        return torch.where(step < self.warmup_steps, warm, cos)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    schedule: Schedule = Schedule()
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    m_dtype: str = "float32"
    factored_v: bool = False
    factored_min_dim: int = 128    # factor only matrices at least this big


def _is_factored(cfg: AdamWConfig, shape: Tuple[int, ...]) -> bool:
    return (cfg.factored_v and len(shape) >= 2
            and shape[-1] >= cfg.factored_min_dim
            and shape[-2] >= cfg.factored_min_dim)


def _map(fn, tree: dict) -> dict:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def adamw_init(cfg: AdamWConfig, params: dict) -> dict:
    """{"m": zeros at ``m_dtype``, "v": fp32 zeros (a factored leaf is
    {"row", "col"}), "step": int32 0} beside each parameter, on its
    device."""
    m_dtype = getattr(torch, cfg.m_dtype)

    def init_v(p):
        if _is_factored(cfg, tuple(p.shape)):
            return {"row": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                       device=p.device),
                    "col": torch.zeros((*p.shape[:-2], p.shape[-1]),
                                       dtype=torch.float32, device=p.device)}
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = next(iter(flatten(params).values())).device
    return {"m": _map(lambda p: torch.zeros(p.shape, dtype=m_dtype,
                                            device=p.device), params),
            "v": _map(init_v, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def leaf_sums(tree: dict) -> Dict[str, torch.Tensor]:
    """Every leaf's sum of squares in fp32 (0-d), keyed and ordered as
    ``flatten(tree)``."""
    return {k: torch.sum(torch.square(g.float()))
            for k, g in flatten(tree).items()}


def global_norm(tree: dict,
                sums: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares (``sums``, the
    tree's :func:`leaf_sums` when the caller has them), in fp32, as the
    reference sums it.  (Not ``torch.linalg.vector_norm``: on the CPU
    it sums a 311M-element leaf in plain fp32 order, 0.3% off at
    qwen2.5-3b's embedding.)"""
    if sums is None:
        sums = leaf_sums(tree)
    return torch.sqrt(torch.sum(torch.stack(list(sums.values()))))


def _update_leaf(cfg: AdamWConfig, p, g, m, v, clip, lr, bc1, bc2,
                 decay: bool) -> None:
    """The reference's update of one leaf, in place, in its order of
    operations, with at most three fp32 temporaries of the leaf's size
    (``x.add_(y, alpha=a)`` for the reference's ``x + a * y``)."""
    g2 = g.to(torch.float32, copy=True).mul_(clip)
    m32 = m if m.dtype == torch.float32 else m.float()
    m32.mul_(cfg.b1).add_(g2, alpha=1 - cfg.b1)
    g2.square_()
    if isinstance(v, dict):
        v["row"].mul_(cfg.b2).add_(torch.mean(g2, dim=-1), alpha=1 - cfg.b2)
        v["col"].mul_(cfg.b2).add_(torch.mean(g2, dim=-2), alpha=1 - cfg.b2)
        del g2
        denom = torch.clamp(torch.mean(v["row"], dim=-1, keepdim=True),
                            min=1e-30)
        vhat = torch.mul(v["row"][..., None], v["col"][..., None, :]).div_(
            denom[..., None])
        denom = vhat.div_(bc2).sqrt_().add_(cfg.eps)
    else:
        v.mul_(cfg.b2).add_(g2, alpha=1 - cfg.b2)
        del g2
        denom = torch.div(v, bc2).sqrt_().add_(cfg.eps)
    update = torch.div(m32, bc1).div_(denom)
    del denom
    if decay:
        update.add_(p, alpha=cfg.weight_decay)
    update.mul_(lr)
    if p.dtype == torch.float32:
        p.sub_(update)
    else:
        p.copy_(p.float().sub_(update))
    if m32 is not m:
        m.copy_(m32)


def adamw_update(cfg: AdamWConfig, params: dict, grads: dict, state: dict,
                 gnorm: Optional[torch.Tensor] = None) -> Tuple[dict, dict]:
    """One AdamW step, **in place** on ``params``, ``state["m"]``,
    ``state["v"]`` and ``state["step"]``; returns (params, state), the
    same objects.  ``grads`` has the params' structure (any float
    dtype) and is not modified.  ``gnorm`` is ``global_norm(grads)``
    when the caller has it already (the train step reports it)."""
    with torch.no_grad():
        state["step"].add_(1)
        step = state["step"].to(torch.float32)
        lr = cfg.schedule(state["step"])
        if gnorm is None:
            gnorm = global_norm(grads)
        clip = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                           max=1.0)
        bc1 = 1.0 - torch.pow(cfg.b1, step)
        bc2 = 1.0 - torch.pow(cfg.b2, step)
        flat_g = flatten(grads)
        flat_m = flatten(state["m"])
        for key, p in flatten(params).items():
            g, m = flat_g[key], flat_m[key]
            v = state["v"]
            for part in key.split("/"):
                v = v[part]
            decay = bool(cfg.weight_decay) and p.ndim >= 2
            if p.ndim >= 3:             # period-stacked: a slice at a time
                for i in range(p.shape[0]):
                    vi = ({n: t[i] for n, t in v.items()}
                          if isinstance(v, dict) else v[i])
                    _update_leaf(cfg, p[i], g[i], m[i], vi, clip, lr, bc1,
                                 bc2, decay)
            else:
                _update_leaf(cfg, p, g, m, v, clip, lr, bc1, bc2, decay)
    return params, state
