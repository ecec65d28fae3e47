"""Mixture-of-Experts FFN with capacity dispatch (counterpart of
``repro.models.moe``).

The function is the reference's, drops included:

* tokens route within subgroups of ``t_g = min(subgroup, s)``
  consecutive positions of one row (``g = b * s / t_g`` groups);
* routing is fp32: ``softmax(x.float() @ router)``, the top ``k`` gates
  in descending order with the lower expert first on a tie (as
  ``jax.lax.top_k``; a stable sort gives that order), renormalised to
  sum to 1;
* a (token, choice) pair's place in its expert counts the earlier pairs
  of the group that chose the same expert, in the flat token-major,
  choice-minor order; it is kept only below the capacity
  ``c = ceil(t_g k cf / e)``, and a dropped pair falls through the
  residual (gate 0);
* the gate is cast to the compute dtype before the combine, which
  accumulates the ``k`` weighted expert outputs in fp32 and rounds once,
  as the reference's combine product does;
* a shared expert (``moe_shared_expert``) is a plain MLP added to the
  routed output.

Where the reference builds one-hot dispatch and combine tensors and
contracts them with einsums, the port moves rows by index: the kept
(token, expert) rows are copied into an ``(e, g * c, d)`` buffer (every
(expert, place) takes at most one row; dropped pairs land on one spare
row past the end, which no product reads), each expert runs its MLP over
its ``g * c`` rows as one ``torch.bmm``, and each token gathers its
``k`` outputs back.  Places no token took are zero rows, and stay zero
through every ``mlp_variant`` (no biases).  The values are those of the
one-hot products; the one-hot tensors, of size ``g t_g e c``, are never
made.  No step reads a value on the host, so the decode step stays free
of synchronisation on the card.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import apply_mlp, dense_init, init_mlp

MOE_SUBGROUP = 512


def _stacked_init(shape, dtype, generator, device, fan_in: int
                  ) -> torch.Tensor:
    """``dense_init`` of a stack of matrices, drawn one matrix at a time
    so the fp32 draw never holds more than one (d, f) matrix (a full
    kimi-k2 expert stack is 11 GiB in bf16)."""
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1, *shape[-2:])
    for i in range(flat.shape[0]):
        flat[i].copy_(dense_init(shape[-2:], dtype, generator, device,
                                 fan_in=fan_in))
    return out


def init_moe(cfg: ArchConfig, dtype, generator: torch.Generator, device,
             lead=()) -> dict:
    """Router (d, e) in fp32 whatever ``dtype`` is, expert weights (e, d,
    f) / (e, f, d) at ``dtype``, and the shared expert's MLP; ``lead``
    prepends stacking axes (the period axis)."""
    d, f, e = cfg.d_model, cfg.expert_d_ff, cfg.moe_num_experts
    p = {"router": dense_init((*lead, d, e), torch.float32, generator,
                              device, fan_in=d),
         "w1": _stacked_init((*lead, e, d, f), dtype, generator, device, d),
         "w2": _stacked_init((*lead, e, f, d), dtype, generator, device, f)}
    if cfg.mlp_variant in ("swiglu", "geglu"):
        p["w3"] = _stacked_init((*lead, e, d, f), dtype, generator, device,
                                d)
    if cfg.moe_shared_expert:
        p["shared"] = init_mlp(d, f, cfg.mlp_variant, dtype, generator,
                               device, lead)
    return p


def _capacity(t_g: int, e: int, k: int, cf: float) -> int:
    return max(1, int(math.ceil(t_g * k * cf / e)))


def _bmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.bmm(x.to(dt), w.to(dt))


def _expert_ffn(p: dict, x: torch.Tensor, variant: str) -> torch.Tensor:
    """x (e, rows, d) through per-expert MLP weights (e, d, f)."""
    h = _bmm(x, p["w1"])
    if variant == "swiglu":
        h = F.silu(h) * _bmm(x, p["w3"])
    elif variant == "geglu":
        h = F.gelu(h, approximate="tanh") * _bmm(x, p["w3"])
    elif variant == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(f"unknown mlp variant {variant!r}")
    return _bmm(h, p["w2"])


def route(p: dict, xg: torch.Tensor, k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                     torch.Tensor]:
    """(router logits (g, t, e) fp32, probs, renormalised top-k gates
    (g, t, k) fp32, their experts (g, t, k) int64) of xg (g, t, d)."""
    logits = torch.matmul(xg.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[..., :k], idx[..., :k]
    return logits, probs, gate / gate.sum(dim=-1, keepdim=True), idx


def apply_moe(p: dict, x: torch.Tensor, cfg: ArchConfig,
              subgroup: int = MOE_SUBGROUP) -> Tuple[torch.Tensor, dict]:
    """MoE FFN.  x: (b, s, d) -> (y (b, s, d) at x's dtype, aux) with aux
    = {moe_lb_loss, moe_z_loss, moe_dropped} (0-d fp32)."""
    b, s, d = x.shape
    e, k, cf = cfg.moe_num_experts, cfg.moe_top_k, cfg.moe_capacity_factor
    t_g = min(subgroup, s)
    if s % t_g:
        raise ValueError(f"seq {s} not divisible by subgroup {t_g}")
    g = b * (s // t_g)
    xg = x.reshape(g, t_g, d)
    logits, probs, gate, idx = route(p, xg, k)

    # place of each (token, choice) in its expert: a cumsum over the
    # flat (t * k) priority order of the group
    c = _capacity(t_g, e, k, cf)
    experts = torch.arange(e, device=x.device)
    onehot = (idx.reshape(g, t_g * k, 1) == experts).to(torch.int32)
    place = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    place = place.gather(-1, idx.reshape(g, t_g * k, 1)).reshape(g, t_g, k)
    keep = place < c
    gate = gate * keep.to(gate.dtype)

    # dispatch: kept rows into (e, g, c) places, dropped ones onto the
    # spare row e * g * c
    grp = torch.arange(g, device=x.device).view(g, 1, 1)
    slot = (idx * g + grp) * c + place
    slot = torch.where(keep, slot, e * g * c).reshape(-1)
    buf = x.new_zeros((e * g * c + 1, d))
    tok = torch.arange(g * t_g * k, device=x.device) // k
    buf.index_copy_(0, slot, xg.reshape(g * t_g, d)[tok])
    out = _expert_ffn(p, buf[:-1].view(e, g * c, d), cfg.mlp_variant)

    # combine: each token's k outputs, weighted by the gates at x's
    # dtype, summed in fp32
    got = out.reshape(e * g * c, d)[slot.clamp(max=e * g * c - 1)]
    got = torch.where(keep.reshape(-1, 1), got, got.new_zeros(()))
    w = gate.to(x.dtype).float().reshape(-1, 1)
    y = (got.float() * w).view(g, t_g, k, d).sum(dim=2).to(out.dtype)
    if "shared" in p:
        y = y + apply_mlp(p["shared"], xg, cfg.mlp_variant)

    # aux losses: Switch load balance (eq. 4) and the router z-loss
    density = (idx[..., :1] == experts).float().mean(dim=1)       # (g, e)
    lb_loss = e * (density * probs.mean(dim=1)).sum(dim=-1).mean()
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()
    dropped = 1.0 - keep.float().mean()
    aux = {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss,
           "moe_dropped": dropped}
    return y.reshape(b, s, d), aux
