"""Train step (counterpart of ``repro.train.step``).

``make_train_step(model, opt_cfg, accum_steps)`` returns
``train_step(state, batch) -> (state, metrics)``:

* fp32 cross-entropy over the text positions, shifted by one, computed
  a sequence chunk at a time (:func:`chunked_cross_entropy`), plus the
  router aux losses of a MoE model;
* gradients by ``torch.autograd`` through ``Model.features`` (its
  attention through ``flash_attention``'s backward kernel on the card,
  each block rematerialised under ``cfg.remat``);
* gradient accumulation over ``accum_steps`` microbatches, the sums
  kept at ``accum_dtype`` (a Python loop where the reference scans);
* the global-norm clip and AdamW, in place (``repro_torch.optim``).

The unembedding product and the CE are plain large products and
reductions outside any kernel in the reference too, so they stay torch
ops here.  ``state`` is ``{"params", "opt"}``; the parameters are leaf
tensors that require grad, updated in place (see ``optim.adamw``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.bridge import flatten, unflatten
from repro_torch.compat import divide_
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.adamw import global_norm

MOE_LB_WEIGHT = 0.01
MOE_Z_WEIGHT = 0.001


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean token CE (fp32) and accuracy.  logits (b, s, v), targets
    (b, s)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    nll = logz - gold
    acc = (logits.argmax(dim=-1) == targets).float()
    if mask is None:
        return nll.mean(), acc.mean()
    denom = torch.clamp(mask.sum(), min=1.0)
    return (nll * mask).sum() / denom, (acc * mask).sum() / denom


def _ce_chunk(x: torch.Tensor, w: torch.Tensor, t: torch.Tensor,
              m: torch.Tensor, softcap: Optional[float]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of masked nll, sum of masked hits) of one chunk: fp32
    logits (b, chunk, v) that live only inside this call."""
    logits = torch.matmul(x.float(), w.float())
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, t.long()[..., None])[..., 0]
    hit = (logits.argmax(dim=-1) == t).float()
    return ((logz - gold) * m).sum(), (hit * m).sum()


def chunked_cross_entropy(features: torch.Tensor, w_out: torch.Tensor,
                          targets: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          softcap: Optional[float] = None,
                          chunk: int = 2048
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CE without materializing (b, s, vocab) logits: sequence chunks of
    ``chunk``, each chunk's fp32 logits made inside a rematerialised
    call (recomputed in the backward, never saved), so peak memory is
    O(b * chunk * vocab).  features (b, s, d), targets (b, s); returns
    (mean nll, accuracy) over the masked positions."""
    b, s, _ = features.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32,
                          device=features.device)
    pad = (-s) % chunk
    if pad:
        features = F.pad(features, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    nll = acc = torch.zeros((), dtype=torch.float32, device=features.device)
    for c0 in range(0, s + pad, chunk):
        sl = slice(c0, c0 + chunk)
        args = (features[:, sl], w_out, targets[:, sl], mask[:, sl], softcap)
        if torch.is_grad_enabled():
            n_i, a_i = torch.utils.checkpoint.checkpoint(
                _ce_chunk, *args, use_reentrant=False)
        else:
            n_i, a_i = _ce_chunk(*args)
        nll, acc = nll + n_i, acc + a_i
    toks = torch.clamp(mask.sum(), min=1.0)
    return nll / toks, acc / toks


def make_loss_fn(model: Model, ce_chunk: int = 2048) -> Callable:
    """``loss_fn(params, batch) -> (loss, metrics)``: CE on the text
    positions (a VLM's trunk carries a patch prefix), shifted by one,
    under ``batch["loss_mask"]`` when given, plus the MoE aux losses at
    ``MOE_LB_WEIGHT`` / ``MOE_Z_WEIGHT``; metrics loss, ce, acc and the
    aux values (0-d fp32)."""
    cfg = model.cfg

    def loss_fn(params: dict, batch: Dict[str, torch.Tensor]):
        features, aux = model.features(params, batch)
        tokens = batch["tokens"]
        features = features[:, -tokens.shape[1]:]      # text positions only
        mask = batch.get("loss_mask")
        mask = mask[:, 1:] if mask is not None else None
        ce, acc = chunked_cross_entropy(
            features[:, :-1], model.unembed_weight(params), tokens[:, 1:],
            mask, softcap=cfg.final_logit_softcap,
            chunk=min(ce_chunk, max(tokens.shape[1] - 1, 1)))
        loss = (ce + MOE_LB_WEIGHT * aux["moe_lb_loss"]
                + MOE_Z_WEIGHT * aux["moe_z_loss"])
        metrics = {"loss": loss, "ce": ce, "acc": acc, **aux}
        return loss, metrics
    return loss_fn


def train_state_init(model: Model, opt_cfg: AdamWConfig,
                     generator: torch.Generator, device) -> dict:
    """{"params": the model's seeded init on ``device`` (leaves that
    require grad), "opt": ``adamw_init``}."""
    params = model.init(generator, device)
    for p in flatten(params).values():
        p.requires_grad_(True)
    return {"params": params, "opt": adamw_init(opt_cfg, params)}


def _microbatch(batch: Dict[str, torch.Tensor], accum: int, i: int
                ) -> Dict[str, torch.Tensor]:
    """Microbatch ``i`` of ``accum``: rows [i * b / accum, (i + 1) * b /
    accum) of each field (the reference's microbatch-major reshape)."""
    out = {}
    for name, x in batch.items():
        b = x.shape[0]
        if b % accum:
            raise ValueError(f"batch {b} % accum {accum} != 0")
        out[name] = x.reshape(accum, b // accum, *x.shape[1:])[i]
    return out


def make_grad_fn(model: Model) -> Callable:
    """``grad_fn(params, batch) -> (metrics, grads)``: the metrics of
    :func:`make_loss_fn` (detached) and the gradient of every leaf of
    ``bridge.flatten(params)``, keyed and ordered as that flat dict (a
    leaf the loss does not reach gets zeros)."""
    loss_fn = make_loss_fn(model)

    def grad_fn(params: dict, batch: Dict[str, torch.Tensor]):
        flat = flatten(params)
        for p in flat.values():
            p.requires_grad_(True)
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, list(flat.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(flat.items(), grads)}
        return {k: v.detach() for k, v in metrics.items()}, grads
    return grad_fn


def accumulate_grads(grad_fn: Callable, params: dict,
                     batch: Dict[str, torch.Tensor], accum_steps: int,
                     accum_dtype: torch.dtype):
    """(metrics, grads) of ``grad_fn`` averaged over ``accum_steps``
    microbatches of ``batch`` (:func:`_microbatch`), the gradient sums
    kept at ``accum_dtype`` and divided as the jitted reference divides
    (:func:`~repro_torch.compat.divide_`); at ``accum_steps`` 1 the
    gradients keep the params' dtype."""
    if accum_steps == 1:
        return grad_fn(params, batch)
    g_sum, m_sum = None, None
    for i in range(accum_steps):
        m, g = grad_fn(params, _microbatch(batch, accum_steps, i))
        if g_sum is None:
            g_sum = {k: torch.zeros(t.shape, dtype=accum_dtype,
                                    device=t.device)
                     for k, t in g.items()}
            m_sum = {k: torch.zeros((), dtype=torch.float32,
                                    device=t.device)
                     for k, t in m.items()}
        for k, t in g.items():
            g_sum[k].add_(t.to(accum_dtype))
        del g
        m_sum = {k: m_sum[k] + m[k] for k in m_sum}
    grads = {k: divide_(t, accum_steps) for k, t in g_sum.items()}
    return {k: divide_(t, accum_steps) for k, t in m_sum.items()}, grads


def make_train_step(model: Model, opt_cfg: AdamWConfig,
                    accum_steps: int = 1,
                    accum_dtype: str = "float32") -> Callable:
    """``train_step(state, batch) -> (state, metrics)``, the state
    updated in place.  metrics (0-d fp32 tensors, detached): those of
    :func:`make_loss_fn` averaged over the microbatches, and
    ``grad_norm`` of the averaged, unclipped gradients: ``global_norm``,
    computed once and handed to the update's clip (the reference sums
    the same fp32 leaf sums of squares twice, in two orders)."""
    grad_fn = make_grad_fn(model)
    acc_dt = getattr(torch, accum_dtype)

    def train_step(state: dict, batch: Dict[str, torch.Tensor]):
        params = state["params"]
        metrics, grads = accumulate_grads(grad_fn, params, batch,
                                          accum_steps, acc_dt)
        with torch.no_grad():
            gnorm = global_norm(grads)
        metrics["grad_norm"] = gnorm
        adamw_update(opt_cfg, params, unflatten(grads), state["opt"],
                     gnorm=gnorm)
        return state, metrics

    return train_step
