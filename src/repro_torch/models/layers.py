"""Primitive layers: norms, embeddings, RoPE, MLP variants, the causal
depthwise conv, initializers (counterpart of ``repro.models.layers``).

Plain functions on tensors; parameters are nested dicts of tensors.
Parameters are stored at ``param_dtype``, activations flow at
``compute_dtype``, and norm statistics and final logits are computed in
float32 regardless, as in the reference.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


# --------------------------------------------------------------------- #
# Initialization
# --------------------------------------------------------------------- #

def dense_init(shape, dtype: torch.dtype, generator: torch.Generator,
               device, fan_in: Optional[int] = None) -> torch.Tensor:
    """Truncated normal at ±2σ, σ = 1/sqrt(fan_in); fan_in defaults to
    ``shape[-2]`` (the contraction dim of an ``x @ w`` product).  Drawn
    in float32 from ``generator`` and cast, as the reference does."""
    if fan_in is None:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, a=-2.0, b=2.0, generator=generator)
    return (w * (1.0 / math.sqrt(max(fan_in, 1)))).to(dtype)


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` under JAX's type promotion (bf16 x f32 -> f32), which
    torch's matmul does not apply by itself."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


# --------------------------------------------------------------------- #
# Norms
# --------------------------------------------------------------------- #

def rms_norm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm; statistics in fp32."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * w.float()).to(x.dtype)


# --------------------------------------------------------------------- #
# Embedding / unembedding
# --------------------------------------------------------------------- #

def embed(w: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup."""
    return w[tokens]


def unembed(w: torch.Tensor, x: torch.Tensor,
            cap: Optional[float] = None) -> torch.Tensor:
    """Project to vocab logits in fp32, with optional final softcap."""
    return softcap(torch.matmul(x.float(), w.float()), cap)


# --------------------------------------------------------------------- #
# Rotary position embedding
# --------------------------------------------------------------------- #

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), fp32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Rotate ``x`` (..., seq, heads, head_dim) by ``positions`` (..., seq).

    Split-half convention: pairs are (x[:d/2], x[d/2:]).  Computed in
    fp32, returned at x.dtype."""
    inv_freq = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].float() * inv_freq   # (..., s, d/2)
    cos = torch.cos(angles)[..., None, :]              # broadcast heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- #
# MLP variants
# --------------------------------------------------------------------- #

def init_mlp(d_model: int, d_ff: int, variant: str, dtype,
             generator: torch.Generator, device, lead=()) -> dict:
    """MLP params; ``lead`` prepends stacking axes (the period axis)."""
    p = {"w1": dense_init((*lead, d_model, d_ff), dtype, generator, device),
         "w2": dense_init((*lead, d_ff, d_model), dtype, generator, device)}
    if variant in ("swiglu", "geglu"):
        p["w3"] = dense_init((*lead, d_model, d_ff), dtype, generator,
                             device)
    return p


def apply_mlp(p: dict, x: torch.Tensor, variant: str) -> torch.Tensor:
    h = mm(x, p["w1"])
    if variant == "swiglu":
        h = F.silu(h) * mm(x, p["w3"])
    elif variant == "geglu":
        h = F.gelu(h, approximate="tanh") * mm(x, p["w3"])
    elif variant == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(f"unknown mlp variant {variant!r}")
    return mm(h, p["w2"])


# --------------------------------------------------------------------- #
# Misc
# --------------------------------------------------------------------- #

def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """``tanh(x / cap) * cap``; identity when ``cap`` is None."""
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                  ) -> torch.Tensor:
    """Depthwise causal conv over x (batch, seq, channels) with kernel w
    (channels, K) and a zero left-pad of K - 1, plus bias b (channels,).
    The result is contiguous in (batch, seq, channels), the layout the
    SSD kernel reads.

    A float32 conv on the card goes through cuDNN, in TF32 unless
    ``torch.backends.cudnn.allow_tf32`` is False."""
    k = w.shape[-1]
    dt = torch.promote_types(x.dtype, w.dtype)
    xc = F.pad(x.to(dt).transpose(1, 2), (k - 1, 0))    # (b, C, K-1+s)
    out = F.conv1d(xc, w.to(dt)[:, None, :], groups=x.shape[-1])
    return out.transpose(1, 2).contiguous() + b
