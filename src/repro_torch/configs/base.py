"""Architecture configuration: the port's own copy of ``repro.configs.base``.

An :class:`ArchConfig` describes one model; ``reduced()`` yields the
same-family small config the CPU tests run.  A model is ``n_layers``
blocks arranged as a repeating *period* (``block_pattern()``); parameters
are stacked per position-in-period, so a layer leaf has a leading
``n_periods`` axis — the same layout as the JAX package, which is what
makes the weight bridge a plain copy.

The fields are kept identical to the reference so configs of later
slices drop in unchanged; this slice's model code reads only the dense
attention-decoder subset and raises on the rest.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One block within a period (mixer + ffn)."""

    mixer: str                    # "attn" | "ssm" | "none"
    ffn: str                      # "dense" | "moe" | "none"
    window: Optional[int] = None  # sliding-window size for local attention
    cross_attn: bool = False      # decoder block with cross-attention


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # identity
    name: str
    family: str                   # dense | ssm | hybrid | moe | audio | vlm
    # trunk dimensions
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # MLP / norm
    mlp_variant: str = "swiglu"   # swiglu | geglu | gelu
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    qkv_bias: bool = False
    # attention flavor
    rope_theta: float = 10000.0
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    sliding_window: Optional[int] = None   # used by blocks with window
    local_global_period: int = 0  # gemma2: alternate local/global every layer
    # MoE
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_every: int = 1            # MoE FFN every k-th block (1 = all blocks)
    moe_d_ff: int = 0             # per-expert hidden dim (0 = use d_ff)
    moe_shared_expert: bool = False
    moe_capacity_factor: float = 1.25
    # hybrid (jamba): attention block every k-th block, SSM otherwise
    attn_every: int = 1           # 1 = all attention; 8 = jamba 1:7
    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # encoder-decoder
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    # modality frontend stub: input is precomputed frame/patch embeddings
    frontend: Optional[str] = None   # None | "audio" | "vision"
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    cache_dtype: str = ""         # KV-cache storage ("" = compute_dtype)
    kv_format: str = ""           # blockwise-quantized KV storage format
                                  # ("" = plain cast storage)
    kv_formats: Tuple[str, ...] = ()   # per-position-in-period override
                                  # of kv_format
    attn_chunk: int = 1024        # online-softmax KV block (training path)
    attn_repeat_kv: bool = False  # materialize KV at full q-head count
    attn_seq_shard: bool = False  # context-parallel attention
    # distribution hints
    fsdp: bool = False            # shard params over the data axis too
    remat: str = "block"          # "none" | "block" | "full"
    batch_axes: Tuple[str, ...] = ()

    # ------------------------------------------------------------------ #
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def kv_format_for(self, pos_in_period: int) -> Optional[str]:
        """Effective KV format for one position-in-period (None = plain).

        ``kv_formats`` (per-layer mixed precision) wins over the uniform
        ``kv_format``; empty strings in either mean unquantized storage.
        """
        if self.kv_formats:
            if len(self.kv_formats) != len(self.block_pattern()):
                raise ValueError(
                    f"{self.name}: kv_formats has {len(self.kv_formats)} "
                    f"entries but the block period is "
                    f"{len(self.block_pattern())}")
            fmt = self.kv_formats[pos_in_period] or self.kv_format
        else:
            fmt = self.kv_format
        return fmt or None

    def block_pattern(self) -> List[BlockSpec]:
        """One period of the layer stack (see module docstring)."""
        period = 1
        if self.attn_every > 1:
            period = max(period, self.attn_every)
        if self.moe_num_experts and self.moe_every > 1:
            period = max(period, self.moe_every)
        if self.local_global_period:
            period = max(period, self.local_global_period)
        blocks = []
        for i in range(period):
            if self.family == "ssm":
                mixer: str = "ssm"
            elif self.attn_every > 1:
                # hybrid: attention at position 0 of each period, SSM else
                mixer = "attn" if i % self.attn_every == 0 else "ssm"
            else:
                mixer = "attn"
            window = None
            if self.local_global_period and i % self.local_global_period == 0:
                window = self.sliding_window   # even positions local
            elif self.sliding_window and not self.local_global_period:
                window = self.sliding_window
            if self.family == "ssm":
                ffn = "none" if self.d_ff == 0 else "dense"
            elif self.moe_num_experts:
                ffn = "moe" if (i + 1) % self.moe_every == 0 else "dense"
            else:
                ffn = "dense"
            blocks.append(BlockSpec(mixer=mixer, ffn=ffn, window=window,
                                    cross_attn=self.is_encoder_decoder))
        return blocks

    @property
    def n_periods(self) -> int:
        period = len(self.block_pattern())
        if self.n_layers % period:
            raise ValueError(f"{self.name}: n_layers={self.n_layers} not "
                             f"divisible by period={period}")
        return self.n_layers // period

    # ------------------------------------------------------------------ #
    def param_count(self) -> int:
        """Total parameters (exact for the reference implementation)."""
        n = 0
        embed = self.vocab_size * self.d_model
        n += embed
        if not self.tie_embeddings:
            n += embed
        for blk in self.block_pattern():
            b = 0
            if blk.mixer == "attn":
                b += self.d_model * (self.q_dim + 2 * self.kv_dim)
                b += self.q_dim * self.d_model
                if self.qkv_bias:
                    b += self.q_dim + 2 * self.kv_dim
                b += 2 * self.d_model          # pre norms (attn)
                if blk.cross_attn:
                    b += self.d_model * (self.q_dim + 2 * self.kv_dim)
                    b += self.q_dim * self.d_model
                    b += self.d_model
            elif blk.mixer == "ssm":
                d_in = self.d_inner
                conv_dim = d_in + 2 * self.ssm_state
                b += self.d_model * (2 * d_in + 2 * self.ssm_state
                                     + self.ssm_heads)
                b += conv_dim * (self.ssm_conv + 1)   # conv weights + biases
                b += 3 * self.ssm_heads        # A_log, dt_bias, D
                b += d_in                      # gated norm
                b += d_in * self.d_model       # out proj
                b += self.d_model              # pre norm
            if blk.ffn == "dense":
                mult = 3 if self.mlp_variant in ("swiglu", "geglu") else 2
                b += mult * self.d_model * self.d_ff + self.d_model
            elif blk.ffn == "moe":
                mult = 3 if self.mlp_variant in ("swiglu", "geglu") else 2
                b += (self.moe_num_experts * mult * self.d_model
                      * self.expert_d_ff)
                b += self.d_model * self.moe_num_experts   # router
                if self.moe_shared_expert:
                    b += mult * self.d_model * self.expert_d_ff
                b += self.d_model
            n += b * self.n_periods
        if self.is_encoder_decoder:
            # encoder blocks: self-attn + dense ffn
            mult = 3 if self.mlp_variant in ("swiglu", "geglu") else 2
            b = (self.d_model * (self.q_dim + 2 * self.kv_dim)
                 + self.q_dim * self.d_model
                 + mult * self.d_model * self.d_ff + 2 * self.d_model)
            n += b * self.n_encoder_layers
        n += self.d_model                      # final norm
        return n

    # ------------------------------------------------------------------ #
    def reduced(self) -> "ArchConfig":
        """Same-family tiny config for CPU tests."""
        period = len(self.block_pattern())
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=period * (2 if period <= 2 else 1),
            n_encoder_layers=2 if self.is_encoder_decoder else 0,
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            head_dim=16,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab_size=512,
            moe_num_experts=min(self.moe_num_experts, 4),
            moe_top_k=min(self.moe_top_k, 2),
            moe_d_ff=64 if self.moe_d_ff else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=32,
            sliding_window=32 if self.sliding_window else None,
            fsdp=False,
            param_dtype="float32",
            compute_dtype="float32",
        )
