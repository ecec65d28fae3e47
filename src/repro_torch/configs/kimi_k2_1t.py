"""kimi-k2-1t-a32b — trillion-parameter MoE (paper-table config).

61 layers, d_model 7168, 64 heads over 8 KV heads of 128 (q_dim 8192 >
d_model), vocab 163840, MoE of 384 experts top-8 with per-expert d_ff
2048 and one shared expert on every layer.  Same values as
``repro.configs.kimi_k2_1t``."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=2048,
    vocab_size=163840,
    mlp_variant="swiglu",
    moe_num_experts=384,
    moe_top_k=8,
    moe_every=1,
    moe_d_ff=2048,
    moe_shared_expert=True,
    rope_theta=50_000.0,
    fsdp=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
