"""llama4-maverick-400b-a17b — MoE with interleaved dense / MoE FFNs
[hf:meta-llama/Llama-4].

48 layers, d_model 5120, 40 heads over 8 KV heads of 128, d_ff 8192,
vocab 202048, MoE of 128 experts top-1 with a shared expert on every
second layer and a dense FFN on the others (the text backbone).  Same
values as ``repro.configs.llama4_maverick_400b``."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    mlp_variant="swiglu",
    moe_num_experts=128,
    moe_top_k=1,
    moe_every=2,
    moe_d_ff=8192,
    moe_shared_expert=True,
    rope_theta=500_000.0,
    fsdp=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
