"""jamba-v0.1-52b — hybrid Mamba + attention, 7:1 interleave, with MoE
[arXiv:2403.19887].

32 layers, d_model 4096, 32 heads over 8 KV heads of 128, d_ff 14336,
vocab 65536, MoE of 16 experts top-2 on every second block.  A period
of 8 blocks: attention at position 0, SSM at 1..7, so the blocks run
attn+dense, ssm+moe, ssm+dense, ..., ssm+moe.  The mixer is the Mamba-2
SSD block at d_state 16 (Jamba v0.1 has Mamba-1 at the same state
size).  Same values as ``repro.configs.jamba_v0p1_52b``."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    mlp_variant="swiglu",
    moe_num_experts=16,
    moe_top_k=2,
    moe_every=2,
    attn_every=8,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=256,
    fsdp=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
