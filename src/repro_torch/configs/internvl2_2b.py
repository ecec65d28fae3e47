"""internvl2-2b — InternViT + InternLM2 VLM [arXiv:2404.16821].

24 layers, d_model 2048, 16 q-heads over 8 KV heads of head_dim 128,
d_ff 8192, SwiGLU MLP, vocab 92553.  The vision frontend is a stub:
requests carry precomputed patch embeddings (n_patches, d_model), which
are put in front of the token embeddings (early fusion into the
trunk).  Same values as ``repro.configs.internvl2_2b``."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    mlp_variant="swiglu",
    frontend="vision",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
