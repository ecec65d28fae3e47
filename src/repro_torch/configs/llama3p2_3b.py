"""llama3.2-3b — small llama3 dense GQA transformer [hf:meta-llama].

28 layers, d_model 3072, 24 q-heads over 8 KV heads of head_dim 128,
d_ff 8192, SwiGLU MLP, vocab 128256, rope theta 5e5, tied embeddings,
full attention on every layer.  Same values as
``repro.configs.llama3p2_3b``."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    mlp_variant="swiglu",
    rope_theta=500_000.0,
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
