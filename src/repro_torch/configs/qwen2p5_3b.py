"""qwen2.5-3b — dense GQA transformer with q/k/v projection biases
[hf:Qwen/Qwen2.5].

36 layers, d_model 2048, 16 q-heads over 2 KV heads of head_dim 128,
d_ff 11008, SwiGLU MLP, vocab 151936, rope theta 1e6, tied embeddings,
full attention on every layer.  Same values as
``repro.configs.qwen2p5_3b``."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab_size=151936,
    mlp_variant="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
