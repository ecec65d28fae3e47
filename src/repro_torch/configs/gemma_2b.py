"""gemma-2b — MQA GeGLU transformer [arXiv:2403.08295].

18 layers, d_model 2048, 8 q-heads over one KV head (MQA) of head_dim
256, d_ff 16384, GeGLU MLP, vocab 256000, tied embeddings, full
attention on every layer.  Same values as ``repro.configs.gemma_2b``."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    mlp_variant="geglu",
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
