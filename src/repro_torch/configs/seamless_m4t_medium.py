"""seamless-m4t-medium — encoder-decoder multimodal backbone
[arXiv:2308.11596].

12 encoder and 12 decoder layers, d_model 1024, 16 heads (MHA) of
head_dim 64, d_ff 4096, GELU MLP, vocab 256206.  The audio frontend is a
stub: requests carry precomputed frame embeddings (src_len, d_model);
every decoder block cross-attends the cached encoder output.  Same
values as ``repro.configs.seamless_m4t_medium``."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    mlp_variant="gelu",
    is_encoder_decoder=True,
    n_encoder_layers=12,
    frontend="audio",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
