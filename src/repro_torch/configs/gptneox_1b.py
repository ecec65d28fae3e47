"""gptneox-1b — GPT-NeoX-family config for the paper's §VII.B case study
(GPT-NeoX inference on an H100): 16 layers, d_model 2048, 16 heads MHA,
head_dim 128, d_ff 8192, gelu MLP, vocab 50432, bf16.  Same values as
``repro.configs.gptneox_1b``."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gptneox-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50432,
    mlp_variant="gelu",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
