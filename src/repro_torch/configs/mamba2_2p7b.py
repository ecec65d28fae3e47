"""mamba2-2.7b — SSD (state-space duality) LM [arXiv:2405.21060].

64 layers, d_model 2560, attention-free, d_ff 0 (the Mamba-2 block
replaces both mixer and MLP), vocab 50280, ssm_state 128; d_inner =
2 * 2560 = 5120 and head_dim 64 give 80 SSD heads.  Same values as
``repro.configs.mamba2_2p7b``."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=256,
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
