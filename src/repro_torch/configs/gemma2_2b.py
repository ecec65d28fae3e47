"""gemma2-2b — local/global alternating attention with logit softcaps
[arXiv:2408.00118].

26 layers, d_model 2304, 8 q-heads over 4 KV heads (GQA) of head_dim
256, d_ff 9216, GeGLU MLP, vocab 256000, tied embeddings.  Even layers
attend a sliding window of 4096 positions (their ring holds 4096 slots),
odd layers attend globally.  Attention logits are softcapped at 50, the
final logits at 30.  Same values as ``repro.configs.gemma2_2b``."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    mlp_variant="geglu",
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    sliding_window=4096,
    local_global_period=2,
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
