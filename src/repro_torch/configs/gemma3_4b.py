"""Gemma3-4B [hf:google/gemma-3-1b-pt family; unverified-tier]: 5:1
local:global, qk-norm, 128k context, dual rope bases (10k local / 1M global)."""
from repro_torch.configs.base import ATTN, LOCAL, ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-4b", family="dense",
    num_layers=34, d_model=2560, num_heads=8, num_kv_heads=4, head_dim=256,
    d_ff=10240, vocab_size=262144,
    layer_pattern=(LOCAL, LOCAL, LOCAL, LOCAL, LOCAL, ATTN),
    sliding_window=1024, qk_norm=True,
    query_scale=256.0 ** -0.5, rope_theta=1e6,
    post_sublayer_norm=True, act="gelu", tie_embeddings=True,
))
