"""Gemma2-27B [arXiv:2408.00118; hf-verified]: local+global alternating,
logit softcaps, post-sublayer norms, query_pre_attn_scalar=144."""
from repro_torch.configs.base import ATTN, LOCAL, ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma2-27b", family="dense",
    num_layers=46, d_model=4608, num_heads=32, num_kv_heads=16, head_dim=128,
    d_ff=36864, vocab_size=256000,
    layer_pattern=(LOCAL, ATTN), sliding_window=4096,
    attn_logit_softcap=50.0, final_logit_softcap=30.0,
    query_scale=144.0 ** -0.5, rope_theta=1e4,
    post_sublayer_norm=True, act="gelu", tie_embeddings=True,
))
