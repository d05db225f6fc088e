"""Qwen3-1.7B [hf:Qwen/Qwen3-8B family; hf-verified]: qk_norm, GQA."""
from repro_torch.configs.base import ATTN, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-1.7b", family="dense",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=8, head_dim=128,
    d_ff=6144, vocab_size=151936,
    qk_norm=True, rope_theta=1e6, tie_embeddings=True,
    layer_pattern=(ATTN,),
))
