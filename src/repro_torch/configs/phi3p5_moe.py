"""Phi-3.5-MoE 42B (6.6B active) [hf:microsoft/Phi-3.5-MoE-instruct;
hf-verified]: 16 experts top-2 on every layer."""
from repro_torch.configs.base import ATTN, ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi3.5-moe-42b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=6400, vocab_size=32064,
    moe_period=1, moe_offset=0, num_experts=16, experts_per_tok=2,
    moe_d_ff=6400, rope_theta=1e4, tie_embeddings=False,
    layer_pattern=(ATTN,),
))
