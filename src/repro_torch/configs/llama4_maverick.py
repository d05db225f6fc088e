"""Llama4-Maverick 400B (17B active) [hf:meta-llama/Llama-4 family;
unverified-tier]: MoE 128e top-1 every other layer, early-fusion multimodal
(vision frontend STUBBED as 576 prefix patch embeddings)."""
from repro_torch.configs.base import ATTN, ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama4-maverick-400b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048,
    moe_period=2, moe_offset=1, num_experts=128, experts_per_tok=1,
    moe_d_ff=8192, rope_theta=5e5, tie_embeddings=False, num_patches=576,
    layer_pattern=(ATTN,),
))
