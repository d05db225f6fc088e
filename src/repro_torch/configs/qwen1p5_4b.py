"""Qwen1.5-4B [hf:Qwen/Qwen1.5-0.5B family; hf-verified]: QKV bias, MHA."""
from repro_torch.configs.base import ATTN, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen1.5-4b", family="dense",
    num_layers=40, d_model=2560, num_heads=20, num_kv_heads=20, head_dim=128,
    d_ff=6912, vocab_size=151936,
    qkv_bias=True, rope_theta=5e6, tie_embeddings=False,
    layer_pattern=(ATTN,),
))
