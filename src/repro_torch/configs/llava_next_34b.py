"""LLaVA-NeXT-34B [hf:llava-hf/llava-v1.6 family; unverified-tier]:
Yi-34B-ish backbone; anyres vision frontend STUBBED as 576 patch embeddings
prefixed to the text sequence (input_specs provides them precomputed)."""
from repro_torch.configs.base import ATTN, ModelConfig, register

CONFIG = register(ModelConfig(
    name="llava-next-34b", family="vlm",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8, head_dim=128,
    d_ff=20480, vocab_size=64000,
    rope_theta=5e6, tie_embeddings=False, num_patches=576,
    layer_pattern=(ATTN,),
))
