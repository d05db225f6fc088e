"""Mamba2-2.7B [arXiv:2405.21060; unverified-tier]: attn-free SSD stack.
d_inner=5120, 80 SSD heads of dim 64, state 128, no FFN sublayer."""
from repro_torch.configs.base import MAMBA, ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-2.7b", family="ssm",
    num_layers=64, d_model=2560, num_heads=1, num_kv_heads=1, head_dim=1,
    d_ff=0, vocab_size=50280,
    layer_pattern=(MAMBA,), use_rope=False,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    tie_embeddings=True,
))
