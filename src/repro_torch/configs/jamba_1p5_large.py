"""Jamba-1.5-Large 398B [arXiv:2403.19887; hf-verified]: Mamba+attn 1:7
interleave (attn at offset 4 of each 8-layer block), MoE 16e top-2 on every
other layer.  SSD formulation used for the mamba mixers (DESIGN.md §2)."""
from repro_torch.configs.base import ATTN, MAMBA, ModelConfig, register

CONFIG = register(ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536,
    layer_pattern=(MAMBA, MAMBA, MAMBA, MAMBA, ATTN, MAMBA, MAMBA, MAMBA),
    use_rope=False,
    moe_period=2, moe_offset=1, num_experts=16, experts_per_tok=2,
    moe_d_ff=24576,
    ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    tie_embeddings=False,
))
