"""Whisper-base [arXiv:2212.04356; unverified-tier]: enc-dec, conv/audio
frontend STUBBED (input_specs provides 1536 precomputed frame embeddings).
LayerNorm, GELU, non-gated MLP, learned positions, no RoPE."""
from repro_torch.configs.base import ATTN, ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-base", family="audio",
    num_layers=6, d_model=512, num_heads=8, num_kv_heads=8, head_dim=64,
    d_ff=2048, vocab_size=51865,
    is_encoder_decoder=True, num_encoder_layers=6, encoder_seq=1536,
    use_rope=False, learned_pos=True, max_pos=32768,
    norm="layernorm", act="gelu", mlp_gated=False, tie_embeddings=True,
    layer_pattern=(ATTN,),
))
