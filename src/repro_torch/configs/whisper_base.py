"""whisper-base: enc-dec, 6+6L d=512 8H MHA d_ff=2048 vocab=51865.

[arXiv:2212.04356].  Conv audio frontend is a STUB: ``input_specs`` provides
precomputed frame embeddings [B, T, d].  Sinusoidal encoder positions,
learned decoder positions, LayerNorm, plain GELU MLP, no RoPE.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    num_layers=6,            # decoder layers
    encoder_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    gated_mlp=False,
    act="gelu",
    norm="layernorm",
    use_rope=False,
    decoder_max_len=448,
    frontend="frames",
    tie_embeddings=True,
)
