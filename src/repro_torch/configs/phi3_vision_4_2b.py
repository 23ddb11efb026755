"""phi-3-vision-4.2b: phi3-mini backbone (32L d=3072 32H MHA d_ff=8192
vocab=32064) + CLIP patch frontend as a STUB (precomputed patch embeddings
prepended to the text sequence).

[hf:microsoft/Phi-3-vision-128k-instruct].
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    gated_mlp=True,
    act="silu",
    rope_theta=10_000.0,
    frontend="patch",
    frontend_len=256,   # stub: 256 patch embeddings per image
)
