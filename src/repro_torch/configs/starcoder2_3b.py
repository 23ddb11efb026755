"""starcoder2-3b: 30L d=3072 24H GQA(kv=2) d_ff=12288 vocab=49152.

[arXiv:2402.19173; hf].
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    gated_mlp=False,
    act="gelu",
    norm="layernorm",
    rope_theta=100_000.0,
)
