"""qwen2-7b: 28L d=3584 28H GQA(kv=4) d_ff=18944 vocab=152064, QKV bias.

[arXiv:2407.10671; hf].  SwiGLU, RMSNorm, RoPE theta 1e6, QKV bias.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    gated_mlp=True,
    act="silu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
