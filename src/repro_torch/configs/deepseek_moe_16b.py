"""deepseek-moe-16b: 28L d=2048 16H MHA, 64 routed top-6 + 2 shared experts,
expert d_ff=1408, first layer dense d_ff=10944, vocab=102400.

[arXiv:2401.06066; hf].
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102_400,
    gated_mlp=True,
    act="silu",
    num_experts=64,
    experts_per_token=6,
    num_shared_experts=2,
    moe_d_ff=1408,
    first_dense_layers=1,
    first_dense_d_ff=10944,
    rope_theta=10_000.0,
)
