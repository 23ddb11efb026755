"""moonshot-v1-16b-a3b (Moonlight-16B-A3B): 48L d=2048 16H MHA,
MoE 64 routed experts top-6 + 2 shared, expert d_ff=1408, vocab=163840.

[hf:moonshotai/Moonlight-16B-A3B].  DeepSeek-V3-style fine-grained MoE;
first layer dense (assumed dense d_ff = 8 * 1408 = 11264, per the
DeepSeek-family convention — noted in DESIGN.md).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163_840,
    gated_mlp=True,
    act="silu",
    num_experts=64,
    experts_per_token=6,
    num_shared_experts=2,
    moe_d_ff=1408,
    first_dense_layers=1,
    first_dense_d_ff=11264,
    rope_theta=50_000.0,
)
