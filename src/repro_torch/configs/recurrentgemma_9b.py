"""recurrentgemma-9b: 38L d=4096, RG-LRU + local attention 1:2, MQA(kv=1),
d_ff=12288, vocab=256000, window 2048.

[arXiv:2402.19427].  Pattern (rglru, rglru, local_attn): 12 full periods +
2-layer tail.  GeGLU MLP in every block; rnn width = d_model.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256_000,
    gated_mlp=True,
    act="gelu",
    pattern=("rglru", "rglru", "local_attn"),
    local_window=2048,
    rglru_width=4096,
    rope_theta=10_000.0,
    tie_embeddings=True,
)
