"""granite-34b-code: 88L d=6144 48H MQA(kv=1) d_ff=24576 vocab=49152.

[arXiv:2405.04324; hf].  GPT-BigCode-lineage code model: plain 4x GELU MLP,
MQA, RoPE, untied embeddings.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b",
    family="dense",
    num_layers=88,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    gated_mlp=False,
    act="gelu",
    rope_theta=10_000.0,
)
