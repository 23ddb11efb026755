"""mamba2-130m: 24L d=768, attention-free SSD, state=128, vocab=50280.

[arXiv:2405.21060].  d_inner = 2*768 = 1536, headdim 64 -> 24 ssm heads,
1 B/C group, conv4, chunked SSD scan.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=1,            # unused (attention-free)
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    pattern=("ssm",),
    ssm_state=128,
    ssm_headdim=64,
    ssm_chunk=256,
    ssm_expand=2,
    ssm_conv=4,
    ssm_groups=1,
    tie_embeddings=True,
)
