"""Registry of the 10 assigned architectures (+ the paper's own config).

Each entry matches the public source cited in the brief; ``smoke_config``
derives a reduced same-family config for CPU smoke tests (small layers/width,
few experts, tiny vocab).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.granite_34b import CONFIG as granite_34b
from repro_torch.configs.starcoder2_7b import CONFIG as starcoder2_7b
from repro_torch.configs.qwen2_7b import CONFIG as qwen2_7b
from repro_torch.configs.starcoder2_3b import CONFIG as starcoder2_3b
from repro_torch.configs.phi3_vision_4_2b import CONFIG as phi3_vision_4_2b
from repro_torch.configs.whisper_base import CONFIG as whisper_base
from repro_torch.configs.mamba2_130m import CONFIG as mamba2_130m
from repro_torch.configs.recurrentgemma_9b import CONFIG as recurrentgemma_9b
from repro_torch.configs.moonshot_v1_16b_a3b import CONFIG as moonshot_v1_16b_a3b
from repro_torch.configs.deepseek_moe_16b import CONFIG as deepseek_moe_16b
from repro_torch.configs.base import ModelConfig

ARCHS: Dict[str, ModelConfig] = {
    c.name: c
    for c in [
        granite_34b, starcoder2_7b, qwen2_7b, starcoder2_3b,
        phi3_vision_4_2b, whisper_base, mamba2_130m, recurrentgemma_9b,
        moonshot_v1_16b_a3b, deepseek_moe_16b,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: 2 pattern periods (+tail/pre), tiny dims."""
    cfg = get_config(name)
    period = len(cfg.pattern)
    layers = cfg.first_dense_layers + 2 * period + len(cfg.tail_kinds())
    changes = dict(
        num_layers=layers,
        d_model=128,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads
        < cfg.num_heads else 4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        remat="none",
        scan_layers=True,
        local_window=min(cfg.local_window, 16) if cfg.local_window else 0,
        max_position=4096,
    )
    if cfg.num_experts:
        changes.update(num_experts=8, experts_per_token=2,
                       moe_d_ff=64, first_dense_d_ff=256)
    if cfg.ssm_state:
        changes.update(ssm_state=16, ssm_headdim=16, ssm_chunk=16)
    if cfg.encoder_layers:
        changes.update(encoder_layers=2, decoder_max_len=64)
    if cfg.rglru_width:
        changes.update(rglru_width=128)
    if cfg.frontend == "patch":
        changes.update(frontend_len=4)
    return dataclasses.replace(cfg, **changes)
