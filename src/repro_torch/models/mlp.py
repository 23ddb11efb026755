"""Dense MLP: gated (SwiGLU/GeGLU) or plain 4x (GELU) variants.

Counterpart of ``repro.models.mlp``.  The reference's ``constrain`` on the
hidden activation is a sharding hint; with no mesh it is nothing here.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import activation, dense_init, pdtype_of


def make_mlp(cfg: ModelConfig, generator: torch.Generator, d_ff: int = 0, *,
             device=None, lead: Tuple[int, ...] = ()) -> Dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    pd = pdtype_of(cfg)
    out_scale = 1.0 / math.sqrt(f * 2 * cfg.num_layers)
    p = {
        "w1": dense_init(generator, (d, f), pd, device=device, lead=lead),
        "w2": dense_init(generator, (f, d), pd, scale=out_scale,
                         device=device, lead=lead),
    }
    if cfg.gated_mlp:
        p["wg"] = dense_init(generator, (d, f), pd, device=device, lead=lead)
    return p


def apply_mlp(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The activation (and the gate's product) in float32, rounded to the
    compute dtype once, as XLA's fusion of the reference's elementwise ops
    computes them."""
    act = activation(cfg.act)
    h = torch.matmul(x, p["w1"].to(x.dtype))
    if cfg.gated_mlp:
        g = torch.matmul(x, p["wg"].to(x.dtype))
        h = act(g.to(torch.float32)) * h.to(torch.float32)
    else:
        h = act(h.to(torch.float32))
    return torch.matmul(h.to(x.dtype), p["w2"].to(x.dtype))
