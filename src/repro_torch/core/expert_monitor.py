"""Expert-popularity monitor: MCPrioQ tracking MoE router decisions online.

Counterpart of ``repro.core.expert_monitor``.  The (layer -> expert) choice
stream is itself a sparse Markov-ish counter workload: src nodes are layer
ids, dst nodes are expert ids, the counter is the routing frequency.  The
load-balance monitor then asks the paper's query: "which experts serve a
cumulative ``t`` of this layer's traffic?" — few experts at high t means
imbalance; decay (§II.C) keeps the view fresh as routing drifts.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.core import mcprioq as mc


@dataclasses.dataclass(frozen=True)
class MonitorConfig:
    num_layers: int
    num_experts: int
    sort_passes: int = 2
    decay_threshold: int = 1 << 20

    def mc_config(self) -> mc.MCConfig:
        cap = 1
        while cap < self.num_experts:
            cap *= 2
        return mc.MCConfig(num_rows=max(2 * self.num_layers, 8),
                           capacity=cap, sort_passes=self.sort_passes)


def init(cfg: MonitorConfig, device=None) -> mc.MCState:
    """Empty monitor on ``device`` (default: the current CUDA device)."""
    return mc.init(cfg.mc_config(), device=device)


def observe(state: mc.MCState, layer: int, expert_counts,
            cfg: MonitorConfig) -> mc.MCState:
    """Fold one layer's router histogram (``[num_experts]`` counts) in;
    functional, as the reference."""
    dev = state.slabs.cnt.device
    e = cfg.num_experts
    counts = torch.as_tensor(expert_counts, device=dev).to(torch.int32)
    src = torch.full((e,), layer, dtype=torch.int32, device=dev)
    dst = torch.arange(e, dtype=torch.int32, device=dev)
    state = mc.update_batch(state, src, dst, weights=counts, mask=counts > 0,
                            cfg=cfg.mc_config())
    return mc.maybe_decay(state, cfg=cfg.mc_config(),
                          total_threshold=cfg.decay_threshold)


def hot_experts(state: mc.MCState, layer: int, t: float,
                cfg: MonitorConfig) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Experts carrying cumulative traffic >= t for a layer, hottest first.
    Returns (expert_ids, load_fractions, n_needed) — n_needed close to
    num_experts*t means balanced routing; small n_needed flags collapse."""
    src = torch.tensor([layer], dtype=torch.int32, device=state.slabs.cnt.device)
    dsts, probs, n = mc.query_threshold(state, src, t, cfg=cfg.mc_config(),
                                        max_items=cfg.num_experts)
    return dsts[0], probs[0], int(n[0])


def balance_report(state: mc.MCState, cfg: MonitorConfig,
                   t: float = 0.9) -> Dict[int, int]:
    """n_needed per layer at threshold t (the imbalance dashboard)."""
    out = {}
    for layer in range(cfg.num_layers):
        _, _, n = hot_experts(state, layer, t, cfg)
        out[layer] = n
    return out
