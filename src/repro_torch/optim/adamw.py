"""Hand-rolled AdamW with global-norm clipping and decoupled weight decay.

Counterpart of ``repro.optim.adamw``.  States mirror the parameter tree
(nested dicts and lists of tensors).  Trees are walked in jax's order (dict
keys sorted; ``checkpoint.ckpt._paths_and_leaves``), so the global norm
adds the leaves in the reference's order, and weight decay is decided by a
leaf's own key, as the reference's ``_decay_mask`` decides it.  ``update``
returns new tensors and writes none of its arguments.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.checkpoint.ckpt import _paths_and_leaves, tree_map

PyTree = Any

#: leaf names that take no weight decay (norms, biases, scalars)
NO_DECAY = ("scale", "bias", "conv_b", "ga_b", "gi_b", "lambda_p", "A_log",
            "ssm_D", "dt_bias", "norm_scale")


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor    # int32 0-dim
    mu: PyTree
    nu: PyTree


def init(params: PyTree) -> AdamWState:
    _, leaves, _ = _paths_and_leaves(params)

    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
        mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(tree: PyTree) -> torch.Tensor:
    _, leaves, _ = _paths_and_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves))


def decays(key: str) -> bool:
    """Whether the leaf at ``key`` ('/'-joined path) takes weight decay:
    not the 1-D norms, biases and scalars."""
    return key.split("/")[-1] not in NO_DECAY


def update(grads: PyTree, state: AdamWState, params: PyTree,
           cfg: AdamWConfig, lr_scale=1.0
           ) -> Tuple[PyTree, AdamWState, dict]:
    """Returns (new_params, new_state, metrics)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    step = state.step + 1
    stepf = step.to(torch.float32)
    b1c = 1.0 - cfg.b1 ** stepf
    b2c = 1.0 - cfg.b2 ** stepf
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=gnorm.device)

    keys, ps, rebuild = _paths_and_leaves(params)
    gs, mus, nus = (_paths_and_leaves(t)[1]
                    for t in (grads, state.mu, state.nu))
    new_p, new_mu, new_nu = [], [], []
    for key, p, g, mu, nu in zip(keys, ps, gs, mus, nus):
        g = g.to(torch.float32) * scale
        mu2 = cfg.b1 * mu + (1 - cfg.b1) * g
        nu2 = cfg.b2 * nu + (1 - cfg.b2) * torch.square(g)
        delta = (mu2 / b1c) / (torch.sqrt(nu2 / b2c) + cfg.eps)
        if decays(key):
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        new_p.append((p.to(torch.float32) - lr * delta).to(p.dtype))
        new_mu.append(mu2)
        new_nu.append(nu2)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return (rebuild(new_p),
            AdamWState(step, rebuild(new_mu), rebuild(new_nu)), metrics)
