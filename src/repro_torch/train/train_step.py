"""Training step factory: grads (+ microbatch accumulation, + optional
gradient compression) -> AdamW update.

Counterpart of ``repro.train.train_step``.  Gradients come from
``torch.autograd`` over ``Model.loss_fn`` (the model recomputes each CE
chunk, and each stacked period when ``cfg.remat`` asks, in the backward).
Microbatches run in a Python loop where the reference scans: their
gradients are added into float32 zeros in order and divided by their
number, and so is the loss.  The step returns a new ``TrainState`` and
writes nothing it was given.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.checkpoint.ckpt import _paths_and_leaves, tree_map
from repro_torch.models.model import Model
from repro_torch.optim import adamw
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.train import compression

PyTree = Any


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: adamw.AdamWConfig = adamw.AdamWConfig()
    warmup_steps: int = 100
    total_steps: int = 10_000
    microbatches: int = 1          # grad accumulation in a loop
    compress_grads: bool = False   # int8 + error feedback


class TrainState(NamedTuple):
    params: PyTree
    opt: adamw.AdamWState
    ef: Optional[compression.EFState]


def init_state(model: Model, generator: Optional[torch.Generator],
               tcfg: TrainConfig, device=None) -> TrainState:
    """Parameters from ``generator`` on ``device`` (default: the GPU; an
    error without one), zero optimizer and error-feedback states."""
    params = model.init(generator, device=device)
    opt = adamw.init(params)
    ef = compression.init(params) if tcfg.compress_grads else None
    return TrainState(params, opt, ef)


def abstract_state(model: Model, tcfg: TrainConfig) -> TrainState:
    """The state's shapes and dtypes, as meta tensors."""
    return init_state(model, None, tcfg, device="meta")


def grads_of(model: Model, params: PyTree, batch: Dict[str, Any]
             ) -> Tuple[PyTree, torch.Tensor, Dict[str, torch.Tensor]]:
    """(grads, loss, metrics) of ``model.loss_fn`` at ``params``: float32
    gradients in the parameters' tree, zeros for a leaf the loss does not
    reach (as ``jax.grad`` gives)."""
    _, leaves, rebuild = _paths_and_leaves(params)
    ps = [p.detach().requires_grad_(True) for p in leaves]
    with torch.enable_grad():
        loss, metrics = model.loss_fn(rebuild(ps), batch)
        gs = torch.autograd.grad(loss, ps, allow_unused=True)
    grads = rebuild([torch.zeros_like(p) if g is None else g
                     for p, g in zip(ps, gs)])
    return grads, loss.detach(), {k: v.detach() for k, v in metrics.items()}


def make_train_step(model: Model, tcfg: TrainConfig
                    ) -> Callable[[TrainState, PyTree],
                                  Tuple[TrainState, dict]]:
    """Returns step(state, batch) -> (state', metrics).

    With microbatches > 1, the batch's leading dim is split and the
    microbatches' gradients are accumulated in turn, so activations scale
    with the microbatch, not the batch."""

    def step(state: TrainState, batch: PyTree):
        dev = state.opt.step.device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        mb = tcfg.microbatches
        if mb > 1:
            for k, x in batch.items():
                if x.shape[0] % mb:
                    raise ValueError(f"batch[{k!r}] of {x.shape[0]} rows "
                                     f"does not split into {mb} microbatches")
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(mb):
                part = {k: x.reshape((mb, x.shape[0] // mb) + x.shape[1:])[i]
                        for k, x in batch.items()}
                g, loss, _ = grads_of(model, state.params, part)
                _, acc, rebuild = _paths_and_leaves(grads)
                grads = rebuild([a + b for a, b in
                                 zip(acc, _paths_and_leaves(g)[1])])
                loss_sum = loss_sum + loss
            grads = tree_map(lambda g: g / mb, grads)
            loss = loss_sum / mb
            metrics = {"loss": loss}
        else:
            grads, loss, metrics = grads_of(model, state.params, batch)

        ef = state.ef
        if tcfg.compress_grads:
            grads, ef, cmetrics = compression.compress(grads, ef)
            metrics = {**metrics, **cmetrics}

        lr_scale = warmup_cosine(state.opt.step,
                                 warmup_steps=tcfg.warmup_steps,
                                 total_steps=tcfg.total_steps)
        params, opt, ometrics = adamw.update(
            grads, state.opt, state.params, tcfg.optimizer, lr_scale)
        metrics = {**metrics, **ometrics, "loss": loss}
        return TrainState(params, opt, ef), metrics

    return step
