"""Mixture-of-Experts block: shared + fine-grained routed experts (top-k).

Counterpart of ``repro.models.moe``: ``num_shared_experts`` always-on
experts fused into one wider MLP, plus ``num_experts`` routed experts with
top-k gating; sort-based dispatch with a fixed capacity into an
``[E, cap, D]`` tile, the grouped expert MLP as batched matmuls, and the
weighted combine back to the tokens.  The reference computes all of it in
plain ``jnp`` (no Pallas kernel), so plain torch is its counterpart here.

Four things are written for a serving engine on a GPU, each with the
reference's result on the reference's inputs:

  * **ties of the router's top-k go to the lower expert id**, as
    ``lax.top_k`` breaks them: a stable descending sort (``torch.topk``
    promises no tie order on CUDA);
  * **the scatter combine is a gather that adds in expert order.**  The
    reference's scatter starts from zeros in the compute dtype and adds
    each slot's weighted output in ``tok_at`` order: for one token, in
    ascending expert id, rounding after each add.  ``index_add_`` on CUDA
    adds by atomics in an order it chooses, so here each token gathers its
    k outputs, sorted by expert id, and adds them one at a time;
  * **pad rows are not dispatched** (``real``): a decode or extension call
    carries ``STEP_ROWS`` rows a sequence (``models.model``), of which the
    first ``real`` are tokens.  The capacity is the reference's for the
    real tokens (``_capacity(B * real)``), so pad rows never take a slot
    from a real token; the router and the shared experts still run on
    every row, at the call's fixed shape, and a pad row's output is the
    shared experts' alone;
  * **the tile keeps its shape**: it has ``_capacity(B * rows)`` slots an
    expert (the call's rows, pads included) of which the first ``cap`` can
    be filled, so a decode and an extension run the grouped matmuls at one
    shape and a token's arithmetic does not depend on its call.

``apply_moe_ep`` (expert parallelism over a mesh) is not ported: there is
no mesh, and the reference itself falls back to ``apply_moe`` without one
(ROADMAP queue C 28).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import activation, dense_init, pdtype_of
from repro_torch.models.mlp import apply_mlp, make_mlp


def make_moe(cfg: ModelConfig, generator: torch.Generator, *, device=None,
             lead: Tuple[int, ...] = ()) -> Dict:
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    pd = pdtype_of(cfg)
    out_scale = 1.0 / math.sqrt(f * 2 * cfg.num_layers)
    p = {
        "router": dense_init(generator, (d, e), pd, scale=0.02,
                             device=device, lead=lead),
        "we1": dense_init(generator, (e, d, f), pd, device=device, lead=lead),
        "we2": dense_init(generator, (e, f, d), pd, scale=out_scale,
                          device=device, lead=lead),
    }
    if cfg.gated_mlp:
        p["weg"] = dense_init(generator, (e, d, f), pd, device=device,
                              lead=lead)
    if cfg.num_shared_experts:
        p["shared"] = make_mlp(cfg, generator,
                               d_ff=cfg.num_shared_experts * f,
                               device=device, lead=lead)
    return p


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    fair = tokens * cfg.experts_per_token / cfg.num_experts
    cap = int(math.ceil(fair * cfg.capacity_factor / 128.0)) * 128
    return max(cap, 128)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last dim: ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _expert_mlp(p: Dict, xe: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The grouped gated expert MLP over ``[E, C, D]`` tiles; the activation
    and the gate's product in float32, rounded once (as ``mlp.apply_mlp``)."""
    act = activation(cfg.act)
    dt = xe.dtype
    h = torch.bmm(xe, p["we1"].to(dt))
    if cfg.gated_mlp:
        g = torch.bmm(xe, p["weg"].to(dt))
        h = act(g.to(torch.float32)) * h.to(torch.float32)
    else:
        h = act(h.to(torch.float32))
    return torch.bmm(h.to(dt), p["we2"].to(dt))


def apply_moe(p: Dict, x: torch.Tensor, cfg: ModelConfig,
              real: Optional[int] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: [B, S, D] -> (out [B, S, D], aux).  The first ``real`` rows of
    each sequence are tokens (default: all); the rest are pad rows, routed
    but not dispatched, and the aux counts the tokens only."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    real = s if real is None else real
    dev = x.device
    xt = x.reshape(b * s, d)

    logits = torch.matmul(xt, p["router"].to(x.dtype)).to(torch.float32)
    if real < s:   # the tokens' rows of the flattened batch
        tok = (torch.arange(b, device=dev)[:, None] * s
               + torch.arange(real, device=dev)[None, :]).reshape(-1)
        logits_t = logits[tok]
    else:
        tok, logits_t = None, logits
    n = b * real
    probs = torch.softmax(logits_t, dim=-1)
    top_p, top_e = top_k(probs, k)                              # [n, k]
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)             # renormalise

    # ---- sort-based dispatch with fixed capacity ----------------------
    cap = _capacity(n, cfg)
    slots = _capacity(b * s, cfg)       # the tile's shape: >= cap
    flat_e = top_e.reshape(-1)                                  # [n*k]
    flat_t = torch.arange(n, device=dev).repeat_interleave(k)   # token ids
    flat_p = top_p.reshape(-1)
    se, sort_idx = torch.sort(flat_e, stable=True)
    st, sp = flat_t[sort_idx], flat_p[sort_idx]
    starts = torch.searchsorted(se, torch.arange(e, device=dev))
    pos = torch.arange(n * k, device=dev) - starts[se]          # slot
    keep = pos < cap
    # dropped pairs go to a sink column, cut off after
    slot = torch.where(keep, pos, slots)
    tok_at = torch.zeros((e, slots + 1), dtype=torch.int64, device=dev)
    tok_at = tok_at.index_put((se, slot), st)[:, :slots]
    gate_at = torch.zeros((e, slots + 1), dtype=torch.float32, device=dev)
    gate_at = gate_at.index_put((se, slot),
                                torch.where(keep, sp, 0.0))[:, :slots]
    rows_of = tok_at if tok is None else tok[tok_at]
    xe = xt[rows_of] * (gate_at[..., None] > 0).to(x.dtype)     # [E, C, D]
    ye = _expert_mlp(p, xe, cfg)                                # [E, C, D]

    # ---- weighted combine back to tokens ------------------------------
    pos_u = torch.empty_like(pos).index_put((sort_idx,), pos)   # unsort
    keep_u = pos_u < cap
    gate_u = torch.where(keep_u, flat_p, 0.0).to(ye.dtype)
    slot_u = torch.clamp(pos_u, max=slots - 1)
    if cfg.moe_combine == "gather":
        vals = ye[flat_e, slot_u]                               # [n*k, d]
        out = (vals * gate_u[:, None]).reshape(n, k, d).sum(dim=1)
    else:
        # the scatter's sum: per token, ascending expert id, one add at a
        # time in the compute dtype
        order = torch.argsort(top_e, dim=-1)                    # [n, k]
        pair = (torch.arange(n, device=dev)[:, None] * k + order)
        out = torch.zeros((n, d), dtype=ye.dtype, device=dev)
        for j in range(k):
            pj = pair[:, j]
            out = out + ye[flat_e[pj], slot_u[pj]] * gate_u[pj][:, None]
    if tok is not None:
        out = torch.zeros((b * s, d), dtype=out.dtype,
                          device=dev).index_put((tok,), out)

    if cfg.num_shared_experts:
        out = out + apply_mlp(p["shared"], x, cfg).reshape(b * s, d)

    # ---- aux: load balance + router z-loss ----------------------------
    # (``bincount`` would read its input's max on the host)
    counts = torch.zeros(e, dtype=torch.int64, device=dev).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    me = probs.mean(dim=0)                                      # [e]
    ce = counts.to(torch.float32) / (n * k)
    aux = {"moe_lb_loss": e * torch.sum(me * ce),
           "moe_z_loss": torch.logsumexp(logits_t, dim=-1).square().mean(),
           "moe_dropped": (~keep).sum().to(torch.int32),
           "moe_expert_counts": counts.to(torch.int32)}
    return out.reshape(b, s, d).to(x.dtype), aux
