"""Online n-gram drafter: MCPrioQ as a speculative-decoding feature.

Counterpart of ``repro.core.speculative``.  The paper's target workload —
"recommend items in descending probability until cumulative probability >=
t" — is the draft-proposal problem of speculative decoding: given the
current context, propose the most probable next tokens.  The chain's src
nodes are rolling hashes of the last ``order`` tokens and its dst nodes are
next tokens, learned online from the tokens the target model emits (§II.C
decay keeps it adaptive).  Drafting a chain of k tokens is k greedy top-1
steps (one kernel launch, ``ops.draft_walk``); the cumulative-threshold
query gives candidate sets for tree-style verification.

Every function returns new tensors and writes into none of the state it was
given, so a reader may go on drafting from a snapshot that the learner is
building the next version from (``core.epoch.EpochStore``) — except
``observe_`` and ``maintain_``, the learner's writes for the state's owner
(``mcprioq.update_batch_`` / ``maybe_decay_``): they write into the state
given and return it, and serve a learner with no readers or the
back-buffer learner (``core.epoch.BackBufferLearner``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from repro_torch.core import hashtable as ht
from repro_torch.core import mcprioq as mc
from repro_torch.core.device import resolve_device
from repro_torch.core.hashtable import EMPTY
from repro_torch.kernels import ops, walk

__all__ = ["NGramConfig", "DrafterState", "check_cuda_limits", "init",
           "context_ids", "observe",
           "observe_", "maintain", "maintain_", "draft", "draft_reference",
           "candidates", "acceptance_rate"]


@dataclasses.dataclass(frozen=True)
class NGramConfig:
    order: int = 2                 # context length n
    mc: mc.MCConfig = mc.MCConfig(num_rows=8192, capacity=64, sort_passes=1)
    decay_threshold: int = 1 << 18


class DrafterState(NamedTuple):
    chain: mc.MCState


def check_cuda_limits(cfg: NGramConfig, device) -> None:
    """Refuse a drafter the CUDA kernels cannot run, before it is built on
    ``device``: on a CUDA device with ``impl`` auto or cuda, a context longer
    than the draft walk holds (``walk.MAX_ORDER``), or a chain that
    ``mcprioq.check_cuda_limits`` refuses.  No fallback."""
    mc.check_cuda_limits(cfg.mc, device)
    if torch.device(device).type == "cuda" and cfg.mc.impl != "ref" \
            and cfg.order > walk.MAX_ORDER:
        raise ValueError(
            f"order {cfg.order} is above {walk.MAX_ORDER}, the longest context "
            f"the CUDA draft walk (kernels/walk.py) holds in registers")


def init(cfg: NGramConfig, device=None) -> DrafterState:
    """Empty drafter on ``device`` (default: the current CUDA device; raises
    when there is none, and on a configuration the CUDA kernels refuse)."""
    dev = resolve_device(device)
    check_cuda_limits(cfg, dev)
    return DrafterState(chain=mc.init(cfg.mc, device=dev))


def _tokens(state: DrafterState, x) -> torch.Tensor:
    return mc._to_state_device(state.chain, x, torch.int32)


def context_ids(tokens: torch.Tensor, order: int) -> torch.Tensor:
    """Rolling hash of the last ``order`` tokens at every position.

    tokens: int32[..., S] -> ctx: int32[..., S] where ctx[..., i] hashes
    tokens[..., i-order+1 : i+1], newest first.  Non-negative (top bit
    cleared) so ids are valid hash-table keys.  Positions before the first
    full window see tokens rolled in from the end and are set to -1.
    """
    h = torch.zeros(tokens.shape, dtype=torch.int64, device=tokens.device)
    for k in range(order):
        h = ht.ctx_hash_fold(h, torch.roll(tokens, k, dims=-1))
    idx = torch.arange(tokens.shape[-1], device=tokens.device)
    ctx = (h & 0x7FFFFFFF).to(torch.int32)
    return torch.where(idx >= order - 1, ctx, -1)


def _transitions(state: DrafterState, tokens, order: int):
    """The ``(src, dst)`` transitions a batch of token sequences teaches.
    The -1 contexts of the first ``order - 1`` positions stay in: the
    update masks them (dropping them here would move the batch's sort
    positions)."""
    tokens = _tokens(state, tokens)
    ctx = context_ids(tokens, order)        # [B, S]
    return ctx[:, :-1].reshape(-1), tokens[:, 1:].reshape(-1)


def observe(state: DrafterState, tokens, *, cfg: NGramConfig) -> DrafterState:
    """Learn from a batch of token sequences. tokens: int32[B, S].

    Pure learning — §II.C maintenance lives in :func:`maintain`."""
    chain = mc.update_batch(state.chain, *_transitions(state, tokens, cfg.order),
                            cfg=cfg.mc)
    return DrafterState(chain=chain)


def observe_(state: DrafterState, tokens, *, cfg: NGramConfig,
             dirty=None, table_dirty=None) -> DrafterState:
    """:func:`observe` for the state's owner (``mcprioq.update_batch_``):
    written into ``state``, which it returns; ``dirty`` flags the rows
    changed, ``table_dirty`` the src-table slot groups written."""
    mc.update_batch_(state.chain, *_transitions(state, tokens, cfg.order),
                     cfg=cfg.mc, dirty=dirty, table_dirty=table_dirty)
    return state


def maintain(state: DrafterState, *, cfg: NGramConfig) -> DrafterState:
    """Learner-side §II.C maintenance: decay once any row total crosses
    ``cfg.decay_threshold``.  With ``cfg.mc.decay_block_rows`` set this is a
    rolling block halve (bounded per-call work); stop-the-world otherwise.
    Reading the trigger costs one device->host synchronisation;
    :func:`maintain_` decides on the device."""
    chain = mc.maybe_decay(state.chain, cfg=cfg.mc,
                           total_threshold=cfg.decay_threshold)
    return DrafterState(chain=chain)


def maintain_(state: DrafterState, *, cfg: NGramConfig,
              dirty=None) -> DrafterState:
    """:func:`maintain` for the state's owner (``mcprioq.maybe_decay_``):
    decided on the device, written into ``state``, which it returns."""
    mc.maybe_decay_(state.chain, cfg=cfg.mc,
                    total_threshold=cfg.decay_threshold, dirty=dirty)
    return state


def draft(state: DrafterState, context, *, cfg: NGramConfig,
          k: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy draft of k tokens per sequence — one kernel launch.

    context: int32[B, >=order] recent tokens.  Returns (draft[B, k],
    ok[B, k] bool) — ok False where the chain had no transition (the caller
    stops speculation there); a lane that fails emits token 0 / ok False
    for every later step.  The order heads go to the walk as the strided
    view ``order[:, 0]``, without a copy.  :func:`draft_reference` keeps
    the k-query loop as the semantic oracle.
    """
    chain = state.chain
    window = _tokens(state, context)[:, -cfg.order:]
    return ops.draft_walk(
        window, chain.src_table.keys, chain.src_table.vals,
        chain.slabs.cnt, chain.slabs.dst, chain.slabs.order[:, 0],
        k=k, max_probes=cfg.mc.max_probes, impl=cfg.mc.impl)


def draft_reference(state: DrafterState, context, *, cfg: NGramConfig,
                    k: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Oracle for :func:`draft`: k top-1 ``query_topk`` calls (the shape of
    the walk before it was a kernel), with the same dead-lane stop.  Must
    match :func:`draft` token for token."""
    order = cfg.order
    win = _tokens(state, context)[:, -order:]
    b = win.shape[0]
    toks = torch.zeros((b, k), dtype=torch.int32, device=win.device)
    oks = torch.zeros((b, k), dtype=torch.bool, device=win.device)
    alive = torch.ones((b,), dtype=torch.bool, device=win.device)
    for s in range(k):
        src = context_ids(win, order)[:, -1]
        dsts, probs = mc.query_topk(state.chain, src, cfg=cfg.mc, k=1)
        nxt = dsts[:, 0]
        ok = alive & (nxt != EMPTY) & (probs[:, 0] > 0)
        nxt = torch.where(ok, nxt, 0)
        toks[:, s] = nxt
        oks[:, s] = ok
        win = torch.cat([win[:, 1:], nxt.unsqueeze(1)], dim=1)
        alive = ok
    return toks, oks


def candidates(state: DrafterState, context, threshold: float, *,
               cfg: NGramConfig, max_items: int = 8):
    """Cumulative-probability candidate set for the next token — the paper's
    headline query, for tree-style speculation or top-p style pruning."""
    window = _tokens(state, context)[:, -cfg.order:]
    src = context_ids(window, cfg.order)[:, -1]
    return mc.query_threshold(state.chain, src, threshold, cfg=cfg.mc,
                              max_items=max_items)


def acceptance_rate(draft_tokens: torch.Tensor, target_tokens: torch.Tensor,
                    ok: torch.Tensor) -> torch.Tensor:
    """Fraction of drafted tokens accepted by the target (prefix match),
    averaged over sequences: a float32 0-dim tensor."""
    match = (draft_tokens == target_tokens) & ok.to(torch.bool)
    accepted = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
    drafted = ok.to(torch.int32).sum(dim=1).clamp(min=1)
    rate = accepted.to(torch.float32) / drafted.to(torch.float32)
    return _mean_f32(rate)


_LANES = 32


def _mean_f32(x: torch.Tensor) -> torch.Tensor:
    """Float32 mean of a 1-D tensor in the order XLA sums it, so the bits
    match ``jnp.mean``: while more than 32 values are left, zero-pad them
    symmetrically (``pad // 2`` in front) to a multiple of 32 and sum each
    window of 32 sequentially; sum the last <= 32 sequentially; multiply by
    the float32 constant ``1/n``.  Column by column with element-wise adds,
    since ``sum(dim)`` promises no order."""
    n = x.numel()
    while x.numel() > _LANES:
        pad = -x.numel() % _LANES
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        win = x.view(-1, _LANES)
        acc = torch.zeros_like(win[:, 0])
        for j in range(_LANES):
            acc = acc + win[:, j]
        x = acc
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for j in range(x.numel()):
        total = total + x[j]
    inv_n = torch.tensor(1.0, dtype=torch.float32) / n
    return total * inv_n.to(x.device)
