"""Sharded MCPrioQ on one card: node-space partitioning with bucket routing.

Counterpart of ``repro.core.sharded``.  Every shard owns a slice of the
graph under the two-level ownership map (hash -> virtual bucket -> shard,
:class:`repro_torch.sharding.Ownership`); a global update batch is routed
to its owner shards through fixed-capacity buckets, each shard applies its
local update, queries route the same way and their answers are routed
back, and the headline top-n read is answered globally by a k-way merge of
the shards' local answers (``ops.topn_merge``; on the card
``ops.topn_windows`` reads every shard's windows in one pass and merges
its blocks' lists).

The reference runs S shards as S devices under ``shard_map``.  Here the S
shards are *logical* shards of one device, as the reference's own tests run
8 shards on one host:

  * the state is **stacked**: every leaf of ``MCState`` gains a leading
    ``[S]`` (as ``init_sharded`` makes it), and the ten scalar leaves are
    the columns of one int32 ``[S, 10]`` tensor, so :func:`shard_state`
    hands out shard ``s`` as an ``MCState`` of views whose scalars are
    consecutive elements of row ``s`` — the owner calls of
    ``core.mcprioq`` write into the stacked storage with no copy;
  * the batch is data-sharded as ``P(axis)`` shards it: sender ``s`` holds
    the contiguous slice ``[s·B/S, (s+1)·B/S)``;
  * ``all_to_all(..., 0, 0, tiled=True)`` of the ``[S_send, S_recv, cap]``
    buckets is a transpose to ``[S_recv, S_send·cap]`` — receiver ``r``
    sees sender 0's bucket first, then sender 1's, and the update's stable
    sorts depend on that order; ``all_gather`` is the stacked ``[S, n]``
    tensor and ``psum`` a sum.

Every per-shard body dispatches the kernel layer through the chain's entry
points: ``update_`` runs :func:`repro_torch.core.mcprioq.update_batch_`,
the query :func:`repro_torch.core.mcprioq.query_impl` (probe + fused
read), ``maintain_``/``decay_`` ``maybe_decay_``/``decay_`` (each shard
keeps its own ``decay_cursor`` and its own device trigger).  The bucket
building runs for all S senders at once, so its launches do not grow with
S; the per-shard calls do (S owner calls per update).

Two kinds of call, as in ``core.mcprioq``: ``update_``, ``maintain_`` and
``decay_`` are for the state's owner and write into the state they are
given; the callables of ``make_*_fn`` are functional — they copy what they
write first and write nothing they are given, because an ``EpochStore``
reader may hold the state.  On a CUDA state the owner calls and the query
make no device->host synchronisation.

**One shard per rank.**  Every call also takes ``ranks``, a
:class:`repro_torch.sharding.ranks.RankGroup`, where the reference takes a
mesh: then this process holds shard ``ranks.rank`` only, as the
reference's ``shard_map`` body holds its block, and the shards exchange
through the group's collectives.  The rank's state is a stacked state with
a leading dim of 1 (``init_sharded(scfg, ranks=...)``), so ``shard_state(
state, 0)`` and the owner calls serve it unchanged; ``scfg.num_shards``
must equal the group's world size (the reference's body takes ``x[0]`` of
its block: one shard a device).  A rank passes its contiguous slice of the
global batch, ``[r·B/S, (r+1)·B/S)`` as ``P(axis)`` hands it out, and every
rank passes a slice of the same length (unchecked: a check would cost a
synchronisation).  ``update_`` builds the rank's ``[S, cap]`` buckets and
exchanges the three leaves in one ``all_to_all`` (stacked ``[S, 3, cap]``);
``query`` routes out, answers on its shard and routes ``d, p, need`` back
in one more (``p``'s bits carried as int32); ``maintain_`` and ``decay_``
are local; ``topn`` all_gathers each rank's own top-n list and its drop
count in one ``[S, 3n+1]`` exchange, merges the lists with
``ops.topn_merge`` (every rank the same answer) and sums the drops, the
reference's ``psum``.  ``ranks=None`` is the stacked one-card chain above.

Fixed per-destination bucket capacity keeps shapes static: overflowed items
are dropped and counted — in the *sender's* ``route_dropped`` for updates,
in the query's drop vector for reads.  torch has no ``mode="drop"``
scatter, so a dropped or inactive item is written to a sink column one past
the bucket's end, which is then sliced off.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import mcprioq as mc
from repro_torch.core.hashtable import EMPTY
from repro_torch.kernels import ops, ref
from repro_torch.sharding.ownership import Ownership
from repro_torch.sharding.ranks import RankGroup

__all__ = [
    "ShardedConfig", "owner_of", "init_sharded", "shard_state",
    "predict_route_overflow", "update_", "query", "maintain_",
    "decay_", "topn_lists", "topn", "make_update_fn", "make_query_fn",
    "make_maintain_fn", "make_decay_fn", "make_topn_fn", "make_update_fn_",
    "make_maintain_fn_",
]


@dataclasses.dataclass(frozen=True)
class ShardedConfig:
    base: mc.MCConfig
    num_shards: int
    axis: str = "shard"   # name parity only: a RankGroup plays the axis
    bucket_factor: float = 2.0  # capacity = factor * fair share
    # two-level hash -> virtual bucket -> shard map; None = the default
    # assignment
    ownership: Optional[Ownership] = None

    def bucket_capacity(self, local_batch: int) -> int:
        fair = max(1, local_batch // self.num_shards)
        # never 0: zero-width buckets can route nothing
        return max(1, int(self.bucket_factor * fair))

    def resolved_ownership(self) -> Ownership:
        own = self.ownership or Ownership(num_shards=self.num_shards)
        if own.num_shards != self.num_shards:
            raise ValueError(
                f"ownership maps {own.num_shards} shards but config has "
                f"{self.num_shards}")
        return own


def owner_of(src: torch.Tensor, num_shards: int) -> torch.Tensor:
    """Owner shard of a node id under the *default* two-level map (routed
    configs use ``ShardedConfig.resolved_ownership().owner_of``)."""
    return Ownership(num_shards=num_shards).owner_of(src)


# ---------------------------------------------------------------------------
# the stacked state
# ---------------------------------------------------------------------------


def _check_ranks(scfg: ShardedConfig, ranks: Optional[RankGroup],
                 state: Optional[mc.MCState] = None) -> int:
    """The number of shards this process holds: ``num_shards`` on one
    card, 1 on a rank (whose world must be ``num_shards``, and whose state
    holds one shard)."""
    if ranks is None:
        return scfg.num_shards
    if ranks.world != scfg.num_shards:
        raise ValueError(
            f"a rank group of world {ranks.world} runs one shard a rank, but "
            f"the config has num_shards={scfg.num_shards}")
    if state is not None and state.slabs.cnt.shape[0] != 1:
        raise ValueError(
            f"a rank holds one shard, but the state stacks "
            f"{state.slabs.cnt.shape[0]}")
    return 1


def init_sharded(scfg: ShardedConfig, device=None, *,
                 ranks: Optional[RankGroup] = None) -> mc.MCState:
    """Empty stacked state of ``scfg.num_shards`` chains on ``device``
    (default: the current CUDA device; raises when there is none); with
    ``ranks``, this rank's one shard (leading dim 1) on ``device``, by
    default the group's device."""
    shards = _check_ranks(scfg, ranks)
    if ranks is not None and device is None:
        device = ranks.device
    return mc.stack_states([mc.init(scfg.base, device=device)] * shards)


def shard_state(state: mc.MCState, s: int) -> mc.MCState:
    """Shard ``s`` of a stacked state as an ``MCState`` of views: the owner
    calls of ``core.mcprioq`` write through them into the stacked storage."""
    return mc.map_leaves(lambda x: x[s], state)


def _as_int32(state: mc.MCState, x) -> torch.Tensor:
    return torch.as_tensor(x, device=state.slabs.cnt.device).to(
        torch.int32).contiguous()


# ---------------------------------------------------------------------------
# bucket building (every sender at once)
# ---------------------------------------------------------------------------


def _build_buckets(vals, owner: torch.Tensor, num_shards: int, cap: int,
                   active: torch.Tensor, senders: Optional[int] = None):
    """Scatter the items of ``senders`` (default S) contiguous sender
    slices into ``[senders, S_recv, cap]`` send buckets grouped by owner:
    the reference's per-sender ``_build_buckets`` for every sender in one
    pass (one sender on a rank).

    One stable sort of the keys ``sender·(S+1) + owner`` orders each
    sender's items by owner (inactive items carry owner S: they sort last,
    take no capacity and are not counted), ``searchsorted`` (left) finds
    every ``(sender, owner)`` group's start, and an item's in-bucket slot is
    its rank in its group.  Items ranked ``>= cap`` are dropped.  Returns
    ``(buckets..., pos, dropped)``: ``pos[i]`` is item i's rank (garbage for
    inactive items, as in the reference: callers mask on ``active``),
    ``dropped`` int32 ``[senders]`` the drops of each sender.
    """
    n = num_shards
    m = n if senders is None else senders
    b = owner.shape[0]
    local = b // m
    dev = owner.device
    owner = torch.where(active, owner, n).to(torch.int64)
    sender = torch.arange(m, device=dev).repeat_interleave(local)
    key_s, sort_idx = torch.sort(sender * (n + 1) + owner, stable=True)
    owner_s = key_s - sender * (n + 1)       # sorting keeps each sender's slice
    groups = torch.arange(m * n, device=dev)
    starts = torch.searchsorted(key_s, groups // n * (n + 1) + groups % n)
    pos_s = (torch.arange(b, device=dev)
             - starts[sender * n + owner_s.clamp(max=n - 1)])
    real = owner_s < n
    keep = real & (pos_s < cap)
    # a dropped or inactive item goes to the sink column ``cap``
    slot = torch.where(keep, (sender * n + owner_s) * (cap + 1) + pos_s,
                       sender * n * (cap + 1) + cap)
    outs = []
    for v in vals:
        buf = torch.full((m * n * (cap + 1),), EMPTY, dtype=torch.int32,
                         device=dev)
        buf.scatter_(0, slot, v[sort_idx])
        outs.append(buf.view(m, n, cap + 1)[:, :, :cap])
    pos = torch.empty((b,), dtype=torch.int32, device=dev).scatter_(
        0, sort_idx, pos_s.to(torch.int32))
    dropped = ((pos_s >= cap) & real).view(m, local).sum(dim=1).to(torch.int32)
    return outs, pos, dropped


def _route(scfg: ShardedConfig, state: mc.MCState, src, vals=(),
           ranks: Optional[RankGroup] = None):
    """Owners, buckets and drops of a batch; the buckets come back as the
    receivers see them, sender 0's bucket first.  On one card ``src`` is
    the global batch, every sender's buckets are built at once and handed
    over by a transpose: ``[S_recv, S_send·cap]`` each leaf.  On a rank
    ``src`` is this rank's slice, its ``[S, cap]`` buckets of every leaf go
    out in one ``all_to_all`` (stacked ``[S, L, cap]``), and this rank's
    come back as ``[L, S_send·cap]``."""
    n = scfg.num_shards
    senders = n if ranks is None else 1
    src = _as_int32(state, src)
    if src.dim() != 1 or src.shape[0] % senders:
        raise ValueError(f"batch of {tuple(src.shape)} is not a multiple of "
                         f"num_shards={n}")
    cap = scfg.bucket_capacity(src.shape[0] // senders)
    owner = scfg.resolved_ownership().owner_of(src)
    active = src >= 0
    bufs, pos, dropped = _build_buckets(
        [src, *(_as_int32(state, v) for v in vals)], owner, n, cap, active,
        senders)
    if ranks is None:
        received = [x.transpose(0, 1).reshape(n, n * cap) for x in bufs]
    else:
        got = ranks.all_to_all(torch.stack([x[0] for x in bufs], dim=1))
        received = got.transpose(0, 1).reshape(len(bufs), n * cap)
    return received, owner, active, pos, dropped, cap


def predict_route_overflow(scfg: ShardedConfig, src) -> np.ndarray:
    """Host-side mirror of :func:`_build_buckets`'s capacity drop decision.

    ``src`` must already be padded to a multiple of ``num_shards``: the
    batch splits into ``num_shards`` contiguous sender slices of length
    ``B/num_shards``, and each slice independently drops the items ranked
    ``>= cap`` within their owner group (stable order).  Returns a bool
    mask, True exactly where the update/query path drops the item.
    """
    src = np.asarray(src)
    n = scfg.num_shards
    if src.size % n:
        raise ValueError(f"batch of {src.size} not padded to a multiple "
                         f"of num_shards={n}")
    local = src.size // n
    cap = scfg.bucket_capacity(local)
    owner = scfg.resolved_ownership().owner_of(
        torch.from_numpy(src.astype(np.int32).reshape(-1))).numpy()
    active = src >= 0
    owner = np.where(active, owner, n)
    out = np.zeros(src.size, dtype=bool)
    for s in range(n):
        sl = slice(s * local, (s + 1) * local)
        own_s = owner[sl]
        sort_idx = np.argsort(own_s, kind="stable")
        owner_sorted = own_s[sort_idx]
        starts = np.searchsorted(owner_sorted, np.arange(n))
        pos_s = (np.arange(local)
                 - starts[np.minimum(owner_sorted, n - 1)])
        drop_sorted = (pos_s >= cap) & (owner_sorted < n)
        drop = np.zeros(local, dtype=bool)
        drop[sort_idx] = drop_sorted
        out[sl] = drop
    return out


def _src_of_row(state: mc.MCState, num_rows: int) -> torch.Tensor:
    """Reverse map row -> src node id of every shard, ``[S, N]``, rebuilt
    from the src tables by one scatter (``kernels/ref.py::src_of_row_ref``;
    invalid table lanes go to a sink, sliced off)."""
    return ref.src_of_row_ref(*state.src_table, num_rows)


def _top_k(x: torch.Tensor, n: int):
    """``lax.top_k`` along the last dim of a float32 ``[S, L]`` tensor
    without NaNs: the n largest values, descending, the lower index first
    among equal values — the first n of a stable descending sort
    (``torch.topk`` promises no order among ties).  Returns
    ``(values[S, n], indices[S, n])``."""
    if not 1 <= n <= x.shape[1]:
        raise ValueError(f"top-n of {n} over {x.shape[1]} entries per shard")
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :n].contiguous(), idx[:, :n].contiguous()


# ---------------------------------------------------------------------------
# the calls: owner forms write into ``state``
# ---------------------------------------------------------------------------


def _flags(dirty, s):
    return None if dirty is None else dirty[s]


def update_(state: mc.MCState, src, dst, w, *, scfg: ShardedConfig,
            ranks: Optional[RankGroup] = None, dirty=None,
            table_dirty=None) -> mc.MCState:
    """Route a global batch ``src[B], dst[B], w[B]`` (B a multiple of S,
    sender slices contiguous) to its owner shards and apply each shard's
    update in place (``update_batch_`` with ``mask = src != EMPTY``); each
    sender's bucket-overflow drops are added to its own shard's
    ``route_dropped``.  ``dirty`` (uint8 ``[S, N]``): every row changed is
    flagged; ``table_dirty`` (uint8 ``[S, hashtable.flag_count(T)]``):
    every src-table slot group written.  With ``ranks``: this rank's slice
    ``[B/S]`` of the global batch, its state and flags of one shard
    (``[1, ...]``).  Returns ``state``."""
    if ranks is not None:
        _check_ranks(scfg, ranks, state)
        (rsrc, rdst, rw), _, _, _, dropped, _ = _route(
            scfg, state, src, (dst, w), ranks)
        mc.update_batch_(shard_state(state, 0), rsrc, rdst, rw, rsrc != EMPTY,
                         cfg=scfg.base, dirty=_flags(dirty, 0),
                         table_dirty=_flags(table_dirty, 0))
        state.route_dropped.add_(dropped)
        return state
    (rsrc, rdst, rw), _, _, _, dropped, _ = _route(scfg, state, src, (dst, w))
    for r in range(scfg.num_shards):
        mc.update_batch_(shard_state(state, r), rsrc[r], rdst[r], rw[r],
                         rsrc[r] != EMPTY, cfg=scfg.base,
                         dirty=_flags(dirty, r),
                         table_dirty=_flags(table_dirty, r))
    state.route_dropped.add_(dropped)
    return state


def query(state: mc.MCState, src, threshold, max_items: int, *,
          scfg: ShardedConfig, ranks: Optional[RankGroup] = None):
    """Threshold query of a global batch ``src[B]``: routed to the owners,
    answered by each shard's fused read (``query_impl``), routed back and
    un-permuted.  Returns ``(dsts[B, max_items], probs[B, max_items],
    n_needed[B], dropped[S])``; ``dropped`` counts the queries each sender
    could not route (their answers are EMPTY/0).  With ``ranks``: this
    rank's slice ``src[B/S]`` in, its answers ``[B/S, ...]`` and its
    ``dropped[1]`` out."""
    n = scfg.num_shards
    if ranks is not None:
        _check_ranks(scfg, ranks, state)
        return _query_rank(state, src, threshold, max_items, scfg, ranks)
    (rsrc,), owner, active, pos, dropped, cap = _route(scfg, state, src)
    outs = [mc.query_impl(shard_state(state, r), rsrc[r], threshold,
                          scfg.base, max_items) for r in range(n)]
    # back to the senders: [S_recv, S_send, cap] -> [S_send, S_recv, cap]
    d, p, need = (torch.stack(x).view(n, n, cap, *x[0].shape[1:])
                  .transpose(0, 1).reshape(n * n * cap, *x[0].shape[1:])
                  for x in zip(*outs))
    # un-permute: item i sits at [sender, owner[i], pos[i]]
    b = owner.shape[0]
    sender = torch.arange(n, device=owner.device).repeat_interleave(b // n)
    ok = (pos < cap) & (pos >= 0) & active
    at = (sender * n + owner) * cap + pos.clamp(0, cap - 1)
    di = torch.where(ok.unsqueeze(1), d[at], EMPTY)
    pi = torch.where(ok.unsqueeze(1), p[at], 0.0)
    ni = torch.where(ok, need[at], 0)
    return di, pi, ni, dropped


def _query_rank(state, src, threshold, max_items, scfg, ranks):
    """:func:`query` on a rank: out with one ``all_to_all``, the fused read
    on this rank's shard, and ``d, p, need`` back in one more (``p``'s bits
    as int32, so the answers travel unchanged)."""
    n = scfg.num_shards
    (rsrc,), owner, active, pos, dropped, cap = _route(scfg, state, src,
                                                      ranks=ranks)
    d, p, need = mc.query_impl(shard_state(state, 0), rsrc, threshold,
                               scfg.base, max_items)
    k = d.shape[1]
    packed = torch.cat([d, p.view(torch.int32), need.unsqueeze(1)], dim=1)
    back = ranks.all_to_all(packed.view(n, cap, 2 * k + 1)).view(n * cap, -1)
    # un-permute: item i sits at [owner[i], pos[i]]
    ok = (pos < cap) & (pos >= 0) & active
    got = back[owner.to(torch.int64) * cap + pos.clamp(0, cap - 1)]
    di = torch.where(ok.unsqueeze(1), got[:, :k], EMPTY)
    pi = torch.where(ok.unsqueeze(1), got[:, k:2 * k].view(torch.float32), 0.0)
    ni = torch.where(ok, got[:, 2 * k], 0)
    return di, pi, ni, dropped


def maintain_(state: mc.MCState, *, scfg: ShardedConfig, total_threshold: int,
              ranks: Optional[RankGroup] = None, dirty=None) -> mc.MCState:
    """Per-shard maintenance in place: ``maybe_decay_`` on every shard,
    each decided on the device by its own row totals and decaying its own
    rolling block.  With ``ranks``: this rank's shard, no collective."""
    for r in range(_check_ranks(scfg, ranks, state)):
        mc.maybe_decay_(shard_state(state, r), cfg=scfg.base,
                        total_threshold=total_threshold,
                        dirty=_flags(dirty, r))
    return state


def decay_(state: mc.MCState, *, scfg: ShardedConfig,
           ranks: Optional[RankGroup] = None, dirty=None) -> mc.MCState:
    """One unconditional decay step per shard, in place (with ``ranks``:
    this rank's shard, no collective)."""
    for r in range(_check_ranks(scfg, ranks, state)):
        mc.decay_(shard_state(state, r), cfg=scfg.base,
                  dirty=_flags(dirty, r))
    return state


def _windows(state: mc.MCState, n: int):
    """Every row's ``min(n, C)``-item priority window of every shard:
    ``(probs[S, N*k] float32, slots[S, N, k] int64, k)``, a dead entry's
    probability 0.0."""
    slabs = state.slabs
    k = min(n, slabs.cnt.shape[2])
    ord_k = slabs.order[:, :, :k].to(torch.int64)            # [S, N, k] heads
    cnt_k = torch.gather(slabs.cnt, 2, ord_k)
    totf = slabs.tot.clamp(min=1).to(torch.float32)
    prob_k = torch.where(cnt_k > 0,
                         cnt_k.to(torch.float32) / totf.unsqueeze(2), 0.0)
    return prob_k.view(slabs.cnt.shape[0], -1), ord_k, k


def topn_lists(state: mc.MCState, n: int, *, scfg: ShardedConfig):
    """Each shard's local top-n: ``(probs, dsts, srcs)`` ``[S, n]``, each
    shard's list descending, and the live edges no list holds.

    Each row exposes its ``min(n, C)``-item priority window, a shard picks
    its n best edges over its flattened windows (``lax.top_k``'s order:
    the lower position first on ties) and labels them through the row ->
    src reverse map.  A dead entry is EMPTY / 0.0.  Reads ``state`` only."""
    cfg = scfg.base
    slabs = state.slabs
    s, _, c = slabs.cnt.shape
    prob, ord_k, k = _windows(state, n)
    top_p, top_i = _top_k(prob, n)
    live_top = top_p > 0
    row = top_i // k
    slot = ord_k.view(s, -1).gather(1, top_i)
    top_dst = torch.where(
        live_top, slabs.dst.view(s, -1).gather(1, row * c + slot), EMPTY)
    top_src = torch.where(
        live_top, _src_of_row(state, cfg.num_rows).gather(1, row), EMPTY)
    # counts are never negative: a live edge is a nonzero count (one pass)
    live = torch.count_nonzero(slabs.cnt, dim=(1, 2))
    dropped = (live - live_top.sum(dim=1)).sum().to(torch.int32)
    return top_p, top_dst, top_src, dropped


def topn(state: mc.MCState, n: int, *, scfg: ShardedConfig,
         ranks: Optional[RankGroup] = None):
    """The globally descending top-n edges of the whole sharded chain:
    ``(srcs[n], dsts[n], probs[n], dropped)``.

    The plain path: the S local answers of :func:`topn_lists` k-way merged
    by ``ops.topn_merge``.  On the card (``impl`` auto or cuda on a CUDA
    state) ``ops.topn_windows`` reads every shard's windows in one pass
    and merges the blocks' lists: the same bits, no sort.
    ``dropped`` counts the live edges the shards could not expose to the
    merge.  Reads ``state`` only.  With ``ranks``: this rank's own list
    (the same two paths at S = 1), every rank's gathered, the S lists
    merged by ``ops.topn_merge`` and the drops summed; the same answer on
    every rank."""
    if ranks is not None:
        _check_ranks(scfg, ranks, state)
        return _topn_rank(state, n, scfg, ranks)
    slabs = state.slabs
    impl = scfg.base.impl
    if not ops._use_ref(impl, slabs.cnt):
        return ops.topn_windows(slabs.cnt, slabs.order, slabs.tot, slabs.dst,
                                *state.src_table, n=n, impl=impl)
    probs, dsts, srcs, dropped = topn_lists(state, n, scfg=scfg)
    return (*ops.topn_merge(probs, dsts, srcs, n=n, impl=impl), dropped)


def _topn_rank(state, n, scfg, ranks):
    """:func:`topn` on a rank: its list and drop count in one
    ``all_gather`` (``[S, 3n+1]`` int32, the probabilities' bits), the
    merge of the S lists (the lowest rank first on ties) and the drops'
    sum."""
    slabs = state.slabs
    impl = scfg.base.impl
    if not ops._use_ref(impl, slabs.cnt):
        srcs, dsts, probs, dropped = ops.topn_windows(
            slabs.cnt, slabs.order, slabs.tot, slabs.dst, *state.src_table,
            n=n, impl=impl)
    else:
        probs, dsts, srcs, dropped = topn_lists(state, n, scfg=scfg)
    mine = torch.cat([probs.reshape(n).view(torch.int32), dsts.reshape(n),
                      srcs.reshape(n), dropped.to(torch.int32).reshape(1)])
    every = ranks.all_gather(mine)
    lists = (every[:, :n].contiguous().view(torch.float32),
             every[:, n:2 * n].contiguous(), every[:, 2 * n:3 * n].contiguous())
    return (*ops.topn_merge(*lists, n=n, impl=impl),
            every[:, 3 * n].sum().to(torch.int32))


# ---------------------------------------------------------------------------
# functional callables (the reference's ``make_*_fn``; a RankGroup for its
# mesh)
# ---------------------------------------------------------------------------


def make_update_fn(scfg: ShardedConfig, ranks: Optional[RankGroup] = None):
    """``(state, src[B], dst[B], w[B]) -> state``, functional: the src
    tables, slabs, scalars and (with the dst hash) row hashes are copied,
    then :func:`update_` writes the copy."""
    def fn(state, src, dst, w):
        own = mc.private_copy(state, dh=scfg.base.use_dst_hash)
        return update_(own, src, dst, w, scfg=scfg, ranks=ranks)
    return fn


def make_update_fn_(scfg: ShardedConfig, ranks: Optional[RankGroup] = None):
    """``(state, src[B], dst[B], w[B], *, dirty=None, table_dirty=None) ->
    state``, the owner program: :func:`update_` under ``scfg``, writing
    into ``state``."""
    def fn(state, src, dst, w, *, dirty=None, table_dirty=None):
        return update_(state, src, dst, w, scfg=scfg, ranks=ranks,
                       dirty=dirty, table_dirty=table_dirty)
    return fn


def make_maintain_fn_(scfg: ShardedConfig, total_threshold: int,
                      ranks: Optional[RankGroup] = None):
    """``(state, *, dirty=None) -> state``, the owner program:
    :func:`maintain_` under ``scfg``, writing into ``state``."""
    def fn(state, *, dirty=None):
        return maintain_(state, scfg=scfg, total_threshold=total_threshold,
                         ranks=ranks, dirty=dirty)
    return fn


def make_query_fn(scfg: ShardedConfig, threshold: float, max_items: int,
                  ranks: Optional[RankGroup] = None):
    """``(state, src[B]) -> (dsts[B, max_items], probs[B, max_items],
    n_needed[B], dropped[num_shards])`` (with ``ranks``: this rank's
    slice in, its answers and ``dropped[1]`` out)."""
    def fn(state, src):
        return query(state, src, threshold, max_items, scfg=scfg, ranks=ranks)
    return fn


def make_maintain_fn(scfg: ShardedConfig, total_threshold: int,
                     ranks: Optional[RankGroup] = None):
    """``state -> state``, functional: the per-shard rolling maintenance
    step (decay one block on every shard whose row totals crossed
    ``total_threshold``) on a copy."""
    def fn(state):
        own = mc.private_copy(state, table=False, dh=scfg.base.use_dst_hash)
        return maintain_(own, scfg=scfg, total_threshold=total_threshold,
                         ranks=ranks)
    return fn


def make_decay_fn(scfg: ShardedConfig, ranks: Optional[RankGroup] = None):
    """``state -> state``, functional: one unconditional decay step per
    shard on a copy."""
    def fn(state):
        own = mc.private_copy(state, table=False, dh=scfg.base.use_dst_hash)
        return decay_(own, scfg=scfg, ranks=ranks)
    return fn


def make_topn_fn(scfg: ShardedConfig, n: int,
                 ranks: Optional[RankGroup] = None):
    """``state -> (srcs[n], dsts[n], probs[n], dropped)``: the globally
    descending top-n edges and the live edges not exposed to the merge
    (with ``ranks``: the same on every rank)."""
    def fn(state):
        return topn(state, n, scfg=scfg, ranks=ranks)
    return fn
