"""N -> M elastic restore: re-route a snapshot's live edges (DESIGN.md §10).

Counterpart of ``repro.persist.reshard``.  Arrays snapshotted at N shards
cannot be loaded onto M shards: row placement is a function of the ownership
map, so changing the shard count moves *every node whose bucket moved* — the
slabs must be rebuilt, not resliced.  An MCPrioQ is fully described by its
live edge multiset, ``(src, dst, cnt)`` triples: :func:`extract_edges` lists
them, and re-ingestion feeds them back through the sharded update path
(``core.sharded.update_`` with ``max_new_per_batch=0``: every re-ingested
item is a new edge, and a bounded prefix would defer the rest), so the
restored chain obeys every routing/capacity invariant by construction.

* **Counts are conserved.**  Each unique ``(src, dst)`` appears once with
  weight ``cnt``; pre-aggregation passes it through untouched and the
  new-edge pass inserts it with that exact count, so ``cnt``/``tot`` on the
  restored chain equal the snapshot's wherever capacity suffices (drops are
  counted, as everywhere else: a src whose probe window is full is counted
  in ``dropped_probes``).
* **Zero routing drops by planning.**  :func:`plan_batches` packs each
  batch with at most ``bucket_capacity`` items per (sender slice,
  destination shard), so the routing provably never drops.

The order permutation is *not* conserved — it is approximate state by the
paper's own contract (A2).  :func:`settle_order` (functional) and
:func:`settle_order_` (the owner's, in place) restore the exact descending
order after ingestion.

At full width a stacked state holds hundreds of millions of slots, so the
scan runs on the state's device and only the live triples cross to the
host; the plan keeps index arrays, not Python lists; the settle sorts
blocks of rows.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from repro_torch.core import mcprioq as mc
from repro_torch.core import slab as sl

#: rows sorted per block by the settle (bounds its sort's temporaries)
SETTLE_BLOCK_ROWS = 1 << 16


def extract_edges(state: mc.MCState
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Live edges of a (possibly shard-stacked) ``MCState``, as host arrays.

    Returns ``(src, dst, cnt)`` int32 arrays in deterministic
    (shard, row, slot) order, the reference's.  Each shard's row -> src map
    is rebuilt from its src table, the live slots are found by ``nonzero``
    on the device, and only their triples are copied to the host.  Rows
    whose src id cannot be recovered from the hash table are skipped
    (cannot happen while the src-table invariant holds).
    """
    keys, vals = state.src_table.keys, state.src_table.vals
    dst, cnt = state.slabs.dst, state.slabs.cnt
    if keys.dim() == 1:  # unsharded: treat as one shard
        keys, vals = keys.unsqueeze(0), vals.unsqueeze(0)
        dst, cnt = dst.unsqueeze(0), cnt.unsqueeze(0)
    num_rows, c = cnt.shape[1], cnt.shape[2]
    srcs, dsts, cnts = [], [], []
    for s in range(keys.shape[0]):
        valid = (keys[s] >= 0) & (vals[s] >= 0) & (vals[s] < num_rows)
        # invalid table lanes land on a sink row, sliced off
        row_src = torch.full((num_rows + 1,), -1, dtype=torch.int32,
                             device=keys.device).scatter_(
            0, torch.where(valid, vals[s], num_rows).to(torch.int64),
            keys[s])[:num_rows]
        live = (cnt[s] > 0) & (row_src >= 0).unsqueeze(1)
        flat = torch.nonzero(live.reshape(-1)).view(-1)   # row-major
        srcs.append(row_src[flat // c].cpu())
        dsts.append(dst[s].reshape(-1)[flat].cpu())
        cnts.append(cnt[s].reshape(-1)[flat].cpu())
    return tuple(torch.cat(x).to(torch.int32).numpy()
                 for x in (srcs, dsts, cnts))


def gather_edges(edges: Tuple[np.ndarray, np.ndarray, np.ndarray], ranks
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The edge lists of a rank group (``ranks`` a
    ``sharding.ranks.RankGroup``; ``edges`` this rank's
    :func:`extract_edges`, or none) concatenated in rank order on every
    rank: with one shard a rank that is the one-card (shard, row, slot)
    order, which decides the re-ingested bits.  Every rank calls."""
    every = ranks.all_gather_cat(torch.from_numpy(
        np.stack([np.asarray(x, np.int32) for x in edges], axis=1)))
    return tuple(np.ascontiguousarray(every[:, i].numpy()) for i in range(3))


def plan_batches(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                 owner: np.ndarray, num_shards: int, slice_len: int,
                 bucket_capacity: int
                 ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Pack edges into routed-update batches that provably never drop.

    The routed path slices a global batch into ``num_shards`` contiguous
    per-shard slices of ``slice_len`` items and enforces bucket capacity
    **per (source slice, destination shard)** pair, so that pair count is
    the constraint to plan against.  Greedy fill: each slice draws at most
    ``bucket_capacity`` items per destination queue (round-robin start so
    skewed owners don't monopolise slice 0) and at most ``slice_len``
    total; slice tails pad with inactive (-1) items, which consume no
    bucket capacity.  Yields ``(src, dst, w)`` global batches of exactly
    ``num_shards * slice_len`` items, the reference's batches.

    Each destination's queue is a slice of one stable argsort of the owners
    (its edges in index order; an owner outside ``[0, num_shards)`` sorts
    last and is planned nowhere, as in the reference) with a head offset, so
    the plan holds index arrays, not lists, at any edge count.  The owners
    are sorted as 16-bit keys where they fit, which numpy sorts by radix.
    Covers every edge exactly once.
    """
    owner = np.asarray(owner)
    key = np.where((owner >= 0) & (owner < num_shards), owner, num_shards)
    key = key.astype(np.uint16 if num_shards < 2 ** 16 else np.int64)
    queue = np.argsort(key, kind="stable")
    bounds = np.searchsorted(key[queue], np.arange(num_shards + 1))
    heads, ends = bounds[:-1].copy(), bounds[1:]
    wave = 0
    while (heads < ends).any():
        g_src = np.full((num_shards, slice_len), -1, np.int32)
        g_dst = np.zeros((num_shards, slice_len), np.int32)
        g_w = np.zeros((num_shards, slice_len), np.int32)
        for s in range(num_shards):
            fill = 0
            for j in range(num_shards):
                d = (s + wave + j) % num_shards
                room = min(bucket_capacity, slice_len - fill)
                take = min(room, int(ends[d] - heads[d]))
                if take <= 0:
                    continue
                idx = queue[heads[d]:heads[d] + take]
                heads[d] += take
                g_src[s, fill:fill + take] = src[idx]
                g_dst[s, fill:fill + take] = dst[idx]
                g_w[s, fill:fill + take] = w[idx]
                fill += take
                if fill >= slice_len:
                    break
        wave += 1
        yield g_src.reshape(-1), g_dst.reshape(-1), g_w.reshape(-1)


def _settle(cnt: torch.Tensor, out: torch.Tensor) -> None:
    """Exact descending order of every row of ``cnt`` written into ``out``
    (same shape), one block of rows at a time."""
    c = cnt.shape[-1]
    rows, dest = cnt.reshape(-1, c), out.view(-1, c)
    for r0 in range(0, rows.shape[0], SETTLE_BLOCK_ROWS):
        block = slice(r0, r0 + SETTLE_BLOCK_ROWS)
        dest[block].copy_(sl.full_sort(rows[block], None))


def settle_order(state: mc.MCState) -> mc.MCState:
    """Exact descending order on every row (stable sort, ties to the lower
    slot id — the same tie-break a fully settled odd-even network reaches
    from slot order), in a new ``order``; the state given is not written.
    Applied once after re-ingestion; subsequent updates resume the normal
    approximate odd-even maintenance."""
    order = torch.empty_like(state.slabs.order)
    _settle(state.slabs.cnt, order)
    return state._replace(slabs=state.slabs._replace(order=order))


def settle_order_(state: mc.MCState) -> mc.MCState:
    """:func:`settle_order` for the state's owner: written into
    ``state.slabs.order`` itself, which it returns."""
    _settle(state.slabs.cnt, state.slabs.order)
    return state
