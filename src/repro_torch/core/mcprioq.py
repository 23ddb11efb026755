"""MCPrioQ: online sparse Markov chain with priority-ordered edge queries.

Counterpart of ``repro.core.mcprioq`` on torch tensors.

Data layout
-----------
  * src hash table  : node-id -> row index into the slabs (open addressing)
  * slabs           : per-row stable edge slots (dst, cnt) + ``order`` perm
  * two counters    : per-edge ``cnt`` and per-row ``tot``; probability is
                      ``cnt/tot`` computed at query time (paper §II.3)
  * optional dst hash: per-row open-addressing table dst -> slot (paper
                      §II.2, ``use_dst_hash``); slots are stable, so the
                      hash survives reordering.  The new-edge pass edits
                      it, a decay tombstones the lanes whose slot died, and
                      a full rebuild (``ops.dh_rebuild_``), decided on the
                      device, runs once the tombstones cross
                      ``dh_rebuild_fraction`` of its capacity.

Update semantics (paper §II.A, batched)
---------------------------------------
A batch of B transitions runs through a three-stage pipeline:
  * **pre-aggregation**: the batch is sorted by (src, dst) and duplicate
    edges are summed into one item each, so B raw transitions collapse to U
    unique edges before either path runs.
  * **update of edge** (normal case): the edge already exists — a fused
    batched increment via :func:`repro_torch.kernels.ops.slab_update`.
  * **new edge** (rare case): new-edge items are stable-partitioned to a
    ``max_new_per_batch`` prefix and handled by one deterministic sequential
    pass (:func:`repro_torch.kernels.ops.slow_path`) that allocates
    rows/slots and applies Space-Saving tail replacement when a row is full.
    Edges past the prefix are counted in ``deferred_new`` (the caller may
    resubmit).
Afterwards ``sort_passes`` odd-even passes (``ops.oddeven_sort``) restore
approximate order — the paper's lock-free bubble sort.

Two kinds of write.  The functional ``update_batch``, ``decay`` and
``maybe_decay`` return a new ``MCState`` and never write into a tensor of
the state they were given: a reader may go on holding the old one.  Their
twins with a trailing underscore, ``update_batch_``, ``decay_`` and
``maybe_decay_``, are for the state's owner — a caller that holds the only
reference to every tensor of the state (one from :func:`init`, or a private
copy): they write into its tensors and return that same state, with no copy
(the port's counterpart of calling the reference's jitted functions with
the state donated).  Each pair shares one body; only who owns the buffers
differs.  An owner call takes ``dirty`` (None, or uint8 [N]) and flags every
row whose ``cnt``, ``dst``, ``tot`` or ``order`` it changed; an update also
takes ``table_dirty`` (None, or uint8 [``hashtable.flag_count(T)``]) and
flags the group of every src-table slot its new-edge pass writes, the only
write of the table (``core.epoch.BackBufferLearner`` catches its back
buffer up by those flags).  On a CUDA state ``update_batch(_)``, the
queries, ``decay(_)`` and ``maybe_decay_`` launch their kernels without any
device->host synchronisation.

The ten scalar leaves (``n_rows`` .. ``dh_tombstones``, in ``MCState``
order) are views of one int32 tensor made by :func:`init`; an owner call
needs them so (the new-edge pass writes the first four as one tensor, the
rebuild the last two).

Kernel dispatch is selected by ``MCConfig.impl`` (``auto``/``ref``/``cuda``).
``update_batch_reference`` keeps the O(B) sequential semantics as an oracle.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.core import hashtable as ht
from repro_torch.core import slab as sl
from repro_torch.core.device import resolve_device
from repro_torch.core.hashtable import EMPTY, TOMB, HashTable
from repro_torch.core.slab import Slabs
from repro_torch.kernels import decay_sort, dh_rebuild, ops

__all__ = [
    "EMPTY", "TOMB", "HashTable", "Slabs", "MCConfig", "MCState",
    "resolve_device", "check_cuda_limits", "init", "private_copy",
    "map_leaves", "stack_states",
    "lookup_rows", "update_batch", "update_batch_", "update_batch_reference",
    "query_impl", "query_threshold", "query_topk", "decay", "decay_",
    "maybe_decay", "maybe_decay_", "check_invariants", "maintenance_stats",
    "counter_stats",
]

_IMPLS = ("auto", "ref", "cuda")


def _next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


@dataclasses.dataclass(frozen=True)
class MCConfig:
    """Static configuration (hashable)."""

    num_rows: int = 1024          # max distinct src nodes tracked
    capacity: int = 128           # max out-degree tracked per src (C)
    table_size: int = 0           # src hash slots; 0 -> 4 * num_rows pow2
    max_probes: int = 64
    sort_passes: int = 1          # odd-even passes per update batch
    use_dst_hash: bool = False    # paper's optional dst->slot hash table
    dst_table_size: int = 0       # per-row; 0 -> 4 * capacity pow2
    max_new_per_batch: int = 0    # slow-path prefix; 0 = unbounded (batch)
    impl: str = "auto"            # kernel dispatch: auto | ref | cuda
    # inference path: fused in-kernel row gather vs pre-ordered rows;
    # 0 = auto-pick the walk's chunk count from capacity
    fused_query: bool = True
    query_chunks: int = 0
    # maintenance: 0 = stop-the-world decay; R > 0 = rolling decay that
    # halves one R-row block per call (bounded per-call work)
    decay_block_rows: int = 0
    # full dst-hash rebuild once decay tombstones exceed this fraction of
    # the total dst-hash capacity (num_rows * dst_table_size)
    dh_rebuild_fraction: float = 0.25

    def __post_init__(self):
        if self.impl not in _IMPLS:
            raise ValueError(f"impl must be one of {_IMPLS}, got {self.impl!r}")

    def resolved_table_size(self) -> int:
        return self.table_size or _next_pow2(4 * self.num_rows)

    def resolved_dst_table_size(self) -> int:
        return self.dst_table_size or _next_pow2(4 * self.capacity)

    def resolved_max_new(self, batch: int) -> int:
        if self.max_new_per_batch <= 0:
            return batch
        return min(self.max_new_per_batch, batch)

    def resolved_decay_rows(self) -> int:
        """Rows decayed per call: the block size, clamped to the table."""
        if self.decay_block_rows <= 0:
            return self.num_rows
        return min(self.decay_block_rows, self.num_rows)

    def dh_rebuild_threshold(self) -> int:
        """Tombstones above which a decay rebuilds every row hash: the
        reference's ``int32(dh_rebuild_fraction * num_rows * H)``."""
        h = self.resolved_dst_table_size()
        return min(int(self.dh_rebuild_fraction * self.num_rows * h), 2 ** 31 - 1)


class MCState(NamedTuple):
    src_table: HashTable   # node-id -> row
    slabs: Slabs
    n_rows: torch.Tensor      # int32[]   allocated rows
    # optional per-row dst hash (one-column arrays while it is disabled)
    dh_keys: torch.Tensor     # int32[N, H]
    dh_vals: torch.Tensor     # int32[N, H]
    # observability counters (drops are the price of fixed shapes)
    dropped_rows: torch.Tensor    # srcs dropped because num_rows exhausted
    dropped_probes: torch.Tensor  # items dropped on probe-window overflow
    evictions: torch.Tensor       # Space-Saving tail replacements
    deferred_new: torch.Tensor    # new edges past the max_new_per_batch prefix
    route_dropped: torch.Tensor   # items dropped on routing-bucket overflow
    # maintenance state + observability
    decay_cursor: torch.Tensor    # next row block for rolling decay
    decay_steps: torch.Tensor     # decay calls applied (blocks, not sweeps)
    dh_rebuilds: torch.Tensor     # full dst-hash rebuilds triggered
    dh_tombstones: torch.Tensor   # live decay tombstones across all row hashes


SCALAR_FIELDS = tuple(f for f in MCState._fields
                      if f not in ("src_table", "slabs", "dh_keys", "dh_vals"))
_COUNTERS = 4   # n_rows, dropped_rows, dropped_probes, evictions


def check_cuda_limits(cfg: MCConfig, device) -> None:
    """Refuse a configuration the CUDA kernels cannot run, before a state is
    built on ``device``: on a CUDA device with ``impl`` auto or cuda, a row
    wider than the decay kernel sorts (``decay_sort.MAX_CAPACITY``, the
    smallest width limit of the kernels), or a row hash wider than the
    rebuild kernel stages in shared memory (``dh_rebuild.MAX_TABLE``).  No
    fallback: ``impl="ref"`` runs the plain versions at any width."""
    if torch.device(device).type != "cuda" or cfg.impl == "ref":
        return
    if cfg.capacity > decay_sort.MAX_CAPACITY:
        raise ValueError(
            f"capacity {cfg.capacity} is above {decay_sort.MAX_CAPACITY}, the "
            f"widest row the CUDA decay kernel (kernels/decay_sort.py) sorts "
            f"in one warp's registers")
    h = cfg.resolved_dst_table_size()
    if cfg.use_dst_hash and h > dh_rebuild.MAX_TABLE:
        raise ValueError(
            f"dst_table_size {h} is above {dh_rebuild.MAX_TABLE}, the widest "
            f"row hash the CUDA rebuild kernel (kernels/dh_rebuild.py) stages "
            f"in shared memory")


def init(cfg: MCConfig, device=None) -> MCState:
    """Empty chain on ``device`` (default: the current CUDA device; raises
    when there is none).  Its scalar leaves are views of one int32 tensor."""
    dev = resolve_device(device)
    check_cuda_limits(cfg, dev)
    n, c = cfg.num_rows, cfg.capacity
    h = cfg.resolved_dst_table_size() if cfg.use_dst_hash else 1

    def int32(value: int) -> torch.Tensor:
        return torch.full((), value, dtype=torch.int32, device=dev)

    state = MCState(
        src_table=ht.make(cfg.resolved_table_size(), device=dev),
        slabs=sl.make(n, c, device=dev),
        n_rows=int32(0),
        dh_keys=torch.full((n, h), EMPTY, dtype=torch.int32, device=dev),
        dh_vals=torch.full((n, h), EMPTY, dtype=torch.int32, device=dev),
        dropped_rows=int32(0),
        dropped_probes=int32(0),
        evictions=int32(0),
        deferred_new=int32(0),
        route_dropped=int32(0),
        decay_cursor=int32(0),
        decay_steps=int32(0),
        dh_rebuilds=int32(0),
        dh_tombstones=int32(0),
    )
    return private_copy(state, table=False, slabs=(), dh=False)


def scalars_of(state: MCState, count: int = len(SCALAR_FIELDS)) -> torch.Tensor:
    """The first ``count`` scalar leaves as one int32 [count] view of the
    tensor they share; raises when they are not consecutive elements of
    one tensor (a state from :func:`init`, :func:`private_copy` or a
    functional write has them so)."""
    leaves = [getattr(state, f) for f in SCALAR_FIELDS[:count]]
    first = leaves[0]
    packed = all(x.dim() == 0 and x.dtype == torch.int32
                 and x.device == first.device
                 and x.untyped_storage().data_ptr()
                 == first.untyped_storage().data_ptr()
                 and x.data_ptr() == first.data_ptr() + 4 * i
                 for i, x in enumerate(leaves))
    if not packed:
        raise ValueError(
            f"the scalar leaves {SCALAR_FIELDS[:count]} are not consecutive "
            f"elements of one int32 tensor; an owner call takes a state made "
            f"by init() or private_copy()")
    return first.as_strided((count,), (1,))


def private_copy(state: MCState, *, table: bool = True,
                 slabs=Slabs._fields, dh: bool = True) -> MCState:
    """A copy of ``state`` that the owner calls may write: the src table
    (``table``), the slab arrays named in ``slabs`` and the row hashes
    ``dh_keys``/``dh_vals`` (``dh``) cloned, the scalar leaves packed into
    one new int32 tensor; the other leaves shared with ``state``.  Works
    on a stacked state too (``core.sharded``: every leaf with a leading
    ``[S]``), whose scalars become the columns of one int32 ``[S, 10]``."""
    scalars = torch.stack([getattr(state, f) for f in SCALAR_FIELDS], dim=-1)
    copy = state._replace(**{f: scalars[..., i]
                             for i, f in enumerate(SCALAR_FIELDS)})
    if table:
        copy = copy._replace(src_table=HashTable(
            *(x.clone() for x in state.src_table)))
    if dh:
        copy = copy._replace(dh_keys=state.dh_keys.clone(),
                             dh_vals=state.dh_vals.clone())
    return copy._replace(slabs=state.slabs._replace(
        **{f: getattr(state.slabs, f).clone() for f in slabs}))


def map_leaves(fn, *states: MCState) -> MCState:
    """``fn`` over the leaves of ``states`` (nested tuples kept)."""
    def one(*xs):
        if isinstance(xs[0], tuple):
            return type(xs[0])(*(one(*ys) for ys in zip(*xs)))
        return fn(*xs)
    return one(*states)


def stack_states(states: Sequence[MCState]) -> MCState:
    """S chains as one stacked state (copies), as ``core.sharded`` keeps
    them: every leaf gains a leading ``[S]``, the scalar leaves become the
    columns of one int32 ``[S, 10]`` tensor."""
    stacked = map_leaves(lambda *xs: torch.stack(xs), *states)
    return private_copy(stacked, table=False, slabs=(), dh=False)


def _device_of(state: MCState) -> torch.device:
    return state.slabs.cnt.device


def _to_state_device(state: MCState, x, dtype) -> torch.Tensor:
    """Input given as a tensor, numpy array or list, as a contiguous
    ``dtype`` tensor on the state's device (a strided view, such as one
    column of a batch, is copied: the kernels take contiguous inputs)."""
    return torch.as_tensor(x, device=_device_of(state)).to(dtype).contiguous()


# ---------------------------------------------------------------------------
# lookups
# ---------------------------------------------------------------------------


def lookup_rows(state: MCState, src: torch.Tensor, cfg: MCConfig):
    """Batched src -> row. Returns ``(rows[B], found[B])``; row 0 when missing.

    The shared open-addressing probe kernel in its flat mode
    (``ops.ht_find`` with ``miss=0``) writes the row, 0 for a missing src,
    and ``found`` as bool itself: one launch at the head of every query and
    update, nothing around it.
    """
    table = state.src_table
    return ops.ht_find(_to_state_device(state, src, torch.int32), table.keys,
                       table.vals, max_probes=cfg.max_probes, miss=0,
                       impl=cfg.impl)


def _find_slots(state: MCState, rows: torch.Tensor, dst: torch.Tensor,
                cfg: MCConfig):
    """Batched (row, dst) -> slot via the dst hash or a row scan (paper
    §II.2).  The hash is one launch of the shared probe kernel in its
    stacked mode (``ops.dh_find``); slot 0 where not found."""
    if cfg.use_dst_hash:
        slots, found = ops.dh_find(rows, dst, state.dh_keys, state.dh_vals,
                                   max_probes=cfg.max_probes, impl=cfg.impl)
        return torch.where(found, slots, 0), found
    return sl.find_slot(state.slabs, rows.to(torch.int64), dst)


# ---------------------------------------------------------------------------
# update
# ---------------------------------------------------------------------------


def _aggregate_batch(src, dst, w, active):
    """Collapse in-batch duplicates: B items -> U unique (src, dst) edges.

    Sorts the batch by (inactive, src, dst) — inactive items sink to the
    tail — and sums weights into the first occurrence (*head*) of each
    unique edge.  Returns ``(src, dst, w, head, pos)`` in sorted order where
    ``head`` marks the unique-edge representatives, ``pos`` is each head
    edge's first-occurrence position in the original batch (for
    arrival-order tie-breaks downstream); non-head slots carry
    ``src = dst = -1`` and ``w = 0``.

    The three sort keys are packed into one int64 (active ids are
    non-negative int32; inactive items, whose ids may be negative, all get
    the same key above every active one — their relative order reaches no
    output).  The sort is stable, so the head of a segment is also its
    earliest arrival.
    """
    b = src.shape[0]
    key = (src.to(torch.int64) << 31) | dst.to(torch.int64)
    key = torch.where(active, key, 1 << 62)
    perm = torch.sort(key, stable=True).indices
    src_s, dst_s, w_s, act_s = src[perm], dst[perm], w[perm], active[perm]
    first = torch.ones_like(act_s)
    first[1:] = (src_s[1:] != src_s[:-1]) | (dst_s[1:] != dst_s[:-1])
    head = act_s & first
    # segment id of each item = index of its head
    seg = (torch.cumsum(head, dim=0) - 1).clamp(0, max(b - 1, 0))
    sums = torch.zeros_like(w_s).index_add_(0, seg, torch.where(act_s, w_s, 0))
    u_w = torch.where(head, sums[seg], 0).to(w.dtype)
    u_src = torch.where(head, src_s, -1)
    u_dst = torch.where(head, dst_s, -1)
    u_pos = torch.where(head, perm, b).to(torch.int32)
    return u_src, u_dst, u_w, head, u_pos


def _take_new_prefix(src, dst, w, pos, new_mask, limit: int):
    """Stable-partition new-edge items to the front, truncated to ``limit``.

    Ties inside the partition break by ``pos`` (original arrival order), so
    a tight ``max_new_per_batch`` admits the earliest-arriving new edges
    instead of starving high node-ids.  Returns ``(src[limit], dst[limit],
    w[limit], mask[limit], overflow)`` where ``overflow`` counts new edges
    that did not fit in the prefix.
    """
    b = src.shape[0]
    key = (~new_mask).to(torch.int64) * (b + 1) + pos.to(torch.int64)
    perm = torch.sort(key, stable=True).indices[:limit]
    p_mask = new_mask[perm]
    overflow = (new_mask.sum() - p_mask.sum()).to(torch.int32)
    return src[perm], dst[perm], w[perm], p_mask, overflow


def _slow_path(state: MCState, src, dst, w, active, cfg: MCConfig,
               dirty=None, table_dirty=None) -> MCState:
    """Insert pass for new edges / new rows (the paper's rare case), through
    the kernel layer (``ops.slow_path_``), written into ``state``'s src
    table, ``dst``/``cnt``/``tot``, counters and, with the dst hash, the
    row hashes: the caller owns them.  Returns ``state``.

    Deterministic (batch order), fully masked — inactive items are no-ops.
    """
    slabs, table = state.slabs, state.src_table
    dh = (dict(dh_keys=state.dh_keys, dh_vals=state.dh_vals)
          if cfg.use_dst_hash else {})
    ops.slow_path_(table.keys, table.vals, slabs.dst, slabs.cnt, slabs.tot,
                   slabs.order, scalars_of(state, _COUNTERS), src, dst, w,
                   active, max_probes=cfg.max_probes, dirty=dirty,
                   table_dirty=table_dirty, impl=cfg.impl, **dh)
    return state


def _batch_inputs(state: MCState, src, dst, weights, mask):
    src = _to_state_device(state, src, torch.int32)
    dst = _to_state_device(state, dst, torch.int32)
    w = (torch.ones_like(src) if weights is None
         else _to_state_device(state, weights, torch.int32))
    m = (torch.ones_like(src, dtype=torch.bool) if mask is None
         else _to_state_device(state, mask, torch.bool))
    return src, dst, w, m & (src >= 0) & (dst >= 0)


def _update(state: MCState, src, dst, weights, mask, cfg: MCConfig, *,
            owner: bool, dirty=None, table_dirty=None) -> MCState:
    """The body of :func:`update_batch` and :func:`update_batch_`: every
    kernel writes into ``state`` except the odd-even pass, which the
    functional twin lets write a fresh ``order`` (it writes every row then;
    the owner's in place writes only the rows that changed)."""
    src, dst, w, m = _batch_inputs(state, src, dst, weights, mask)
    b = src.shape[0]

    # (1) pre-aggregate: B items -> U unique edges (duplicates never pay a
    # slow-path step again)
    u_src, u_dst, u_w, u_act, u_pos = _aggregate_batch(src, dst, w, m)

    # (2) classify against the pre-state: edge exists <=> fast
    rows0, found_src0 = lookup_rows(state, u_src, cfg)
    _, found_d0 = _find_slots(state, rows0, u_dst, cfg)
    fast = u_act & found_src0 & found_d0

    # (3) fast path: fused batched increment through the kernel layer (the
    # batched equivalent of the paper's atomic fetch-add)
    slabs = state.slabs
    ops.slab_update_(torch.where(fast, rows0, -1), u_dst, u_w, slabs.dst,
                     slabs.cnt, slabs.tot, dirty=dirty, impl=cfg.impl)

    # (4) slow path: new edges only, partitioned to a bounded prefix so the
    # sequential pass is O(max_new)
    new_mask = u_act & ~fast
    limit = cfg.resolved_max_new(b)
    p_src, p_dst, p_w, p_mask, overflow = _take_new_prefix(
        u_src, u_dst, u_w, u_pos, new_mask, limit)
    state.deferred_new.add_(overflow)
    _slow_path(state, p_src, p_dst, p_w, p_mask, cfg, dirty, table_dirty)

    # (5) lock-free bubble sort, through the kernel layer
    if cfg.sort_passes and owner:
        ops.oddeven_sort_(slabs.cnt, slabs.order, passes=cfg.sort_passes,
                          dirty=dirty, impl=cfg.impl)
    elif cfg.sort_passes:
        state = state._replace(slabs=slabs._replace(order=ops.oddeven_sort(
            slabs.cnt, slabs.order, passes=cfg.sort_passes, impl=cfg.impl)))
    return state


def update_batch(
    state: MCState,
    src,
    dst,
    weights=None,
    mask=None,
    *,
    cfg: MCConfig,
) -> MCState:
    """Apply a batch of transitions ``src[i] -> dst[i]`` (paper §II.A).

    Pipeline: pre-aggregate duplicates, fused fast-path increment
    (``ops.slab_update_``), bounded sequential slow path for new edges
    (``ops.slow_path_``; an empty pass is one short launch), then
    ``cfg.sort_passes`` odd-even passes (``ops.oddeven_sort``).  Functional:
    the kernels write into copies of what they write (the src table,
    ``dst``/``cnt``/``tot``, the scalars, the row hashes with the dst hash
    on) and a fresh ``order``.
    """
    return _update(private_copy(state, slabs=("dst", "cnt", "tot"),
                                dh=cfg.use_dst_hash),
                   src, dst, weights, mask, cfg, owner=False)


def update_batch_(state: MCState, src, dst, weights=None, mask=None, *,
                  cfg: MCConfig, dirty=None, table_dirty=None) -> MCState:
    """:func:`update_batch` for the state's owner: written into ``state``'s
    own tensors, which it returns (no copy; ``order`` rows that the odd-even
    pass leaves as they were are not rewritten).  ``dirty`` (uint8 [N]):
    every row changed is flagged; ``table_dirty`` (uint8
    [``hashtable.flag_count(T)``]): every src-table slot group written."""
    return _update(state, src, dst, weights, mask, cfg, owner=True,
                   dirty=dirty, table_dirty=table_dirty)


def update_batch_reference(
    state: MCState,
    src,
    dst,
    weights=None,
    mask=None,
    *,
    cfg: MCConfig,
) -> MCState:
    """Pre-kernel oracle for :func:`update_batch` (the seed implementation).

    Inline scatter-add fast path + an O(B) sequential slow path that walks
    every batch item.  Kept as the semantic ground truth for equivalence
    tests; ``max_new_per_batch`` is deliberately ignored here.
    """
    src, dst, w, m = _batch_inputs(state, src, dst, weights, mask)

    # classify against the pre-state: edge exists <=> fast
    rows0, found_src0 = lookup_rows(state, src, cfg)
    slots0, found_d0 = _find_slots(state, rows0, dst, cfg)
    fast = m & found_src0 & found_d0

    # fast path: scatter-add (duplicates aggregate, like contended atomics)
    # into copies of what this function writes
    state = private_copy(state, slabs=("dst", "cnt", "tot"),
                         dh=cfg.use_dst_hash)
    add_w = torch.where(fast, w, 0)
    slabs = state.slabs
    rows64 = rows0.to(torch.int64)
    flat = rows64 * cfg.capacity + slots0.to(torch.int64)
    slabs.cnt.view(-1).index_add_(0, flat, add_w)
    slabs.tot.index_add_(0, rows64, add_w)

    # slow path: everything else, sequential + masked
    _slow_path(state, src, dst, w, m & ~fast, cfg)

    # lock-free bubble sort, vectorised
    slabs = state.slabs
    order = sl.oddeven_passes(slabs.cnt, slabs.order, cfg.sort_passes)
    return state._replace(slabs=Slabs(slabs.dst, slabs.cnt, slabs.tot, order))


# ---------------------------------------------------------------------------
# inference
# ---------------------------------------------------------------------------


def _ordered_rows(state: MCState, src: torch.Tensor, cfg: MCConfig):
    """Gather counts/dsts of each queried row in priority order.

    The **unfused** layout transform (three O(B*C) gathers in plain torch)
    kept as the baseline the fused path must match bit for bit
    (``cfg.fused_query=False``): counts of unknown srcs are zeroed so the
    walk's liveness test (``c > 0``) subsumes the ``found`` mask.
    """
    rows, found = lookup_rows(state, src, cfg)
    r = rows.to(torch.int64)
    order = state.slabs.order[r].to(torch.int64)              # [B, C]
    c = torch.gather(state.slabs.cnt[r], 1, order)
    d = torch.gather(state.slabs.dst[r], 1, order)
    c = torch.where(found.unsqueeze(1), c, 0)
    return c, d, state.slabs.tot[r], found


def query_impl(state: MCState, src, threshold, cfg: MCConfig, max_items: int):
    """Shared inference dispatch: fused in-kernel row gather by default
    (``ops.ht_find`` probe + ``ops.cdf_query_fused``), the unfused
    ``_ordered_rows`` + ``ops.cdf_query`` pipeline otherwise.
    ``threshold=None`` is top-k mode (every live item)."""
    src = _to_state_device(state, src, torch.int32)
    if cfg.fused_query:
        rows, found = lookup_rows(state, src, cfg)
        return ops.cdf_query_fused(
            rows, found, state.slabs.cnt, state.slabs.dst, state.slabs.order,
            state.slabs.tot, threshold, max_items=max_items,
            chunks=cfg.query_chunks, impl=cfg.impl)
    c, d, tot, _ = _ordered_rows(state, src, cfg)
    return ops.cdf_query(c, d, tot, threshold, max_items=max_items,
                         chunks=cfg.query_chunks, impl=cfg.impl)


def query_threshold(
    state: MCState,
    src,
    threshold: float,
    *,
    cfg: MCConfig,
    max_items: int = 16,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Items in descending probability until cumulative prob >= threshold.

    Returns ``(dsts[B, max_items], probs[B, max_items], n_needed[B])`` where
    entries past ``n_needed`` are EMPTY/0.  ``n_needed`` is the paper's
    CDF^-1(t): how many items a reader must touch.  Unknown srcs yield 0.
    Runs through the kernel layer (``ops.cdf_query_fused`` /
    ``ops.cdf_query`` per ``cfg.fused_query``).
    """
    return query_impl(state, src, threshold, cfg, max_items)


def query_topk(state: MCState, src, *, cfg: MCConfig, k: int = 8):
    """Top-k edges by (approximate) probability. ``(dsts[B,k], probs[B,k])``.

    Top-k is the kernel's explicit ``threshold=None`` mode (keep every live
    item), sharing the CDF walk of the threshold query.
    """
    dk, pk, _ = query_impl(state, src, None, cfg, k)
    return dk, pk


# ---------------------------------------------------------------------------
# decay (paper §II.C) — incremental maintenance
# ---------------------------------------------------------------------------


def _decay(state: MCState, cfg: MCConfig, *, fire=None, dirty=None,
           fresh: bool = False) -> MCState:
    """The body of :func:`decay`, :func:`decay_` and :func:`maybe_decay_`,
    written into ``state``; ``fire`` (a 0-dim bool tensor) gates it on the
    device.  ``fresh``: the stop-the-world kernel writes every row into new
    tensors instead (the functional twin without the dst hash: every row is
    written anyway).  With the dst hash the decay kernel repairs the
    decayed rows' hashes (each lane whose slot died becomes TOMB, counted
    in ``dh_tombstones``), then ``ops.dh_rebuild_`` rebuilds every row hash
    if the tombstones crossed the threshold — both decided on the device."""
    n = cfg.num_rows
    r = cfg.resolved_decay_rows()
    slabs = state.slabs
    dh = (dict(dh_keys=state.dh_keys, dh_vals=state.dh_vals,
               tombstones=state.dh_tombstones) if cfg.use_dst_hash else {})
    if r >= n and fresh:  # stop-the-world: one full-table dispatch
        cnt, dst, order, tot = ops.decay_sort(
            slabs.cnt, slabs.dst, slabs.order, impl=cfg.impl)
        state = state._replace(slabs=Slabs(dst, cnt, tot, order))
    elif r >= n:
        ops.decay_sort_(slabs.cnt, slabs.dst, slabs.order, slabs.tot,
                        fire=fire, dirty=dirty, impl=cfg.impl, **dh)
    else:
        # the last block is clamped so every call touches exactly r rows (it
        # overlaps the previous block when r does not divide n; halving is
        # not idempotent per row — kept as the reference has it)
        ops.decay_sort_rolling_(slabs.cnt, slabs.dst, slabs.order, slabs.tot,
                                state.decay_cursor, block_rows=r, fire=fire,
                                dirty=dirty, impl=cfg.impl, **dh)
    state.decay_steps.add_(1 if fire is None else fire)
    if cfg.use_dst_hash:
        first = SCALAR_FIELDS.index("dh_rebuilds")
        ops.dh_rebuild_(slabs.cnt, slabs.dst, state.dh_keys, state.dh_vals,
                        scalars_of(state)[first:first + 2],
                        threshold=cfg.dh_rebuild_threshold(),
                        max_probes=cfg.max_probes, fire=fire, dirty=dirty,
                        impl=cfg.impl)
    return state


def decay(state: MCState, *, cfg: MCConfig) -> MCState:
    """§II.C decay through the kernel layer (``ops.decay_sort``).

    Stop-the-world (``decay_block_rows == 0``): halve every counter, evict
    dead edges and compact the whole table.  Rolling mode
    (``decay_block_rows == R``): halve only the cursor's R-row block and
    advance the cursor, so a serving system amortises maintenance across
    steps — per-call kernel work scales with R, not ``num_rows``, and readers
    see the paper's approximately-correct mid-maintenance state.  The block
    is found from the cursor on the device (``ops.decay_sort_rolling_``), so
    neither mode synchronises with the host.  With the dst hash the decayed
    rows' hashes are repaired incrementally (tombstones, not rebuilds) and
    a full rebuild runs only when the tombstones cross
    ``dh_rebuild_fraction`` of the hash capacity.  Functional: the decay
    writes into copies of the slabs, scalars and row hashes (the
    stop-the-world one without the dst hash into fresh tensors).
    """
    fresh = cfg.resolved_decay_rows() >= cfg.num_rows and not cfg.use_dst_hash
    return _decay(private_copy(state, table=False,
                               slabs=() if fresh else Slabs._fields,
                               dh=cfg.use_dst_hash),
                  cfg, fresh=fresh)


def decay_(state: MCState, *, cfg: MCConfig, dirty=None) -> MCState:
    """:func:`decay` for the state's owner: written into ``state``'s own
    tensors (a rolling decay writes its block and the cursor and nothing
    else), which it returns.  ``dirty`` (uint8 [N]): the decayed rows are
    flagged."""
    return _decay(state, cfg, dirty=dirty)


def maybe_decay(state: MCState, *, cfg: MCConfig, total_threshold: int) -> MCState:
    """Decay when any row total exceeds ``total_threshold`` (paper §II.C
    suggests decaying "at some threshold over the number of total
    transitions").  In rolling mode each trigger halves one block; the
    threshold keeps firing until the offending row's block comes around.
    Reading the trigger costs one device->host synchronisation per call;
    :func:`maybe_decay_` decides on the device."""
    if bool((state.slabs.tot > total_threshold).any()):
        return decay(state, cfg=cfg)
    return state


def maybe_decay_(state: MCState, *, cfg: MCConfig, total_threshold: int,
                 dirty=None) -> MCState:
    """:func:`maybe_decay` for the state's owner, decided on the device as
    the reference's ``lax.cond`` does: the trigger is a device bool that
    the decay kernel reads, so a call that does not fire writes nothing
    and nothing is read on the host.  Returns ``state``."""
    fire = (state.slabs.tot > total_threshold).any()
    return _decay(state, cfg, fire=fire, dirty=dirty)


# ---------------------------------------------------------------------------
# invariant checks (used by tests and the smoke script)
# ---------------------------------------------------------------------------


def _dh_consistent(state: MCState, cfg: MCConfig) -> torch.Tensor:
    """Dst-hash invariant: every live slot is reachable through the hash and
    every occupied hash lane points at a live slot holding its key (no stale
    entries after decay/repair)."""
    slabs = state.slabs
    n, c = slabs.dst.shape
    dev = slabs.dst.device
    rows = torch.arange(n, dtype=torch.int32, device=dev).repeat_interleave(c)
    live = slabs.cnt.reshape(-1) > 0
    slots, found = ops.dh_find(torch.where(live, rows, -1),
                               slabs.dst.reshape(-1).clamp(min=0),
                               state.dh_keys, state.dh_vals,
                               max_probes=cfg.max_probes, impl=cfg.impl)
    expect = torch.arange(c, dtype=torch.int32, device=dev).repeat(n)
    live_ok = (~live | (found & (slots == expect))).all()
    v = state.dh_vals.clamp(0, c - 1).to(torch.int64)
    pointed_ok = ((torch.gather(slabs.dst, 1, v) == state.dh_keys)
                  & (torch.gather(slabs.cnt, 1, v) > 0))
    stale_ok = ((state.dh_keys < 0) | pointed_ok).all()
    return live_ok & stale_ok


def check_invariants(state: MCState, cfg: Optional[MCConfig] = None) -> dict:
    slabs = state.slabs
    cap = slabs.order.shape[1]
    order_ok = (torch.sort(slabs.order, dim=1).values
                == torch.arange(cap, dtype=torch.int32,
                                device=slabs.order.device)).all()
    tot_ok = (slabs.tot == slabs.cnt.sum(dim=1).to(torch.int32)).all()
    free_ok = ((slabs.cnt == 0) == (slabs.dst == EMPTY)).all()
    nonneg = (slabs.cnt >= 0).all()
    out = {
        "order_is_permutation": bool(order_ok),
        "tot_matches_cnt_sum": bool(tot_ok),
        "free_slots_consistent": bool(free_ok),
        "counts_nonnegative": bool(nonneg),
        "sorted_fraction": float(sl.sorted_fraction(slabs.cnt, slabs.order)),
    }
    if cfg is not None and cfg.use_dst_hash:
        out["dst_hash_consistent"] = bool(_dh_consistent(state, cfg))
    return out


def maintenance_stats(state: MCState) -> dict:
    """Maintenance observability counters, host-side ints."""
    return {
        "decay_steps": int(state.decay_steps),
        "decay_cursor": int(state.decay_cursor),
        "dh_rebuilds": int(state.dh_rebuilds),
        "dh_tombstones": int(state.dh_tombstones),
    }


_COUNTER_FIELDS = ("n_rows", "dropped_rows", "dropped_probes", "evictions",
                   "deferred_new", "route_dropped", "decay_steps",
                   "dh_rebuilds", "dh_tombstones")


def counter_stats(state: MCState, ranks=None) -> dict:
    """Every additive observability counter as a host-side int.

    Counters are summed over any leading dims, so the same helper reads a
    local ``MCState`` and a stacked per-shard state.  ``decay_cursor`` is a
    position, not a count, and is deliberately excluded.  The sums are
    stacked into one tensor and cross to the host in ONE device->host copy.
    With ``ranks`` (a ``sharding.ranks.RankGroup``, ``state`` this rank's
    shard) the sums are summed over the ranks too (``psum``): every rank
    gets the whole chain's counters, as the one-card stacked state gives
    them.
    """
    vals = torch.stack([getattr(state, f).sum() for f in _COUNTER_FIELDS])
    if ranks is not None:
        vals = ranks.psum(vals)
    vals = vals.tolist()
    return {f: int(v) for f, v in zip(_COUNTER_FIELDS, vals)}
