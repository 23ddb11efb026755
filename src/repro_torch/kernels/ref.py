"""Plain PyTorch versions of every kernel in this package.

Counterpart of ``repro.kernels.ref``.  Each function is the semantic ground
truth of one CUDA kernel; kernels must match exactly, integer outputs and
float32 probabilities alike (the only float ops, ``t * tot`` and
``cnt / tot``, are per-row/per-item and association-free).  They run on any
device; on the CPU they are what the kernel wrappers dispatch to.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import hashtable as ht
from repro_torch.core import slab as sl
from repro_torch.core.hashtable import EMPTY, TOMB, first_true

# The in-place forms (a trailing underscore) write into the tensors they are
# given, as the kernels do for the state's owner, and set ``dirty`` (None, or
# uint8 [N], one flag per row) for the rows the kernel flags; the new-edge
# pass also sets ``table_dirty`` (None, or uint8, one flag per group of
# ``hashtable.flag_group`` src-table slots) for the slots it writes.  They neither
# clone a tensor they are given nor read one on the host (the sequential
# new-edge pass excepted), and take ``fire`` (a 0-dim bool tensor: write
# only when it holds) without reading it.


def _flag(dirty, rows: torch.Tensor) -> None:
    """Set ``dirty`` where the bool ``rows`` [N] holds (no-op for None)."""
    if dirty is not None:
        dirty.bitwise_or_(rows.to(torch.uint8))


def _flag_slot(table_dirty, slot: int, size: int) -> None:
    """Set the table flag of src-table ``slot`` (no-op for None)."""
    if table_dirty is not None:
        table_dirty[slot // ht.flag_group(size)] = 1


def _fired(new: torch.Tensor, old: torch.Tensor, fire) -> torch.Tensor:
    return new if fire is None else torch.where(fire, new, old)


def oddeven_ref(c_ord: torch.Tensor, order: torch.Tensor, passes: int):
    """k odd-even passes over counts-in-order + the order permutation.

    c_ord[N, C] are the counts *already gathered into order position* (the
    kernel-side layout); order[N, C] the slot permutation. Returns the pair
    after ``passes`` full (even+odd) sweeps, descending target; the inputs
    are not written.
    """
    cap = c_ord.shape[1]
    idx = torch.arange(cap, device=c_ord.device)
    for _ in range(passes):
        for start in (0, 1):
            # pairs (p, p + 1) for p = start, start + 2, ..: each position's
            # partner, and whether it is the pair's left or right element
            off = idx - start
            left = (off >= 0) & (off % 2 == 0) & (idx + 1 < cap)
            right = (off >= 1) & (off % 2 == 1)
            partner = torch.where(left, idx + 1, torch.where(right, idx - 1, idx))
            pc = c_ord[:, partner]
            swap = (left & (c_ord < pc)) | (right & (pc < c_ord))
            c_ord, order = (torch.where(swap, pc, c_ord),
                            torch.where(swap, order[:, partner], order))
    return c_ord, order


def oddeven_sort_ref(cnt: torch.Tensor, order: torch.Tensor, passes: int):
    """What the odd-even kernel computes from the raw slab arrays: gather the
    counts into order position once, run the passes, return the new order."""
    _, new_order = oddeven_ref(sl.gather_cols(cnt, order), order, passes)
    return new_order


def oddeven_sort_ref_(cnt: torch.Tensor, order: torch.Tensor, passes: int,
                      dirty=None) -> None:
    """:func:`oddeven_sort_ref` written into ``order``; a row whose order
    changed is flagged."""
    new_order = oddeven_sort_ref(cnt, order, passes)
    _flag(dirty, (new_order != order).any(dim=1))
    order.copy_(new_order)


# ---------------------------------------------------------------------------
# the per-row dst hash (paper §II.2): keys/vals [N, H], one open-addressing
# table per slab row, dst -> slot.  Edits of several rows at once: the
# ``rows`` of one call must be distinct.
# ---------------------------------------------------------------------------


def dh_delete_rows_(keys: torch.Tensor, rows: torch.Tensor, key: torch.Tensor,
                    active: torch.Tensor, max_probes: int) -> None:
    """``hashtable.delete`` of ``key[i]`` in table ``rows[i]`` where
    ``active[i]``: the key's lane, if its chain holds it, becomes TOMB."""
    table = ht.HashTable(keys, keys)   # the value the probe reads is unused
    _, slot, hit = ht._lookup_probe(table, key, max_probes, rows)
    old = keys[rows, slot]
    keys[rows, slot] = torch.where(hit & active, TOMB, old).to(keys.dtype)


def dh_insert_rows_(keys: torch.Tensor, vals: torch.Tensor,
                    rows: torch.Tensor, key: torch.Tensor, val: torch.Tensor,
                    active: torch.Tensor, max_probes: int) -> None:
    """``hashtable.insert`` of ``key[i] -> val[i]`` in table ``rows[i]``
    where ``active[i]``: the key's own lane or the first EMPTY, the first
    TOMB before either when the key is absent (also when the window is
    exhausted); an insert that finds no lane drops the key."""
    slot, ok = ht.insert_probe(keys, key, max_probes, rows)
    ok = ok & active
    col = slot.clamp(min=0).to(torch.int64)
    keys[rows, col] = torch.where(ok, key, keys[rows, col]).to(keys.dtype)
    vals[rows, col] = torch.where(ok, val, vals[rows, col]).to(vals.dtype)


def _dh_repair(cnt: torch.Tensor, keys: torch.Tensor, vals: torch.Tensor):
    """The row hashes ``keys/vals`` of decayed rows ``cnt``: every occupied
    lane whose slot ``clip(val, 0, C-1)`` holds count 0 becomes TOMB.
    Returns ``(keys', number of lanes tombstoned)``."""
    pointed = torch.gather(cnt, 1, vals.clamp(0, cnt.shape[1] - 1).to(torch.int64))
    dead = (keys >= 0) & (pointed == 0)
    return (torch.where(dead, TOMB, keys).to(keys.dtype),
            dead.sum(dtype=torch.int32))


def decay_sort_ref(cnt: torch.Tensor, dst: torch.Tensor, order: torch.Tensor,
                   dh_keys=None, dh_vals=None):
    """§II.C decay of every row given (the reference's composition): halve
    the counts, evict the edges whose count reaches 0, re-sum the rows, and
    sort with C//2+1 odd-even passes — a full transposition network, and a
    stable one, since only strictly out-of-order neighbours swap.  Returns
    ``(cnt', dst', order', tot')``; given the row hashes ``dh_keys/dh_vals
    [N, H]``, also ``dh_keys'`` (each lane whose slot died a TOMB) and the
    number of lanes tombstoned (0-dim int32)."""
    new_cnt = cnt >> 1
    new_dst = torch.where(new_cnt == 0, EMPTY, dst).to(torch.int32)
    new_tot = new_cnt.sum(dim=1).to(torch.int32)
    new_order = oddeven_sort_ref(new_cnt, order, cnt.shape[1] // 2 + 1)
    if dh_keys is None:
        return new_cnt, new_dst, new_order, new_tot
    return (new_cnt, new_dst, new_order, new_tot,
            *_dh_repair(new_cnt, dh_keys, dh_vals))


def _bitonic_sort_rows(keys: torch.Tensor) -> torch.Tensor:
    """Ascending bitonic network over each row of ``keys[N, P]`` (P a power
    of two): for k = 2, 4, .., P and j = k/2, .., 1, position e and its
    partner e ^ j keep the lower key where ``e & k`` is 0, else the higher."""
    p = keys.shape[1]
    e = torch.arange(p, device=keys.device)
    k = 2
    while k <= p:
        j = k // 2
        while j >= 1:
            other = keys[:, e ^ j]
            keep_min = ((e & j) == 0) == ((e & k) == 0)
            keys = torch.where(keep_min, torch.minimum(keys, other),
                               torch.maximum(keys, other))
            j //= 2
        k *= 2
    return keys


def decay_sort_rows_ref(cnt: torch.Tensor, dst: torch.Tensor,
                        order: torch.Tensor):
    """The same decay as :func:`decay_sort_ref`, computed the way the CUDA
    kernel (``csrc/decay_sort.cu``) decomposes it (same arguments, same
    results): halve, evict, reduce; a row whose halved counts are already
    non-increasing in priority order keeps its order; any other row sorts
    the unique keys (count descending, priority position e ascending) with a
    bitonic network padded to P = 32 * V positions (V the power of two of
    slots per lane) with keys that sort last — 64-bit keys
    ``-count * 2^32 + e`` — and sorted position i takes the slot
    ``order[e_i]``.  Used by the tests and ``chip_smoke.py``, not on any
    path."""
    n, cap = cnt.shape
    new_cnt = cnt >> 1
    new_dst = torch.where(new_cnt == 0, EMPTY, dst).to(torch.int32)
    new_tot = new_cnt.sum(dim=1).to(torch.int32)
    width = 32
    while width < cap:
        width *= 2
    h = sl.gather_cols(new_cnt, order).to(torch.int64)
    pos = torch.arange(cap, dtype=torch.int64, device=cnt.device)
    keys = torch.cat([-h * 2 ** 32 + pos,
                      torch.full((n, width - cap), torch.iinfo(torch.int64).max,
                                 dtype=torch.int64, device=cnt.device)], dim=1)
    by_key = _bitonic_sort_rows(keys)[:, :cap] & (2 ** 32 - 1)
    in_order = (h[:, :-1] >= h[:, 1:]).all(dim=1, keepdim=True)
    new_order = torch.gather(order, 1, torch.where(in_order, pos, by_key))
    return new_cnt, new_dst, new_order.to(torch.int32), new_tot


def decay_sort_ref_(cnt: torch.Tensor, dst: torch.Tensor, order: torch.Tensor,
                    tot: torch.Tensor, fire=None, dirty=None, dh_keys=None,
                    dh_vals=None, tombstones=None) -> None:
    """:func:`decay_sort_ref` of every row written into ``cnt, dst, order,
    tot`` (unless ``fire`` is false); every decayed row is flagged.  Given
    the row hashes, their dead lanes become TOMB in ``dh_keys`` and their
    number is added to ``tombstones`` (0-dim int32)."""
    blocks = decay_sort_ref(cnt, dst, order, dh_keys, dh_vals)
    for full, block in zip((cnt, dst, order, tot, dh_keys), blocks):
        if full is not None:
            full.copy_(_fired(block, full, fire))
    if dh_keys is not None:
        tombstones.add_(_fired(blocks[5], 0, fire))
    _flag(dirty, torch.ones_like(tot, dtype=torch.bool) if fire is None
          else fire.expand(tot.shape))


def decay_sort_rolling_ref_(cnt: torch.Tensor, dst: torch.Tensor,
                            order: torch.Tensor, tot: torch.Tensor,
                            cursor: torch.Tensor, block_rows: int, fire=None,
                            dirty=None, dh_keys=None, dh_vals=None,
                            tombstones=None) -> None:
    """Rolling decay of one ``block_rows``-row block, in place, found on the
    device as the reference finds it: ``cur = cursor mod ceil(n / r)``, first
    row ``min(cur * r, n - r)`` (the last block is clamped and overlaps the
    one before it when r does not divide n).  That block of ``cnt, dst,
    order, tot`` is decayed by :func:`decay_sort_ref` and flagged, and the
    cursor set to ``cur + 1`` — unless ``fire`` is false, when nothing
    changes.  Given the row hashes, the block's are repaired as in
    :func:`decay_sort_ref_`.  Nothing is read on the host."""
    n = cnt.shape[0]
    cur = torch.remainder(cursor, -(-n // block_rows))
    row0 = (cur.to(torch.int64) * block_rows).clamp(max=n - block_rows)
    rows = row0 + torch.arange(block_rows, device=cnt.device)
    blocks = decay_sort_ref(cnt[rows], dst[rows], order[rows],
                            *((None, None) if dh_keys is None
                              else (dh_keys[rows], dh_vals[rows])))
    for full, block in zip((cnt, dst, order, tot, dh_keys), blocks):
        if full is not None:
            full[rows] = _fired(block, full[rows], fire)
    if dh_keys is not None:
        tombstones.add_(_fired(blocks[5], 0, fire))
    cursor.copy_(_fired((cur + 1).to(torch.int32), cursor, fire))
    if dirty is not None:
        dirty[rows] |= 1 if fire is None else fire.to(torch.uint8)


def decay_sort_rolling_ref(cnt: torch.Tensor, dst: torch.Tensor,
                           order: torch.Tensor, tot: torch.Tensor,
                           cursor: torch.Tensor, block_rows: int,
                           dh_keys=None, dh_vals=None, tombstones=None):
    """:func:`decay_sort_rolling_ref_` on copies: returns copies of ``cnt,
    dst, order, tot`` with the cursor's block decayed, and the next cursor
    (and, given the row hashes, copies of ``dh_keys`` and ``tombstones``
    repaired and counted); the inputs are not written."""
    outs = tuple(x.clone() for x in (cnt, dst, order, tot, cursor))
    if dh_keys is None:
        decay_sort_rolling_ref_(*outs, block_rows)
        return outs
    dh = (dh_keys.clone(), tombstones.clone())
    decay_sort_rolling_ref_(*outs, block_rows, dh_keys=dh[0], dh_vals=dh_vals,
                            tombstones=dh[1])
    return outs + dh


def dh_rebuild_ref_(cnt: torch.Tensor, dst: torch.Tensor,
                    dh_keys: torch.Tensor, dh_vals: torch.Tensor,
                    counters: torch.Tensor, threshold: int, max_probes: int,
                    fire=None, dirty=None) -> None:
    """The full rebuild of every row hash, decided on the device: when
    ``counters[1]`` (``dh_tombstones``) is above ``threshold`` and ``fire``
    (a 0-dim bool, or None) holds, every row's table becomes a fresh EMPTY
    table with ``dst[r, i] -> i`` inserted for i ascending wherever
    ``cnt[r, i] > 0``, ``counters`` (``dh_rebuilds``, ``dh_tombstones``)
    becomes ``(+1, 0)`` and every row is flagged; otherwise nothing
    changes.  A loop over the C slots, each step one insert into every row
    at once.  Nothing is read on the host."""
    n, cap = cnt.shape
    go = counters[1] > threshold
    if fire is not None:
        go = go & fire
    keys, vals = torch.full_like(dh_keys, EMPTY), torch.full_like(dh_vals, EMPTY)
    rows = torch.arange(n, device=cnt.device)
    for i in range(cap):
        dh_insert_rows_(keys, vals, rows, dst[:, i], torch.full_like(rows, i),
                        cnt[:, i] > 0, max_probes)
    dh_keys.copy_(torch.where(go, keys, dh_keys))
    dh_vals.copy_(torch.where(go, vals, dh_vals))
    counters.copy_(torch.where(go, torch.stack([counters[0] + 1,
                                                torch.zeros_like(counters[1])]),
                               counters))
    _flag(dirty, go.expand(n))


def slab_update_ref_(rows: torch.Tensor, dsts: torch.Tensor, w: torch.Tensor,
                     dst: torch.Tensor, cnt: torch.Tensor, tot: torch.Tensor,
                     dirty=None) -> torch.Tensor:
    """Fast-path batched edge increment (paper §II.A.2, existing edges only),
    written into ``cnt`` and ``tot``.

    For each item i: find slot of dsts[i] in row rows[i]; if present add w[i]
    to cnt and tot, and flag the row.  Items whose edge is absent are no-ops
    (the caller sends them down the slow path).  rows < 0 marks padding.
    Returns ``found[B]``.
    """
    active = rows >= 0
    safe_rows = rows.clamp(min=0).to(torch.int64)
    hit = dst[safe_rows] == dsts.unsqueeze(1)          # [B, C]
    slot, any_hit = first_true(hit, dim=1)
    found = any_hit & active
    slot = torch.where(any_hit, slot, 0)
    addw = torch.where(found, w, 0).to(cnt.dtype)
    cap = cnt.shape[1]
    cnt.view(-1).index_add_(0, safe_rows * cap + slot, addw)
    tot.index_add_(0, safe_rows, addw)
    hits = torch.zeros_like(tot).index_add_(0, safe_rows, found.to(tot.dtype))
    _flag(dirty, hits > 0)
    return found


def slab_update_ref(rows: torch.Tensor, dsts: torch.Tensor, w: torch.Tensor,
                    dst: torch.Tensor, cnt: torch.Tensor, tot: torch.Tensor):
    """:func:`slab_update_ref_` on copies of ``cnt``/``tot``; returns
    ``(dst, cnt', tot', found)``."""
    cnt, tot = cnt.clone(), tot.clone()
    found = slab_update_ref_(rows, dsts, w, dst, cnt, tot)
    return dst, cnt, tot, found


def probe_find_ref(rows: Optional[torch.Tensor], keys_q: torch.Tensor,
                   keys: torch.Tensor, vals: torch.Tensor, max_probes: int,
                   miss: int = EMPTY):
    """Batched open-addressing probe (the shared lookup oracle).

    rows[B] select a table out of keys/vals[N, H]; rows < 0 marks padding.
    ``rows=None`` probes one flat table keys/vals[H].  Covers both the
    per-row dst hash (paper §II.2, N = slab rows) and the flat src table
    (paper §II.1).  Returns ``(slots[B], found[B] bool)`` with slot ``miss``
    (EMPTY by default) where missing.

    Semantics are the core scalar probe (``hashtable.lookup``: scan from the
    home slot, stop at the key or the first EMPTY, give up after
    ``max_probes``), as one (B, max_probes) window gather + min-reductions
    over probe positions.
    """
    if rows is None:
        rows = torch.zeros_like(keys_q)
        keys, vals = keys.unsqueeze(0), vals.unsqueeze(0)
    h = keys.shape[1]
    safe_rows = rows.clamp(min=0).to(torch.int64)
    kq = keys_q.to(torch.int64)
    h0 = ht.hash_u32(keys_q) & (h - 1)
    p = torch.arange(max_probes, dtype=torch.int64, device=keys.device)
    idx = (h0.unsqueeze(1) + p) & (h - 1)                      # (B, P)
    win = keys[safe_rows.unsqueeze(1), idx].to(torch.int64)    # (B, P)
    key_p, _ = first_true(win == kq.unsqueeze(1), dim=1)
    empty_p, _ = first_true(win == EMPTY, dim=1)
    found = (key_p < empty_p) & (rows >= 0)
    slot_idx = (h0 + key_p.clamp(max=max_probes - 1)) & (h - 1)
    slots = vals[safe_rows, slot_idx]
    return torch.where(found, slots, miss).to(torch.int32), found


# the dst-hash entry point is the same probe; kept under its §II.2 name
dh_find_ref = probe_find_ref


def _needed_walk(c_ord: torch.Tensor, totf: torch.Tensor, threshold):
    """The integer walk shared by every CDF oracle: which priority positions
    a reader needs, and how many (CDF^-1).  ``threshold=None`` is top-k mode
    (every live item).  The prefix sums are exact int32; the comparison is
    ``float32(prefix_before) < float32(t) * float32(tot)``."""
    if threshold is None:
        needed = c_ord > 0
    else:
        cum = torch.cumsum(c_ord, dim=1, dtype=torch.int32)
        before = (cum - c_ord).to(torch.float32)
        t32 = torch.full((), float(threshold), dtype=torch.float32,
                         device=c_ord.device)
        needed = (before < (t32 * totf).unsqueeze(1)) & (c_ord > 0)
    return needed, needed.sum(dim=1).to(torch.int32)


def _pad_items(dk: torch.Tensor, pk: torch.Tensor, max_items: int):
    """Pad the emission window out to ``max_items`` when it exceeds C, so
    the plain path returns the same (B, max_items) shape the kernels allocate
    (entries past C are always EMPTY/0 — a row has at most C items)."""
    pad = max_items - dk.shape[1]
    if pad > 0:
        dk = torch.nn.functional.pad(dk, (0, pad), value=EMPTY)
        pk = torch.nn.functional.pad(pk, (0, pad), value=0.0)
    return dk, pk


def cdf_query_ref(c_ord: torch.Tensor, d_ord: torch.Tensor, tot: torch.Tensor,
                  threshold, max_items: int):
    """Cumulative-probability threshold query (paper §II.B).

    c_ord/d_ord[B, C]: counts/dsts gathered in descending-priority order
    (zeros for missing rows). Returns (dsts[B,k], probs[B,k], n_needed[B]).

    ``threshold=None`` is top-k mode: keep every live item (no threshold
    test).  The cumulative walk runs in exact integer count space —
    ``needed[j] = (sum(cnt[<j]) < t * tot) & (cnt[j] > 0)`` — so the result
    is independent of how a kernel chunks the walk.
    """
    totf = tot.clamp(min=1).to(torch.float32)
    needed, n_needed = _needed_walk(c_ord, totf, threshold)
    k = min(max_items, c_ord.shape[1])
    keep = needed[:, :k]
    pk_raw = c_ord[:, :k].to(torch.float32) / totf.unsqueeze(1)
    dk = torch.where(keep, d_ord[:, :k], EMPTY).to(torch.int32)
    pk = torch.where(keep, pk_raw, 0.0)
    dk, pk = _pad_items(dk, pk, max_items)
    return dk, pk, n_needed


def cdf_query_fused_ref(rows: torch.Tensor, found: torch.Tensor,
                        cnt: torch.Tensor, dst: torch.Tensor,
                        order: torch.Tensor, tot: torch.Tensor,
                        threshold, max_items: int):
    """Fused row-gather + CDF walk (plain version of ``cdf_gather.py``).

    rows[B] are pre-resolved row indices (0 where missing), found[B] the
    src-lookup mask; cnt/dst/order[N, C], tot[N] are the raw slab arrays.
    One combined linear-index gather pulls counts straight into priority
    order; dsts/probs are only gathered for the ``max_items`` emission window
    instead of all C (``n_needed`` still walks every count).
    """
    r = rows.clamp(min=0).to(torch.int64)
    cap = cnt.shape[1]
    flat = r.unsqueeze(1) * cap + order[r].to(torch.int64)  # [B, C] linear slots
    found = found.to(torch.bool)
    c_ord = torch.where(found.unsqueeze(1), cnt.reshape(-1)[flat], 0).to(torch.int32)
    totf = tot[r].clamp(min=1).to(torch.float32)
    needed, n_needed = _needed_walk(c_ord, totf, threshold)
    k = min(max_items, cap)
    keep = needed[:, :k]
    d_k = dst.reshape(-1)[flat[:, :k]]                 # emission window only
    p_k = c_ord[:, :k].to(torch.float32) / totf.unsqueeze(1)
    dk = torch.where(keep, d_k, EMPTY).to(torch.int32)
    pk = torch.where(keep, p_k, 0.0)
    dk, pk = _pad_items(dk, pk, max_items)
    return dk, pk, n_needed


def _merge_steps(probs: torch.Tensor, n: int):
    """The n head-pointer steps over the lists ``probs`` [L, M]: each step
    reads the L list heads (a pointer past the end reads 0.0), takes the
    first maximum — the lowest list on ties, NaN above every number, as
    ``jnp.argmax`` — and advances that list's pointer, whatever its head
    holds.  Returns the heads taken as read (float32 [n]) and their flat
    positions in ``probs`` (int64 [n], -1 for a pointer past the end)."""
    s, m = probs.shape
    dev = probs.device
    lanes = torch.arange(s, device=dev)
    ptr = torch.zeros((s,), dtype=torch.int64, device=dev)
    heads = torch.zeros((n,), dtype=torch.float32, device=dev)
    at = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for step in range(n):
        j = ptr.clamp(max=m - 1)
        head = torch.where(ptr < m, probs[lanes, j], 0.0)
        top = head.max()
        first = (head == top) | (head.isnan() & top.isnan())
        best = torch.where(first, lanes, s).min().view(1)
        heads[step:step + 1] = head[best]
        at[step:step + 1] = torch.where(ptr[best] < m, best * m + j[best], -1)
        ptr.index_add_(0, best, torch.ones_like(best))
    return heads, at


def _emit(heads, at, dsts, srcs):
    """A merge's output from its steps: a head that is not ``> 0`` emits
    EMPTY/EMPTY/0.0, the others their src and dst."""
    live = heads > 0
    at = at.clamp(min=0)
    return (torch.where(live, srcs.reshape(-1)[at], EMPTY).to(torch.int32),
            torch.where(live, dsts.reshape(-1)[at], EMPTY).to(torch.int32),
            torch.where(live, heads, 0.0))


def topn_merge_ref(probs: torch.Tensor, dsts: torch.Tensor,
                   srcs: torch.Tensor, n: int):
    """Fixed-shape k-way merge of per-shard top lists (plain version of
    ``topn_merge.py``).

    probs float32 / dsts / srcs int32 [S, M]: each shard's local answer,
    descending by prob on the sharded read's path (dead entries carry prob
    0 / EMPTY at the tail).  The head-pointer merge as a loop of n steps:
    each step reads the S list heads (a pointer past the end reads 0.0),
    takes the first maximum — the lowest shard on ties, NaN above every
    number, as ``jnp.argmax`` — and advances that shard's pointer, whatever
    its head holds.  A head that is not ``> 0`` emits EMPTY/EMPTY/0.0.  The
    same steps on any input, descending or not.  Returns
    ``(srcs[n], dsts[n], probs[n])``.
    """
    return _emit(*_merge_steps(probs, n), dsts, srcs)


MERGE_GROUP = 32        # lists one warp of the merge kernel takes: one per lane
MERGE_REC_STEPS = 8192  # level-1 steps one merge block keeps in shared memory


def merge_lists_per_launch(n: int) -> int:
    """Lists one block of the merge kernel takes for n steps
    (``csrc/topn_merge.cu``): 32 groups of 32, fewer groups above n = 256
    so that the groups' n steps each fit its shared memory, and one group
    at the least."""
    groups = max(1, min(MERGE_GROUP, MERGE_REC_STEPS // max(n, 1)))
    return MERGE_GROUP * groups


def _block_merge_steps(probs: torch.Tensor, n: int):
    """:func:`_merge_steps` as one block of the merge kernel takes them
    (``csrc/topn_merge.cu``): above ``MERGE_GROUP`` lists, level 1 merges
    each group of ``MERGE_GROUP`` consecutive lists into its n steps, and
    level 2 merges the groups' step lists; the positions are flat positions
    in ``probs`` (-1 past the end)."""
    lists, m = probs.shape
    if lists <= MERGE_GROUP:
        return _merge_steps(probs, n)
    heads, at = [], []
    for g in range(0, lists, MERGE_GROUP):
        h, a = _merge_steps(probs[g:g + MERGE_GROUP], n)
        heads.append(h)
        at.append(torch.where(a < 0, -1, a + g * m))
    top, pos = _merge_steps(torch.stack(heads), n)
    at = torch.stack(at).reshape(-1)
    return top, torch.where(pos < 0, -1, at[pos.clamp(min=0)])


def topn_merge_rounds_ref(probs: torch.Tensor, dsts: torch.Tensor,
                          srcs: torch.Tensor, n: int):
    """:func:`topn_merge_ref` as the CUDA kernel computes it (the plain
    mirror of ``csrc/topn_merge.cu``'s launches): each launch merges
    consecutive blocks of :func:`merge_lists_per_launch` lists, each block
    in two levels (:func:`_block_merge_steps`), into one list of their n
    steps, the heads as read (NaN, zero and negative too) and their
    positions in the original lists; those lists are the next launch's,
    until one block emits."""
    per = merge_lists_per_launch(n)
    lists, pos = probs, None
    while True:
        heads, at = [], []
        for g in range(0, lists.shape[0], per):
            h, a = _block_merge_steps(lists[g:g + per], n)
            a = torch.where(a < 0, -1, a + g * lists.shape[1])
            if pos is not None:   # a position of this launch's lists
                a = torch.where(a < 0, -1, pos[a.clamp(min=0)])
            heads.append(h)
            at.append(a)
        if len(heads) == 1:
            return _emit(heads[0], at[0], dsts, srcs)
        lists, pos = torch.stack(heads), torch.stack(at).reshape(-1)


def topn_window_lists_ref(cnt: torch.Tensor, order: torch.Tensor,
                          tot: torch.Tensor, n: int, blocks: int):
    """The window kernel's lists and counts (plain mirror of
    ``csrc/topn_windows.cu``).

    cnt/order int32 [S, N, C], tot [S, N].  Each row's window is its first
    ``k = min(n, C)`` order positions, entry j's probability ``cnt /
    max(tot, 1)`` (float32) where its count is > 0; a live entry's key is
    ``(prob bits << 32) | (0xFFFFFFFF - (row * k + j))``, a dead one's 0.
    Shard s's rows are cut into ``blocks`` tiles of ``ceil(N / blocks)``
    consecutive rows; list ``s * blocks + b`` holds tile b's n largest keys,
    descending, 0 past its live entries.  Returns ``(lists int64 [S *
    blocks, n], counts int64 [S, 2])``, counts = each shard's live edges
    (count > 0) and live window entries."""
    s, rows, c = cnt.shape
    k = min(n, c)
    cnt_k = torch.gather(cnt, 2, order[:, :, :k].to(torch.int64))
    live_k = cnt_k > 0
    totf = tot.clamp(min=1).to(torch.float32)
    prob = torch.where(live_k, cnt_k.to(torch.float32) / totf.unsqueeze(2), 0.0)
    flat = torch.arange(rows * k, dtype=torch.int64,
                        device=cnt.device).view(rows, k)
    key = torch.where(live_k, (prob.view(torch.int32).to(torch.int64) << 32)
                      | (0xFFFFFFFF - flat), 0)
    tile = -(-rows // blocks)
    width = max(tile * k, n)
    tiles = torch.zeros((s, blocks * tile * k), dtype=torch.int64,
                        device=cnt.device)
    tiles[:, :rows * k] = key.view(s, -1)
    tiles = torch.nn.functional.pad(tiles.view(s, blocks, tile * k),
                                    (0, width - tile * k))
    lists = torch.topk(tiles, n, dim=2).values.reshape(s * blocks, n)
    counts = torch.stack([(cnt > 0).sum(dim=(1, 2)), live_k.sum(dim=(1, 2))],
                         dim=1)
    return lists, counts


def src_of_row_ref(tab_keys: torch.Tensor, tab_vals: torch.Tensor,
                   rows: int) -> torch.Tensor:
    """Reverse map row -> src node id of every shard, ``[S, N]`` and
    contiguous, from the src tables ``tab_keys/tab_vals [S, T]`` by one
    scatter into the flat ``S·N`` rows: each valid lane (key >= 0, 0 <=
    value < N) writes its key at its row, every other row holds EMPTY
    (invalid lanes go to a sink one past the end, sliced off, as the
    reference's ``mode="drop"`` drops them)."""
    s = tab_keys.shape[0]
    valid = (tab_keys >= 0) & (tab_vals >= 0) & (tab_vals < rows)
    base = torch.arange(s, dtype=torch.int64, device=tab_keys.device) * rows
    idx = torch.where(valid, tab_vals + base.unsqueeze(1), s * rows)
    out = torch.full((s * rows + 1,), EMPTY, dtype=torch.int32,
                     device=tab_keys.device)
    out.scatter_(0, idx.reshape(-1), tab_keys.reshape(-1))
    return out[:s * rows].view(s, rows)


def topn_merge_windows_ref(lists: torch.Tensor, counts: torch.Tensor,
                           order: torch.Tensor, dst: torch.Tensor,
                           tab_keys: torch.Tensor, tab_vals: torch.Tensor,
                           n: int, blocks: int):
    """The merge of the window lists and its labels (plain mirror of
    ``csrc/topn_merge.cu``'s ``mcq_topn_merge_windows`` and
    ``mcq_topn_label``): the block's merge steps over the
    lists' probabilities (the keys' high words), the lowest list on ties; a
    winner > 0 labelled from its key — shard ``list // blocks``, row and
    window position from ``0xFFFFFFFF - low word``, dst at the slot
    ``order[s, row, j]``, src through :func:`src_of_row_ref` of the src
    tables — the others EMPTY / EMPTY / 0.0; ``dropped = sum_s (live_s -
    min(n, window live_s))``.  Returns ``(srcs[n], dsts[n], probs[n],
    dropped)``."""
    k = min(n, order.shape[2])
    probs = (lists >> 32).to(torch.int32).view(torch.float32)
    heads, at = _block_merge_steps(probs, n)
    live = heads > 0
    at = torch.where(live, at, 0)
    key = lists.reshape(-1)[at]
    shard = at // n // blocks
    flat = torch.where(live, 0xFFFFFFFF - (key & 0xFFFFFFFF), 0)
    row, j = flat // k, flat % k
    slot = order[shard, row, j].to(torch.int64)
    src = src_of_row_ref(tab_keys, tab_vals, order.shape[1])[shard, row]
    dropped = (counts[:, 0] - counts[:, 1].clamp(max=n)).sum()
    return (torch.where(live, src, EMPTY).to(torch.int32),
            torch.where(live, dst[shard, row, slot], EMPTY).to(torch.int32),
            torch.where(live, heads, 0.0), dropped.to(torch.int32))


def topn_windows_ref(cnt: torch.Tensor, order: torch.Tensor,
                     tot: torch.Tensor, dst: torch.Tensor,
                     tab_keys: torch.Tensor, tab_vals: torch.Tensor, n: int,
                     blocks: int = 1):
    """The sharded global top-n as the CUDA kernels decompose it (plain
    version of ``topn_windows.py``): :func:`topn_window_lists_ref`, then
    :func:`topn_merge_windows_ref`.  Equal to ``core/sharded.py``'s plain
    ``topn_lists`` + :func:`topn_merge_ref` for every ``blocks``.  Returns
    ``(srcs[n], dsts[n], probs[n], dropped)``."""
    lists, counts = topn_window_lists_ref(cnt, order, tot, n, blocks)
    return topn_merge_windows_ref(lists, counts, order, dst, tab_keys,
                                  tab_vals, n, blocks)


def draft_walk_ref(window: torch.Tensor, ht_keys: torch.Tensor,
                   ht_vals: torch.Tensor, cnt: torch.Tensor, dst: torch.Tensor,
                   ord0: torch.Tensor, *, k: int, max_probes: int):
    """k-step greedy draft walk (plain version of ``kernels/walk.py``).

    A loop of k steps of (rolling ctx hash -> src probe -> top-1 gather at
    the order head ``ord0[row]``) with a dead-lane stop: once a step finds no
    transition the lane emits token 0 / ok 0 for every later step.
    window[B, order] int32 (any strides); ord0[N] the order head of every
    row (``slabs.order[:, 0]``, a strided view is fine).  Returns
    ``(toks[B, k], ok[B, k])``, both int32.
    """
    n = cnt.shape[0]
    b = window.shape[0]
    toks = torch.zeros((b, k), dtype=torch.int32, device=window.device)
    oks = torch.zeros((b, k), dtype=torch.int32, device=window.device)
    win = window.to(torch.int32)
    alive = torch.ones((b,), dtype=torch.bool, device=window.device)
    for s in range(k):
        src = ht.ctx_window_hash(win)
        rows, found = probe_find_ref(None, src, ht_keys, ht_vals, max_probes,
                                     miss=0)
        rowm = rows.clamp(0, n - 1).to(torch.int64)
        slot0 = ord0[rowm].to(torch.int64)
        cnt0 = cnt[rowm, slot0]
        dst0 = dst[rowm, slot0]
        ok = alive & found & (cnt0 > 0) & (dst0 != EMPTY)
        nxt = torch.where(ok, dst0, 0).to(torch.int32)
        toks[:, s] = nxt
        oks[:, s] = ok.to(torch.int32)
        win = torch.cat([win[:, 1:], nxt.unsqueeze(1)], dim=1)
        alive = ok
    return toks, oks


def _on_copies(pass_):
    """The functional form of an in-place new-edge pass: it runs on copies of
    what the pass writes and returns ``(tab_keys, tab_vals, dst_slab, cnt,
    tot, counters)``, and ``(dh_keys, dh_vals)`` after them when the row
    hashes are given; the inputs are not written."""
    def functional(tab_keys, tab_vals, dst_slab, cnt, tot, order, counters,
                   src, dst, w, active, max_probes, dh_keys=None,
                   dh_vals=None):
        out = [x.clone() for x in (tab_keys, tab_vals, dst_slab, cnt, tot,
                                   counters)]
        dh = [] if dh_keys is None else [dh_keys.clone(), dh_vals.clone()]
        pass_(*out[:5], order, out[5], src, dst, w, active, max_probes,
              None, *dh)
        return tuple(out + dh)
    functional.__name__ = functional.__qualname__ = pass_.__name__[:-1]
    functional.__doc__ = f"``{pass_.__name__}`` on copies (see there)."
    return functional


def slow_path_ref_(tab_keys: torch.Tensor, tab_vals: torch.Tensor,
                   dst_slab: torch.Tensor, cnt: torch.Tensor, tot: torch.Tensor,
                   order: torch.Tensor, counters: torch.Tensor,
                   src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                   active: torch.Tensor, max_probes: int,
                   dirty=None, dh_keys=None, dh_vals=None,
                   table_dirty=None) -> None:
    """Sequential insert pass for new edges / new rows (the paper's rare case).

    Deterministic (batch order); inactive items are no-ops.  For each active
    item: look the src up or allocate the next row (``counters[0]`` =
    ``n_rows``; a full table counts ``dropped_rows`` = ``counters[1]``, an
    exhausted probe window ``dropped_probes`` = ``counters[2]``); then find
    the dst's slot, else the first free slot, else replace the order tail
    (Space-Saving: the newcomer inherits the victim's count; ``evictions`` =
    ``counters[3]``).  A later item sees the rows and slots an earlier one
    made.  Writes ``tab_keys, tab_vals, dst_slab, cnt, tot, counters`` in
    place and flags every row it writes (and in ``table_dirty`` the group of
    every src-table slot it writes).  Given the row hashes ``dh_keys/
    dh_vals [N, H]`` (paper §II.2), an item then edits its row's table: it
    deletes the evicted dst where it replaced the tail, then inserts ``dst
    -> slot`` where the dst was not in the row (the insert may reuse the
    TOMB the delete just made).  A sequential walk: it reads the items on
    the host.
    """
    n_cap = cnt.shape[0]
    n_rows, dropped_rows, dropped_probes, evictions = counters.tolist()
    table = ht.HashTable(tab_keys, tab_vals)
    slabs = sl.Slabs(dst_slab, cnt, tot, order)

    def one(x):  # one item's row-hash edit takes tensors of one element
        return torch.full((1,), x, device=cnt.device)

    for i in torch.nonzero(active).flatten().tolist():
        s, d, wi = src[i], dst[i], w[i]
        # --- src row (lookup or allocate) -------------------------------
        row0, found_src = ht.lookup(table, s, max_probes)
        if bool(found_src):
            row = int(row0)
        elif n_rows >= n_cap:
            dropped_rows += 1
            continue
        else:
            slot, ok = ht.insert_probe(tab_keys, s, max_probes)
            if not bool(ok):
                dropped_probes += 1
                continue
            row = n_rows
            tab_keys[int(slot)] = s
            tab_vals[int(slot)] = row
            _flag_slot(table_dirty, int(slot), tab_keys.shape[0])
            n_rows += 1
        # --- dst slot (find / free / Space-Saving tail replace) ---------
        slot_eq, found_d = sl.find_slot(slabs, row, d)
        slot_free, has_free = sl.free_slot(slabs, row)
        if bool(found_d):
            slot, base = int(slot_eq), cnt[row, int(slot_eq)]
        elif bool(has_free):
            slot, base = int(slot_free), 0
        else:
            slot = int(sl.tail_slot(slabs, row))
            base = cnt[row, slot]
            evictions += 1
        evicted = int(dst_slab[row, slot])
        cnt[row, slot] = base + wi
        dst_slab[row, slot] = d
        tot[row] += wi
        if dirty is not None:
            dirty[row] = 1
        if dh_keys is not None and not bool(found_d):
            if not bool(has_free):
                dh_delete_rows_(dh_keys, one(row), one(evicted), one(True),
                                max_probes)
            dh_insert_rows_(dh_keys, dh_vals, one(row), d.view(1), one(slot),
                            one(True), max_probes)
    counters.copy_(torch.tensor(
        [n_rows, dropped_rows, dropped_probes, evictions], dtype=torch.int32))


def slow_path_rows_ref_(tab_keys: torch.Tensor, tab_vals: torch.Tensor,
                        dst_slab: torch.Tensor, cnt: torch.Tensor,
                        tot: torch.Tensor, order: torch.Tensor,
                        counters: torch.Tensor, src: torch.Tensor,
                        dst: torch.Tensor, w: torch.Tensor,
                        active: torch.Tensor, max_probes: int,
                        dirty=None, dh_keys=None, dh_vals=None,
                        table_dirty=None) -> None:
    """The same pass as :func:`slow_path_ref_`, computed the way the CUDA
    kernel decomposes it (same arguments, same results).

    Phase A, rows: every active item looks its src up in the pre-state
    table at once; only the items that miss (src absent, or stored with an
    EMPTY value) run a sequential chain in item order — look up again (an
    earlier miss may have inserted the src), else take the next row, else
    count ``dropped_rows`` / ``dropped_probes``.  With every row taken at
    the start, the chain is a count of the misses.  Phase B, slots: the
    items that have a row, grouped by (row, position); rows never see each
    other, so the k-th item of every row is applied at once, for k = 0, 1,
    ...  Given the row hashes, each of those steps then applies its items'
    deletes, then their inserts, all rows at once.  Used by the tests and
    ``chip_smoke.py``, not on any path.
    """
    n_cap, cap = cnt.shape
    n_rows, dropped_rows, dropped_probes, evictions = counters.tolist()
    act = active.to(torch.bool)

    # --- phase A: rows ------------------------------------------------------
    table = ht.HashTable(tab_keys, tab_vals)
    rows, found = ht.lookup(table, src, max_probes)
    rows = torch.where(act & found, rows, -1).to(torch.int64)
    missing = torch.nonzero(act & ~found).flatten().tolist()
    if n_rows >= n_cap:
        dropped_rows += len(missing)
        missing = []
    for i in missing:
        row0, found_src = ht.lookup(table, src[i], max_probes)
        if bool(found_src):
            rows[i] = int(row0)
        elif n_rows >= n_cap:
            dropped_rows += 1
        else:
            slot, ok = ht.insert_probe(tab_keys, src[i], max_probes)
            if not bool(ok):
                dropped_probes += 1
                continue
            tab_keys[int(slot)] = src[i]
            tab_vals[int(slot)] = n_rows
            _flag_slot(table_dirty, int(slot), tab_keys.shape[0])
            rows[i] = n_rows
            n_rows += 1

    # --- phase B: slots, rank k of every row at once ------------------------
    items = torch.nonzero(rows >= 0).flatten()
    if items.numel():
        key = rows[items] * (rows.numel() + 1) + items
        items = items[torch.sort(key).indices]
        r_sorted = rows[items]
        head = torch.ones_like(r_sorted, dtype=torch.bool)
        head[1:] = r_sorted[1:] != r_sorted[:-1]
        pos = torch.arange(items.numel(), device=items.device)
        start = torch.cummax(torch.where(head, pos, 0), dim=0).values
        rank = pos - start
        for k in range(int(rank.max()) + 1):
            it = items[rank == k]
            r = rows[it]
            d, wi = dst[it], w[it]
            slot_eq, found_d = first_true(dst_slab[r] == d.unsqueeze(1), dim=1)
            slot_free, has_free = first_true(cnt[r] == 0, dim=1)
            tail = order[r, cap - 1].to(torch.int64)
            slot = torch.where(found_d, slot_eq, torch.where(has_free, slot_free, tail))
            base = torch.where(has_free & ~found_d, 0, cnt[r, slot])
            evicted = dst_slab[r, slot]
            cnt[r, slot] = (base + wi).to(cnt.dtype)
            dst_slab[r, slot] = d.to(dst_slab.dtype)
            tot[r] += wi.to(tot.dtype)
            evictions += int((~found_d & ~has_free).sum())
            if dh_keys is not None:
                dh_delete_rows_(dh_keys, r, evicted, ~found_d & ~has_free,
                                max_probes)
                dh_insert_rows_(dh_keys, dh_vals, r, d, slot, ~found_d,
                                max_probes)
        if dirty is not None:
            dirty[r_sorted] = 1
    counters.copy_(torch.tensor(
        [n_rows, dropped_rows, dropped_probes, evictions], dtype=torch.int32))


slow_path_ref = _on_copies(slow_path_ref_)
slow_path_rows_ref = _on_copies(slow_path_rows_ref_)


def copy_dirty_rows_ref(f_cnt, f_dst, f_order, f_tot, f_keys, f_vals,
                        f_scalars, b_cnt, b_dst, b_order, b_tot, b_keys,
                        b_vals, b_scalars, dirty, table_dirty,
                        row_hashes=None) -> None:
    """Catch the back state up with the front (plain version of
    ``copy_rows.py``): the ``cnt``/``dst``/``order`` rows and ``tot`` of
    every row flagged in ``dirty`` (and their row hashes, given
    ``row_hashes`` = front ``dh_keys, dh_vals``, back ``dh_keys,
    dh_vals``), the src table ``keys``/``vals`` slots of every group
    flagged in ``table_dirty`` (a flag per ``T / len(table_dirty)`` slots)
    and the ``scalars`` whole; then clear both flags."""
    rows = dirty != 0
    by_row = ((f_cnt, b_cnt), (f_dst, b_dst), (f_order, b_order))
    if row_hashes is not None:
        by_row += tuple(zip(row_hashes[:2], row_hashes[2:]))
    for f, b in by_row:
        b.copy_(torch.where(rows.unsqueeze(1), f, b))
    b_tot.copy_(torch.where(rows, f_tot, b_tot))
    slots = (table_dirty != 0).repeat_interleave(
        f_keys.numel() // table_dirty.numel())
    for f, b in ((f_keys, b_keys), (f_vals, b_vals)):
        b.copy_(torch.where(slots, f, b))
    b_scalars.copy_(f_scalars)
    dirty.zero_()
    table_dirty.zero_()
