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
from repro_torch.core.hashtable import EMPTY, first_true


def oddeven_ref(c_ord: torch.Tensor, order: torch.Tensor, passes: int):
    """k odd-even passes over counts-in-order + the order permutation.

    c_ord[N, C] are the counts *already gathered into order position* (the
    kernel-side layout); order[N, C] the slot permutation. Returns the pair
    after ``passes`` full (even+odd) sweeps, descending target.
    """
    c_ord = c_ord.clone()
    order = order.clone()
    cap = c_ord.shape[1]
    for _ in range(passes):
        for start in (0, 1):
            m = (cap - start) // 2
            if m <= 0:
                continue
            left = slice(start, start + 2 * m, 2)
            right = slice(start + 1, start + 1 + 2 * m, 2)
            left_c, right_c = c_ord[:, left], c_ord[:, right]
            left_o, right_o = order[:, left], order[:, right]
            swap = left_c < right_c
            nl_c = torch.where(swap, right_c, left_c)
            nr_c = torch.where(swap, left_c, right_c)
            nl_o = torch.where(swap, right_o, left_o)
            nr_o = torch.where(swap, left_o, right_o)
            c_ord[:, left] = nl_c
            c_ord[:, right] = nr_c
            order[:, left] = nl_o
            order[:, right] = nr_o
    return c_ord, order


def oddeven_sort_ref(cnt: torch.Tensor, order: torch.Tensor, passes: int):
    """What the odd-even kernel computes from the raw slab arrays: gather the
    counts into order position once, run the passes, return the new order."""
    _, new_order = oddeven_ref(sl.gather_cols(cnt, order), order, passes)
    return new_order


def decay_sort_ref(cnt: torch.Tensor, dst: torch.Tensor, order: torch.Tensor):
    """§II.C decay of every row given (the reference's composition): halve
    the counts, evict the edges whose count reaches 0, re-sum the rows, and
    sort with C//2+1 odd-even passes — a full transposition network, and a
    stable one, since only strictly out-of-order neighbours swap.  Returns
    ``(cnt', dst', order', tot')``."""
    new_cnt = cnt >> 1
    new_dst = torch.where(new_cnt == 0, EMPTY, dst).to(torch.int32)
    new_tot = new_cnt.sum(dim=1).to(torch.int32)
    new_order = oddeven_sort_ref(new_cnt, order, cnt.shape[1] // 2 + 1)
    return new_cnt, new_dst, new_order, new_tot


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


def decay_sort_rolling_ref(cnt: torch.Tensor, dst: torch.Tensor,
                           order: torch.Tensor, tot: torch.Tensor,
                           cursor: torch.Tensor, block_rows: int):
    """Rolling decay of one ``block_rows``-row block, found on the device as
    the reference finds it: ``cur = cursor mod ceil(n / r)``, first row
    ``min(cur * r, n - r)`` (the last block is clamped and overlaps the one
    before it when r does not divide n).  Returns copies of ``cnt, dst,
    order, tot`` with that block decayed by :func:`decay_sort_ref`, and the
    next cursor ``cur + 1``; nothing reads the cursor on the host."""
    n = cnt.shape[0]
    cur = torch.remainder(cursor, -(-n // block_rows))
    row0 = (cur.to(torch.int64) * block_rows).clamp(max=n - block_rows)
    rows = row0 + torch.arange(block_rows, device=cnt.device)
    blocks = decay_sort_ref(cnt[rows], dst[rows], order[rows])
    outs = []
    for full, block in zip((cnt, dst, order, tot), blocks):
        out = full.clone()
        out[rows] = block
        outs.append(out)
    return (*outs, (cur + 1).to(torch.int32))


def slab_update_ref(rows: torch.Tensor, dsts: torch.Tensor, w: torch.Tensor,
                    dst: torch.Tensor, cnt: torch.Tensor, tot: torch.Tensor):
    """Fast-path batched edge increment (paper §II.A.2, existing edges only).

    For each item i: find slot of dsts[i] in row rows[i]; if present add w[i]
    to cnt and tot.  Items whose edge is absent are no-ops (the caller sends
    them down the slow path).  rows < 0 marks padding.
    """
    active = rows >= 0
    safe_rows = rows.clamp(min=0).to(torch.int64)
    hit = dst[safe_rows] == dsts.unsqueeze(1)          # [B, C]
    slot, any_hit = first_true(hit, dim=1)
    found = any_hit & active
    slot = torch.where(any_hit, slot, 0)
    addw = torch.where(found, w, 0).to(cnt.dtype)
    cap = cnt.shape[1]
    cnt = cnt.clone().view(-1).index_add_(0, safe_rows * cap + slot, addw).view_as(cnt)
    tot = tot.clone().index_add_(0, safe_rows, addw)
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


def slow_path_ref(tab_keys: torch.Tensor, tab_vals: torch.Tensor,
                  dst_slab: torch.Tensor, cnt: torch.Tensor, tot: torch.Tensor,
                  order: torch.Tensor, counters: torch.Tensor,
                  src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                  active: torch.Tensor, max_probes: int,
                  own_counts: bool = False):
    """Sequential insert pass for new edges / new rows (the paper's rare case).

    Deterministic (batch order); inactive items are no-ops.  For each active
    item: look the src up or allocate the next row (``counters[0]`` =
    ``n_rows``; a full table counts ``dropped_rows`` = ``counters[1]``, an
    exhausted probe window ``dropped_probes`` = ``counters[2]``); then find
    the dst's slot, else the first free slot, else replace the order tail
    (Space-Saving: the newcomer inherits the victim's count; ``evictions`` =
    ``counters[3]``).  A later item sees the rows and slots an earlier one
    made.  Returns ``(tab_keys, tab_vals, dst_slab, cnt, tot, counters)``,
    all fresh; the inputs are not written, except ``cnt`` and ``tot`` when
    the caller owns them (``own_counts``): those are written in place and
    returned.
    """
    tab_keys, tab_vals, dst_slab = tab_keys.clone(), tab_vals.clone(), dst_slab.clone()
    if not own_counts:
        cnt, tot = cnt.clone(), tot.clone()
    n_cap = cnt.shape[0]
    n_rows, dropped_rows, dropped_probes, evictions = counters.tolist()
    table = ht.HashTable(tab_keys, tab_vals)
    slabs = sl.Slabs(dst_slab, cnt, tot, order)
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
        cnt[row, slot] = base + wi
        dst_slab[row, slot] = d
        tot[row] += wi
    new_counters = torch.tensor(
        [n_rows, dropped_rows, dropped_probes, evictions], dtype=torch.int32
    ).to(counters.device)
    return tab_keys, tab_vals, dst_slab, cnt, tot, new_counters


def slow_path_rows_ref(tab_keys: torch.Tensor, tab_vals: torch.Tensor,
                       dst_slab: torch.Tensor, cnt: torch.Tensor,
                       tot: torch.Tensor, order: torch.Tensor,
                       counters: torch.Tensor, src: torch.Tensor,
                       dst: torch.Tensor, w: torch.Tensor,
                       active: torch.Tensor, max_probes: int,
                       own_counts: bool = False):
    """The same pass as :func:`slow_path_ref`, computed the way the CUDA
    kernel decomposes it (same arguments, same results).

    Phase A, rows: every active item looks its src up in the pre-state
    table at once; only the items that miss (src absent, or stored with an
    EMPTY value) run a sequential chain in item order — look up again (an
    earlier miss may have inserted the src), else take the next row, else
    count ``dropped_rows`` / ``dropped_probes``.  With every row taken at
    the start, the chain is a count of the misses.  Phase B, slots: the
    items that have a row, grouped by (row, position); rows never see each
    other, so the k-th item of every row is applied at once, for k = 0, 1,
    ...  Used by the tests and ``chip_smoke.py``, not on any path.
    """
    tab_keys, tab_vals, dst_slab = tab_keys.clone(), tab_vals.clone(), dst_slab.clone()
    if not own_counts:
        cnt, tot = cnt.clone(), tot.clone()
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
            cnt[r, slot] = (base + wi).to(cnt.dtype)
            dst_slab[r, slot] = d.to(dst_slab.dtype)
            tot[r] += wi.to(tot.dtype)
            evictions += int((~found_d & ~has_free).sum())
    new_counters = torch.tensor(
        [n_rows, dropped_rows, dropped_probes, evictions], dtype=torch.int32
    ).to(counters.device)
    return tab_keys, tab_vals, dst_slab, cnt, tot, new_counters
