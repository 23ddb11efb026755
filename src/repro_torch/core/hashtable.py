"""Functional open-addressing hash table on torch tensors.

Counterpart of ``repro.core.hashtable``: the table is a pair of fixed-shape
int32 tensors (``keys``, ``vals``) and every operation is a pure function
``table -> table`` (inputs are never written).  Linear probing with a bounded
probe count: a lookup or insert inspects at most ``max_probes`` slots from the
key's home slot, no retries.

Sentinels: ``EMPTY = -1`` (never written), ``TOMB = -2`` (deleted; probe
continues through it, insert may reuse it).  Keys must be non-negative int32.

The bounded probe loop is written as one window gather plus first-position
reductions (what the batched probe kernel computes), not as a loop over probe
positions: a slot's first visit time is its probe position, so the two agree
even when the window wraps a small table.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.device import resolve_device

EMPTY = -1
TOMB = -2

_U32 = 0xFFFFFFFF


class HashTable(NamedTuple):
    """Open-addressing table. ``size`` must be a power of two."""

    keys: torch.Tensor  # int32[size]
    vals: torch.Tensor  # int32[size]


#: src-table slots one table flag stands for (the whole table when smaller):
#: the new-edge pass flags the group of every slot it writes, and the
#: back-buffer learner's catch-up copies the flagged groups
FLAG_GROUP = 32


def flag_group(size: int) -> int:
    """Slots one flag stands for in a table of ``size`` slots."""
    return min(FLAG_GROUP, size)


def flag_count(size: int) -> int:
    """Table flags (uint8) a table of ``size`` slots takes."""
    return -(-size // flag_group(size))


def make(size: int, device=None) -> HashTable:
    """Empty table on ``device`` (default: the current CUDA device; raises
    when there is none)."""
    if size & (size - 1):
        raise ValueError(f"hash table size must be a power of two, got {size}")
    device = resolve_device(device)
    return HashTable(
        keys=torch.full((size,), EMPTY, dtype=torch.int32, device=device),
        vals=torch.full((size,), EMPTY, dtype=torch.int32, device=device),
    )


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """splitmix32-style avalanche; int32 in, uint32 value out (as int64).

    torch has no wrap-around uint32 arithmetic, so the value is carried in
    int64 and masked to its low 32 bits after every multiply (the second
    product can exceed 2**63; int64 wraps and the low 32 bits stay right).
    """
    x = x.to(torch.int64) & _U32
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & _U32
    x = ((x ^ (x >> 15)) * 0x846CA68B) & _U32
    x = x ^ (x >> 16)
    return x


def ctx_hash_fold(h: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """One step of the rolling n-gram context hash: ``h*M + hash_u32(tok)``
    in uint32 arithmetic (value carried in int64)."""
    return (h * 1000003 + hash_u32(tok)) & _U32


def ctx_window_hash(window: torch.Tensor) -> torch.Tensor:
    """Context id of a ``[..., W]`` token window: fold the W tokens newest
    first and clear the top bit so the id is a valid table key."""
    w = window.shape[-1]
    h = torch.zeros(window.shape[:-1], dtype=torch.int64, device=window.device)
    for j in range(w):
        h = ctx_hash_fold(h, window[..., w - 1 - j])
    return (h & 0x7FFFFFFF).to(torch.int32)


def _slot0(key: torch.Tensor, size: int) -> torch.Tensor:
    return hash_u32(key) & (size - 1)


def first_true(mask: torch.Tensor, dim: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lowest index along ``dim`` where ``mask`` holds: ``(index, any)``.

    ``index`` is the size of ``dim`` where no element holds.  Written as a
    min over masked positions: ``argmax`` does not promise the first of
    several equal maxima on every device.
    """
    n = mask.shape[dim]
    pos = torch.arange(n, dtype=torch.int64, device=mask.device)
    shape = [1] * mask.dim()
    shape[dim] = n
    idx = torch.where(mask, pos.view(shape), n).amin(dim=dim)
    return idx, idx < n


def _window(keys_tab: torch.Tensor, key: torch.Tensor, max_probes: int,
            rows=None):
    """Probe window of ``key`` (any batch shape ``[...]``) in a flat table,
    or, given ``rows`` (the shape of ``key``), in table ``rows`` of a stack
    ``keys_tab[N, H]``.

    Returns ``(idx[..., P], win[..., P])``: the visited slots in probe order
    and the keys they hold.
    """
    size = keys_tab.shape[-1]
    key = key.to(torch.int64)
    p = torch.arange(max_probes, dtype=torch.int64, device=keys_tab.device)
    idx = (_slot0(key, size).unsqueeze(-1) + p) & (size - 1)
    win = keys_tab[idx] if rows is None else keys_tab[rows.unsqueeze(-1), idx]
    return idx, win.to(torch.int64)


def _lookup_probe(table: HashTable, key: torch.Tensor, max_probes: int,
                  rows=None):
    idx, win = _window(table.keys, key, max_probes, rows)
    key64 = key.to(torch.int64).unsqueeze(-1)
    key_p, _ = first_true(win == key64)
    empty_p, _ = first_true(win == EMPTY)
    hit = key_p < empty_p
    slot = idx.gather(-1, key_p.clamp(max=max_probes - 1).unsqueeze(-1)).squeeze(-1)
    held = table.vals[slot] if rows is None else table.vals[rows, slot]
    val = torch.where(hit, held, EMPTY).to(torch.int32)
    return val, slot, hit


def lookup(table: HashTable, key, max_probes: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return ``(val, found)``. ``val`` is EMPTY when not found.

    At most ``max_probes`` slots are inspected; a longer chain shows up as a
    miss and is tracked by the caller's overflow counter.
    """
    key = _key_tensor(key, table.keys.device)
    val, _, _ = _lookup_probe(table, key, max_probes)
    return val, val != EMPTY


def lookup_batch(table: HashTable, keys, max_probes: int = 64,
                 impl: str = "vmap"):
    """Batched read-only probe: ``(vals[B], found[B])``.

    ``impl='vmap'`` (default) is the batched form of :func:`lookup`.  Any
    kernel impl (``auto``/``ref``/``cuda``) routes through the shared
    open-addressing probe kernel in its flat mode (``ops.ht_find``: one
    launch on CUDA tensors).  Imported lazily: this module is a leaf the
    kernel layer itself depends on.
    """
    keys = _key_tensor(keys, table.keys.device)
    if impl == "vmap":
        return lookup(table, keys, max_probes)
    from repro_torch.kernels import ops
    return ops.ht_find(keys, table.keys, table.vals, max_probes=max_probes,
                       impl=impl)


def insert_probe(keys_tab: torch.Tensor, key: torch.Tensor, max_probes: int,
                 rows=None):
    """Where ``insert`` would write ``key``: ``(slot, ok)`` of the key's shape
    (``slot`` is -1 and ``ok`` False when the probe window is exhausted);
    ``rows`` as in :func:`_window` (slots are then columns of those rows).

    Lands on the key itself or on the first EMPTY (end of chain).  The first
    TOMB seen before that is preferred when (a) the walk stopped at EMPTY
    without the key, or (b) the window exhausted without the key or an EMPTY
    (a tombstone-saturated chain).  In both cases the key is provably absent,
    so reuse keeps the chain invariant intact.
    """
    idx, win = _window(keys_tab, key, max_probes, rows)
    key64 = key.to(torch.int64).unsqueeze(-1)
    stop_p, stopped = first_true((win == key64) | (win == EMPTY))
    pos = torch.arange(max_probes, dtype=torch.int64, device=keys_tab.device)
    tomb_p, has_tomb = first_true((win == TOMB) & (pos < stop_p.unsqueeze(-1)))
    last = max_probes - 1
    stop_idx = idx.gather(-1, stop_p.clamp(max=last).unsqueeze(-1)).squeeze(-1)
    tomb_idx = idx.gather(-1, tomb_p.clamp(max=last).unsqueeze(-1)).squeeze(-1)
    landed = win.gather(-1, stop_p.clamp(max=last).unsqueeze(-1)).squeeze(-1)
    landed_key = torch.where(stopped, landed, EMPTY)
    use_tomb = has_tomb & (~stopped | (landed_key == EMPTY))
    slot = torch.where(use_tomb, tomb_idx, torch.where(stopped, stop_idx, -1))
    return slot.to(torch.int32), slot >= 0


def insert(table: HashTable, key, val, max_probes: int = 64
           ) -> Tuple[HashTable, torch.Tensor, torch.Tensor]:
    """Insert or update ``key -> val``.

    Returns ``(table, slot, ok)``; ``ok`` False means the probe window was
    exhausted (caller should count it as an overflow drop).
    """
    dev = table.keys.device
    key = _key_tensor(key, dev)
    val = _key_tensor(val, dev)
    slot, ok = insert_probe(table.keys, key, max_probes)
    widx = slot.clamp(min=0).to(torch.int64)
    new_keys = table.keys.clone()
    new_vals = table.vals.clone()
    new_keys[widx] = torch.where(ok, key, table.keys[widx])
    new_vals[widx] = torch.where(ok, val, table.vals[widx])
    return HashTable(new_keys, new_vals), slot, ok


def delete(table: HashTable, key, max_probes: int = 64) -> Tuple[HashTable, torch.Tensor]:
    """Tombstone ``key``. Returns ``(table, deleted)``."""
    key = _key_tensor(key, table.keys.device)
    _, slot, ok = _lookup_probe(table, key, max_probes)
    new_keys = table.keys.clone()
    new_keys[slot] = torch.where(ok, TOMB, table.keys[slot]).to(torch.int32)
    return HashTable(new_keys, table.vals), ok


def insert_batch_sequential(
    table: HashTable,
    keys,
    vals,
    active,
    max_probes: int = 64,
) -> Tuple[HashTable, torch.Tensor, torch.Tensor]:
    """Sequentially insert a batch. Deterministic: batch order wins.

    Returns ``(table, slots[B], n_dropped)``.  This is the writer side; batched
    readers (:func:`lookup_batch`) never conflict with it because the caller
    sequences update and query steps.
    """
    dev = table.keys.device
    keys = _key_tensor(keys, dev)
    vals = _key_tensor(vals, dev)
    active = torch.as_tensor(active, device=dev).to(torch.bool)
    new_keys = table.keys.clone()
    new_vals = table.vals.clone()
    slots = torch.full(keys.shape, -1, dtype=torch.int32, device=dev)
    n_dropped = 0
    for i in torch.nonzero(active).flatten().tolist():
        slot, ok = insert_probe(new_keys, keys[i], max_probes)
        slots[i] = slot
        if bool(ok):
            new_keys[int(slot)] = keys[i]
            new_vals[int(slot)] = vals[i]
        else:
            n_dropped += 1
    dropped = torch.full((), n_dropped, dtype=torch.int32, device=dev)
    return HashTable(new_keys, new_vals), slots, dropped


def load_factor(table: HashTable) -> torch.Tensor:
    return (table.keys >= 0).to(torch.float32).mean()


def _key_tensor(x, device) -> torch.Tensor:
    """int32 tensor on ``device`` from a tensor, numpy array or Python int."""
    return torch.as_tensor(x, device=device).to(torch.int32)
