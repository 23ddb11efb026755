"""CUDA kernel: the new-edge pass of ``update_batch``, row-parallel.

Replaces ``repro/core/mcprioq.py:311`` ``_slow_path`` — in the reference a
``lax.scan`` over the new-edge prefix, not a Pallas kernel.  Per active item,
in item order: look the src up or allocate the next row (hash insert with
tombstone reuse; ``dropped_rows`` / ``dropped_probes`` on failure), then the
slot holding the dst, else the first free slot, else Space-Saving
replacement of the order tail (the newcomer inherits the victim's count;
``evictions``).  A later item sees what an earlier one wrote.  With the
per-row dst hash (``dh_keys/dh_vals [N, H]``, paper §II.2; the reference's
``_dh_del``/``_dh_set`` at ``core/mcprioq.py:356-358``) each item then
deletes the dst it evicted and inserts its own dst -> slot in its row's
table.

Only two things chain an item to earlier ones: a missing src takes the next
row, and items on one row share its slots.  So the kernel (four launches)
looks every src up at once, walks only the misses in item order on one warp
(a count and nothing more once every row is taken), sorts the items that
have a row by (row, item) in shared memory, and gives each row to its own
warp, which applies that row's items in order, the row-hash edits
included (a warp-wide windowed probe, ``csrc/probe_window.cuh``, shared
with the chain and the rebuild).  It reads how many items
have a row on the device, so the sort's work follows that count, and an
empty pass costs a few short launches and no device->host
synchronisation.  Plain mirror of this decomposition:
:func:`repro_torch.kernels.ref.slow_path_rows_ref`.

Bound on this card: bytes — the items, their probe windows and the rows
they touch.  The state's owner hands its own tensors (``slow_path_cuda_``):
the pass writes the src table, ``dst_slab``, ``cnt``, ``tot`` and the
counters in place, sets the dirty flag of every row it writes and, given
``table_dirty``, the flag of the group of src-table slots
(``hashtable.flag_group``) of every slot it writes.  The
functional wrapper first copies what the pass writes — the src table,
``dst_slab``, ``cnt``/``tot`` and the counters, 2·(2·H + 2·N·C + N)·4 B read
+ written: an ``EpochStore`` reader may hold the tensors given.

Source: ``csrc/slow_path.cu`` (entry ``mcq_slow_path``).  Plain versions:
:func:`slow_path_ref` and :func:`slow_path_ref_`.
"""

from __future__ import annotations

import torch

from repro_torch.core import hashtable as ht
from repro_torch.kernels import _build
from repro_torch.kernels.ref import slow_path_ref, slow_path_ref_

# the plain versions are re-exported beside their kernel
__all__ = ["slow_path_cuda", "slow_path_cuda_", "slow_path_ref",
           "slow_path_ref_", "launches"]

launches = 0  # kernel launches made by slow_path_cuda_ in this process

_NO_ROW = 0x7FFFFFFE  # row field of a missing src in the kernel's sort keys
# the row launch caches 2 x C int32 per warp, 4 warps, in 48 KiB of shared
# memory (MCQ_SP_ROW_WARPS, MCQ_SP_SMEM_DEFAULT in csrc/slow_path.cu)
_MAX_CAPACITY = 48 * 1024 // (4 * 2 * 4)


def slow_path_cuda_(tab_keys: torch.Tensor, tab_vals: torch.Tensor,
                    dst_slab: torch.Tensor, cnt: torch.Tensor,
                    tot: torch.Tensor, order: torch.Tensor,
                    counters: torch.Tensor, src: torch.Tensor,
                    dst: torch.Tensor, w: torch.Tensor,
                    active: torch.Tensor, *, max_probes: int = 64,
                    dirty=None, dh_keys=None, dh_vals=None,
                    table_dirty=None) -> None:
    """The pass on the GPU, written into the given src table, ``dst_slab``,
    ``cnt``, ``tot``, ``counters`` and row hashes (the caller owns all of
    them); no copy.  ``dirty`` (uint8 [N]): the flag of every row written
    set; ``table_dirty`` (uint8 [``hashtable.flag_count(H)``]): the flag of
    every slot group written set.  Arguments as :func:`slow_path_cuda`."""
    global launches
    _build.require_cuda_int32(
        "slow_path_cuda", flags=("dirty", "table_dirty"), tab_keys=tab_keys,
        tab_vals=tab_vals, dst_slab=dst_slab, cnt=cnt, tot=tot, order=order,
        counters=counters, src=src, dst=dst, w=w, active=active, dirty=dirty,
        dh_keys=dh_keys, dh_vals=dh_vals, table_dirty=table_dirty)
    size = tab_keys.shape[0]
    if tab_keys.dim() != 1 or tab_vals.shape != tab_keys.shape or size < 1 \
            or size & (size - 1):
        raise ValueError("slow_path_cuda: tab_keys/tab_vals must be [H], H a "
                         "power of two")
    if cnt.dim() != 2 or not (cnt.shape == dst_slab.shape == order.shape) \
            or tot.shape != cnt.shape[:1] or cnt.shape[1] < 1:
        raise ValueError("slow_path_cuda: dst_slab/cnt/order must be [N, C], "
                         "tot [N]")
    if cnt.shape[1] > _MAX_CAPACITY:
        raise ValueError(f"slow_path_cuda: at most {_MAX_CAPACITY} slots per row")
    if cnt.shape[0] >= _NO_ROW:
        raise ValueError(f"slow_path_cuda: at most {_NO_ROW - 1} rows")
    if counters.shape != (4,):
        raise ValueError("slow_path_cuda: counters must be int32[4]")
    if src.dim() != 1 or not (src.shape == dst.shape == w.shape == active.shape):
        raise ValueError("slow_path_cuda: src/dst/w/active must be [L]")
    if max_probes < 1:
        raise ValueError("slow_path_cuda: max_probes must be >= 1")
    _build.require_flags("slow_path_cuda", dirty, cnt.shape[0])
    if table_dirty is not None and table_dirty.shape != (ht.flag_count(size),):
        raise ValueError(f"slow_path_cuda: table_dirty must be uint8"
                         f"[{ht.flag_count(size)}], one flag per "
                         f"{ht.flag_group(size)} table slots")
    dh_size = _build.require_row_hashes("slow_path_cuda", dh_keys, dh_vals,
                                        cnt.shape[0])
    n_items = src.shape[0]
    if n_items == 0:
        return
    keys = torch.empty(n_items, dtype=torch.int64, device=src.device)
    with_row = torch.empty_like(keys)
    n_with = torch.empty(1, dtype=torch.int32, device=src.device)
    _build.launch("mcq_slow_path", src.device, src.data_ptr(), dst.data_ptr(),
                  w.data_ptr(), active.data_ptr(), n_items,
                  tab_keys.data_ptr(), tab_vals.data_ptr(), tab_keys.shape[0],
                  dst_slab.data_ptr(), cnt.data_ptr(), tot.data_ptr(),
                  order.data_ptr(), counters.data_ptr(), _build.ptr(dirty),
                  cnt.shape[0],
                  cnt.shape[1], max_probes, keys.data_ptr(),
                  with_row.data_ptr(), n_with.data_ptr(), _build.ptr(dh_keys),
                  _build.ptr(dh_vals), dh_size, _build.ptr(table_dirty))
    launches += 1


def slow_path_cuda(tab_keys: torch.Tensor, tab_vals: torch.Tensor,
                   dst_slab: torch.Tensor, cnt: torch.Tensor,
                   tot: torch.Tensor, order: torch.Tensor,
                   counters: torch.Tensor, src: torch.Tensor,
                   dst: torch.Tensor, w: torch.Tensor, active: torch.Tensor,
                   *, max_probes: int = 64, dh_keys=None, dh_vals=None):
    """The new-edge pass on the GPU.  tab_keys/tab_vals[H] the src table,
    dst_slab/cnt/order[N, C], tot[N], counters[4] = (n_rows, dropped_rows,
    dropped_probes, evictions), items src/dst/w/active[L] (active int32,
    non-zero = apply); optionally the row hashes dh_keys/dh_vals[N, H].
    Returns ``(tab_keys, tab_vals, dst_slab, cnt, tot, counters)``, then
    ``(dh_keys, dh_vals)`` when given: fresh tensors, the inputs not
    written."""
    out = [x.clone() for x in (tab_keys, tab_vals, dst_slab, cnt, tot)]
    out.append(counters.clone())
    dh = [] if dh_keys is None else [dh_keys.clone(), dh_vals.clone()]
    slow_path_cuda_(*out[:5], order, out[5], src, dst, w, active,
                    max_probes=max_probes,
                    **dict(zip(("dh_keys", "dh_vals"), dh)))
    return tuple(out + dh)
