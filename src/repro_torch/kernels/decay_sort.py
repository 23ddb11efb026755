"""CUDA kernel: the §II.C decay of slab rows in one pass — halve, evict,
re-sum and re-sort.

Replaces the TPU composition ``repro/kernels/ops.py::decay_sort`` (the
prologue ``cnt >> 1``, evict, row sum, then ``repro/kernels/oddeven.py::
oddeven_pallas`` with ``C//2 + 1`` passes as a full sort), and in rolling
mode the block slicing of ``repro/core/mcprioq.py::decay_impl``.  Per row:
``cnt' = cnt >> 1``, ``dst' = EMPTY`` where ``cnt'`` is 0, ``tot'`` the row
sum of ``cnt'``, ``order'`` the stable descending sort of the counts in
priority order.  The odd-even network with ``C//2 + 1`` passes sorts any row
completely and never swaps equal counts, so its result is exactly the sort
by (count descending, priority position ascending): the kernel keeps a row
whose halved counts are already in order as it is, and sorts any other by
that unique key (64 bits: ``-count * 2^32 + position``) with a bitonic
network, which gives the same bits.

Bound on this card: bytes — cnt, dst and order read once, the three written
once, plus ``tot``: 6·C·4 B per row (0.96 ms for 2^20 x 128 at 3.35 TB/s);
a 1024-row block moves 3 MB and is a launch and two DRAM round trips.  The
design gives each row a warp that reads and writes the row once, sums with a
warp reduction and sorts in registers (28 compare-exchange steps at C = 128
against 260 serial shared-memory steps of 65 odd-even passes; none for a row
already in order).  The kernel writes in place: its outputs may be its
inputs, so the state's owner decays its own tensors and a rolling decay
moves the block and nothing else (``decay_sort_cuda_``,
``decay_sort_rolling_cuda_``).  In rolling mode it reads the cursor itself
and a one-thread launch after the block moves it, so a rolling decay needs
no device->host synchronisation; given a device ``fire`` flag, both launches
return at once when it is false (``maybe_decay_``).  The functional wrappers
give the kernel fresh outputs (whole table) or copies of the state (rolling:
an ``EpochStore`` reader may hold the tensors given).

With the per-row dst hash (``dh_keys/dh_vals [N, H]``, paper §II.2) the same
warp repairs the decayed row's table, as the reference's
``core/mcprioq.py:580`` ``_dh_repair_rows`` does after the block: every
occupied lane whose slot now holds count 0 becomes TOMB, and their number is
added to the state's ``dh_tombstones`` with one integer atomic per row.
That adds the row hash's read and the dead lanes' writes (8·H B per row:
4 MiB for a 1024-row block at H = 512).

Source: ``csrc/decay_sort.cu`` (entry ``mcq_decay_sort``).  Plain versions:
:func:`decay_sort_ref`, :func:`decay_sort_rolling_ref` and their in-place
forms; :func:`decay_sort_rows_ref` mirrors the kernel's decomposition.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (decay_sort_ref, decay_sort_ref_,
                                     decay_sort_rolling_ref,
                                     decay_sort_rolling_ref_,
                                     decay_sort_rows_ref)

# the plain versions are re-exported beside their kernel
__all__ = ["decay_sort_cuda", "decay_sort_cuda_", "decay_sort_rolling_cuda",
           "decay_sort_rolling_cuda_", "decay_sort_ref", "decay_sort_ref_",
           "decay_sort_rolling_ref", "decay_sort_rolling_ref_",
           "decay_sort_rows_ref", "launches", "MAX_CAPACITY"]

launches = 0  # kernel launches made by this module's wrappers in this process

MAX_CAPACITY = 1024   # 32 lanes x 32 registers: the widest row a warp sorts


def _check(name, cnt, dst, order, fire=None, dirty=None, dh_keys=None,
           dh_vals=None, tombstones=None, **more):
    _build.require_cuda_int32(name, bools=("fire",), flags=("dirty",), cnt=cnt,
                              dst=dst, order=order, fire=fire, dirty=dirty,
                              dh_keys=dh_keys, dh_vals=dh_vals,
                              tombstones=tombstones, **more)
    if cnt.dim() != 2 or not (cnt.shape == dst.shape == order.shape):
        raise ValueError(f"{name}: cnt/dst/order must be [N, C]")
    if not 1 <= cnt.shape[1] <= MAX_CAPACITY:
        raise ValueError(f"{name}: capacity {cnt.shape[1]} is outside 1.."
                         f"{MAX_CAPACITY}, the rows one warp sorts in registers")
    if fire is not None and fire.dim() != 0:
        raise ValueError(f"{name}: fire must be a 0-dim bool tensor")
    _build.require_flags(name, dirty, cnt.shape[0])
    dh_size = _build.require_row_hashes(name, dh_keys, dh_vals, cnt.shape[0])
    if dh_size and (tombstones is None or tombstones.dim() != 0):
        raise ValueError(f"{name}: the row hashes need tombstones, a 0-dim "
                         f"int32 tensor")
    return dh_size


def _launch(cnt, dst, order, outs, cursor, fire, dirty, block_rows, dh_size,
            dh_keys=None, dh_vals=None, tombstones=None):
    global launches
    _build.launch("mcq_decay_sort", cnt.device, cnt.data_ptr(), dst.data_ptr(),
                  order.data_ptr(), *(x.data_ptr() for x in outs),
                  _build.ptr(cursor), _build.ptr(fire), _build.ptr(dirty),
                  cnt.shape[0], block_rows, cnt.shape[1], _build.ptr(dh_keys),
                  _build.ptr(dh_vals), dh_size, _build.ptr(tombstones))
    launches += 1


def decay_sort_cuda(cnt: torch.Tensor, dst: torch.Tensor, order: torch.Tensor,
                    *, dh_keys=None, dh_vals=None):
    """Every row of cnt/dst/order [N, C] decayed on the GPU in one launch.
    Returns fresh ``(cnt', dst', order', tot')``; given the row hashes
    dh_keys/dh_vals [N, H], also a repaired copy of ``dh_keys`` and the
    number of lanes tombstoned (0-dim int32)."""
    outs = (torch.empty_like(cnt), torch.empty_like(dst),
            torch.empty_like(order),
            torch.empty(cnt.shape[:1], dtype=torch.int32, device=cnt.device))
    dh = ()
    if dh_keys is not None:
        dh = (dh_keys.clone(),
              torch.zeros((), dtype=torch.int32, device=cnt.device))
    keys, tombs = dh or (None, None)
    dh_size = _check("decay_sort_cuda", cnt, dst, order, dh_keys=keys,
                     dh_vals=dh_vals, tombstones=tombs)
    if cnt.shape[0]:
        _launch(cnt, dst, order, outs, None, None, None, cnt.shape[0], dh_size,
                keys, dh_vals, tombs)
    return outs + dh


def decay_sort_cuda_(cnt: torch.Tensor, dst: torch.Tensor, order: torch.Tensor,
                     tot: torch.Tensor, *, fire=None, dirty=None, dh_keys=None,
                     dh_vals=None, tombstones=None) -> None:
    """Every row of cnt/dst/order [N, C] and tot [N] decayed in place on the
    GPU, one launch; unless the device bool ``fire`` is false, when nothing
    is written.  ``dirty`` (uint8 [N]): every decayed row's flag set.  Given
    the row hashes dh_keys/dh_vals [N, H], each row's is repaired in place
    and ``tombstones`` (0-dim int32) counts the lanes tombstoned."""
    dh = dict(dh_keys=dh_keys, dh_vals=dh_vals, tombstones=tombstones)
    dh_size = _check("decay_sort_cuda_", cnt, dst, order, fire, dirty, tot=tot,
                     **dh)
    if tot.shape != cnt.shape[:1]:
        raise ValueError("decay_sort_cuda_: tot must be [N]")
    if cnt.shape[0]:
        _launch(cnt, dst, order, (cnt, dst, order, tot), None, fire, dirty,
                cnt.shape[0], dh_size, **dh)


def decay_sort_rolling_cuda_(cnt: torch.Tensor, dst: torch.Tensor,
                             order: torch.Tensor, tot: torch.Tensor,
                             cursor: torch.Tensor, *, block_rows: int,
                             fire=None, dirty=None, dh_keys=None,
                             dh_vals=None, tombstones=None) -> None:
    """The rolling block the device-side ``cursor`` (0-dim int32) selects,
    decayed in place on the GPU, and the cursor moved to the next block;
    rows ``row0 .. row0 + block_rows`` of cnt/dst/order [N, C] and tot [N]
    are written, no other.  Unless the device bool ``fire`` is false: then
    nothing is written and the cursor stays.  ``dirty`` (uint8 [N]): the
    block's flags set.  Given the row hashes, the block's are repaired as
    in :func:`decay_sort_cuda_`."""
    dh = dict(dh_keys=dh_keys, dh_vals=dh_vals, tombstones=tombstones)
    dh_size = _check("decay_sort_rolling_cuda_", cnt, dst, order, fire, dirty,
                     tot=tot, cursor=cursor, **dh)
    n = cnt.shape[0]
    if tot.shape != (n,) or cursor.dim() != 0:
        raise ValueError("decay_sort_rolling_cuda_: tot must be [N] and cursor "
                         "a 0-dim tensor")
    if not 1 <= block_rows <= n:
        raise ValueError(f"decay_sort_rolling_cuda_: block_rows {block_rows} "
                         f"outside 1..{n}")
    _launch(cnt, dst, order, (cnt, dst, order, tot), cursor, fire, dirty,
            block_rows, dh_size, **dh)


def decay_sort_rolling_cuda(cnt: torch.Tensor, dst: torch.Tensor,
                            order: torch.Tensor, tot: torch.Tensor,
                            cursor: torch.Tensor, *, block_rows: int,
                            dh_keys=None, dh_vals=None, tombstones=None):
    """The rolling decay into copies: returns copies of cnt/dst/order [N, C]
    and tot [N] with the cursor's block decayed, and the next cursor (and,
    given the row hashes, copies of ``dh_keys`` and ``tombstones`` repaired
    and counted); the inputs are not written."""
    outs = tuple(x.clone() for x in (cnt, dst, order, tot, cursor))
    dh = () if dh_keys is None else (dh_keys.clone(), tombstones.clone())
    keys, tombs = dh or (None, None)
    decay_sort_rolling_cuda_(*outs, block_rows=block_rows, dh_keys=keys,
                             dh_vals=dh_vals, tombstones=tombs)
    return outs + dh
